"""The arithmetic of the attention kernels' bf16 route, emulated on the CPU.

``csrc/flash_attention.cu`` runs bf16 prefill and decode attention on the
tensor cores: scores are f32 sums of exact bf16 products, the softmax is
online over key tiles in f32, and ``p @ v`` is ``p_hi @ v + p_lo @ v`` with
``p_hi = bf16(p)`` and ``p_lo = bf16(p - p_hi)``, both products summed in
f32, ``l`` summed from the f32 ``p``; only the output is rounded to bf16.
The kernels run only on a card, so this file emulates that arithmetic in
plain PyTorch and holds it to the bar the card tests hold the kernels to:
within ``ATTN_TOL`` of each output's ``sum_j p_j |v_j|`` plus one bf16 unit
of the output, against ``ref.mqa_attention_ref`` and
``ref.decode_attention_ref`` run in f32 on the same bf16 values. Rows that
cancel (v of mean 0 over 1,536 keys, so some outputs lie near 0 and their
bf16 unit is tiny) and peaked rows (one key takes almost all of p) are both
covered; rounding p to bf16 alone misses the bar on the cancelling rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref

ATTN_TOL = 1e-5                       # of sum_j p_j |v_j|, as the card tests
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def bf16_values(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, as f32."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def emulate(q, k, v, valid, tile, p_mode, exp2):
    """One query row per row of ``q`` (n, hd) against keys ``k``, ``v`` (S,
    hd), ``valid`` (n, S) bool, in key tiles of ``tile``: the kernels' online
    softmax in f32; ``p_mode`` "split" (p_hi + p_lo) or "bf16" (p rounded
    alone); ``exp2`` as the prefill kernel (scores times scale log2 e, base
    2), else as the decode kernel (scale, base e). Returns bf16 outputs."""
    n, hd = q.shape
    scale = np.float32(1.0 / np.sqrt(hd))
    if exp2:
        scale, exp = np.float32(float(scale) * LOG2E), torch.exp2
    else:
        exp = torch.exp
    m = torch.full((n, 1), NEG_INF)
    l = torch.zeros((n, 1))
    acc = torch.zeros((n, hd))
    for lo in range(0, k.shape[0], tile):
        s = q @ k[lo:lo + tile].T                      # exact bf16 products, f32 sums
        x = torch.where(valid[:, lo:lo + tile], s * torch.tensor(scale), NEG_INF)
        m_new = torch.maximum(m, x.max(dim=1, keepdim=True).values)
        alpha = exp(m - m_new)
        p = exp(x - m_new)
        l = alpha * l + p.sum(dim=1, keepdim=True)
        hi = p.bfloat16().float()
        vt = v[lo:lo + tile]
        if p_mode == "split":
            pv = hi @ vt + (p - hi).bfloat16().float() @ vt
        else:
            pv = hi @ vt
        acc = alpha * acc + pv
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).bfloat16().float().numpy()


def worst(got, want, scale):
    """Largest error over the bar (<= 1 holds it)."""
    tol = ATTN_TOL * scale + bf16_ulp(want)
    return float((np.abs(got - want) / tol).max())


def inputs(seed, S, hd, peaked):
    """bf16-valued q, k, v for one head: v of mean 0 over the keys (the
    outputs cancel); ``peaked``: every 97th query row's own key scaled up so
    that it takes almost all of that row's p."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, hd)).astype(np.float32) * 0.5
    k = rng.standard_normal((S, hd)).astype(np.float32) * 0.5
    if peaked:
        rows = np.arange(0, S, 97)
        k[rows] = q[rows] * 4.0
    v = rng.standard_normal((S, hd)).astype(np.float32)
    v -= v.mean(axis=0, keepdims=True)
    return bf16_values(q), bf16_values(k), bf16_values(v)


@pytest.mark.parametrize("hd,tile", [(64, 128), (128, 128), (256, 64)])
@pytest.mark.parametrize("peaked", [False, True])
def test_prefill_split_holds_the_bar(hd, tile, peaked):
    S = 1536
    q, k, v = inputs(hd + peaked, S, hd, peaked)
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    args = [jnp.asarray(a)[None, None] for a in (q, k, v)]
    want = np.asarray(ref.mqa_attention_ref(*args))[0, 0]
    scale = np.asarray(ref.mqa_attention_ref(args[0], args[1], jnp.abs(args[2])))[0, 0]
    got = emulate(tq, tk, tv, causal, tile, "split", exp2=True)
    assert worst(got, want, scale) <= 1.0
    if not peaked:           # the long rows cancel: bf16 p alone misses
        assert worst(emulate(tq, tk, tv, causal, tile, "bf16", exp2=True), want, scale) > 1.0


@pytest.mark.parametrize("hd,tile", [(128, 64), (256, 32)])
@pytest.mark.parametrize("peaked", [False, True])
def test_decode_split_holds_the_bar(hd, tile, peaked):
    S, B = 1536, 8
    rng = np.random.default_rng(hd + 7 * peaked)
    _, k, v = inputs(hd + peaked, S, hd, False)
    q = bf16_values(rng.standard_normal((B, hd)).astype(np.float32) * 0.5)
    if peaked:
        k[100] = bf16_values(q[0] * 4.0)           # row 0's key 100 takes its p
    lengths = np.array([S, S - 1, 1025, 1024, 777, 513, 64, 1], dtype=np.int32)
    valid = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kk, vv = (jnp.asarray(a)[None, :, None].repeat(B, axis=0) for a in (k, v))
    want = np.asarray(ref.decode_attention_ref(jnp.asarray(q)[:, None], kk, vv,
                                               jnp.asarray(lengths)))[:, 0]
    scale = np.asarray(ref.decode_attention_ref(jnp.asarray(q)[:, None], kk, jnp.abs(vv),
                                                jnp.asarray(lengths)))[:, 0]
    got = emulate(tq, tk, tv, valid, tile, "split", exp2=False)
    assert worst(got, want, scale) <= 1.0
    if not peaked:
        assert worst(emulate(tq, tk, tv, valid, tile, "bf16", exp2=False), want, scale) > 1.0
