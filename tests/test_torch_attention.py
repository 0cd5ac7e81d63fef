"""The port's attention kernels' plain versions against the reference.

``kernels/flash_attention.py``: ``flash_attention_plain`` against
``ref.mqa_attention_ref`` and the reference's Pallas ``flash_attention``
(interpret mode, as the reference's own tests run it, with blocks of 64 and
128), ``decode_attention_plain`` against ``ref.decode_attention_ref`` and the
Pallas ``decode_attention``, at the shapes of ``tests/test_kernels.py``; the
dispatchers on CPU tensors; the layout rule of the CUDA wrapper.

Tolerances: f32 within 1e-5 (the same function summed in another order; the
Pallas kernels' online softmax and multiplied scale differ from the ref's in
the last bits). bf16 against the ref: both round scores, probabilities and
the output to bf16, in sums of another order, so within two bf16 units of
the output's scale (``2 ** -7`` of the largest |value|). A row of length 0
gives the mean of v (the ref's uniform softmax), not the Pallas kernel's 0.
The kernels themselves run only on a card: ``tests/test_torch_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import cuda_build
from repro_torch.kernels import flash_attention as t_fa

F32_TOL = 1e-5
PREFILL_SHAPES = [(128, 64, 4, 4), (256, 64, 8, 2), (192, 128, 4, 1)]   # (S, hd, H, KV)
DECODE_SHAPES = [(256, 4, 4, 64), (512, 8, 2, 64), (384, 4, 1, 128)]    # (S, H, KV, hd)


def prefill_inputs(seed, S, hd, H, KV, B=2):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, S, hd)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, hd)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    return q, k, v


def decode_inputs(seed, S, H, KV, hd, B=3):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, hd)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return q, k, v


def torch_args(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("S,hd,H,KV", PREFILL_SHAPES)
def test_flash_plain_matches_ref(S, hd, H, KV, window):
    q, k, v = prefill_inputs(S + H + window, S, hd, H, KV)
    got = t_fa.flash_attention_plain(*torch_args(q, k, v), window=window)
    want = ref.mqa_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("window", [0, 96])
def test_flash_plain_matches_ref_bf16(window):
    q, k, v = prefill_inputs(11 + window, 256, 64, 8, 2)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(ref.mqa_attention_ref(*bf, window=window).astype(jnp.float32))
    got = t_fa.flash_attention_plain(
        *[torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in bf],
        window=window)
    assert got.dtype == torch.bfloat16
    scale = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= 2 * scale


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("S,hd,H,KV", PREFILL_SHAPES)
def test_flash_plain_matches_pallas(S, hd, H, KV, window, block):
    q, k, v = prefill_inputs(S + H + window + block, S, hd, H, KV)
    got = t_fa.flash_attention_plain(*torch_args(q, k, v), window=window)
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                               block_q=block, block_k=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("S,H,KV,hd", DECODE_SHAPES)
def test_decode_plain_matches_ref(S, H, KV, hd):
    q, k, v = decode_inputs(S + H, S, H, KV, hd)
    lens = np.asarray([S // 3, S, 1], np.int32)
    got = t_fa.decode_attention_plain(*torch_args(q, k, v, lens))
    want = ref.decode_attention_ref(*[jnp.asarray(a) for a in (q, k, v, lens)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("S,H,KV,hd", DECODE_SHAPES)
def test_decode_plain_matches_pallas(S, H, KV, hd, block):
    q, k, v = decode_inputs(S + H + block, S, H, KV, hd)
    lens = np.asarray([S // 3, S, 1], np.int32)
    got = t_fa.decode_attention_plain(*torch_args(q, k, v, lens))
    want = ops.decode_attention(*[jnp.asarray(a) for a in (q, k, v, lens)], block_s=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_decode_length_zero_is_the_mean_of_v():
    """The ref's softmax of a row that is all -1e30 is uniform over all S
    slots; the port follows the ref (the Pallas kernel gives 0 there)."""
    q, k, v = decode_inputs(5, 96, 4, 2, 64, B=2)
    lens = np.asarray([0, 40], np.int32)
    got = t_fa.decode_attention_plain(*torch_args(q, k, v, lens)).numpy()
    want = np.asarray(ref.decode_attention_ref(*[jnp.asarray(a) for a in (q, k, v, lens)]))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    mean_v = np.repeat(v[0].mean(axis=0), 2, axis=0)             # (H, hd), GQA heads
    np.testing.assert_allclose(got[0], mean_v, rtol=F32_TOL, atol=F32_TOL)
    pallas = np.asarray(ops.decode_attention(*[jnp.asarray(a) for a in (q, k, v, lens)],
                                             block_s=32))
    assert np.all(pallas[0] == 0.0)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("block_q", [16, 64, 100])
def test_blocked_plain_equals_unblocked(block_q, window):
    q, k, v = prefill_inputs(block_q + window, 200, 64, 6, 3)
    args = torch_args(q, k, v)
    blocked = t_fa.flash_attention_plain(*args, window=window, block_q=block_q)
    whole = t_fa.flash_attention_plain(*args, window=window, block_q=200)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_dispatchers_take_the_plain_versions_off_the_card():
    q, k, v = torch_args(*prefill_inputs(3, 70, 64, 4, 2))
    before = (cuda_build.LAUNCHES["flash_attention"], cuda_build.LAUNCHES["decode_attention"])
    assert torch.equal(t_fa.flash_attention(q, k, v, 16), t_fa.flash_attention_plain(q, k, v, 16))
    qd, kd, vd = torch_args(*decode_inputs(4, 70, 4, 2, 64))
    lens = torch.tensor([0, 35, 70], dtype=torch.int32)
    assert torch.equal(t_fa.decode_attention(qd, kd, vd, lens),
                       t_fa.decode_attention_plain(qd, kd, vd, lens))
    assert (cuda_build.LAUNCHES["flash_attention"],
            cuda_build.LAUNCHES["decode_attention"]) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_fa.decode_attention(qd.to("meta"), kd.to("meta"), vd.to("meta"), lens.to("meta"))


def test_kernel_reads_permuted_views_in_place():
    """The model's (B, S, H, hd) tensors, permuted to (B, H, S, hd), keep
    their storage; a view whose rows are not 16-byte vectors is copied."""
    x = torch.zeros((2, 40, 6, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert cuda_build.aligned_rows(x) is x
    odd = torch.zeros((2, 40, 6, 66))[..., 1:65].transpose(1, 2)
    copy = cuda_build.aligned_rows(odd)
    assert copy is not odd and copy.is_contiguous() and torch.equal(copy, odd)


@pytest.mark.parametrize("window", [0, 64])
def test_model_chunked_sdpa_matches_reference(window):
    """``models.attention.chunked_sdpa`` (the (B, S, H, hd) layout) against
    the reference model's own, query blocks of 64."""
    from repro.models import attention as j_attn
    from repro_torch.models import attention as t_attn

    rng = np.random.default_rng(7 + window)
    q = (rng.standard_normal((2, 256, 8, 64)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((2, 256, 2, 64)) * 0.3).astype(np.float32)
    v = rng.standard_normal((2, 256, 2, 64)).astype(np.float32)
    got = t_attn.chunked_sdpa(*torch_args(q, k, v), window=window, block_q=64)
    want = j_attn.chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                               block_q=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    blk = t_attn.sdpa(*torch_args(q[:, 64:128], k, v), 64, window)
    want_blk = j_attn.sdpa(jnp.asarray(q[:, 64:128]), jnp.asarray(k), jnp.asarray(v), 64, 256,
                           window)
    np.testing.assert_allclose(blk.numpy(), np.asarray(want_blk), rtol=F32_TOL, atol=F32_TOL)
