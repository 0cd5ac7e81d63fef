"""The arithmetic of the WKV kernel's chunked route, emulated on the CPU.

``csrc/wkv.cu`` runs the chunked WKV in two kernels. The one that walks the
chunks forms ``y += r_dec S`` and ``S' = e^total S + k_dec^T v`` by TF32
products on the tensor cores, every f32 operand split into ``hi =
tf32(x)`` and ``lo = tf32(x - hi)`` and each product taken as ``hi hi +
hi lo + lo hi`` in f32; the state joins each chunk's update by one f32 fma.
The one that adds each chunk's own part factorises the scores at the
start of each sub-chunk of 8 steps: for ``t`` in sub-chunk ``n > 0``, ``s``
in an earlier one and ``g = cum_prev[8 n]``, ``exp(cum_prev[t] - cum[s]) =
exp(cum_prev[t] - g) exp(g - cum[s])``, so the blocks below the diagonal
are ``r~ k~^T``, split TF32 products too; the pairs inside each sub-chunk
and the bonus keep the direct form, and ``A v`` is f32. The kernels run only on a
card, so this file emulates that arithmetic in plain PyTorch (TF32 rounding
to nearest, ties away, as ``cvt.rna.tf32.f32``; each product's sum in f64,
then f32, as an f32 accumulator that rounds once) and holds it to the bar
the card tests hold the kernel to: within ``WKV_TOL`` of each output's sum
of absolute terms against ``wkv_chunked_plain`` (the errors taken in f64),
for the model's, strong and wide decays, hd 64 and 128, from a nonzero
state. One TF32 product in place of the split misses that bar, which is why
the split stays.

The factorised exponents are <= 0 in exact arithmetic (the cumulative sum
does not increase), so no factor can overflow whatever the decays; in the
kernel's f32 they are the plain version's own differences of f32 cumulative
sums, which may sit one rounding of the sum above 0 (the plain version's
exponents do the same, and matching them to the bit at the boundary pairs
(8 n, 8 n - 1) is what keeps 1e-5 under strong decays).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import wkv as t_wkv

WKV_TOL = 1e-5        # of each output's sum of absolute terms, as the card tests
C, SUB = 32, 8


def draw(seed, B, T, H, hd, decay):
    """r, k, v standard normal, u uniform in [0, 1), a standard normal state,
    and log decays ``-exp(N)`` in the spreads of ``tests/test_torch_wkv.py``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) for _ in range(3))
    n = rng.standard_normal((B, T, H, hd))
    dd = {"model": -1.0 + 0.3 * n, "strong": np.minimum(2.0 + n, 10.0), "wide": 2.0 * n}[decay]
    logw = (-np.exp(dd)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return [torch.from_numpy(a) for a in (r, k, v, logw, u, s0)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits, to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(eq, a, b, split):
    """``einsum(eq, a, b)`` as the kernel's tensor cores take it: split,
    ``hi hi`` in one f32 accumulator and ``hi lo + lo hi`` in another, then
    their f32 sum; else one TF32 product."""
    def f64(x):
        return x.double()

    ah, bh = tf32(a), tf32(b)
    if not split:
        return torch.einsum(eq, f64(ah), f64(bh)).float()
    al, bl = tf32(a - ah), tf32(b - bh)
    big = torch.einsum(eq, f64(ah), f64(bh)).float()
    small = (torch.einsum(eq, f64(ah), f64(bl)) + torch.einsum(eq, f64(al), f64(bh))).float()
    return big + small


def emulate(r, k, v, logw, u, state, split=True, exponents=None):
    """The chunked route as ``csrc/wkv.cu`` computes it, on f32 inputs (B, T,
    H, hd). Returns (y, final state); appends every exponent of the
    factorised scores to ``exponents`` with the largest |cum| of its chunk
    and channel."""
    B, T, H, hd = r.shape
    S = state.clone()                                            # (B, H, kk, j)
    y = torch.empty((B, T, H, hd), dtype=torch.float32)
    sub = torch.arange(SUB)
    lower = (sub[:, None] > sub[None, :])[None, :, :, None, None]
    for c in range(T // C):
        sl = slice(c * C, (c + 1) * C)
        rb, kb, vb, lw = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]       # (B, C, H, hd)
        cum = t_wkv.cumsum_f32(lw)
        cp = cum - lw
        total = cum[:, -1]
        # the state kernel: y's inter-chunk part, then the state
        rdec = rb * torch.exp(cp)
        kdec = kb * torch.exp(total[:, None] - cum)
        y_inter = product("bthk,bhkj->bthj", rdec, S, split)
        upd = product("bshk,bshj->bhkj", kdec, vb, split)
        S = (torch.exp(total)[..., None].double() * S.double() + upd.double()).float()
        # the intra-chunk kernel: the scores by sub-chunks
        A = torch.zeros((B, C, C, H), dtype=torch.float32)             # [b, t, s, h]
        big = cum.abs().amax(dim=1, keepdim=True)
        for n in range(1, C // SUB):
            rows, before = slice(n * SUB, (n + 1) * SUB), slice(0, n * SUB)
            g = cp[:, n * SUB]                                         # (B, H, hd)
            e_r, e_k = cp[:, rows] - g[:, None], g[:, None] - cum[:, before]
            if exponents is not None:
                exponents += [(e_r, big), (e_k, big)]
            rx = rb[:, rows] * torch.exp(e_r)
            kx = kb[:, before] * torch.exp(e_k)
            A[:, rows, before] = product("bthd,bshd->btsh", rx, kx, split)
        for lo in range(0, C, SUB):
            part = slice(lo, lo + SUB)
            expo = cp[:, part, None] - cum[:, None, part]              # (B, 8, 8, H, hd)
            W = torch.where(lower, torch.exp(expo), 0.0)
            A[:, part, part] = torch.einsum("bthd,bshd,btshd->btsh", rb[:, part], kb[:, part], W)
        diag = torch.einsum("bthd,bthd,hd->bth", rb, kb, u)
        A[:, torch.arange(C), torch.arange(C)] = diag
        causal = torch.tril(torch.ones((C, C), dtype=torch.bool))[None, :, :, None]
        y_intra = torch.einsum("btsh,bshd->bthd", torch.where(causal, A, 0.0), vb)
        y[:, sl] = y_inter + y_intra
    return y, S


def over_bar(got, args):
    """Largest error of ``got`` against ``wkv_chunked_plain`` over WKV_TOL
    times each output's sum of absolute terms (<= 1 holds the bar)."""
    r, k, v, logw, u, s0 = args
    want = t_wkv.wkv_chunked_plain(*args)
    scale = t_wkv.wkv_chunked_plain(r.abs(), k.abs(), v.abs(), logw, u.abs(), s0.abs())
    return max(float(((g.double() - w.double()).abs() / (WKV_TOL * sc.double())).max())
               for g, w, sc in zip(got, want, scale))


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("decay", ["model", "strong", "wide"])
def test_split_products_and_factorised_scores_hold_the_bar(hd, decay):
    args = draw({"model": 0, "strong": 1, "wide": 2}[decay] + hd, 2, 96, 2, hd, decay)
    assert over_bar(emulate(*args), args) <= 1.0


@pytest.mark.parametrize("hd", [64, 128])
def test_one_tf32_product_misses_the_bar(hd):
    args = draw(3 + hd, 2, 96, 2, hd, "model")
    assert over_bar(emulate(*args, split=False), args) > 1.0


@pytest.mark.parametrize("decay", ["model", "strong", "wide"])
def test_no_factorised_exponent_is_positive(decay):
    """In exact arithmetic (the same f32 log decays summed in f64, cum_prev
    the previous step's cum) both factors' exponents are <= 0; in the
    kernel's f32 they exceed 0 by at most one rounding of the chunk's largest
    |cum|, so every factor stays finite, at most 1 + 2^-22 |cum|, even at the
    model's clamp of -e^10 a step."""
    r, k, v, logw, u, s0 = draw(4, 2, 128, 2, 64, decay)
    if decay == "strong":
        logw[:, ::7] = -float(np.exp(np.float32(10.0)))        # the clamp, every 7th step
    found = []
    y, s = emulate(r, k, v, logw, u, s0, exponents=found)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    for e, big in found:
        assert bool((e <= 2.0 ** -23 * big).all())
        assert bool(torch.isfinite(torch.exp(e)).all())
    lw = logw.double().reshape(2, 4, C, 2, 64)
    cum = torch.cumsum(lw, dim=2)
    cp = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
    for n in range(1, C // SUB):
        g = cp[:, :, n * SUB:n * SUB + 1]
        assert bool((cp[:, :, n * SUB:(n + 1) * SUB] - g <= 0).all())
        assert bool((g - cum[:, :, :n * SUB] <= 0).all())
