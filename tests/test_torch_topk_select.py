"""The arithmetic of the codec's per-block top-k kernel, emulated on the CPU.

``csrc/delta_codec.cu`` runs one warp per codec block of B values, lane
``l`` holding values ``l, l + 32, ...`` (V = 1, 2, 4, ..., 32 a lane). A
value's key is the bits of ``|d|`` plus one, an unsigned integer in the
order of ``|d|`` (-0.0 is +0.0); a NaN, and a slot past the block, has key
0 and counts for no one, and a NaN is kept for k >= 1. With k >= the
block's non-NaN values everything is kept, with k = 0 nothing. Otherwise
the warp finds T, the k-th largest key, by one of two selections: up to
``kRoundsMax`` and 8 values a lane, rounds (each lane sorts its keys; a
round takes the warp's largest head and drops it from every lane that
holds it), else a bitwise search (31 steps from bit 30 down, keeping each
bit that leaves at least k keys at or above it). Every key above T is kept,
and of the keys equal to T the first ``k - #{key > T}`` in index order, by a
ballot per register slot; the rounds know when that is all of them.

The kernel runs only on a card, so this file emulates both selections in
plain PyTorch (their constants read from the source) and holds the masked
delta bitwise against ``topk_blocks_plain``, which is held to the
reference's ``ref.topk_blocks_ref`` on the rows without subnormals (XLA's
CPU backend flushes them to zero; the kernel and the plain version order
them as IEEE values): blocks of 1, 31, 32, 33, 128 and 1,024 values, k =
0, 1, 8, 16, ``kRoundsMax`` and one more, B - 1 and B, with ties, NaNs, zeros of both signs,
subnormals, +inf, blocks all equal and blocks all NaN.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro_torch.kernels import cuda_build
from repro_torch.kernels import delta_codec as t_dc

ROUNDS_MAX = int(re.search(r"constexpr int kRoundsMax = (\d+);",
                           (cuda_build.CSRC / "delta_codec.cu").read_text()).group(1))
BLOCKS = [1, 31, 32, 33, 128, 1024]
j_topk_ref = jax.jit(j_ref.topk_blocks_ref)     # k traced: one compile a block size
SPECIALS = np.array([0.0, -0.0, np.inf, np.nan, 1e-45, -1e-40, 1.0, -1.0, 0.5], np.float32)


def values_per_lane(block: int) -> int:
    return next(v for v in (1, 2, 4, 8, 16, 32) if 32 * v >= block)


def kernel_route(block: int, k: int) -> str:
    return "rounds" if values_per_lane(block) <= 8 and k <= ROUNDS_MAX else "search"


def lanes(d: torch.Tensor):
    """(nb, B) -> the kernel's registers (nb, V, 32) of values, keys and NaN
    flags: slot (v, l) holds value l + 32 v."""
    nb, block = d.shape
    v = values_per_lane(block)
    x = torch.zeros((nb, 32 * v), dtype=torch.float32)
    x[:, :block] = d
    x = x.view(nb, v, 32)
    inside = (torch.arange(32 * v) < block).view(1, v, 32)
    a = x.view(torch.int32).long() & 0x7FFFFFFF
    nan = inside & (a > 0x7F800000)
    key = torch.where(inside & ~nan, a + 1, 0)
    return x, key, nan


def select_rounds(key, k):
    """(T, ties kept, all ties) a block by the rounds: sorted heads, the
    warp's largest head dropped from every lane holding it each round."""
    nb = key.shape[0]
    s = key.sort(dim=1, descending=True).values          # each lane's keys, largest first
    taken = torch.zeros(nb, dtype=torch.long)
    above = torch.zeros(nb, dtype=torch.long)
    last = torch.full((nb,), 2**32 - 1, dtype=torch.long)
    t = torch.zeros(nb, dtype=torch.long)
    ties = torch.zeros(nb, dtype=torch.long)
    all_ties = torch.zeros(nb, dtype=torch.bool)
    done = (key != 0).sum((1, 2)) <= k                    # those the kernel keeps whole
    while not bool(done.all()):
        m = s[:, 0, :].max(dim=1).values
        above = torch.where(~done & (m != last), taken, above)
        last = torch.where(done, last, m)
        hit = (s[:, 0, :] == m[:, None]) & ~done[:, None]
        taken = taken + hit.sum(dim=1)
        shifted = torch.cat([s[:, 1:, :], torch.zeros_like(s[:, :1, :])], dim=1)
        s = torch.where(hit[:, None, :], shifted, s)
        now = ~done & (taken >= k)
        t = torch.where(now, m, t)
        ties = torch.where(now, k - above, ties)
        left = (s[:, 0, :] == m[:, None]).any(dim=1)
        all_ties = torch.where(now, (taken == k) & ~left, all_ties)
        done = done | now
    return t, ties, all_ties


def select_search(key, k):
    """(T, ties kept, all ties) a block by the bitwise search."""
    t = torch.zeros(key.shape[0], dtype=torch.long)
    for bit in range(30, -1, -1):
        cand = t | (1 << bit)
        count = (key >= cand[:, None, None]).sum((1, 2))
        t = torch.where(count >= k, cand, t)
    ties = k - (key > t[:, None, None]).sum((1, 2))
    return t, ties, torch.zeros_like(t, dtype=torch.bool)


def emulate(d: torch.Tensor, k: int, route: str) -> torch.Tensor:
    """The kernel's masked delta of (nb, B) f32 by the given selection."""
    nb, block = d.shape
    x, key, nan = lanes(d)
    keep = torch.zeros_like(nan)
    if k > 0:
        t, ties, all_ties = (select_rounds if route == "rounds" else select_search)(key, k)
        eq = key == t[:, None, None]
        # a ballot per register slot: the equal keys in earlier slots, then
        # in earlier lanes of this one
        per_slot = eq.sum(dim=2)
        before = per_slot.cumsum(dim=1) - per_slot
        prefix = before[:, :, None] + eq.long().cumsum(dim=2) - eq.long()
        tie_kept = eq & (prefix < ties[:, None, None])
        keep = torch.where(all_ties[:, None, None], key >= t[:, None, None],
                           (key > t[:, None, None]) | tie_kept)
        whole = (key != 0).sum((1, 2)) <= k
        keep = torch.where(whole[:, None, None], key != 0, keep) | nan
    out = torch.where(keep, x, torch.zeros_like(x))
    return out.view(nb, -1)[:, :block]


def blocks_of(block: int) -> torch.Tensor:
    """Rows of one block size: random normals, normals rounded to a few
    distinct magnitudes (ties), sparse rows, the special values (NaN, both
    zeros, subnormals, +inf) mixed with ties, a row all equal, a row all NaN."""
    rng = np.random.default_rng(block)
    reps = 2 if block >= 1024 else 6
    rows = []
    for _ in range(reps):
        rows.append(rng.standard_normal(block))
        rows.append(np.round(rng.standard_normal(block) * 2) / 2)
        sparse = rng.standard_normal(block)
        sparse[rng.random(block) < 0.9] = 0.0
        rows.append(sparse)
        rows.append(rng.choice(SPECIALS, block))
    rows.append(np.full(block, -0.75))
    rows.append(np.full(block, np.nan))
    return torch.from_numpy(np.stack(rows).astype(np.float32))


@functools.lru_cache(maxsize=None)
def want(block: int, k: int) -> torch.Tensor:
    """``topk_blocks_plain`` of the rows, checked against the reference on
    the rows without subnormals: XLA's CPU backend flushes subnormals to
    zero, so the reference ranks a subnormal as it ranks a zero."""
    d = blocks_of(block)
    plain = t_dc.topk_blocks_plain(d, k)
    ref = torch.from_numpy(np.array(j_topk_ref(jnp.asarray(d.numpy()), k)))
    normal = ~((d != 0) & (d.abs() < torch.finfo(torch.float32).tiny)).any(dim=1)
    assert int(normal.sum()) >= 4
    assert torch.equal(plain[normal].view(torch.int32), ref[normal].view(torch.int32))
    return plain


CASES = sorted({(b, k) for b in BLOCKS
                for k in (0, 1, 8, 16, ROUNDS_MAX, ROUNDS_MAX + 1, b - 1, b) if 0 <= k <= b})


@pytest.mark.parametrize("route", ["rounds", "search"])
@pytest.mark.parametrize("block,k", CASES)
def test_emulated_selection_equals_plain_and_reference(block, k, route):
    got = emulate(blocks_of(block), k, route)
    assert torch.equal(got.view(torch.int32), want(block, k).view(torch.int32))


def test_the_kernel_takes_rounds_at_the_main_shape():
    """The codec's blocks (128 values, k = 8 of the default topk_frac) take
    the rounds; large k and blocks of more than 256 values the search."""
    codec = t_dc.DeltaCodec("topk")
    assert kernel_route(codec.block, round(codec.topk_frac * codec.block)) == "rounds"
    assert kernel_route(128, ROUNDS_MAX + 1) == "search"
    assert kernel_route(1024, 1) == "search"
