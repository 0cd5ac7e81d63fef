"""The arithmetic of the event-queue head kernel, emulated on the CPU.

``csrc/event_pop.cu`` finds the queue head in one launch of a thread block
cluster: up to ``kMaxBlocks`` blocks of ``kThreads`` threads, thread
``tid`` of block ``rank`` taking slots ``rank * kThreads + tid + j *
blocks * kThreads`` (``kUnroll`` of them a pass, all loaded before any is
folded). Each thread folds its slots in index order into a running head
``(key, kind, seq, idx, time bits)`` and a NaN flag, where the key is an
orderable 32-bit image of the time: -0.0 made +0.0, then the sign flip that
orders IEEE bits as unsigned integers; a NaN time only sets the flag. A warp
folds its lanes by successive minima (redux.sync): the key, then the kind
among the lanes that hold that key, then the seq, then the index, and takes
the winner's time bits from the first lane that holds it; the warps of a
block fold the same way in warp 0, and block 0 folds the blocks' partials.
The kernel runs only on a card, so this file emulates that arithmetic in
plain PyTorch over the kernel's own partition of Q (its constants read from
the source) and holds the four words it writes bitwise against
``event_head_plain`` and the index and flag against the reference's
``ref.event_pop_ref``: ties on time, kind and seq, -0.0 beside +0.0, +inf
and -inf, NaN, nothing valid, and Q either side of a block and of a pass.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro_torch.kernels import cuda_build
from repro_torch.kernels import event_pop as t_pop


def kernel_constant(name: str) -> int:
    source = (cuda_build.CSRC / "event_pop.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


THREADS, MAX_BLOCKS, UNROLL = (kernel_constant(n) for n in ("kThreads", "kMaxBlocks", "kUnroll"))
EMPTY_KEY = 0xFFFFFFFF
INT_MAX = 2**31 - 1
FIELDS = ("key", "kind", "seq", "idx", "bits", "nan")
QS = [1, 70, 1_025, 8_191, 8_193, 9_965, 19_800]
TIMES = {
    "ties": [0.25, 1.0, 1.5, 7.75],
    "signed_zeros": [-0.0, 0.0, 0.5, -1.0],
    "infinities": [np.inf, -np.inf, 1.0, np.inf],
    "nan": [1.0, np.nan, 0.5, -0.0],
    "invalid": [1.0, 2.0],
}
j_pop_ref = jax.jit(j_ref.event_pop_ref)


def time_key(t: torch.Tensor) -> torch.Tensor:
    """The kernel's u32 key of each (non-NaN) f32 time, in int64."""
    u = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(t == 0, 0, u)
    return torch.where(u >= 2**31, ~u & 0xFFFFFFFF, u | 2**31)


def cluster_blocks(q: int) -> int:
    return min(MAX_BLOCKS, -(-q // THREADS))


def empty(shape):
    h = {f: torch.zeros(shape, dtype=torch.int64) for f in FIELDS}
    h["key"].fill_(EMPTY_KEY)
    for f in ("kind", "seq", "idx"):
        h[f].fill_(INT_MAX)
    h["nan"] = torch.zeros(shape, dtype=torch.bool)
    return h


def warp_fold(h):
    """The lexicographic min over the last axis (32 lanes), by successive
    minima as redux.sync takes them; the time bits from the first lane that
    holds the winner (ffs of a ballot)."""
    out = {"key": h["key"].min(-1).values}
    tie = h["key"] == out["key"][..., None]
    for f in ("kind", "seq", "idx"):
        out[f] = torch.where(tie, h[f], INT_MAX).min(-1).values
        tie = tie & (h[f] == out[f][..., None])
    lane = tie.to(torch.int32).argmax(-1, keepdim=True)
    out["bits"] = h["bits"].gather(-1, lane)[..., 0]
    out["nan"] = h["nan"].any(-1)
    return out


def to_lanes(h):
    """Partials (..., m) as lanes (..., 32), the lanes past m empty (m <= 32)."""
    m = h["key"].shape[-1]
    pad = empty(h["key"].shape[:-1] + (32 - m,))
    return {f: torch.cat([h[f], pad[f]], dim=-1) for f in FIELDS}


def emulate(time, kind, seq, valid) -> torch.Tensor:
    """The kernel's four words ``[idx, found, time bits, kind]``."""
    q = time.shape[0]
    blocks = cluster_blocks(q)
    threads = blocks * THREADS
    passes = -(-q // (threads * UNROLL))
    slot = torch.arange(passes * UNROLL * threads).view(passes * UNROLL, blocks, THREADS)
    inside = slot < q
    at = slot.clamp(max=q - 1)
    t, k, s = time[at], kind[at].long(), seq[at].long()
    v = inside & valid[at]
    nan = v & torch.isnan(t)
    key = time_key(torch.where(nan, 0.0, t))
    bits = t.view(torch.int32).long() & 0xFFFFFFFF
    h = empty((blocks, THREADS))
    for j in range(passes * UNROLL):            # each thread's slots, in index order
        take = v[j] & ~nan[j]
        before = (key[j] < h["key"]) | ((key[j] == h["key"]) & (
            (k[j] < h["kind"]) | ((k[j] == h["kind"]) & (s[j] < h["seq"]))))
        take = take & before
        for f, x in (("key", key[j]), ("kind", k[j]), ("seq", s[j]), ("idx", slot[j]),
                     ("bits", bits[j])):
            h[f] = torch.where(take, x, h[f])
        h["nan"] = h["nan"] | nan[j]
    warps = THREADS // 32
    h = warp_fold({f: x.view(blocks, warps, 32) for f, x in h.items()})   # every warp
    h = warp_fold(to_lanes(h))                                             # warp 0, each block
    h = warp_fold(to_lanes({f: x[None] for f, x in h.items()}))            # block 0
    h = {f: x[0] for f, x in h.items()}
    has_nan = bool(h["nan"])
    won = int(h["key"]) != EMPTY_KEY and not has_nan
    found = int(h["key"]) != EMPTY_KEY or has_nan
    word_t = 0x7FC00000 if has_nan else (int(h["bits"]) if won else 0x7F800000)
    words = [int(h["idx"]) if won else 0, int(found), word_t, int(h["kind"]) if won else int(kind[0])]
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32))


def queue(rng, q, case):
    t = rng.choice(np.asarray(TIMES[case], np.float32), q).astype(np.float32)
    k = rng.integers(0, 4, q).astype(np.int32)
    s = rng.integers(0, 6, q).astype(np.int32)
    share = 0.0 if case == "invalid" else rng.choice([0.3, 0.7, 1.0])
    v = rng.random(q) < share
    if case == "nan" and v.any() and rng.random() < 0.5:
        t[np.flatnonzero(v)[-1]] = np.nan            # a NaN in the last valid slot
    if case == "ties":
        t[:] = np.float32(1.0)                       # everything ties on time
    return t, k, s, v


def test_time_key_orders_as_f32():
    values = np.array([-np.inf, -3e38, -1.0, -1e-40, -1e-45, -0.0, 0.0, 1e-45, 1e-40, 1.0,
                       3e38, np.inf], np.float32)
    keys = time_key(torch.from_numpy(values)).tolist()
    for (a, ka), (b, kb) in zip(zip(values, keys), zip(values[1:], keys[1:])):
        assert (ka < kb) == (a < b) and (ka == kb) == (a == b), (a, b)
    assert max(keys) < EMPTY_KEY and min(keys) >= 0


def test_partition_takes_every_slot_once():
    for q in QS + [THREADS * MAX_BLOCKS * UNROLL + 1]:
        blocks = cluster_blocks(q)
        threads = blocks * THREADS
        slots = [rank * THREADS + tid + j * threads
                 for rank in range(blocks) for tid in range(THREADS)
                 for j in range(-(-q // threads))
                 if rank * THREADS + tid + j * threads < q]
        assert sorted(slots) == list(range(q)), q
        assert 1 <= blocks <= MAX_BLOCKS and (blocks == MAX_BLOCKS or blocks * THREADS >= q)


@pytest.mark.parametrize("case", sorted(TIMES))
@pytest.mark.parametrize("q", QS)
def test_emulated_head_equals_plain_and_reference(q, case):
    rng = np.random.default_rng(q * 7 + sorted(TIMES).index(case))
    for _ in range(3):
        t, k, s, v = queue(rng, q, case)
        args = [torch.from_numpy(x) for x in (t, k, s, v)]
        got = emulate(*args)
        want = t_pop.event_head_plain(*args)
        assert torch.equal(got, want), (got.tolist(), want.tolist())
        ri, rf = j_pop_ref(*(jnp.asarray(x) for x in (t, k, s, v)))
        assert (int(got[0]), bool(got[1])) == (int(ri), bool(rf))


def test_pop_head_on_the_cpu_reads_the_plain_words():
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(x) for x in queue(rng, 70, "signed_zeros")]
    idx, found, head_t, kind, head = t_pop.pop_head(*args)
    assert torch.equal(head, t_pop.event_head_plain(*args))
    assert (idx, found, kind) == (int(head[0]), bool(head[1]), int(head[3]))
    assert np.float32(head_t).view(np.int32) == int(head[2])
