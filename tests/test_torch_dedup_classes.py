"""The chunk-dedup kernel's algorithm, emulated on the CPU.

``csrc/chunk_dedup.cu`` finds each slot's digest class through a hash
table in shared memory: a block takes one column and a group of receivers
(one bit each of a uint32, the group sized by the host so the grid is
about one wave of the card's SMs); every slot's key is its digest's bits
with -0.0 made +0.0, and a NaN digest has no key. Pass 1 inserts each
slot: it claims its key's entry (linear probing from murmur3's finaliser)
and ORs its presence bits in. Pass 2: each slot ORs in the bits of its
key's entry and its own presence. A table holds ``kTile`` slots at half
load; a longer store goes in tiles, every output tile against every
candidate tile. The kernel runs only on a card, so this file emulates that
algorithm in plain PyTorch (its constants read from the source), once
with the kernel's table and once with a table forced small enough that
probe chains collide and the store runs past it, inserting the slots in a
shuffled order (the atomics' order is free), and holds it bitwise against
``chunk_dedup_plain``, the reference's ``ref.chunk_dedup_ref`` and its
Pallas kernel run in interpret mode: an all-NaN column, a column of only
-0.0 and +0.0, one class, NaN beside duplicates, the gate (R = 1), and
receivers in several groups.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_transfer as j_ck
from repro.kernels import ref as j_ref
from repro_torch.kernels import chunk_transfer as t_ck
from repro_torch.kernels import cuda_build

SOURCE = (cuda_build.CSRC / "chunk_dedup.cu").read_text()


def kernel_constant(name: str) -> str:
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", SOURCE).group(1)


THREADS, SLOTS, MAX_GROUP = (int(kernel_constant(n)) for n in ("kThreads", "kSlots", "kMaxGroup"))
TILE = THREADS * SLOTS
EMPTY = 0xFFFFFFFF
H100_SMS = 132
j_dedup_ref = jax.jit(j_ref.chunk_dedup_ref)


def launch_shape(r: int, c: int, s: int, sms: int, tile: int = TILE):
    """The host's grid: receivers a block, groups, the table's log2 size."""
    per_column = 1 if c >= sms else sms // c
    group = -(-r // per_column)
    group = min(MAX_GROUP, max(group, -(-r // 65535)))
    bits = 5
    while (1 << bits) < 2 * min(s, tile):
        bits += 1
    return group, -(-r // group), bits


def table_keys(digest: torch.Tensor) -> list:
    """The kernel's u32 key of each digest: its bits, -0.0 made +0.0;
    EMPTY (a NaN pattern) for NaN."""
    b = digest.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(digest == 0, 0, b)
    return torch.where(torch.isnan(digest), EMPTY, b).tolist()


def slot_hash(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


class Table:
    def __init__(self, bits: int):
        self.wrap = (1 << bits) - 1
        self.key = [EMPTY] * (1 << bits)
        self.held = [0] * (1 << bits)
        self.probes = 0

    def insert(self, k: int, bits: int):
        h = slot_hash(k) & self.wrap
        while self.key[h] not in (EMPTY, k):     # atomicCAS found another key
            h = (h + 1) & self.wrap
            self.probes += 1
        self.key[h] = k
        self.held[h] |= bits

    def lookup(self, k: int) -> int:
        h = slot_hash(k) & self.wrap
        while True:
            if self.key[h] == k:
                return self.held[h]
            if self.key[h] == EMPTY:
                return 0
            h = (h + 1) & self.wrap


def emulate(have, digest, sms=H100_SMS, tile=TILE, seed=0, stats=None):
    """(R, S, C) bool as the kernel computes it; ``tile`` forces a smaller
    table and tiles, ``seed`` shuffles the order the slots insert."""
    r, s, c = have.shape
    group, _, bits = launch_shape(r, c, s, sms, tile)
    order = np.random.default_rng(seed)
    sat = torch.zeros_like(have, dtype=torch.bool)
    for col in range(c):
        keys = table_keys(digest[:, col])
        for i0 in range(0, r, group):
            ng = min(group, r - i0)
            weights = 2 ** torch.arange(ng, dtype=torch.int64)
            held = (have[i0:i0 + ng, :, col].long() * weights[:, None]).sum(0).tolist()
            for o0 in range(0, s, tile):
                acc = [0] * min(tile, s - o0)
                for p0 in range(0, s, tile):
                    table = Table(bits)
                    for p in p0 + order.permutation(min(tile, s - p0)):
                        if keys[p] != EMPTY:
                            table.insert(keys[p], held[p])
                    for q in range(len(acc)):
                        if keys[o0 + q] != EMPTY:
                            acc[q] |= table.lookup(keys[o0 + q])
                    if stats is not None:
                        stats["probes"] += table.probes
                        stats["tables"] += 1
                out = torch.tensor([held[o0 + q] | a for q, a in enumerate(acc)], dtype=torch.int64)
                sat[i0:i0 + ng, o0:o0 + len(acc), col] = ((out[None, :] >> torch.arange(ng)[:, None])
                                                          & 1).bool()
    return sat


def digests(rng, s, c, classes, columns=()):
    """(S, C) f32 digests in ``classes`` duplicate classes, NaN and +-0.0
    among them; ``columns`` overrides whole columns: "nan", "zeros" (only
    -0.0 and +0.0), "one" (one class)."""
    d = rng.integers(0, classes, (s, c)).astype(np.float32) * 1.5
    d[rng.random((s, c)) < 0.08] = np.nan
    zero = rng.random((s, c)) < 0.08
    d[zero] = np.where(rng.random((s, c)) < 0.5, -0.0, 0.0)[zero]
    for col, kind in enumerate(columns):
        if kind == "nan":
            d[:, col] = np.nan
        elif kind == "zeros":
            d[:, col] = np.where(rng.random(s) < 0.5, -0.0, 0.0)
        elif kind == "one":
            d[:, col] = 7.25
    return d


# (r, s, c, classes, columns, sms, tile)
CASES = [
    (20, 70, 3, 6, (), H100_SMS, TILE),                       # one tile, a receiver a group
    (20, 70, 3, 6, (), 4, TILE),                              # 20 receivers in one group
    (9, 64, 4, 5, ("nan", "zeros", "one"), 8, TILE),          # the edge columns
    (1, 90, 4, 9, ("zeros",), H100_SMS, TILE),                # the gate
    (70, 33, 2, 4, (), 2, TILE),                              # groups of 32, 32 and 6
    (6, 70, 2, 40, ("one",), 8, 16),                          # S past a 32-entry table
    (5, 45, 3, 30, ("nan", "zeros"), 4, 8),                   # a 16-entry table, 6 tiles
]


@pytest.mark.parametrize("r,s,c,classes,columns,sms,tile", CASES)
def test_emulated_classes_equal_plain_and_reference(r, s, c, classes, columns, sms, tile):
    rng = np.random.default_rng(r * 100 + s + c)
    dig = digests(rng, s, c, classes, columns)
    have = rng.random((r, s, c)) < 0.3
    th, td = torch.from_numpy(have), torch.from_numpy(dig)
    want = t_ck.chunk_dedup_plain(th, td)
    stats = {"probes": 0, "tables": 0}
    for seed in (0, 1):                       # the slots insert in another order
        assert torch.equal(emulate(th, td, sms, tile, seed, stats), want)
    ref = j_dedup_ref(jnp.asarray(have), jnp.asarray(dig))
    pallas = j_ck.chunk_dedup_pallas(jnp.asarray(have), jnp.asarray(dig), interpret=True)
    np.testing.assert_array_equal(want.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(want.numpy(), np.asarray(pallas))
    if tile < s:                              # the forced-small table collided
        assert stats["probes"] > 0 and stats["tables"] > 2 * c
    if "nan" in columns:                      # a NaN digest: presence only
        col = columns.index("nan")
        assert torch.equal(want[:, :, col], th[:, :, col])


def test_the_launch_fills_one_wave_at_the_main_shapes():
    assert (THREADS, SLOTS, MAX_GROUP) == (512, 4, 32)
    assert kernel_constant("kTile").strip() == "kThreads * kSlots"
    assert launch_shape(100, 4, 512, H100_SMS) == (4, 25, 10)   # a tick: 100 blocks
    assert launch_shape(1, 4, 512, H100_SMS) == (1, 1, 10)      # the gate
    assert launch_shape(400, 4, 512, H100_SMS) == (13, 31, 10)  # the scale case
    assert launch_shape(5, 2, 2049, H100_SMS)[2] == 12          # a full table: 2 tiles


def test_keys_match_float_equality():
    d = torch.tensor([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45],
                     dtype=torch.float32)
    k = table_keys(d)
    assert k[0] == k[1] == 0 and k[6] == EMPTY
    for a in range(len(d)):
        for b in range(len(d)):
            if a != 6 and b != 6:
                assert (k[a] == k[b]) == bool(d[a] == d[b])
