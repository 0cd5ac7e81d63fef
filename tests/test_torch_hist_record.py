"""The histogram update's fused route, on the CPU: the port's ``record``
dispatcher (its plain route, ``record_plain``: ``bin_index``, the plain
bincount, the add) against the reference's ``record``, and a numpy model of
``csrc/hist_bincount.cu`` (the per-sample binning, written out as the same
sequence of f32 and f64 roundings, and the launch's partition of the
samples into a cluster's blocks or a grid, each with its own histogram,
folded onto ``counts``) against ``bin_index``, ``record_plain`` and the
reference. The kernel's constants are read from the source.

Every comparison is bitwise: bins and i32 counts. XLA's CPU backend flushes
subnormals to zero; every subnormal lies below ``lo`` and goes to bin 0
either way.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import hist as j_hist
from repro_torch.kernels import cuda_build
from repro_torch.obs import hist as t_hist
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

SOURCE = (cuda_build.CSRC / "hist_bincount.cu").read_text()
F32, F64 = np.float32, np.float64
CONFIGS = [dict(), dict(bins=16, lo=1e-3, hi=1e3), dict(bins=7, lo=0.5, hi=3.0)]


def constant(name: str) -> int:
    """An integer constant of the kernel's source (``kName = 123`` or
    ``kName = 0x3F3504F3u``)."""
    m = re.search(rf"\b{name}\s*=\s*(0x[0-9A-Fa-f]+|\d+)u?\b", SOURCE)
    assert m, name
    return int(m.group(1), 0)


def f32_of(bits: int):
    return np.uint32(bits).view(F32)


THREADS, CLUSTER_BLOCKS, UNROLL = (constant(n) for n in ("kThreads", "kMaxClusterBlocks",
                                                         "kUnroll"))
PORTABLE_BLOCKS = constant("kPortableClusterBlocks")
ATOMIC_THREADS, ATOMIC_BLOCKS = constant("kAtomicThreads"), constant("kMaxAtomicBlocks")
CLUSTER_MAX_M = CLUSTER_BLOCKS * THREADS * UNROLL
P = [f32_of(constant(f"kP{i}Bits")) for i in range(9)]
SQRT_HALF, Q1, Q2 = (f32_of(constant(n)) for n in ("kSqrtHalfBits", "kQ1Bits", "kQ2Bits"))


# ---------------------------------------------------------------------------
# the model: hist_bincount.cu's arithmetic, one numpy rounding per step
# ---------------------------------------------------------------------------


def fma64(a, b, c):
    """``fma64``: the f64 product of two f32 values (exact), the f64 sum,
    one rounding to f32."""
    return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def model_xla_log(x):
    """``xla_log_f32`` of the source for f32 x >= 1, finite."""
    bits = np.asarray(x, F32).view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(F32) + F32(1.0)
    m = ((bits & ~np.uint32(0x7F800000)) | np.uint32(0x3F000000)).view(F32)
    small = m < SQRT_HALF
    x1 = (m - F32(1.0)) + np.where(small, m, F32(0.0))
    e = e - np.where(small, F32(1.0), F32(0.0))
    x2 = x1 * x1
    x3 = x2 * x1
    y1 = fma64(fma64(x1, P[0], P[1]), x1, P[2])
    y2 = fma64(fma64(x1, P[3], P[4]), x1, P[5])
    y3 = fma64(fma64(x1, P[6], P[7]), x1, P[8])
    y = fma64(fma64(y1, x3, y2), x3, y3)
    s = fma64(y, x3, e * Q1)
    r = x1 - x2 * F32(0.5)
    return fma64(e, Q2, r + s)


def model_bin(v, lo: float, ratio: float, bins: int) -> np.ndarray:
    """``bin_of`` of the source: NaN and v <= lo to 0, a quotient of +inf to
    ``bins``, else the ceiling of log(v / lo) / ratio, less one, clamped."""
    v = np.asarray(v, F32)
    with np.errstate(over="ignore", invalid="ignore"):
        live = v > F32(lo)
        q = np.where(live, v / F32(lo), F32(1.0))
        inf = live & np.isposinf(q)
        go = live & ~inf
        x = model_xla_log(np.where(go, q, F32(1.0))) / F32(ratio)
    x = np.minimum(x, F32(bins + 1))
    c = np.clip(np.ceil(x).astype(np.int32) - 1, 0, bins)
    return np.where(go, c, np.where(inf, bins, 0)).astype(np.int32)


def launch_blocks(m: int, most: int):
    """(route, blocks, threads a block) of one launch over m samples, on a
    card that places clusters of at most ``most`` blocks."""
    if m <= CLUSTER_MAX_M:
        return "cluster", min(max(-(-m // THREADS), 1), most), THREADS
    return "grid", min(-(-m // (ATOMIC_THREADS * UNROLL)), ATOMIC_BLOCKS), ATOMIC_THREADS


def warp_order(weighted: np.ndarray) -> np.ndarray:
    """``bin_pass``'s compaction for one warp's pass: ``weighted`` (kUnroll,
    32) bool, slot by lane; returns the (slot, lane) each k-th weighted
    sample is fetched from, k = 0, 1, ..., found as the kernel finds it (the
    slot by the running counts, the lane by dropping set bits of the
    slot's ballot)."""
    masks = [sum(1 << int(lane) for lane in np.flatnonzero(row)) for row in weighted]
    start = np.concatenate([[0], np.cumsum([bin(m).count("1") for m in masks])])
    out = []
    for k in range(int(start[-1])):
        slot = int(sum(k >= start[u] for u in range(1, UNROLL)))
        held, before = masks[slot], k - int(start[slot])
        for _ in range(before):
            held &= held - 1
        out.append((slot, (held & -held).bit_length() - 1))
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def model_record(counts, values, weights, cfg, most: int = CLUSTER_BLOCKS):
    """The launch: each warp's passes (lane l of a pass at base + l + u *
    stride, a stride of the whole cluster or grid), its weighted samples
    fetched in the compaction's order, each block's histogram of their
    bins, folded onto counts with i32 wrap-around."""
    lo, ratio, bins = t_hist.bin_params(cfg)
    values, weights = np.ravel(values), np.ravel(weights)
    m = values.size
    w = (weights != 0).astype(np.int64) if weights.dtype == np.bool_ else weights.astype(np.int64)
    route, blocks, threads = launch_blocks(m, most)
    stride = blocks * threads
    seen = np.zeros(m, np.int64)
    per_block = np.zeros((blocks, bins + 1), np.int64)
    lanes, slots = np.arange(32), np.arange(UNROLL)
    for warp_base in range(0, stride, 32):
        rank = warp_base // threads
        for base in range(warp_base, m, stride * UNROLL):
            i = base + lanes[None, :] + slots[:, None] * stride      # (slot, lane)
            inside = i < m
            seen[i[inside]] += 1
            weighted = inside & (w[np.minimum(i, m - 1)] != 0)
            order = warp_order(weighted)
            if not len(order):
                continue
            taken = i[order[:, 0], order[:, 1]]
            assert np.array_equal(np.sort(taken), np.sort(i[weighted]))   # each once
            np.add.at(per_block, (rank, model_bin(values[taken], lo, ratio, bins)), w[taken])
    assert (seen == 1).all()                          # every sample once, none twice
    total = np.asarray(counts, np.int64) + per_block.sum(axis=0)
    return ((total + 2**31) % 2**32 - 2**31).astype(np.int32), route, blocks


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def edge_values(cfg) -> np.ndarray:
    """Every f32 edge and its neighbours, the sync-period multiples, 0, -0.0,
    negatives, subnormals, NaN, +-inf and 3e38."""
    e = t_hist.edges(cfg).astype(F32)
    return np.concatenate([
        e, np.nextafter(e, F32(np.inf)), np.nextafter(e, F32(-np.inf)),
        np.arange(1, 33, dtype=F32) * F32(0.25),
        F32([0.0, -0.0, -1.0, -3e38, 1e-45, 1e-40, 1.1754942e-38, np.nan, np.inf, -np.inf, 3e38,
             cfg.lo, cfg.hi])])


def log_uniform(rng, cfg, n: int) -> np.ndarray:
    return np.exp(rng.uniform(np.log(cfg.lo) - 3.0, np.log(cfg.hi) + 3.0, n)).astype(F32)


def to_t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_the_sources_constants_are_the_ports():
    """The log's constants in the kernel are ``obs/hist.py``'s, and one
    cluster pass covers the loop's largest batch (R * cap = 51,200)."""
    assert SQRT_HALF == F32(t_hist._SQRT_HALF) and Q1 == F32(t_hist._Q1)
    assert Q2 == F32(t_hist._Q2) and P == [F32(p) for p in t_hist._P]
    assert constant("kMaxBins") == 12_288 and CLUSTER_MAX_M >= 100 * 512
    assert (CLUSTER_BLOCKS, PORTABLE_BLOCKS) == (16, 8) and UNROLL <= 32


@pytest.mark.parametrize("kw", CONFIGS)
def test_model_binning_is_bin_index_at_every_edge(kw):
    """The kernel's per-sample arithmetic, modelled, against the port's
    ``bin_index`` and the reference's at every edge, its neighbours and the
    special values, and 100,000 log-uniform values."""
    cfg, jcfg = t_hist.HistConfig(**kw), j_hist.HistConfig(**kw)
    values = np.concatenate([edge_values(cfg),
                             log_uniform(np.random.default_rng(len(kw)), cfg, 100_000)])
    lo, ratio, bins = t_hist.bin_params(cfg)
    got = model_bin(values, lo, ratio, bins)
    np.testing.assert_array_equal(got, t_hist.bin_index(to_t(values), cfg).numpy())
    np.testing.assert_array_equal(got, np.asarray(j_hist.bin_index(jnp.asarray(values), jcfg)))
    with np.errstate(over="ignore"):
        q = values[values > F32(lo)] / F32(lo)
    q = q[np.isfinite(q)]
    np.testing.assert_array_equal(model_xla_log(q), t_hist.xla_log_f32(to_t(q)).numpy())


@pytest.mark.parametrize("kw", CONFIGS[:2])
@pytest.mark.parametrize("weights", ["bool", "i32"])
@pytest.mark.parametrize("m", [0, 1, 300, 51_200])
def test_record_plain_route_matches_reference(kw, weights, m):
    """``record`` on the CPU (its plain route) against the reference's
    ``record``: edge values first, then log-uniform ones; bool or i32
    weights with zeros among them; a fresh output, ``counts`` untouched."""
    cfg, jcfg = t_hist.HistConfig(**kw), j_hist.HistConfig(**kw)
    rng = np.random.default_rng(m + cfg.bins)
    values = np.concatenate([edge_values(cfg), log_uniform(rng, cfg, m)])[:m]
    w = rng.random(m) < 0.3 if weights == "bool" else \
        (rng.integers(-2, 5, m) * (rng.random(m) < 0.5)).astype(np.int32)
    counts = rng.integers(0, 1_000, cfg.bins + 1).astype(np.int32)
    tc = to_t(counts)
    got = t_hist.record(tc, to_t(values), to_t(w), cfg)
    want = np.asarray(j_hist.record(jnp.asarray(counts), jnp.asarray(values), jnp.asarray(w),
                                    jcfg))
    assert got.dtype == torch.int32 and got.data_ptr() != tc.data_ptr()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tc.numpy(), counts)
    np.testing.assert_array_equal(t_hist.record_plain(tc, to_t(values), to_t(w), cfg).numpy(),
                                  want)


def test_record_launches_nothing_off_the_card():
    cfg = t_hist.HistConfig()
    before = cuda_build.LAUNCHES["hist_bincount"]
    counts = torch.zeros(cfg.bins + 1, dtype=torch.int32)
    out = t_hist.record(counts, torch.ones((4, 8)), torch.ones((4, 8), dtype=torch.bool), cfg)
    assert cuda_build.LAUNCHES["hist_bincount"] == before and int(out.sum()) == 32


@pytest.mark.parametrize("m,most", [(1, 16), (512, 16), (1_025, 16), (51_200, 16),
                                    (51_200, 8), (65_536, 16), (65_536, 8), (65_537, 16),
                                    (300_001, 16)])
@pytest.mark.parametrize("weights", ["bool", "i32"])
def test_model_launch_is_record(m, most, weights):
    """The launch modelled (sample partition, the warps' compaction of their
    weighted samples, per-block histograms) against ``record_plain`` and
    the reference: one cluster up to 64 Ki samples (blocks of 1,024
    threads, at most 16, or the portable 8 where the card places no larger
    cluster: two passes at 64 Ki), the grid-stride route past it; large i32
    weights wrap as the reference's sums do."""
    cfg, jcfg = t_hist.HistConfig(), j_hist.HistConfig()
    rng = np.random.default_rng(m)
    values = np.concatenate([edge_values(cfg), log_uniform(rng, cfg, m)])[:m]
    if weights == "bool":
        w = rng.random(m) < 0.05
    else:
        w = (rng.integers(1, 5, m) * (rng.random(m) < 0.3)).astype(np.int32)
        w[rng.random(m) < 0.001] = 2**30
    counts = rng.integers(0, 1_000, cfg.bins + 1).astype(np.int32)
    got, route, blocks = model_record(counts, values, w, cfg, most)
    assert route == ("cluster" if m <= 65_536 else "grid")
    if m == 51_200:
        assert blocks == most                         # the merge batch: a full cluster
    np.testing.assert_array_equal(
        got, t_hist.record_plain(to_t(counts), to_t(values), to_t(w), cfg).numpy())
    if m <= 65_536:
        np.testing.assert_array_equal(got, np.asarray(j_hist.record(
            jnp.asarray(counts), jnp.asarray(values), jnp.asarray(w), jcfg)))
