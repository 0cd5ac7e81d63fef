"""The port's telemetry pieces against the reference, one at a time: the
histogram binning and its f32 log, ``record``/``observe``, percentiles,
the trace ring's appends and drain (overflow included), one metrics sample,
the Chrome-trace and JSONL exporters, and one whole banked events-engine run
with histograms on.

The same numpy-made inputs go to both packages; the reference's functions
run eagerly on the CPU (its bincount through ``ref.hist_bincount_ref``, as
its own tests run it there). Tolerances:

- bitwise: bin indices, the f32 log of the binning, histogram counts, the
  propagation latch, the serving FIFO, trace records (f32 instants and
  args, i32 kinds and ids), cursors and drops, every integer metric, and
  the exporters' output on one report;
- ``bytes_total``, an f32 sum over links, within 1e-6 relative: the two
  libraries add in their own order.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro.net import bank as j_bank
from repro.net import gossip as j_gossip
from repro.net import topology as j_topo
from repro.obs import export as j_export
from repro.obs import hist as j_hist
from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.kernels import cuda_build
from repro_torch.kernels import hist_bincount as t_bincount
from repro_torch.net import bank as t_bank
from repro_torch.net import gossip as t_gossip
from repro_torch.net import topology as t_topo
from repro_torch.obs import export as t_export
from repro_torch.obs import hist as t_hist
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_gossip import (dag_to_t, random_stacked, reference_draws, reference_edge_draws,
                               seeded_task, to_t)

BYTES_RTOL = 1e-6


def j_cfg(**kw):
    return j_hist.HistConfig(**kw)


def t_cfg(**kw):
    return t_hist.HistConfig(**kw)


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


def edge_and_sync_values(cfg) -> np.ndarray:
    """Every f32 edge and its two f32 neighbours, the sync-period multiples
    0.25 s .. 8 s (and finer ones), and values past either end."""
    e = j_hist.edges(cfg).astype(np.float32)
    sync = np.arange(1, 33, dtype=np.float32) * np.float32(0.25)
    fine = np.arange(1, 801, dtype=np.float32) * np.float32(0.01)
    ends = np.float32([0.0, -1.0, 1e-9, cfg.lo, cfg.hi, 3e38, np.inf, -np.inf, np.nan])
    return np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                           np.nextafter(e, np.float32(-np.inf)), sync, fine, ends])


@pytest.mark.parametrize("bins,lo,hi", [(64, 1e-4, 1e4), (16, 1e-3, 10.0), (7, 0.5, 3.0)])
def test_bin_index_matches_reference_at_edges_and_sync_multiples(bins, lo, hi):
    values = edge_and_sync_values(j_cfg(bins=bins, lo=lo, hi=hi))
    want = np.asarray(j_hist.bin_index(jnp.asarray(values), j_cfg(bins=bins, lo=lo, hi=hi)))
    got = t_hist.bin_index(to_t(values), t_cfg(bins=bins, lo=lo, hi=hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if (bins, lo, hi) == (64, 1e-4, 1e4):
        one = int(t_hist.bin_index(torch.tensor([1.0]), t_cfg())[0])
        assert one == int(want[32])          # 1.0 s lies on edge 32


def test_xla_log_matches_the_reference_log():
    """The binning's f32 log against the reference's ``jnp.log`` on the CPU,
    bitwise, over normal f32 values across the decades the bins use."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.exp(rng.uniform(-30.0, 40.0, 60_000)), rng.uniform(1.0, 2.0, 20_000),
                        np.arange(1, 5_000)]).astype(np.float32)
    want = np.asarray(jnp.log(jnp.asarray(x)))
    np.testing.assert_array_equal(t_hist.xla_log_f32(to_t(x)).numpy(), want)


def test_record_matches_reference_and_impls_agree():
    rng = np.random.default_rng(1)
    vals = np.exp(rng.uniform(-12.0, 12.0, (6, 40))).astype(np.float32)
    w = rng.integers(0, 3, (6, 40)).astype(np.int32)
    counts = rng.integers(0, 5, 65).astype(np.int32)
    want = np.asarray(j_hist.record(jnp.asarray(counts), jnp.asarray(vals), jnp.asarray(w),
                                    j_cfg()))
    got = t_hist.record(to_t(counts), to_t(vals), to_t(w), t_cfg())
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper that record calls and the plain bincount agree
    plain = to_t(counts) + t_bincount.hist_bincount_plain(
        t_hist.bin_index(to_t(vals).reshape(-1), t_cfg()), to_t(w).reshape(-1), 65)
    np.testing.assert_array_equal(plain.numpy(), want)


# ---------------------------------------------------------------------------
# observe, percentiles
# ---------------------------------------------------------------------------


def perturbed(rng, dags, frac=0.3):
    """The stacked replicas after a round: some rows re-published, some
    approvals moved, two rows propagated everywhere."""
    pub = np.array(dags.publisher)
    t = np.array(dags.publish_time)
    ac = np.array(dags.approval_count)
    hit = rng.random(pub.shape) < frac
    pub = np.where(hit, rng.integers(0, 8, pub.shape), pub).astype(np.int32)
    t = np.where(hit, t + rng.choice(np.float32([0.25, 1.0, 2.5]), pub.shape), t).astype(
        np.float32)
    ac = np.where(rng.random(pub.shape) < frac, ac + 1, ac).astype(np.int32)
    agree = rng.choice(pub.shape[1], 2, replace=False)     # rows every replica now holds
    pub[:, agree] = pub[0, agree]
    t[:, agree] = t[0, agree]
    return dags._replace(publisher=jnp.asarray(pub), publish_time=jnp.asarray(t),
                         approval_count=jnp.asarray(ac))


def test_observe_matches_reference_with_bank_and_serving():
    rng = np.random.default_rng(2)
    n, cap, s_slots, c, q = 6, 16, 16, 3, 4
    old = random_stacked(rng, n, cap=cap)
    new = perturbed(rng, old)
    old_have = rng.random((n, s_slots, c)) < 0.4
    have = old_have | (rng.random((n, s_slots, c)) < 0.3)
    jb = j_bank.BankState(have=jnp.asarray(have), credit=jnp.zeros((n, n), jnp.float32),
                          sent=jnp.zeros((n, n), jnp.float32))
    tb = t_bank.BankState(have=to_t(have), credit=torch.zeros((n, n)), sent=torch.zeros((n, n)))
    jh = j_hist.init_hist(j_cfg(), old, queue_cap=q)
    th = t_hist.init_hist(t_cfg(), dag_to_t(old), queue_cap=q)
    for step in range(3):
        t = np.float32(3.0 + 1.25 * step)
        serve = {k: rng.integers(0, 3, n).astype(np.int32) for k in ("serve_enq", "serve_admit")}
        serve["serve_queued"] = rng.integers(0, q - 2, n).astype(np.int32)
        serve["serve_stale_node"] = rng.integers(0, 9, n).astype(np.int32)
        jh = j_hist.observe(j_cfg(), jh, jnp.float32(t), old, new, old_have=jnp.asarray(old_have),
                            bstate=jb, **{k: jnp.asarray(v) for k, v in serve.items()})
        th = t_hist.observe(t_cfg(), th, torch.tensor(t), dag_to_t(old), dag_to_t(new),
                            old_have=to_t(old_have), bstate=tb,
                            **{k: to_t(v) for k, v in serve.items()})
        for name in th._fields:
            np.testing.assert_array_equal(getattr(th, name).numpy(),
                                          np.asarray(getattr(jh, name)), err_msg=name)
        old, new = new, perturbed(rng, new)
    assert all(int(getattr(th, name).sum()) > 0 for name in t_hist.HIST_NAMES)


@pytest.mark.parametrize("q", [0.0, 1.0, 50.0, 95.0, 99.0, 100.0])
def test_percentile_summary_and_report_match(q):
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 6, 65).astype(np.int32)
    counts[-1] = 2                                   # overflow bin populated
    assert t_hist.percentile(counts, t_cfg(), q) == j_hist.percentile(counts, j_cfg(), q)
    assert t_hist.summary(counts, t_cfg()) == j_hist.summary(counts, j_cfg())
    empty = np.zeros(65, np.int32)
    assert all(np.isnan(v) for v in t_hist.percentile(empty, t_cfg(), q))
    hs = t_hist.init_hist(t_cfg(), dag_to_t(random_stacked(rng, 3)))
    rep = t_hist.report_dict(hs._replace(merge_lat=to_t(counts)), t_cfg())
    assert rep["percentiles"]["merge_lat"] == j_hist.summary(counts, j_cfg())
    np.testing.assert_array_equal(rep["edges"], j_hist.edges(j_cfg()))


# ---------------------------------------------------------------------------
# the trace ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [5, 40, 1000])
def test_append_edges_and_drain_match_reference(capacity):
    """Masks, scalar and per-edge args over several appends; the small
    capacities overflow mid-append, so the first records stay and the rest
    count in ``dropped``, with the reference's slots and counters."""
    rng = np.random.default_rng(capacity)
    n = 6
    jr, tr = j_trace.init_trace(capacity), t_trace.init_trace(capacity)
    for step, kind in enumerate([0, 1, 0, 3, 1, 0]):
        mask = rng.random((n, n)) < 0.3
        arg = rng.uniform(0, 1e6, (n, n)).astype(np.float32) if step % 2 else 2.0
        t = np.float32(0.5 * step + 0.125)
        jr = j_trace.append_edges(jr, jnp.float32(t), kind, jnp.asarray(mask),
                                  jnp.asarray(arg) if step % 2 else arg)
        tr = t_trace.append_edges(tr, float(t), kind, to_t(mask),
                                  to_t(arg) if step % 2 else arg)
    assert int(tr.cursor) == int(jr.cursor) and int(tr.dropped) == int(jr.dropped)
    for name in ("t", "kind", "src", "dst", "arg"):
        np.testing.assert_array_equal(getattr(tr, name)[:capacity].numpy(),
                                      np.asarray(getattr(jr, name)), err_msg=name)
    host = [(0.125, 2, 1, 1, 3.5), (0.125, 0, 2, 3, 1.0), (9.0, 4, -1, -1, 1.0)]
    want, got = j_trace.drain(jr, host), t_trace.drain(tr, host)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert got[name].dtype == want[name].dtype, name
    if capacity == 5:
        assert int(tr.dropped) > 0 and len(got["t"]) == capacity + len(host)


def test_append_takes_a_device_tensor_instant():
    tr = t_trace.init_trace(8)
    mask = torch.eye(3, dtype=torch.bool)
    t_trace.append_edges(tr, torch.tensor(1.5), t_trace.KIND_COMMIT, mask, torch.arange(3.0))
    got = t_trace.drain(tr)
    np.testing.assert_array_equal(got["t"], [1.5, 1.5, 1.5])
    np.testing.assert_array_equal(got["src"], got["dst"])
    np.testing.assert_array_equal(got["arg"], [0.0, 1.0, 2.0])


# ---------------------------------------------------------------------------
# one metrics sample
# ---------------------------------------------------------------------------


def test_metrics_update_matches_reference():
    rng = np.random.default_rng(4)
    n, cap, c = 5, 16, 2
    cfg_j = j_metrics.ObsConfig(series_capacity=3, tau_max=20.0)
    cfg_t = t_metrics.ObsConfig(series_capacity=3, tau_max=20.0)
    old = random_stacked(rng, n, cap=cap)
    digest = rng.integers(0, 4, (cap, c)).astype(np.float32)
    jm, tm = j_metrics.init_metrics(n, cfg_j), t_metrics.init_metrics(n, cfg_t)
    for step in range(5):                             # 5 samples, capacity 3
        new = perturbed(rng, old)
        have = rng.random((n, cap, c)) < 0.6
        sent = rng.uniform(0, 1e6, (n, n)).astype(np.float32)
        jb = j_bank.BankState(have=jnp.asarray(have), credit=jnp.zeros((n, n), jnp.float32),
                              sent=jnp.asarray(sent))
        tb = t_bank.BankState(have=to_t(have), credit=torch.zeros((n, n)), sent=to_t(sent))
        t = np.float32(1.0 + step)
        bank = step % 2 == 0
        jm = j_metrics.update(jm, cfg_j, jnp.float32(t), new,
                              j_metrics.rows_changed(new, old),
                              jb if bank else None, jnp.asarray(digest) if bank else None)
        delta = t_metrics.rows_changed(dag_to_t(new), dag_to_t(old))
        np.testing.assert_array_equal(delta.numpy(), np.asarray(j_metrics.rows_changed(new, old)))
        tm = t_metrics.update(tm, cfg_t, torch.tensor(t), dag_to_t(new), delta,
                              tb if bank else None, to_t(digest) if bank else None)
        old = new
    assert (tm.rounds, tm.cursor, tm.dropped) == (int(jm.rounds), int(jm.cursor),
                                                 int(jm.dropped)) == (5, 5, 2)
    for name in t_metrics.SERIES + ("rows_merged", "link_bytes"):
        got, want = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        if name == "bytes_total":
            np.testing.assert_allclose(got, want, rtol=BYTES_RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def sample_report(export):
    """One report with every record kind, a partition that never heals, a
    histogram and vector-valued series, built in ``export``'s own type."""
    rng = np.random.default_rng(5)
    n, s = 4, 6
    trace = {
        "t": np.array([0.0, 0.5, 0.5, 1.0, 1.5, 2.0, 2.0, 3.0, 4.0, 5.0]),
        "kind": np.array([2, 0, 1, 3, 4, 5, 6, 4, 0, 4], np.int32),
        "src": np.array([1, 0, 2, 1, -1, 3, 2, -1, 9, -1], np.int32),
        "dst": np.array([1, 1, 3, 1, -1, 0, 2, -1, 1, -1], np.int32),
        "arg": np.array([2.5, 3.0, 7e6, 4.0, 1.0, 2.0, 8.0, 0.0, 1.0, 1.0]),
    }
    cfg = j_cfg()
    counts = {name: rng.integers(0, 3, 65).astype(np.int32) * (i != 2)
              for i, name in enumerate(j_hist.HIST_NAMES)}
    hist = {"bins": 64, "lo": 1e-4, "hi": 1e4, "edges": j_hist.edges(cfg), "counts": counts,
            "percentiles": {k: j_hist.summary(v, cfg) for k, v in counts.items()}}
    return export.ObsReport(
        num_nodes=n, engine="events", rounds=s,
        series={"t": np.arange(s, dtype=np.float64), "tips": np.arange(s, dtype=np.int64),
                "staleness_node": rng.integers(0, 5, (s, n)),
                "bytes_total": rng.uniform(0, 1e6, s)},
        rows_merged=np.arange(n, dtype=np.int64), link_bytes=np.zeros((n, n)),
        samples_dropped=1, trace=trace, trace_dropped=3,
        dispatch_counts={"advance_events": 3}, final={"bytes_sent": 7.0}, hist=hist)


def test_chrome_trace_and_jsonl_match_reference(tmp_path):
    jr, tr = sample_report(j_export), sample_report(t_export)
    lat = np.full((4, 4), 0.25)
    lat[0, 1] = np.inf
    for latency in (None, lat):
        assert t_export.chrome_trace(tr, latency) == j_export.chrome_trace(jr, latency)
    assert t_export.metrics_jsonl_lines(tr) == j_export.metrics_jsonl_lines(jr)
    path = t_export.write_chrome_trace(tr, str(tmp_path / "trace.json"))
    assert json.load(open(path)) == json.loads(json.dumps(j_export.chrome_trace(jr)))
    path = t_export.write_metrics_jsonl(tr, str(tmp_path / "m.jsonl"))
    lines = open(path).read().splitlines()
    assert lines == j_export.metrics_jsonl_lines(jr)
    assert [json.loads(x)["kind"] for x in lines[:7]] == ["summary"] + ["hist"] * 5 + ["sample"]
    assert tr.samples == 6 and tr.trace_records == 10


# ---------------------------------------------------------------------------
# a whole banked events-engine run with histograms
# ---------------------------------------------------------------------------


def test_events_bank_run_obs_matches_reference():
    """A starved, lossy, jittered ring on the events engine with the bank
    (drain-only batches included) and histograms on, with the reference's
    draws: the histogram counts, every trace record, every integer series
    and the counters bitwise; bytes within 1e-6; the kernel path unused on
    the CPU."""
    from repro import obs as j_obs
    from repro_torch import obs as t_obs

    n, seed, gseed = 8, 0, 3
    kw = dict(link_latency=0.5, latency_jitter=1.0, drop=0.3, bandwidth=1e7)
    jt, jn, jg, _ = j_exp.make_cnn_setup(num_nodes=n, seed=seed)
    _, tn, tg, _ = t_exp.make_cnn_setup(num_nodes=n, seed=seed)
    jd, td = j_exp.default_dagfl_config(n), t_exp.default_dagfl_config(n)
    want = j_sys.run_dagfl_gossip(
        jt, jn, jd, j_sys.SimConfig(iterations=15, eval_every=5, seed=seed), jg,
        topology=j_topo.ring(n, **kw), gossip=j_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        engine="events", bank_gossip=j_bank.BankGossipConfig(chunks_per_slot=4, slot_bytes=7e6),
        obs=j_obs.ObsConfig(hist=j_obs.HistConfig())).extras["obs"]
    before = cuda_build.LAUNCHES["hist_bincount"]
    got = t_sys.run_dagfl_gossip(
        seeded_task(jt, seed), tn, td, t_sys.SimConfig(iterations=15, eval_every=5, seed=seed),
        tg, topology=t_topo.ring(n, **kw),
        gossip=t_gossip.GossipConfig(sync_period=1.0, seed=gseed), engine="events",
        bank_gossip=t_bank.BankGossipConfig(chunks_per_slot=4, slot_bytes=7e6), device="cpu",
        draw=reference_draws(seed, td.capacity), edge_draw=reference_edge_draws(gseed, n),
        obs=t_obs.ObsConfig(hist=t_obs.HistConfig())).extras["obs"]
    assert cuda_build.LAUNCHES["hist_bincount"] == before
    assert_reports_equal(got, want)
    assert got.hist["counts"]["chunk_lat"].sum() > 0
    assert (got.trace["kind"] == t_trace.KIND_DRAIN).any()


def assert_reports_equal(got, want):
    """Two ``ObsReport``s: everything bitwise but the f32 byte sums."""
    assert (got.num_nodes, got.engine, got.rounds, got.samples_dropped, got.trace_dropped) == (
        want.num_nodes, want.engine, want.rounds, want.samples_dropped, want.trace_dropped)
    assert got.dispatch_counts == want.dispatch_counts
    assert list(got.series) == list(want.series)
    for name in want.series:
        if name == "bytes_total":
            np.testing.assert_allclose(got.series[name], want.series[name], rtol=BYTES_RTOL)
        else:
            np.testing.assert_array_equal(got.series[name], want.series[name], err_msg=name)
            assert got.series[name].dtype == want.series[name].dtype, name
    for name in want.trace:
        np.testing.assert_array_equal(got.trace[name], want.trace[name], err_msg=name)
    np.testing.assert_array_equal(got.rows_merged, want.rows_merged)
    np.testing.assert_array_equal(got.link_bytes, want.link_bytes)
    assert got.final.keys() == want.final.keys()
    for key in want.final:
        np.testing.assert_allclose(got.final[key], want.final[key], rtol=BYTES_RTOL)
    assert (got.hist is None) == (want.hist is None)
    if want.hist is not None:
        for name in j_hist.HIST_NAMES:
            np.testing.assert_array_equal(got.hist["counts"][name], want.hist["counts"][name],
                                          err_msg=name)
        np.testing.assert_equal(got.hist["percentiles"], want.hist["percentiles"])  # NaN == NaN
