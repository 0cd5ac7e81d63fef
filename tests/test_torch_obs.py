"""The port's telemetry through every ported loop: obs-on against obs-off on
each arm (ticks, events, the bank, the codec), a whole ``run_dagfl_gossip``
with telemetry and histograms against the reference, the overlay's
collectors under ``converge``, overflow and device spans, and the §IV tip
simulation's recorded trace and ``to_report``.

The reference's threefry draws are fed to the port (``edge_draw``,
``draw``, the tip simulation's ``draw``), so the two runs make the same
rounds. Tolerances:

- bitwise: everything an obs-on run shares with its obs-off run (ledgers,
  replicas, transport state, parameters, curves, counters), and against the
  reference the histogram counts, the trace records, every integer series
  and counter, and the tip simulation's report;
- ``bytes_total`` and the final byte bill within 1e-6 relative (f32 sums
  in each library's order), as in ``tests/test_torch_hist.py``.
"""
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro.net import events as j_events
from repro.net import gossip as j_gossip
from repro.net import topology as j_topo
from repro_torch import obs as t_obs
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.kernels.delta_codec import DeltaCodec
from repro_torch.net import bank as t_bank
from repro_torch.net import events as t_events
from repro_torch.net import gossip as t_gossip
from repro_torch.net import topology as t_topo
from repro_torch.obs import trace as t_trace
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_events import reference_tip_draws
from test_torch_gossip import (FIELDS, INT_FIELDS, _genesis, _publish_t, assert_dags_equal,
                               dag_to_t, reference_draws, reference_edge_draws, seeded_task)
from test_torch_hist import assert_reports_equal

N = 8
ARMS = {
    "ticks": dict(topology=("ring", dict(link_latency=1.5, drop=0.3)),
                  partition=(5.0, 12.0)),
    "events": dict(topology=("ring", dict(link_latency=0.5, latency_jitter=1.0, drop=0.3)),
                   engine="events", partition=(5.0, 12.0)),
    "bank": dict(topology=("ring", dict(link_latency=0.5, drop=0.2, bandwidth=1e7)),
                 bank=dict(chunks_per_slot=4, slot_bytes=7e6)),
    "codec": dict(topology=("ring", dict(link_latency=0.5, drop=0.2, bandwidth=1e6)),
                  bank=dict(chunks_per_slot=4, slot_bytes=7e6, codec=DeltaCodec("int4"))),
}


def run_port(arm, obs, iterations=15, **kw):
    spec = ARMS[arm]
    make, tkw = spec["topology"]
    task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=N, seed=0)
    dcfg = t_exp.default_dagfl_config(N)
    part = spec.get("partition")
    return t_sys.run_dagfl_gossip(
        task, nodes, dcfg, t_sys.SimConfig(iterations=iterations, eval_every=5, seed=0), gval,
        topology=getattr(t_topo, make)(N, **tkw),
        gossip=t_gossip.GossipConfig(sync_period=1.0, seed=3), engine=spec.get("engine"),
        partition=None if part is None else t_gossip.PartitionSchedule(
            t_topo.split_halves(N), *part),
        bank_gossip=None if "bank" not in spec else t_bank.BankGossipConfig(**spec["bank"]),
        device="cpu", obs=obs, **kw)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_obs_on_equals_obs_off(arm):
    """The acceptance invariant: telemetry reads only. Same draws, the same
    curve, ledgers, replicas, transport state and parameters, bitwise."""
    off = run_port(arm, None)
    on = run_port(arm, t_obs.ObsConfig(hist=t_obs.HistConfig()))
    for name in ("iters", "times", "accs"):
        np.testing.assert_array_equal(getattr(on, name), getattr(off, name), err_msg=name)
    for f in FIELDS:
        assert torch.equal(getattr(on.extras["dag"], f), getattr(off.extras["dag"], f)), f
        assert torch.equal(getattr(on.extras["replicas"].dags, f),
                           getattr(off.extras["replicas"].dags, f)), f
    if "bank" in ARMS[arm]:
        for name in ("have", "credit", "sent"):
            assert torch.equal(getattr(on.extras["replicas"].bank_state, name),
                               getattr(off.extras["replicas"].bank_state, name)), name
        assert on.extras["bank_bytes_sent"] == off.extras["bank_bytes_sent"] > 0
    for k in off.final_params:
        assert torch.equal(on.final_params[k], off.final_params[k]), k
    for key in ("sync_rounds", "edge_draws", "events_processed", "dispatch_counts",
                "approvals_issued", "divergence_curve"):
        np.testing.assert_array_equal(on.extras[key], off.extras[key], err_msg=key)
    assert "obs" not in off.extras
    rep = on.extras["obs"]
    assert rep.rounds == on.extras["sync_rounds"] > 0 and rep.samples == rep.rounds
    assert rep.hist["counts"]["merge_lat"].sum() > 0
    kinds = set(rep.trace["kind"].tolist())
    assert {t_trace.KIND_PUBLISH, t_trace.KIND_COMMIT, t_trace.KIND_DELIVER} <= kinds
    assert (t_trace.KIND_DRAIN in kinds) == ("bank" in ARMS[arm])
    assert (t_trace.KIND_PARTITION in kinds) == ("partition" in ARMS[arm])
    assert int((rep.trace["kind"] == t_trace.KIND_COMMIT).sum()) == 15
    assert rep.engine == ARMS[arm].get("engine", "ticks")


def test_run_dagfl_gossip_obs_matches_reference():
    """A lossy ring with a partition on the ticks engine, telemetry and
    histograms on, the reference's draws fed in: the report agrees bitwise
    (byte sums aside), and the run is the reference's run."""
    n, seed, gseed = N, 0, 3
    jt, jn, jg, _ = j_exp.make_cnn_setup(num_nodes=n, seed=seed)
    _, tn, tg, _ = t_exp.make_cnn_setup(num_nodes=n, seed=seed)
    jd, td = j_exp.default_dagfl_config(n), t_exp.default_dagfl_config(n)
    rj = j_sys.run_dagfl_gossip(
        jt, jn, jd, j_sys.SimConfig(iterations=20, eval_every=5, seed=seed), jg,
        topology=j_topo.ring(n, link_latency=1.5, drop=0.3),
        gossip=j_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        partition=j_gossip.PartitionSchedule(j_topo.split_halves(n), 5.0, 12.0),
        obs=j_obs.ObsConfig(hist=j_obs.HistConfig()))
    rt = t_sys.run_dagfl_gossip(
        seeded_task(jt, seed), tn, td, t_sys.SimConfig(iterations=20, eval_every=5, seed=seed),
        tg, topology=t_topo.ring(n, link_latency=1.5, drop=0.3),
        gossip=t_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        partition=t_gossip.PartitionSchedule(t_topo.split_halves(n), 5.0, 12.0),
        device="cpu", draw=reference_draws(seed, td.capacity),
        edge_draw=reference_edge_draws(gseed, n),
        obs=t_obs.ObsConfig(hist=t_obs.HistConfig()))
    np.testing.assert_array_equal(rt.accs, rj.accs)
    assert_dags_equal(rt.extras["replicas"].dags, rj.extras["replicas"].dags,
                      INT_FIELDS + ("publish_time",))
    got, want = rt.extras["obs"], rj.extras["obs"]
    assert_reports_equal(got, want)
    assert t_obs.metrics_jsonl_lines(got) == j_obs.metrics_jsonl_lines(want)
    assert t_obs.chrome_trace(got) == j_obs.chrome_trace(want)
    assert (got.trace["kind"] == t_trace.KIND_PARTITION).sum() == 2
    assert got.hist["counts"]["commit_lat"].sum() > 0


# ---------------------------------------------------------------------------
# the network's collectors
# ---------------------------------------------------------------------------


def one_publish_net(obs_cfg, sync_period=1.0, partition=None):
    dag = dag_to_t(_genesis(4))
    return t_gossip.GossipNetwork(dag, None, t_topo.ring(4, link_latency=0.5),
                                  t_gossip.GossipConfig(sync_period=sync_period, seed=1),
                                  partition=partition, obs_cfg=obs_cfg)


def test_converge_samples_and_overflow_are_counted():
    """An ideal wire samples at t = 0 (a flush has no timeline); series and
    trace past their capacities keep the first records and count the rest;
    partitions log begin and heal once each; no telemetry, no report."""
    assert one_publish_net(None).obs_report() is None
    part = t_gossip.PartitionSchedule(np.array([0, 0, 1, 1]), 2.0, 4.0)
    net = one_publish_net(t_obs.ObsConfig(series_capacity=3, trace_capacity=5), 1.0, part)
    for seq, t in enumerate((1.0, 2.5, 3.0, 5.0, 6.0), start=1):
        _publish_t(net, seq % 4, seq, t - 0.5)
        net.advance(t)
    net.converge(7.0)
    rep = net.obs_report()
    assert rep.rounds == net.rounds_run > 3
    assert rep.samples == 3 and rep.samples_dropped == rep.rounds - 3
    np.testing.assert_array_equal(rep.series["t"], [1.0, 2.0, 3.0])
    parts = rep.trace["kind"] == t_trace.KIND_PARTITION
    np.testing.assert_array_equal(rep.trace["t"][parts], [2.0, 4.0])
    np.testing.assert_array_equal(rep.trace["arg"][parts], [1.0, 0.0])
    assert rep.trace_records == 5 + 2 and rep.trace_dropped > 0
    ideal = one_publish_net(t_obs.ObsConfig(), sync_period=0.0)
    _publish_t(ideal, 1, 1, 0.5)
    ideal.advance(3.0)
    rep = ideal.obs_report()
    assert rep.rounds > 0 and (rep.series["t"] == 0.0).all()
    assert rep.dispatch_counts == {"converge": 1}


def test_device_spans_equal_host_spans_at_f32():
    """``ObsConfig(device_spans=True)`` routes the FL loop's PUBLISH/COMMIT
    spans through the device ring: the same records as the host list, at
    the ring's f32 precision."""
    host = run_port("ticks", t_obs.ObsConfig(), iterations=8).extras["obs"]
    dev = run_port("ticks", t_obs.ObsConfig(device_spans=True), iterations=8).extras["obs"]
    assert dev.dispatch_counts["trace_device"] == 16
    spans = np.isin(host.trace["kind"], [t_trace.KIND_PUBLISH, t_trace.KIND_COMMIT])
    h = {k: v[spans] for k, v in host.trace.items()}
    order = np.lexsort((h["kind"], h["t"].astype(np.float32)))
    d_spans = np.isin(dev.trace["kind"], [t_trace.KIND_PUBLISH, t_trace.KIND_COMMIT])
    d = {k: v[d_spans] for k, v in dev.trace.items()}
    np.testing.assert_array_equal(d["t"], h["t"][order].astype(np.float32))
    np.testing.assert_array_equal(d["arg"], h["arg"][order].astype(np.float32))
    for k in ("kind", "src", "dst"):
        np.testing.assert_array_equal(d[k], h[k][order])


# ---------------------------------------------------------------------------
# the §IV tip simulation
# ---------------------------------------------------------------------------


def test_insystem_record_trace_and_report_match_reference():
    """The tip simulation with ``record_trace=True`` and the reference's
    draws: the PUBLISH/COMMIT records, the drops and ``to_report`` (series,
    trace, JSONL, Chrome trace) equal the reference's, and the traced run is
    the untraced one."""
    kw = dict(h=np.asarray([1.0, 2.5, 0.5, 1.5, 3.0], np.float32), arrival_rate=1.5, k=2,
              tau_max=20.0, horizon=25.0, capacity=32, seed=3, sync_period=0.5, max_pending=3)
    top = dict(link_latency=0.75, latency_jitter=0.5, drop=0.2, seed=1)
    want = j_events.simulate_insystem_tips(j_topo.ring(5, **top), record_trace=True, **kw)
    got = t_events.simulate_insystem_tips(t_topo.ring(5, **top), record_trace=True,
                                          device="cpu", draw=reference_tip_draws(3, 5, 32), **kw)
    plain = t_events.simulate_insystem_tips(t_topo.ring(5, **top), device="cpu",
                                            draw=reference_tip_draws(3, 5, 32), **kw)
    assert plain.trace is None and plain.trace_dropped == 0
    np.testing.assert_array_equal(got.tips, plain.tips)
    assert got.overflow == want.overflow > 0          # some STARTs found no pending slot
    assert got.trace_dropped == want.trace_dropped == 0
    for name in want.trace:
        np.testing.assert_array_equal(got.trace[name], want.trace[name], err_msg=name)
    kinds = got.trace["kind"]
    assert (kinds == t_trace.KIND_COMMIT).sum() == got.published
    jr, tr = want.to_report(), got.to_report()
    assert (tr.num_nodes, tr.engine, tr.rounds, tr.samples_dropped) == (
        jr.num_nodes, jr.engine, jr.rounds, jr.samples_dropped) == (5, "insystem",
                                                                   got.published, got.overflow)
    assert t_obs.metrics_jsonl_lines(tr) == j_obs.metrics_jsonl_lines(jr)
    assert t_obs.chrome_trace(tr) == j_obs.chrome_trace(jr)
    assert plain.to_report().trace_records == 0
