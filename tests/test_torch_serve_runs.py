"""Inference serving through whole network runs, against the reference: the
event engine's serving arms (plain, bank, faults, bank_faults,
bank_partition; the fused and the scan round), the int8 codec's wire price
and telemetry with the histograms.

The same schedules run in both packages; the reference's edge, fault and
arrival draws are fed to the port (``reference_edge_draws``,
``reference_fault_draw``, ``reference_serve_draw``).
The faulted bank arm's spoof draws are indexed by the batch's count within
its advance, INFER batches included, as the reference folds its spoof key.
``ServePair`` compares both networks after every advance. Tolerances:
bitwise for the ledgers, the queue, the transport and fault state, the
serve state and report, the telemetry's integer series, records and
histograms; the telemetry's f32 byte sums within 1e-6 relative
(``assert_reports_equal``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dag as j_dag
from repro.kernels.delta_codec import DeltaCodec as JDeltaCodec
from repro.net import bank as j_bank
from repro.net import faults as j_faults
from repro.net import gossip as j_gossip
from repro.net import replica as j_replica
from repro.net import serve as j_serve
from repro.net import topology as j_topo
from repro.obs import HistConfig as JHistConfig
from repro.obs import ObsConfig as JObsConfig
from repro_torch import obs as t_obs
from repro_torch.core import bank as t_store
from repro_torch.kernels.delta_codec import DeltaCodec
from repro_torch.net import bank as t_bank
from repro_torch.net import faults as t_faults
from repro_torch.net import gossip as t_gossip
from repro_torch.net import serve as t_serve
from repro_torch.net import topology as t_topo
from test_torch_bank import assert_state_equal
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_faults import genesis_j, reference_fault_draw
from test_torch_gossip import assert_dags_equal, dag_to_t, reference_edge_draws
from test_torch_hist import assert_reports_equal
from test_torch_serve import (CAP, assert_serve_reports_equal, assert_serve_states_equal,
                              configs, drive, publish_port, reference_serve_draw, schedule)

SERVE = dict(rate=3.0, sample_capacity=32)     # a reciprocal that is not exact; overflow
j_publish_local = jax.jit(j_replica.publish_local)     # one compile, not one per primitive


class ServePair:
    """One serving overlay in both packages, the reference's draws fed to
    the port; ``publish`` and ``advance`` act on both, and ``advance``
    compares them."""

    def __init__(self, top_args, serve=SERVE, bank=None, codec=None, faults=None,
                 partition=None, impl="fused", seed=0, obs=None):
        make, args, kw = top_args
        jtop, ttop = getattr(j_topo, make)(*args, **kw), getattr(t_topo, make)(*args, **kw)
        n = jtop.num_nodes
        jc, tc = configs(**serve)
        jpart = tpart = None
        if partition is not None:
            jpart = j_gossip.PartitionSchedule(*partition)
            tpart = t_gossip.PartitionSchedule(*partition)
        self.seed = seed
        self.fault_draws = reference_fault_draw(seed)
        self.j = j_gossip.GossipNetwork(
            genesis_j(n), jnp.zeros((CAP, 8)), jtop,
            j_gossip.GossipConfig(sync_period=1.0, seed=seed, impl=impl, engine="events"),
            jpart, bank_cfg=None if bank is None else j_bank.BankGossipConfig(
                **bank, codec=codec and JDeltaCodec(codec)),
            obs_cfg=None if obs is None else JObsConfig(hist=JHistConfig()),
            faults_cfg=None if faults is None else j_faults.FaultConfig(**faults),
            serve_cfg=jc)
        self.t = t_gossip.GossipNetwork(
            dag_to_t(genesis_j(n)), t_store.init_bank({"w": torch.zeros(8)}, CAP), ttop,
            t_gossip.GossipConfig(sync_period=1.0, seed=seed, impl=impl, engine="events"),
            tpart, bank_cfg=None if bank is None else t_bank.BankGossipConfig(
                **bank, codec=codec and DeltaCodec(codec)),
            obs_cfg=None if obs is None else t_obs.ObsConfig(hist=t_obs.HistConfig()),
            faults_cfg=None if faults is None else t_faults.FaultConfig(**faults),
            serve_cfg=tc, edge_draw=reference_edge_draws(seed, n),
            fault_draw=self.fault_draws, serve_draw=reference_serve_draw(seed, jc, n))

    def publish(self, node, seq, t):
        d = j_publish_local(
            self.j.read(node), jnp.int32(seq), jnp.asarray(node, jnp.int32), jnp.float32(t),
            jnp.full((2,), j_dag.NO_TX, jnp.int32), jnp.float32(0.5), jnp.float32(0.0),
            jnp.asarray(seq % CAP, jnp.int32))
        self.j.write(node, d)
        if self.j.bank_cfg is not None:
            self.j.bank_commit(node, seq % CAP, jnp.full((8,), float(seq)))
        publish_port(self.t, node, seq, t)

    def advance(self, t):
        self.t.advance(t)
        self.j.advance(t)
        self.compare(f"t={t}: ")

    def compare(self, msg):
        j, t = self.j, self.t
        assert_dags_equal(t.replicas.dags, j.replicas.dags)
        counters = ("tick", "rounds_run", "events_processed", "device_calls", "dispatch_counts")
        assert [getattr(t, c) for c in counters] == [getattr(j, c) for c in counters], msg
        key = jax.random.PRNGKey(self.seed)
        for _ in range(t.edge_draws):
            key, _sub = jax.random.split(key)
        np.testing.assert_array_equal(np.asarray(key), np.asarray(j._key), err_msg=msg + "key")
        for name in ("time", "valid"):
            np.testing.assert_array_equal(getattr(t._equeue, name).numpy(),
                                          np.asarray(getattr(j._equeue, name)),
                                          err_msg=msg + name)
        if t.bank_cfg is not None:
            assert_state_equal(t.bank_state, j.bank_state, msg=msg)
            np.testing.assert_array_equal(t._last_srv.numpy(), np.asarray(j._last_srv),
                                          err_msg=msg + "last_srv")
        if j._fstate is not None:
            for name in ("rejects", "tainted"):
                np.testing.assert_array_equal(getattr(t.fault_state, name).numpy(),
                                              np.asarray(getattr(j._fstate, name)),
                                              err_msg=msg + name)
        assert_serve_states_equal(t.serve_state, j._sstate, msg)
        assert_serve_reports_equal(t.serve_report(), j.serve_report())

    def run(self):
        """The schedule of ``test_torch_serve.drive``."""
        n = self.t.topology.num_nodes
        for t_end, base, t0, step in schedule(n):
            for i in range(n):
                self.publish(i, base + i, t0 + step * i)
            self.advance(t_end)
        return self


def arm(name, impl="fused"):
    """The reference's serving arms on six nodes."""
    n = 6
    bank = dict(chunks_per_slot=2) if name.startswith("bank") else None
    faults = partition = None
    if name in ("faults", "bank_faults"):
        role = j_faults.ROLE_SPOOF if bank is not None else j_faults.ROLE_SELECTIVE
        faults = dict(roles=(role,) + (0,) * (n - 1))
    if name == "bank_partition":
        partition = (j_topo.split_halves(n), 2.0, 6.0)
    top = (("ring", (n,), dict(link_latency=0.7)) if name == "faults"
           else ("full", (n,), dict(link_latency=1.0)))
    return ServePair(top, bank=bank, faults=faults, partition=partition, impl=impl)


@pytest.mark.parametrize("impl", ["fused", "scan"])
@pytest.mark.parametrize("name", ["plain", "bank", "faults", "bank_faults", "bank_partition"])
def test_serving_arm_matches_reference(name, impl):
    pair = arm(name, impl).run()
    rep = pair.t.serve_report()
    assert rep["served_total"] > 0 and rep["samples_dropped"] > 0
    arrived = rep["requests_served"] + rep["queued"] + rep["inflight"] + rep["dropped"]
    np.testing.assert_array_equal(rep["arrivals"], arrived)
    if name == "bank_faults":
        batch = [c for c in pair.fault_draws.calls if c[0] == "spoof_batch"]
        # a batch within an advance is counted with its INFER batches
        assert max(index[1] for _s, index, _shape in batch) >= pair.t.edge_draws


def test_codec_wire_price_matches_reference():
    """int8 over starved links: the chunks are priced at their encoded size,
    and the gated staleness the requests see follows."""
    pair = ServePair(("full", (5,), dict(link_latency=1.0, bandwidth=64.0)),
                     bank=dict(chunks_per_slot=2), codec="int8").run()
    assert pair.t.serve_report()["staleness_max"] > 0


def test_serving_telemetry_matches_reference():
    """Telemetry with the histograms on a banked serving run: the serve
    series, the INFER records on the diagonal, the "infer" Chrome slices,
    the queue-wait and staleness histograms equal the reference's; the
    obs-on run is bitwise the obs-off one."""
    top = ("full", (4,), dict(link_latency=1.0))
    on = ServePair(top, bank=dict(chunks_per_slot=2), obs=True).run()
    want, got = on.j.obs_report(), on.t.obs_report()
    assert_reports_equal(got, want)
    served = got.series["requests_served"]
    assert served.shape[1] == 4 and served[-1].sum() > 0
    assert np.all(np.diff(served, axis=0) >= 0) and np.any(got.series["serve_staleness"] >= 0)
    infer = got.trace["kind"] == t_obs.KIND_INFER
    assert infer.any()
    np.testing.assert_array_equal(got.trace["src"][infer], got.trace["dst"][infer])
    assert np.all(got.trace["arg"][infer] >= 1)
    assert "infer" in {e["name"] for e in t_obs.chrome_trace(got)["traceEvents"]}
    for name in ("queue_wait", "serve_stale"):
        assert got.hist["counts"][name].sum() > 0, name
    off = t_gossip.GossipNetwork(
        dag_to_t(genesis_j(4)), t_store.init_bank({"w": torch.zeros(8)}, CAP),
        t_topo.full(4, link_latency=1.0), t_gossip.GossipConfig(sync_period=1.0, engine="events"),
        bank_cfg=t_bank.BankGossipConfig(chunks_per_slot=2), serve_cfg=t_serve.ServeConfig(**SERVE),
        edge_draw=reference_edge_draws(0, 4), serve_draw=reference_serve_draw(
            0, j_serve.ServeConfig(**SERVE), 4))
    drive(off, 4)
    assert_serve_states_equal(off.serve_state, on.j._sstate)
    for x, y in zip(off.replicas.dags + off.bank_state, on.t.replicas.dags + on.t.bank_state):
        assert torch.equal(x, y)
