"""The port's continuous-time event engine against the reference: the queue
head, the queue, the stability model, both event loops of
``GossipNetwork`` (bankless, banked, with a codec), a whole
``run_dagfl_gossip(engine="events")`` and the §IV in-system tip simulation.

The same numpy-made inputs go to both packages. The JAX side runs as its own
tests run it: ``ref.event_pop_ref`` and the Pallas kernel in interpret mode,
loaded with ``importlib`` (``repro.kernels`` re-exports the function under
the submodule's name); the kernel against its plain version on a card is in
``tests/test_torch_kernels.py``, which runs without JAX. The reference's
threefry draws are fed to the port:
the edge uniforms through ``edge_draw`` (``reference_edge_draws``, indexed
by the delivery rounds drawn) and the tip simulation's draws through its
``draw``. Tolerances:

- bitwise: queue heads, queue times and validity, ledgers, transport state
  (``have``, ``credit``, ``sent``, ``_last_srv``), counters, draws consumed,
  the tip trace and every stability value — f32 elementwise IEEE on equal
  inputs, and numpy on the same seeds;
- trained parameters within 1e-4 (twenty iterations of f32 SGD computed by
  two libraries, as in ``tests/test_torch_gossip.py``);
- the tip simulation's statistics: the reference's own assertions (Eq. (4)
  within 15 % at its bench point, and its other bounds).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DagFLConfig as JDagFLConfig
from repro.core import dag as j_dag
from repro.core import stability as j_stab
from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro.kernels import ref as j_ref
from repro.kernels.delta_codec import DeltaCodec as JDeltaCodec
from repro.net import bank as j_bank
from repro.net import events as j_events
from repro.net import gossip as j_gossip
from repro.net import replica as j_replica
from repro.net import topology as j_topo
from repro_torch.configs.base import DagFLConfig
from repro_torch.core import bank as t_store
from repro_torch.core import dag as t_dag
from repro_torch.core import stability as t_stab
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.kernels import cuda_build
from repro_torch.kernels import event_pop as t_pop
from repro_torch.kernels.delta_codec import DeltaCodec
from repro_torch.net import bank as t_bank
from repro_torch.net import events as t_events
from repro_torch.net import gossip as t_gossip
from repro_torch.net import replica as t_replica
from repro_torch.net import topology as t_topo
from test_torch_bank import assert_state_equal
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_gossip import (INT_FIELDS, assert_dags_equal, dag_to_t, reference_draws,
                               reference_edge_draws, seeded_task)

CAP, K = 32, 2
j_pop_ref = jax.jit(j_ref.event_pop_ref)


# ---------------------------------------------------------------------------
# the queue head
# ---------------------------------------------------------------------------


def pop_inputs(rng, q, times):
    """(time, kind, seq, valid) with many ties on time, kind and seq."""
    t = rng.choice(np.asarray(times, np.float32), q).astype(np.float32)
    k = rng.integers(0, 4, q).astype(np.int32)
    s = rng.integers(0, 6, q).astype(np.int32)
    v = rng.random(q) < rng.choice([0.0, 0.3, 0.7, 1.0])
    return t, k, s, v


TIME_SETS = {
    "ties": [0.25, 1.0, 1.5, 7.75],
    "signed_zeros": [-0.0, 0.0, 0.5, -1.0],
    "inf_and_nan": [np.inf, 1.0, np.nan, -np.inf, 1.0],
}


def padded_ref(t, k, s, v, size=70):
    """``ref.event_pop_ref`` of the queue padded with invalid slots to one
    length (one compile): an invalid slot never wins, so the answer is the
    unpadded queue's."""
    pad = size - len(t)
    return j_pop_ref(jnp.asarray(np.pad(t, (0, pad))), jnp.asarray(np.pad(k, (0, pad))),
                     jnp.asarray(np.pad(s, (0, pad))), jnp.asarray(np.pad(v, (0, pad))))


@pytest.mark.parametrize("times", sorted(TIME_SETS))
def test_event_pop_plain_matches_reference(times):
    """Every Q from 1 to 70, three draws each: idx and found bitwise, and the
    head's read back (time bits and kind) as the kernel defines it."""
    rng = np.random.default_rng(sorted(TIME_SETS).index(times))
    for q in range(1, 71):
        for _ in range(3):
            t, k, s, v = pop_inputs(rng, q, TIME_SETS[times])
            ri, rf = padded_ref(t, k, s, v)
            args = tuple(torch.from_numpy(x) for x in (t, k, s, v))
            pi, pf = t_pop.event_pop_plain(*args)
            assert (int(pi), bool(pf)) == (int(ri), bool(rf)), (q, t, k, s, v)
            assert pi.dtype == torch.int32 and pf.dtype == torch.bool
            idx, found, head_t, kind = t_pop.read_head(t_pop.event_head_plain(*args))
            assert (idx, found, kind) == (int(ri), bool(rf), int(k[int(ri)]))
            valid_t = t[v]
            if np.isnan(valid_t).any():
                assert np.isnan(head_t) and idx == 0
            elif not found:
                assert head_t == np.inf
            else:
                assert np.float32(head_t).tobytes() == t[idx].tobytes()
                assert head_t == valid_t.min()


def test_event_pop_edge_cases():
    """The tie rules spelled out: time, then kind, then seq, then index;
    -0.0 ties +0.0; a valid NaN gives slot 0; nothing valid gives (0, False)."""
    f32, i32 = (lambda x: torch.tensor(x, dtype=torch.float32)), \
        (lambda x: torch.tensor(x, dtype=torch.int32))
    t = f32([2.0, 1.0, 1.0, 1.0, 1.0])
    k, s = i32([0, 1, 0, 0, 0]), i32([0, 1, 7, 3, 5])
    v = torch.ones(5, dtype=torch.bool)
    assert [int(x) for x in t_pop.event_pop_plain(t, k, s, v)] == [3, 1]
    v[3] = False
    assert int(t_pop.event_pop_plain(t, k, s, v)[0]) == 4
    assert [int(x) for x in t_pop.event_pop_plain(t, k, s, torch.zeros(5, dtype=torch.bool))] \
        == [0, 0]
    zeros = f32([0.0, -0.0, 1.0])
    assert int(t_pop.event_pop_plain(zeros, i32([1, 0, 0]), i32([0, 1, 2]),
                                     torch.ones(3, dtype=torch.bool))[0]) == 1
    nan = f32([3.0, 1.0, float("nan"), 2.0])
    assert [int(x) for x in t_pop.event_pop_plain(nan, i32([0] * 4), i32([0, 1, 2, 3]),
                                                  torch.ones(4, dtype=torch.bool))] == [0, 1]
    # the dispatcher takes the plain version for CPU tensors and launches nothing
    before = cuda_build.LAUNCHES["event_pop"]
    assert [int(x) for x in t_pop.event_pop(t, k, s, v)] == [4, 1]
    assert cuda_build.LAUNCHES["event_pop"] == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_pop.event_head(t.to("meta"), k.to("meta"), s.to("meta"), v.to("meta"))


def test_event_pop_plain_matches_the_interpreted_pallas_kernel():
    """Against ``event_pop_pallas`` in interpret mode, on NaN-free inputs
    only: the Pallas kernel drops a whole block that holds a valid NaN,
    where the reference (and the port) return slot 0."""
    pallas = importlib.import_module("repro.kernels.event_pop")
    rng = np.random.default_rng(11)
    for q, block_q in ((1, 4), (5, 4), (17, 4), (33, 16), (70, 16), (64, 512)):
        for times in ("ties", "signed_zeros"):
            t, k, s, v = pop_inputs(rng, q, TIME_SETS[times] + [np.inf])
            pi, pf = pallas.event_pop_pallas(jnp.asarray(t), jnp.asarray(k), jnp.asarray(s),
                                             jnp.asarray(v), block_q=block_q)
            ti, tf = t_pop.event_pop_plain(*(torch.from_numpy(x) for x in (t, k, s, v)))
            assert (int(ti), bool(tf)) == (int(pi), bool(pf)), (q, block_q, t, k, s, v)


# ---------------------------------------------------------------------------
# the queue and the stability model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make,args,kw", [
    ("ring", (6,), dict(link_latency=0.5)),
    ("ring", (5,), dict()),
    ("k_regular", (8, 3), dict(link_latency=0.5, latency_jitter=1.0, seed=4)),
    ("erdos_renyi", (9, 0.3), dict(link_latency=3.7, seed=2)),
    ("star", (1,), dict()),
])
def test_queue_matches_reference(make, args, kw):
    jt, tt = getattr(j_topo, make)(*args, **kw), getattr(t_topo, make)(*args, **kw)
    for period in (1.0, 0.25):
        want = j_events.delivery_intervals(jt, period)
        got = t_events.delivery_intervals(tt, period)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        for drain in (False, True):
            jq, jiv = j_events.make_edge_queue(jt, period, drain_slots=drain)
            tq, tiv = t_events.make_edge_queue(tt, period, drain_slots=drain)
            for name in t_events.EventQueue._fields:
                a, b = getattr(tq, name).numpy(), np.asarray(getattr(jq, name))
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
            assert tiv.numpy().tobytes() == np.asarray(jiv).tobytes()


def test_stability_values_match_reference():
    for jcfg, tcfg in ((JDagFLConfig(), DagFLConfig()),
                       (JDagFLConfig(num_nodes=16, k=3, alpha=6, arrival_rate=2.5, beta=2),
                        DagFLConfig(num_nodes=16, k=3, alpha=6, arrival_rate=2.5, beta=2))):
        for f in (1e9, 1.5e9, 2e9):
            for name in ("training_delay", "validation_delay", "iteration_delay",
                         "equilibrium_tips"):
                assert getattr(t_stab, name)(tcfg, f) == getattr(j_stab, name)(jcfg, f), name
        assert t_stab.transmission_delay(tcfg) == j_stab.transmission_delay(jcfg)
        assert t_stab.equilibrium_tips(tcfg) == j_stab.equilibrium_tips(jcfg)
    for tips in (np.zeros(0), np.arange(1.0), np.arange(7.0), np.random.default_rng(0).random(50)):
        for frac in (0.5, 0.1, 1.0):
            a, b = t_stab.tail_mean(tips, frac), j_stab.tail_mean(tips, frac)
            assert a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("seed", [0, 3])
def test_simulate_tip_count_matches_reference(seed):
    cfg = (JDagFLConfig(k=3, alpha=5), DagFLConfig(k=3, alpha=5))
    want = j_stab.simulate_tip_count(cfg[0], horizon=300.0, seed=seed, f=1.2e9)
    got = t_stab.simulate_tip_count(cfg[1], horizon=300.0, seed=seed, f=1.2e9)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.tips, want.tips)
    assert got.tail_mean(0.3) == want.tail_mean(0.3)


# ---------------------------------------------------------------------------
# engine A: GossipNetwork(engine="events") against the reference
# ---------------------------------------------------------------------------


def genesis_j(num_nodes):
    d = j_dag.empty_dag(CAP, K, num_nodes + 1)
    return j_dag.publish(d, jnp.asarray(num_nodes, jnp.int32), jnp.float32(0.0),
                         jnp.full((K,), j_dag.NO_TX, jnp.int32), jnp.float32(0.5),
                         jnp.float32(0.0), jnp.asarray(0, jnp.int32))


class Pair:
    """The same overlay in both packages, the reference's edge draws fed to
    the port; ``publish`` and ``advance`` act on both."""

    def __init__(self, top_args, engine="events", sync_period=1.0, partition=None, seed=0,
                 impl="fused", bank_cfg=None, codec=None, **cfg):
        make, args, kw = top_args
        jtop, ttop = getattr(j_topo, make)(*args, **kw), getattr(t_topo, make)(*args, **kw)
        n = jtop.num_nodes
        jpart = tpart = None
        if partition is not None:
            jpart = j_gossip.PartitionSchedule(*partition)
            tpart = t_gossip.PartitionSchedule(*partition)
        self.seed = seed
        self.j = j_gossip.GossipNetwork(
            genesis_j(n), jnp.zeros((CAP, 8)), jtop,
            j_gossip.GossipConfig(sync_period=sync_period, seed=seed, impl=impl, engine=engine,
                                  **cfg),
            jpart, bank_cfg=None if bank_cfg is None else j_bank.BankGossipConfig(
                **bank_cfg, codec=codec and JDeltaCodec(codec)))
        self.t = t_gossip.GossipNetwork(
            dag_to_t(genesis_j(n)), t_store.init_bank({"w": torch.zeros(8)}, CAP), ttop,
            t_gossip.GossipConfig(sync_period=sync_period, seed=seed, impl=impl, engine=engine,
                                  **cfg),
            tpart, bank_cfg=None if bank_cfg is None else t_bank.BankGossipConfig(
                **bank_cfg, codec=codec and DeltaCodec(codec)),
            edge_draw=reference_edge_draws(seed, n))

    def publish(self, node, seq, t, value=None):
        value = float(seq) if value is None else value
        d = j_replica.publish_local(
            self.j.read(node), seq, jnp.asarray(node, jnp.int32), jnp.float32(t),
            jnp.asarray([seq - 1, j_dag.NO_TX], jnp.int32), jnp.float32(0.5),
            jnp.float32(0.0), jnp.asarray(seq % CAP, jnp.int32))
        self.j.write(node, d)
        d = t_replica.publish_local(
            self.t.read(node), seq, node, torch.tensor(t, dtype=torch.float32),
            torch.tensor([seq - 1, t_dag.NO_TX], dtype=torch.int32), torch.tensor(0.5),
            torch.tensor(0.0), seq % CAP)
        self.t.write(node, d)
        if self.t.bank_cfg is not None:
            self.j.bank_commit(node, seq % CAP, jnp.full((8,), value))
            self.t.bank_commit(node, seq % CAP, {"w": torch.full((8,), value)})

    def advance(self, t):
        self.j.advance(t)
        self.t.advance(t)
        self.compare(f"t={t}: ")

    def converge(self, at_time):
        assert self.t.converge(at_time) == self.j.converge(at_time)
        self.compare("converge: ")

    def compare(self, msg):
        j, t = self.j, self.t
        assert_dags_equal(t.replicas.dags, j.replicas.dags)
        counters = ("tick", "rounds_run", "events_processed", "device_calls", "dispatch_counts")
        assert [getattr(t, c) for c in counters] == [getattr(j, c) for c in counters], msg
        # draws consumed: the reference's key after as many splits as the port drew
        key = jax.random.PRNGKey(self.seed)
        for _ in range(t.edge_draws):
            key, _sub = jax.random.split(key)
        np.testing.assert_array_equal(np.asarray(key), np.asarray(j._key), err_msg=msg + "key")
        if t.cfg.engine == "events":
            for name in ("time", "valid"):
                np.testing.assert_array_equal(getattr(t._equeue, name).numpy(),
                                              np.asarray(getattr(j._equeue, name)),
                                              err_msg=msg + name)
        if t.bank_cfg is not None:
            assert_state_equal(t.bank_state, j.bank_state, msg=msg)
            np.testing.assert_array_equal(t.missing_chunks(), j.missing_chunks(), err_msg=msg)
            assert t.bytes_sent() == j.bytes_sent(), msg
            if t.cfg.engine == "events":
                np.testing.assert_array_equal(t._last_srv.numpy(), np.asarray(j._last_srv),
                                              err_msg=msg + "last_srv")

    def missing_rows(self):
        """How many of the port's replicas lack some row of the union."""
        return int((self.t.missing_rows() > 0).sum())


def test_fast_links_deliver_before_the_tick():
    """A 0.5 s link delivers at 0.5 s; the tick engine waits for the 1 s tick."""
    p = Pair(("ring", (6,), dict(link_latency=0.5)))
    p.publish(0, 1, 0.1)
    p.advance(0.6)
    assert p.missing_rows() == 3                 # the neighbours heard
    p.advance(1.0)                               # second hop at 1.0
    assert p.missing_rows() == 1


def test_slow_links_fire_at_true_cadence():
    """latency 1.5, period 1: deliveries at 1.5, 3.0, 4.5, with losses."""
    p = Pair(("ring", (8,), dict(link_latency=1.5, drop=0.2, seed=4)), seed=9)
    p.publish(0, 1, 0.1)
    for t in (1.4, 1.5, 3.0, 4.5, 7.25):
        p.advance(t)
    p.publish(5, 2, 7.3)
    p.advance(12.0)
    p.converge(12.0)


def test_partition_suppresses_and_heals():
    p = Pair(("full", (6,), dict(link_latency=1.0, drop=0.1)),
             partition=(t_topo.split_halves(6), 0.5, 4.5), seed=2)
    p.publish(0, 1, 0.2)
    p.advance(4.0)                               # every delivery inside the split
    assert p.missing_rows() == 3                 # the far side starved
    p.advance(5.0)                               # healed delivery at t=5
    assert p.t.synced() and p.j.synced()


def test_overflow_window_fast_forwards_like_the_reference():
    """A window longer than max_ticks_per_advance periods elides each edge's
    backlog: same rounds, same draws, same post-window schedule."""
    p = Pair(("ring", (6,), dict(link_latency=1.0, drop=0.3, seed=3)), seed=7)
    p.publish(0, 1, 0.3)
    p.advance(100.0)
    p.publish(2, 2, 100.5)
    for t in (101.0, 104.0, 170.0):
        p.advance(t)


def test_max_events_per_advance_defers_the_rest():
    p = Pair(("k_regular", (6, 3), dict(link_latency=0.5, latency_jitter=1.0, seed=1)),
             seed=4, max_events_per_advance=5)
    p.publish(1, 1, 0.1)
    for t in (3.0, 3.0, 9.0, 9.5):
        p.advance(t)
    assert p.t.events_capped > 0


@pytest.mark.parametrize("impl", ["fused", "scan", "lax"])
def test_degenerate_limit_unit(impl):
    """Uniform delay equal to the period: the port's events run equals the
    reference's events run (and, below, the port's ticks run) for each impl."""
    p = Pair(("ring", (6,), dict(link_latency=1.0, drop=0.3, seed=3)),
             partition=(t_topo.split_halves(6), 2.5, 4.5), seed=7, impl=impl)
    p.publish(0, 1, 0.3)
    for t in (1.0, 2.0, 3.5, 6.0):
        p.advance(t)
        if t == 2.0:
            p.publish(2, 2, 2.1)
    p.converge(10.0)


def bank(**kw):
    return dict(chunks_per_slot=4, **kw)


def test_unlimited_bank():
    p = Pair(("ring", (6,), dict(link_latency=1.0, drop=0.2, seed=1)), seed=3, bank_cfg=bank())
    p.publish(0, 1, 0.3)
    p.publish(4, 2, 0.5)
    for t in (1.0, 3.0, 6.0):
        p.advance(t)


def test_drains_recover_bandwidth():
    """latency 2, period 1, 8 B/s links, 8 B chunks: the event engine
    accrues continuously and drains a chunk every second."""
    p = Pair(("ring", (2,), dict(link_latency=2.0, bandwidth=64.0)), bank_cfg=bank())
    p.publish(0, 1, 0.2)
    for t in (1.0, 2.0, 3.0, 4.0):
        p.advance(t)
    assert int(p.t.missing_chunks()[1]) == 0
    assert p.t.events_processed > 2                     # the drains ran as batches
    assert p.t.edge_draws < p.t.events_processed        # and drew nothing


def test_drain_respects_partition():
    p = Pair(("ring", (2,), dict(link_latency=1.0, bandwidth=64.0)), bank_cfg=bank(),
             partition=(np.asarray([0, 1]), 0.5, 6.5))
    p.publish(0, 1, 0.2)
    p.advance(6.0)
    assert int(p.t.missing_rows()[1]) == 1 and p.t.bytes_sent() == 0.0
    p.advance(12.0)
    assert int(p.t.missing_rows()[1]) == 0 and int(p.t.missing_chunks()[1]) == 0


def test_starved_drains_with_losses_strides_and_converge():
    """Jittered latencies, losses, a partition, 20 B/s links and 8-value
    chunks: drains arm at many distinct instants; then converge."""
    p = Pair(("ring", (6,), dict(link_latency=0.5, latency_jitter=1.0, drop=0.3, seed=2,
                                 bandwidth=160.0)),
             partition=(t_topo.split_halves(6), 3.0, 7.0), seed=5, bank_cfg=bank())
    for seq, (node, t) in enumerate([(0, 0.5), (3, 1.2), (5, 2.7), (1, 3.1), (4, 4.0),
                                     (2, 6.5), (0, 9.9), (5, 11.0)], start=1):
        p.publish(node, seq, t, value=float(seq % 3))      # equal payloads dedup
        p.advance(t)
    p.converge(12.0)


def test_drain_rearm_makes_strict_progress():
    """The reference's livelock regression, without serving: irregular
    accrual windows over 10 Mbit/s links with 7 MB slots put completions
    within f32 rounding of chunk boundaries; with the re-arm clamped to the
    next f32 instant no advance leaves a valid due event behind."""
    p = Pair(("ring", (6,), dict(bandwidth=1e7)),
             bank_cfg=bank(slot_bytes=7e6))
    t = 0.0
    for k in range(12):
        p.publish(k % 6, 1 + k, t, value=1.0 + 0.37 * k)
        t += 0.937
        p.advance(t)
        qt, qv = p.t._equeue.time.numpy(), p.t._equeue.valid.numpy()
        assert not (qv & (qt <= np.float32(t))).any(), t
    assert p.t.events_processed > p.t.edge_draws


def test_int8_codec_drains():
    """With the int8 codec a chunk costs its encoded size: the drains arm at
    the f32 product ``chunk_bytes * wire_ratio()``."""
    p = Pair(("ring", (4,), dict(link_latency=1.0, bandwidth=40.0)), seed=1, bank_cfg=bank(),
             codec="int8")
    assert p.t._wire_chunk_bytes != p.t._chunk_bytes
    p.publish(0, 1, 0.2)
    p.publish(2, 2, 1.7)
    for t in (1.0, 2.0, 3.5, 5.0, 8.0):
        p.advance(t)
    assert p.t.events_processed > p.t.edge_draws     # some batches were drains only


# ---------------------------------------------------------------------------
# the degenerate limit inside the port: events == ticks
# ---------------------------------------------------------------------------


def port_net(top, engine, partition, seed, impl="fused", bank_cfg=None):
    return t_gossip.GossipNetwork(
        dag_to_t(genesis_j(top.num_nodes)), t_store.init_bank({"w": torch.zeros(8)}, CAP), top,
        t_gossip.GossipConfig(sync_period=1.0, seed=seed, impl=impl, engine=engine),
        partition, bank_cfg=bank_cfg)


@pytest.mark.parametrize("overlay", ["ring", "er", "star", "full"])
@pytest.mark.parametrize("split", [False, True])
def test_degenerate_limit_events_equal_ticks(overlay, split):
    """A property over overlays, losses, partitions and publishes, a few
    fixed examples: with every delay equal to the period the events engine
    is bitwise the ticks engine (the default torch draws on both)."""
    n = 8
    seed = ["ring", "er", "star", "full"].index(overlay) * 2 + split
    rng = np.random.default_rng(seed)
    drop = float(rng.choice([0.0, 0.3]))
    top = {
        "ring": lambda: t_topo.ring(n, link_latency=1.0, drop=drop, seed=seed),
        "er": lambda: t_topo.erdos_renyi(n, 0.4, link_latency=1.0, drop=drop, seed=seed),
        "star": lambda: t_topo.star(n, link_latency=1.0, drop=drop),
        "full": lambda: t_topo.full(n, link_latency=1.0, drop=drop),
    }[overlay]()
    part = t_gossip.PartitionSchedule(t_topo.split_halves(n), 1.5, 3.5) if split else None
    bank_cfg = t_bank.BankGossipConfig(chunks_per_slot=4) if seed % 3 == 0 else None
    a, b = (port_net(top, engine, part, seed, bank_cfg=bank_cfg) for engine in ("ticks", "events"))
    for net in (a, b):
        for seq in range(1, 4):
            node = int(np.random.default_rng([seed, seq]).integers(0, n))
            d = t_replica.publish_local(
                net.read(node), seq, node, torch.tensor(0.1 * seq, dtype=torch.float32),
                torch.full((K,), t_dag.NO_TX, dtype=torch.int32), torch.tensor(0.5),
                torch.tensor(0.0), seq)
            net.write(node, d)
            net.bank_commit(node, seq, {"w": torch.full((8,), float(seq))})
    for t in (1.0, 2.5, 5.0, 80.0):
        a.advance(t)
        b.advance(t)
        assert_dags_equal(b.replicas.dags, a.replicas.dags)
        assert (b.rounds_run, b.edge_draws) == (a.rounds_run, a.edge_draws)
        # past the 64-period cap the ticks engine fast-forwards its tick, the
        # events engine counts batches (``tick += done``), as the reference's do
        assert b.tick == a.tick or t == 80.0
        if bank_cfg is not None:
            for name in ("have", "credit", "sent"):
                assert torch.equal(getattr(b.bank_state, name), getattr(a.bank_state, name))
    assert a.converge(90.0) == b.converge(90.0)
    assert_dags_equal(b.replicas.dags, a.replicas.dags)
    assert b.edge_draws == a.edge_draws and b.events_processed > 0


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def run_pair(n, topology, gseed=3, bank_cfg=None, partition=None, iterations=20):
    seed = 0
    jt, jn, jg, _ = j_exp.make_cnn_setup(num_nodes=n, seed=seed)
    _, tn, tg, _ = t_exp.make_cnn_setup(num_nodes=n, seed=seed)
    jd, td = j_exp.default_dagfl_config(n), t_exp.default_dagfl_config(n)
    make, args, kw = topology
    rj = j_sys.run_dagfl_gossip(
        jt, jn, jd, j_sys.SimConfig(iterations=iterations, eval_every=5, seed=seed), jg,
        topology=getattr(j_topo, make)(*args, **kw),
        gossip=j_gossip.GossipConfig(sync_period=1.0, seed=gseed), engine="events",
        partition=None if partition is None else j_gossip.PartitionSchedule(*partition),
        bank_gossip=None if bank_cfg is None else j_bank.BankGossipConfig(**bank_cfg))
    rt = t_sys.run_dagfl_gossip(
        seeded_task(jt, seed), tn, td,
        t_sys.SimConfig(iterations=iterations, eval_every=5, seed=seed), tg,
        topology=getattr(t_topo, make)(*args, **kw),
        gossip=t_gossip.GossipConfig(sync_period=1.0, seed=gseed), engine="events",
        partition=None if partition is None else t_gossip.PartitionSchedule(*partition),
        bank_gossip=None if bank_cfg is None else t_bank.BankGossipConfig(**bank_cfg),
        device="cpu", draw=reference_draws(seed, td.capacity),
        edge_draw=reference_edge_draws(gseed, n))
    assert rt.avg_latency == rj.avg_latency
    for name in ("iters", "times", "accs"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name), err_msg=name)
    assert_dags_equal(rt.extras["dag"], rj.extras["dag"], INT_FIELDS + ("publish_time",))
    assert_dags_equal(rt.extras["replicas"].dags, rj.extras["replicas"].dags,
                      INT_FIELDS + ("publish_time",))
    for key in ("divergence_curve", "missing_rows_final"):
        np.testing.assert_array_equal(rt.extras[key], np.asarray(rj.extras[key]), err_msg=key)
    for key in ("sync_rounds", "events_processed", "device_calls", "dispatch_counts",
                "approvals_issued", "approvals_in_union", "synced_final"):
        assert rt.extras[key] == rj.extras[key], key
    for k in rj.final_params:
        np.testing.assert_allclose(rt.final_params[k].numpy(), np.asarray(rj.final_params[k]),
                                   atol=1e-4, rtol=0)
    return rt, rj


def test_run_dagfl_gossip_events_matches_reference():
    """A lossy ring with jittered latencies and a partition that heals: the
    curve, every integer column of the union and each replica, the counters
    bitwise; parameters within 1e-4."""
    n = 8
    rt, _ = run_pair(n, ("ring", (n,), dict(link_latency=0.5, latency_jitter=1.0, drop=0.3)),
                     partition=(t_topo.split_halves(n), 5.0, 12.0))
    assert rt.extras["events_processed"] > rt.extras["checks"]


def test_run_dagfl_gossip_events_bank_matches_reference():
    """The same ring starved (10 Mbit/s, 7 MB models): drains arm, rows wait
    for their payload, and the transport state, lag and bill agree bitwise."""
    n = 8
    rt, rj = run_pair(n, ("ring", (n,), dict(link_latency=0.5, latency_jitter=1.0, drop=0.3,
                                             bandwidth=1e7)),
                      bank_cfg=dict(chunks_per_slot=4, slot_bytes=7e6), iterations=15)
    assert_state_equal(rt.extras["replicas"].bank_state, rj.extras["replicas"].bank_state)
    for key in ("bank_lag_curve", "bank_missing_final"):
        np.testing.assert_array_equal(rt.extras[key], np.asarray(rj.extras[key]), err_msg=key)
    assert rt.extras["bank_bytes_sent"] == rj.extras["bank_bytes_sent"]
    assert rt.extras["bank_lag_curve"][:, 2].max() > 0


# ---------------------------------------------------------------------------
# engine B: the §IV in-system simulation
# ---------------------------------------------------------------------------


def reference_tip_draws(seed, n, cap):
    """The reference's draws in its key chain: the first arrival from
    ``split(key)``, each START from ``split(key, 4)`` (node, tips, gap),
    each delivery batch from ``split(key)``. Jitted, as the reference's
    loop draws them."""

    @jax.jit
    def start(key):
        key, kn, ks, ka = jax.random.split(key, 4)
        return (key, jax.random.randint(kn, (), 0, n),
                jax.random.uniform(ks, (cap,), minval=1e-9, maxval=1.0),
                jax.random.exponential(ka))

    @jax.jit
    def first(key):
        key, sub = jax.random.split(key)
        return key, jax.random.exponential(sub)

    @jax.jit
    def edges(key):
        key, sub = jax.random.split(key)
        return key, jax.random.uniform(sub, (n, n))

    key = [jax.random.PRNGKey(seed)]
    calls = []

    def draw(what, index):
        assert index == len(calls)
        calls.append(what)
        key[0], *out = {"start": start, "first": first, "edges": edges}[what](key[0])
        out = [torch.from_numpy(np.array(x)) for x in out]
        return tuple(out) if what == "start" else out[0]

    return draw


@pytest.mark.parametrize("case", ["ring_partition", "overflow"])
def test_insystem_tips_match_reference(case):
    """Small runs with the reference's draws: the trace, the counts and the
    union bitwise. ``overflow``: two pending slots against long iterations,
    so START finds no free slot and pending slots recycle."""
    if case == "ring_partition":
        top_args = ("ring", (5,), dict(link_latency=0.75, latency_jitter=0.5, drop=0.2, seed=1))
        kw = dict(h=np.asarray([1.0, 2.5, 0.5, 1.5, 3.0], np.float32), arrival_rate=1.5, k=2,
                  tau_max=20.0, horizon=25.0, capacity=CAP, seed=3, sync_period=0.5,
                  partition=(t_topo.split_halves(5), 6.0, 12.0))
    else:
        top_args = ("full", (4,), dict())
        kw = dict(h=6.0, arrival_rate=2.0, k=2, tau_max=20.0, horizon=20.0, capacity=CAP,
                  seed=5, sync_period=1.0, max_pending=2, trace_cap=16)
    make, args, tkw = top_args
    part = kw.pop("partition", None)
    want = j_events.simulate_insystem_tips(
        getattr(j_topo, make)(*args, **tkw),
        partition=None if part is None else j_gossip.PartitionSchedule(*part), **kw)
    got = t_events.simulate_insystem_tips(
        getattr(t_topo, make)(*args, **tkw),
        partition=None if part is None else t_gossip.PartitionSchedule(*part), device="cpu",
        draw=reference_tip_draws(kw["seed"], args[0], CAP), **kw)
    for name in ("times", "tips", "staleness"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.published, got.overflow) == (want.published, want.overflow)
    assert_dags_equal(got.union, want.union)
    if case == "overflow":
        assert got.overflow > 0 and got.published > 2


def test_insystem_tips_match_eq4_on_bench_point():
    """The reference's acceptance: the in-system tail mean within 15 % of
    Eq. (4) on a well-connected overlay, delivery intervals well under h.

    The reference's own run: its seed-0 draws fed to the port. One seed's
    tail mean spreads by about 10 % around Eq. (4) (the reference's seeds
    0-7 give 3.84 to 5.10 against 4.16; its seed 1 misses 15 %), so the
    default draws are held to this bound over several seeds, on the card
    (``chip_smoke.py``)."""
    cfg = DagFLConfig(num_nodes=16, alpha=5, k=2)
    f = 1.5e9
    pred = t_stab.equilibrium_tips(cfg, f)
    trace = t_events.simulate_insystem_tips(
        t_topo.full(16), h=t_stab.iteration_delay(cfg, f), arrival_rate=cfg.arrival_rate,
        k=cfg.k, tau_max=cfg.tau_max, horizon=600.0, capacity=256, seed=0, sync_period=0.25,
        device="cpu", draw=reference_tip_draws(0, 16, 256))
    assert trace.overflow == 0
    assert trace.published > 400                  # lambda = 1 over 600 s
    assert trace.tail_mean(0.5) == pytest.approx(pred, rel=0.15), (trace.tail_mean(0.5), pred)


def test_insystem_tips_scale_with_h():
    kw = dict(arrival_rate=1.0, k=2, tau_max=60.0, horizon=250.0, capacity=256, seed=1,
              sync_period=0.25, device="cpu")
    lo = t_events.simulate_insystem_tips(t_topo.full(8), h=1.0, **kw)
    hi = t_events.simulate_insystem_tips(t_topo.full(8), h=4.0, **kw)
    assert hi.tail_mean(0.5) > 1.8 * lo.tail_mean(0.5)


def test_insystem_slow_gossip_inflates_tips():
    kw = dict(h=2.0, arrival_rate=1.0, k=2, tau_max=60.0, horizon=300.0, capacity=256, seed=0,
              device="cpu")
    fast = t_events.simulate_insystem_tips(t_topo.full(8), sync_period=0.1, **kw)
    slow = t_events.simulate_insystem_tips(t_topo.ring(8, link_latency=4.0), sync_period=4.0,
                                           **kw)
    assert slow.staleness.max() > fast.staleness.max()
    assert slow.tail_mean(0.5) > fast.tail_mean(0.5)


def test_insystem_per_node_h_and_counters():
    h = np.asarray([0.5] * 6 + [6.0, 6.0], np.float32)   # two stragglers
    trace = t_events.simulate_insystem_tips(
        t_topo.k_regular(8, 4), h=h, arrival_rate=1.0, k=2, tau_max=60.0, horizon=200.0,
        capacity=256, seed=2, sync_period=0.5, device="cpu")
    pub = trace.union.published_per_node.numpy()
    assert trace.overflow == 0
    assert int(pub[:8].sum()) == trace.published
    assert (pub[:8] > 0).all()


def test_insystem_trace_empty_tail_mean_is_nan_and_telemetry_raises():
    """An empty trace's tail mean is NaN, and its export raises without the
    union ledger it reads the node count from; with one, a short traced run
    exports (its parity with the reference is in ``tests/test_torch_obs.py``)."""
    tr = t_events.InSystemTrace(times=np.zeros(0), tips=np.zeros(0), staleness=np.zeros(0),
                                published=0, overflow=0, union=None)
    assert np.isnan(tr.tail_mean())
    with pytest.raises(ValueError, match="union"):
        tr.to_report()
    run = t_events.simulate_insystem_tips(t_topo.full(3), h=1.0, arrival_rate=1.0, k=2,
                                          tau_max=20.0, horizon=5.0, record_trace=True,
                                          device="cpu")
    rep = run.to_report()
    assert rep.num_nodes == 3 and rep.samples == len(run.times) and rep.trace_dropped == 0
