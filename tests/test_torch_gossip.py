"""The port's gossip overlay against the reference: topology, merge, winner
reduction, rounds, the tick clock and a whole ``run_dagfl_gossip``.

The same numpy-made inputs go to both packages. The JAX side runs as its own
tests run it: the lax oracle ``ref.gossip_winner_ref`` and the Pallas kernel
in interpret mode. The reference's threefry edge draws (``key_{n+1}, sub_n =
split(key_n)``, ``uniform(sub_n, (N, N))`` for the n-th executed round) are
made with JAX and fed to the port through ``edge_draw``, so every round must
sample the same edges. Everything that is an index, a mask, a time or an
integer ledger column must match bitwise; trained parameters within 1e-4
(twenty iterations of f32 SGD computed by two libraries, as in
``tests/test_torch_system.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dag as j_dag
from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro.kernels import gossip_merge as j_gm
from repro.kernels import ref as j_ref
from repro.net import gossip as j_gossip
from repro.net import replica as j_replica
from repro.net import topology as j_topo
from repro_torch.core import bank as t_bank
from repro_torch.core import dag as t_dag
from repro_torch.core.consensus import Prepared
from repro_torch.core.controller import Controller
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.fl import tasks as t_tasks
from repro_torch.kernels import gossip_merge as t_gm
from repro_torch.kernels.delta_codec import DeltaCodec
from repro_torch.net import gossip as t_gossip
from repro_torch.net.bank import BankGossipConfig
from repro_torch.net import replica as t_replica
from repro_torch.net import topology as t_topo
from repro_torch.obs import HistConfig, ObsConfig

FIELDS = t_dag.DagState._fields
# the reference's functions, jitted: one compile per shape instead of one per primitive
j_winner_ref = jax.jit(j_ref.gossip_winner_ref)
j_winner_nbr = jax.jit(j_gm.gossip_winner_nbr)
j_merge = jax.jit(j_dag.merge)
j_merge_select = jax.jit(j_dag.merge_select)
j_row_winner = jax.jit(j_dag.row_winner)
INT_FIELDS = ("publisher", "approvals", "approvers", "approval_count", "model_slot", "count",
              "published_per_node", "contributing_m0", "contributing_m1")


def to_t(x):
    return torch.from_numpy(np.array(x))


def dag_to_t(jd) -> t_dag.DagState:
    return t_dag.DagState(**{f: to_t(getattr(jd, f)) for f in FIELDS})


def assert_dags_equal(td, jd, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)),
                                      err_msg=f)


def random_stacked(rng, r, cap=16, num_nodes=8, k=2) -> j_dag.DagState:
    """Random stacked replicas that ``publish`` cannot reach: one key may
    carry different payloads on different replicas, so the tie-break order
    is pinned, not just the CRDT happy path."""
    pub = rng.integers(-1, num_nodes, (r, cap)).astype(np.int32)
    t = np.where(pub >= 0, rng.integers(0, 4, (r, cap)) * 0.5, 0.0)
    approvers = (rng.random((r, cap, num_nodes)) < 0.3) & (pub[..., None] >= 0)
    return j_dag.DagState(
        publisher=jnp.asarray(pub),
        publish_time=jnp.asarray(t, jnp.float32),
        approvals=jnp.asarray(rng.integers(-1, cap, (r, cap, k)), jnp.int32),
        approvers=jnp.asarray(approvers),
        approval_count=jnp.asarray(approvers.sum(-1), jnp.int32),
        accuracy=jnp.asarray(rng.random((r, cap)), jnp.float32),
        auth_tag=jnp.asarray(rng.random((r, cap)), jnp.float32),
        model_slot=jnp.asarray(rng.integers(-1, cap, (r, cap)), jnp.int32),
        count=jnp.asarray(rng.integers(0, 3 * cap, (r,)), jnp.int32),
        published_per_node=jnp.asarray(rng.integers(0, 5, (r, num_nodes)), jnp.int32),
        contributing_m0=jnp.asarray(rng.integers(0, 5, (r, num_nodes)), jnp.int32),
        contributing_m1=jnp.asarray(rng.integers(0, 5, (r, num_nodes)), jnp.int32),
    )


def reference_edge_draws(seed, n):
    """The reference's per-round edge uniforms, in round order."""
    cache, key = [], [jax.random.PRNGKey(seed)]

    def draw(round_index):
        while len(cache) <= round_index:
            key[0], sub = jax.random.split(key[0])
            cache.append(np.array(jax.random.uniform(sub, (n, n))))
        return torch.from_numpy(cache[round_index])

    return draw


def reference_draws(seed, cap):
    """The reference's tip-selection uniforms: prepare i from
    split(PRNGKey(seed*100003+i))[0], check from PRNGKey(done)."""

    def draw(stream, index):
        if stream == "prepare":
            key = jax.random.split(jax.random.PRNGKey(seed * 100003 + index))[0]
        else:
            key = jax.random.PRNGKey(index)
        return to_t(jax.random.uniform(key, (cap,), minval=1e-9, maxval=1.0))

    return draw


def seeded_task(jtask, seed):
    """The port's task, started from the reference's initial parameters."""
    params0 = {k: np.asarray(v) for k, v in jtask.init(jax.random.PRNGKey(seed)).items()}

    class Seeded(t_tasks.CNNTask):
        def init(self, seed=0, device="cuda"):
            return t_tasks.params_from_jax(params0, device)

    return Seeded(**{f: getattr(jtask, f) for f in jtask.__dataclass_fields__})


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make,args,kw", [
    ("ring", (7,), dict(link_latency=1.5, latency_jitter=0.4, drop=0.3, seed=2)),
    ("k_regular", (8, 3), dict(link_latency=0.5, latency_jitter=1.0, seed=5, bandwidth=1e6)),
    ("erdos_renyi", (12, 0.3), dict(latency_jitter=2.0, drop=0.1, seed=7)),
    ("star", (6,), dict(hub=2, link_latency=0.2, latency_jitter=0.1, seed=1)),
    ("full", (5,), dict(drop=0.05, seed=3, bandwidth=100e6)),
])
def test_topology_constructors_match(make, args, kw):
    jt = getattr(j_topo, make)(*args, **kw)
    tt = getattr(t_topo, make)(*args, **kw)
    for name in ("adjacency", "latency", "drop", "bandwidth"):
        a, b = getattr(tt, name), np.asarray(getattr(jt, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(tt.degree(), jt.degree())
    for got, want in zip(t_topo.neighbor_table(tt.adjacency), j_topo.neighbor_table(jt.adjacency)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_topo.components(tt.adjacency), j_topo.components(jt.adjacency))
    assert t_topo.is_connected(tt.adjacency) == j_topo.is_connected(jt.adjacency)
    for period in (0.5, 1.0, 3.0):
        assert t_topo.path_latency_bound(tt, period) == j_topo.path_latency_bound(jt, period)
        np.testing.assert_array_equal(t_gossip.stride_matrix(tt, period),
                                      j_gossip.stride_matrix(jt, period))


def test_partition_helpers_match():
    for n in (1, 6, 9):
        np.testing.assert_array_equal(t_topo.split_halves(n), j_topo.split_halves(n))
        for seed in (0, 4):
            a, b = t_topo.split_random(n, 3, seed), j_topo.split_random(n, 3, seed)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(t_topo.partition_matrix(a), j_topo.partition_matrix(b))
    assert t_topo.TABLE1_LINK_CLASSES == j_topo.TABLE1_LINK_CLASSES


# ---------------------------------------------------------------------------
# the winner reduction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,rr,cap,offset", [
    (9, 9, 16, None),        # identity block
    (9, 1, 300, None),       # the union fold's shape; cap not a multiple of 256
    (12, 4, 257, 5),         # a receiver block at row_offset 5
    (5, 5, 3, None),
    (6, 6, 40, 0),
])
def test_gossip_winner_matches_reference(r, rr, cap, offset):
    rng = np.random.default_rng(r * 1000 + cap)
    pub = rng.integers(-1, 3, (r, cap)).astype(np.int32)        # few publishers: key ties
    pub[:, ::7] = -1                                             # rows nobody holds
    t = (rng.integers(0, 3, (r, cap)) * 0.5).astype(np.float32)  # equal times, other publishers
    ac = rng.integers(0, 5, (r, cap)).astype(np.int32)
    for density in (0.0, 0.4, 1.0):
        mask = rng.random((rr, r)) < density
        row_ids = None if offset is None else jnp.arange(rr, dtype=jnp.int32) + offset
        j_args = (jnp.asarray(t), jnp.asarray(pub), jnp.asarray(ac), jnp.asarray(mask))
        want = j_winner_ref(*j_args, row_ids=row_ids)
        pallas = j_gm.gossip_winner_pallas(*j_args, interpret=True,
                                           row_offset=0 if offset is None else offset)
        got = t_gm.gossip_winner(to_t(t), to_t(pub), to_t(ac), to_t(mask), row_offset=offset)
        for g, w, p in zip(got, want, pallas):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), np.asarray(p))

        # the neighbour-list form: candidates = the mask's admitted senders + self
        ids = np.arange(rr) + (offset or 0)
        full = mask.copy()
        full[np.arange(rr), ids] = True
        nbr = np.argsort(~full, axis=1, kind="stable").astype(np.int32)
        act = np.take_along_axis(full, nbr, axis=1)
        identity = offset is None and rr == r          # row_ids=None: receiver i is sender i
        j_rows = None if identity else jnp.asarray(ids, jnp.int32)
        t_rows = None if identity else to_t(ids.astype(np.int32))
        want_nbr = j_winner_nbr(*j_args[:3], jnp.asarray(nbr), jnp.asarray(act),
                                          row_ids=j_rows)
        got_nbr = t_gm.gossip_winner_nbr(to_t(t), to_t(pub), to_t(ac), to_t(nbr), to_t(act),
                                         row_ids=t_rows)
        for g, w, d in zip(got_nbr, want_nbr, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), np.asarray(d))


def test_gossip_winner_edge_values():
    """NaN, -inf, -0.0 times and negative counters, where max and == are
    subtle: the plain version is the reference's arithmetic."""
    rng = np.random.default_rng(3)
    r, cap = 4, 64
    pub = rng.integers(-1, 2, (r, cap)).astype(np.int32)
    t = rng.choice(np.array([np.nan, -np.inf, -0.0, 0.0, 1.0], np.float32), (r, cap))
    ac = rng.integers(-2, 3, (r, cap)).astype(np.int32)
    mask = rng.random((r, r)) < 0.6
    want = j_winner_ref(jnp.asarray(t), jnp.asarray(pub), jnp.asarray(ac), jnp.asarray(mask))
    got = t_gm.gossip_winner(to_t(t), to_t(pub), to_t(ac), to_t(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def test_row_winner_merge_and_merge_select_match():
    rng = np.random.default_rng(0)
    r = 7
    jd = random_stacked(rng, r)
    td = dag_to_t(jd)
    for i, j in [(0, 1), (3, 3), (6, 2), (4, 5)]:
        ja, jb = (jax.tree_util.tree_map(lambda x: x[k], jd) for k in (i, j))
        ta, tb = (t_dag.DagState(*(x[k] for x in td)) for k in (i, j))
        for g, w in zip(t_dag.row_winner((ta.publish_time, ta.publisher),
                                         (tb.publish_time, tb.publisher)),
                        j_row_winner((ja.publish_time, ja.publisher),
                                     (jb.publish_time, jb.publisher))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert_dags_equal(t_dag.merge(ta, tb), j_merge(ja, jb))
    # a sender broadcast into every receiver of the stack at once
    merge_into_all = jax.jit(jax.vmap(j_dag.merge, in_axes=(0, None)))
    for j in range(r):
        want = merge_into_all(jd, jax.tree_util.tree_map(lambda x: x[j], jd))
        assert_dags_equal(t_dag.merge(td, t_dag.DagState(*(x[j] for x in td))), want)

    for density in (0.0, 0.5, 1.0):
        mask = rng.random((r, r)) < density
        mask[np.arange(r), np.arange(r)] = True
        src, _ = j_winner_ref(jd.publish_time, jd.publisher, jd.approval_count,
                              jnp.asarray(mask))
        want = j_merge_select(jd, src, mask=jnp.asarray(mask))
        assert_dags_equal(t_dag.merge_select(td, to_t(src), mask=to_t(mask)), want)
        nbr = np.argsort(~mask, axis=1, kind="stable").astype(np.int32)
        act = np.take_along_axis(mask, nbr, axis=1)
        want_nbr = j_merge_select(jd, src, nbr_idx=jnp.asarray(nbr), nbr_act=jnp.asarray(act))
        got_nbr = t_dag.merge_select(td, to_t(src), nbr_idx=to_t(nbr), nbr_act=to_t(act))
        assert_dags_equal(got_nbr, want_nbr)
        assert_dags_equal(got_nbr, want)


def test_replica_functions_match():
    rng = np.random.default_rng(1)
    jd = random_stacked(rng, 6)
    td = dag_to_t(jd)
    assert_dags_equal(t_replica.merge_all(td), j_replica.merge_all_jit(jd))
    np.testing.assert_array_equal(t_replica.missing_vs_union(td).numpy(),
                                  np.asarray(j_replica.missing_vs_union_jit(jd)))
    np.testing.assert_array_equal(t_replica.missing_vs_peer(td).numpy(),
                                  np.asarray(j_replica.missing_vs_peer(jd)))
    assert bool(t_replica.replicas_synced(td)) == bool(j_replica.replicas_synced_jit(jd))
    one = jax.tree_util.tree_map(lambda x: x[2], jd)
    same = t_replica.stack(dag_to_t(one), 4)
    assert bool(t_replica.replicas_synced(same))
    assert_dags_equal(t_replica.merge_all(same), one)
    assert bool(j_replica.replicas_synced_jit(
        jax.tree_util.tree_map(lambda x: jnp.repeat(x[None], 4, axis=0), one)))
    for seq in (0, 5, 40):
        for g, w in zip(t_replica.global_row(dag_to_t(one), seq), j_replica.global_row(one, seq)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# one round, and the tick clock
# ---------------------------------------------------------------------------


def test_one_round_matches_reference_for_every_impl():
    rng = np.random.default_rng(2)
    r = 9
    j_scan = j_gossip.make_gossip_round("scan")
    j_pallas = j_gossip.make_gossip_round("pallas")
    t_rounds = {impl: t_gossip.make_gossip_round(impl) for impl in ("fused", "scan", "lax")}
    masks = [np.zeros((r, r), bool), ~np.eye(r, dtype=bool), np.triu(np.ones((r, r), bool), 1)]
    masks += [rng.random((r, r)) < 0.4 for _ in range(3)]
    for edges in masks:
        jd = random_stacked(rng, r)
        want = j_scan(jd, jnp.asarray(edges))
        assert_dags_equal(dag_to_t(j_pallas(jd, jnp.asarray(edges))), want)
        for impl, fn in t_rounds.items():
            assert_dags_equal(fn(dag_to_t(jd), to_t(edges)), want)


CAP, K = 32, 2


def _genesis(num_nodes):
    d = j_dag.empty_dag(CAP, K, num_nodes + 1)
    return j_dag.publish(d, jnp.asarray(num_nodes, jnp.int32), jnp.float32(0.0),
                         jnp.full((K,), j_dag.NO_TX, jnp.int32), jnp.float32(0.5),
                         jnp.float32(0.0), jnp.asarray(0, jnp.int32))


def _publish_j(net, node, seq, t):
    d = j_replica.publish_local(
        net.read(node), seq, jnp.asarray(node, jnp.int32), jnp.float32(t),
        jnp.asarray([seq - 1, j_dag.NO_TX], jnp.int32), jnp.float32(0.5), jnp.float32(0.0),
        jnp.asarray(seq % CAP, jnp.int32))
    net.write(node, d)


def _publish_t(net, node, seq, t):
    d = t_replica.publish_local(
        net.read(node), seq, node, torch.tensor(t, dtype=torch.float32),
        torch.tensor([seq - 1, t_dag.NO_TX], dtype=torch.int32), torch.tensor(0.5),
        torch.tensor(0.0), seq % CAP)
    net.write(node, d)


# node, time: publish on node at time, then advance the clock to time;
# 9.9 overflows max_ticks_per_advance (fast-forward), the partition holds [3, 7)
SCHEDULE = [(0, 0.5), (3, 1.2), (5, 2.7), (1, 3.1), (4, 4.0), (2, 6.5), (0, 9.9), (5, 11.0)]


def _reference_clock(impl):
    """The reference network's state after each step of SCHEDULE, then a
    tick, then converge."""
    n = 6
    top = j_topo.ring(n, link_latency=1.5, drop=0.3, seed=0)
    net = j_gossip.GossipNetwork(
        _genesis(n), jnp.zeros((CAP, 4)), top,
        j_gossip.GossipConfig(sync_period=1.0, seed=5, max_ticks_per_advance=3, impl=impl),
        j_gossip.PartitionSchedule(j_topo.split_halves(n), 3.0, 7.0))
    steps = []

    def record():   # copies: the reference donates its replica buffers to each write
        steps.append((jax.tree_util.tree_map(np.array, net.replicas.dags), net.tick,
                      net.rounds_run, net.device_calls, dict(net.dispatch_counts)))

    for seq, (node, t) in enumerate(SCHEDULE, start=1):
        _publish_j(net, node, seq, t)
        net.advance(t)
        record()
    net._tick_once(12.0)
    record()
    synced = net.converge()
    record()
    return steps, synced, np.asarray(net.missing_rows())


@pytest.fixture(scope="module")
def reference_clock():
    return functools.lru_cache(maxsize=None)(_reference_clock)


@pytest.mark.parametrize("impl", ["fused", "scan", "lax"])
def test_advance_and_converge_match_reference(reference_clock, impl):
    """Each port impl against the reference impl of its family. The
    schedule approves rows a replica has not received yet, which leaves
    approver bits on empty rows: the sequential fold keeps them, the fused
    union drops them (no candidate holds an identity there), and the
    reference's two impls differ on exactly that mid-run."""
    steps, synced, missing = reference_clock("scan" if impl == "scan" else "fused")
    n = 6
    top = t_topo.ring(n, link_latency=1.5, drop=0.3, seed=0)
    net = t_gossip.GossipNetwork(
        dag_to_t(_genesis(n)), None, top,
        t_gossip.GossipConfig(sync_period=1.0, seed=5, max_ticks_per_advance=3, impl=impl),
        t_gossip.PartitionSchedule(t_topo.split_halves(n), 3.0, 7.0),
        edge_draw=reference_edge_draws(5, n))
    got = []

    def record():   # copies: the port writes its replicas in place
        got.append((t_replica.snapshot(net.replicas.dags), net.tick, net.rounds_run,
                    net.device_calls,
                    dict(net.dispatch_counts)))

    for seq, (node, t) in enumerate(SCHEDULE, start=1):
        _publish_t(net, node, seq, t)
        net.advance(t)
        record()
    net._tick_once(12.0)
    record()
    assert net.converge() == synced
    record()
    assert len(got) == len(steps)
    for (dags, *counters), (j_dags, *j_counters) in zip(got, steps):
        assert_dags_equal(dags, j_dags)
        assert counters == j_counters
    assert net.synced() == synced
    np.testing.assert_array_equal(net.missing_rows(), missing)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def test_run_dagfl_gossip_matches_reference():
    n, seed, gseed = 8, 0, 3
    jt, jn, jg, _ = j_exp.make_cnn_setup(num_nodes=n, seed=seed)
    _, tn, tg, _ = t_exp.make_cnn_setup(num_nodes=n, seed=seed)
    jd, td = j_exp.default_dagfl_config(n), t_exp.default_dagfl_config(n)
    rj = j_sys.run_dagfl_gossip(
        jt, jn, jd, j_sys.SimConfig(iterations=20, eval_every=5, seed=seed), jg,
        topology=j_topo.ring(n, link_latency=1.5, drop=0.3),
        gossip=j_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        partition=j_gossip.PartitionSchedule(j_topo.split_halves(n), 5.0, 12.0))
    rt = t_sys.run_dagfl_gossip(
        seeded_task(jt, seed), tn, td, t_sys.SimConfig(iterations=20, eval_every=5, seed=seed),
        tg, topology=t_topo.ring(n, link_latency=1.5, drop=0.3),
        gossip=t_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        partition=t_gossip.PartitionSchedule(t_topo.split_halves(n), 5.0, 12.0),
        device="cpu", draw=reference_draws(seed, td.capacity),
        edge_draw=reference_edge_draws(gseed, n))
    assert rt.system == rj.system == "dagfl_gossip"
    assert rt.avg_latency == rj.avg_latency
    for name in ("iters", "times", "accs"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name), err_msg=name)
    assert_dags_equal(rt.extras["dag"], rj.extras["dag"], INT_FIELDS + ("publish_time",))
    assert_dags_equal(rt.extras["replicas"].dags, rj.extras["replicas"].dags,
                      INT_FIELDS + ("publish_time",))
    np.testing.assert_array_equal(rt.extras["divergence_curve"], rj.extras["divergence_curve"])
    np.testing.assert_array_equal(rt.extras["missing_rows_final"],
                                  np.asarray(rj.extras["missing_rows_final"]))
    for key in ("sync_rounds", "device_calls", "dispatch_counts", "events_processed",
                "approvals_issued", "approvals_in_union", "synced_final"):
        assert rt.extras[key] == rj.extras[key], key
    assert rt.extras["sync_rounds"] > 0 and rt.extras["approvals_issued"] > 0
    for k in rj.final_params:
        np.testing.assert_allclose(rt.final_params[k].numpy(), np.asarray(rj.final_params[k]),
                                   atol=1e-4, rtol=0)
    stages = rt.extras["stage_ms"]
    assert stages["advance"]["count"] == 40 and stages["commit"]["count"] == 20


def _uniform_draws(cap):
    def draw(stream, index):
        rng = np.random.default_rng([0 if stream == "prepare" else 1, index])
        return torch.from_numpy(rng.uniform(1e-9, 1.0, cap).astype(np.float32))
    return draw


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_ideal_wire_equals_run_dagfl(impl):
    """sync_period 0, drop 0, a connected overlay: every advance converges,
    so each node's view is the shared ledger and the run is ``run_dagfl``'s,
    bitwise."""
    n = 8
    dcfg = t_exp.default_dagfl_config(n)
    sim = t_sys.SimConfig(iterations=20, eval_every=5, seed=0)
    task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=n, seed=0)
    base = t_sys.run_dagfl(task, nodes, dcfg, sim, gval, device="cpu",
                           draw=_uniform_draws(dcfg.capacity))
    task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=n, seed=0)   # fresh node RNGs
    ideal = t_sys.run_dagfl_gossip(
        task, nodes, dcfg, sim, gval, topology=t_topo.full(n),
        gossip=t_gossip.GossipConfig(sync_period=0.0, seed=0, impl=impl), device="cpu",
        draw=_uniform_draws(dcfg.capacity))
    for name in ("iters", "times", "accs"):
        np.testing.assert_array_equal(getattr(ideal, name), getattr(base, name), err_msg=name)
    assert ideal.avg_latency == base.avg_latency
    for f in FIELDS:
        assert torch.equal(getattr(ideal.extras["dag"], f), getattr(base.extras["dag"], f)), f
    for k in base.final_params:
        assert torch.equal(ideal.final_params[k], base.final_params[k]), k
    assert ideal.extras["approvals_issued"] == ideal.extras["approvals_in_union"]
    # no advance follows the last commit, so the replicas end one commit apart
    assert ideal.extras["dispatch_counts"] == {"converge": 2 * sim.iterations}


# ---------------------------------------------------------------------------
# what is not ported, devices, and copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("option", [
    dict(mesh=object()), dict(bank_gossip=BankGossipConfig(codec=DeltaCodec("int8")),
                              engine="events", serve=object()),
    dict(bank_gossip=BankGossipConfig(codec=DeltaCodec("int4")), faults=object(),
         mesh=object()),
    dict(bank_gossip=BankGossipConfig(), faults=object(), serve=object()),
    dict(engine="events", obs=ObsConfig(), faults=object(), serve=object()),
    dict(obs=ObsConfig(hist=HistConfig()), serve=object()), dict(faults=object(), mesh=object()),
    dict(serve=object()),
    dict(gossip=t_gossip.GossipConfig(engine="events"), faults=object(), mesh=object()),
])
def test_unported_options_raise(option):
    task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=2, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        t_sys.run_dagfl_gossip(task, nodes, t_exp.default_dagfl_config(2),
                               t_sys.SimConfig(iterations=2), gval, device="cpu", **option)


def test_unported_network_parts_raise():
    dag = dag_to_t(_genesis(3))
    top = t_topo.ring(3)
    for kw in (dict(mesh=object()),
               dict(bank_cfg=BankGossipConfig(codec=DeltaCodec("int8")),
                    cfg=t_gossip.GossipConfig(engine="events"), serve_cfg=object()),
               dict(bank_cfg=BankGossipConfig(codec=DeltaCodec("topk")), faults_cfg=object(),
                    mesh=object()),
               dict(bank_cfg=BankGossipConfig(), faults_cfg=object(), serve_cfg=object()),
               dict(obs_cfg=ObsConfig(), mesh=object()),
               dict(faults_cfg=object(), mesh=object()), dict(serve_cfg=object()),
               dict(cfg=t_gossip.GossipConfig(engine="events"), obs_cfg=ObsConfig(),
                    serve_cfg=object()),
               dict(cfg=t_gossip.GossipConfig(engine="events"), faults_cfg=object(),
                    serve_cfg=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            t_gossip.GossipNetwork(dag, None, top, **kw)
    with pytest.raises(ValueError, match="impl"):
        t_gossip.GossipNetwork(dag, None, top, t_gossip.GossipConfig(impl="pallas"))
    with pytest.raises(ValueError, match="engine"):
        t_gossip.GossipNetwork(dag, None, top, t_gossip.GossipConfig(engine="heap"))
    with pytest.raises(NotImplementedError):
        t_replica.init_replicas(dag, None, 3, mesh=object())
    with pytest.raises(NotImplementedError):
        t_gossip.make_gossip_round("fused", mesh=object())


def test_run_dagfl_gossip_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=2, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        t_sys.run_dagfl_gossip(task, nodes, t_exp.default_dagfl_config(2),
                               t_sys.SimConfig(iterations=2), gval)


def test_copies_outlive_a_later_commit():
    """Replicas are written in place: ``read`` and ``extras["replicas"]``
    hand out copies that a later commit leaves as they were, while a view
    from ``replica.read_replica`` sees the commit."""
    n = 4
    task, _, gval, _ = t_exp.make_cnn_setup(num_nodes=n, seed=0)
    dcfg = t_exp.default_dagfl_config(n)
    ctrl = Controller(dcfg, task.eval_fn, device="cpu")
    gv = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in gval.items()}
    state = ctrl.genesis(task.init(0, "cpu"), gv)
    ledger = t_sys._GossipLedger(state, t_topo.ring(n), t_gossip.GossipConfig(), None)
    snap = ledger.net.read(1)
    view = t_replica.read_replica(ledger.net.replicas, 1)
    before = ledger.extras(ledger.union_dag())
    kept = [x.clone() for x in before["replicas"].dags]
    prepared = Prepared(new_params=t_bank.bank_read(state.bank, 0),
                        chosen_rows=torch.tensor([0, t_dag.NO_TX], dtype=torch.int32),
                        new_accuracy=torch.tensor(0.5), num_tips_seen=torch.tensor(1))
    ledger.commit(1, torch.tensor(1.0), prepared)
    assert int(view.count) == 2 and bool(view.approvers[0, 1])        # the live view moved
    assert int(snap.count) == 1 and not bool(snap.approvers[0, 1])
    for x, y in zip(before["replicas"].dags, kept):
        assert torch.equal(x, y)
    after = ledger.extras(ledger.union_dag())
    assert after["approvals_issued"] == 1 and before["approvals_issued"] == 0
    assert int(after["replicas"].dags.count[1]) == 2
