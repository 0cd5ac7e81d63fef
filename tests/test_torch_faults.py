"""The port's fault injection (``repro_torch.net.faults``) against the
reference on the ticks engine without the bank: the role masks, the edge
attacks, sybil forgery, config validation and the rejection credit, then
every role on a known schedule, each step of each case held against the
reference's own network.

The same numpy-made inputs go to both packages. The reference's threefry
draws are fed to the port: the edge uniforms through ``edge_draw``
(``reference_edge_draws``) and its fault draws through ``fault_draw``
(``reference_fault_draw``: the round's sub-key folded with the salt 7 or
11, and on the events engine ``fold_in(fold_in(key, 11), done)``). The
cases on the banked ticks engine are in ``tests/test_torch_faults_bank.py``,
the events engine's in ``tests/test_torch_faults_events.py`` and
``tests/test_torch_faults_events_bank.py``, whole runs in
``tests/test_torch_faults_runs.py``; each module compiles few of the
reference's faulted programs. Tolerances: bitwise everywhere — ledgers,
transport and fault state (``rejects``, ``tainted``), the fault report, the
rejection credit and the draws consumed — f32 elementwise IEEE on equal
inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anomaly as j_anomaly
from repro.core import dag as j_dag
from repro.kernels.delta_codec import DeltaCodec as JDeltaCodec
from repro.net import bank as j_bank
from repro.net import faults as j_faults
from repro.net import gossip as j_gossip
from repro.net import replica as j_replica
from repro.net import topology as j_topo
from repro.obs import ObsConfig as JObsConfig
from repro_torch.core import anomaly as t_anomaly
from repro_torch.core import bank as t_store
from repro_torch.core import dag as t_dag
from repro_torch.kernels.delta_codec import DeltaCodec
from repro_torch.net import bank as t_bank
from repro_torch.net import faults as t_faults
from repro_torch.net import gossip as t_gossip
from repro_torch.net import replica as t_replica
from repro_torch.net import topology as t_topo
from repro_torch.obs import ObsConfig
from test_torch_bank import assert_state_equal
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_gossip import assert_dags_equal, dag_to_t, random_stacked, reference_edge_draws

CAP, K = 32, 2
SALTS = {"edges": 7, "spoof": 11}


def reference_fault_draw(seed):
    """The reference's fault uniforms, by stream and index (see the module
    docstring); ``draw.calls`` records what the port asked for."""
    keys, subs = [jax.random.PRNGKey(seed)], []

    def key_after(splits):
        while len(keys) <= splits:
            key, sub = jax.random.split(keys[-1])
            keys.append(key)
            subs.append(sub)
        return keys[splits]

    def draw(stream, index, shape):
        draw.calls.append((stream, index, shape))
        if stream == "spoof_batch":
            splits, done = index
            key = jax.random.fold_in(jax.random.fold_in(key_after(splits), 11), done)
        else:
            key_after(index + 1)
            key = jax.random.fold_in(subs[index], SALTS[stream])
        return torch.from_numpy(np.array(jax.random.uniform(key, shape)))

    draw.calls = []
    return draw


def genesis_j(num_nodes):
    d = j_dag.empty_dag(CAP, K, num_nodes + 1)
    return j_dag.publish(d, jnp.asarray(num_nodes, jnp.int32), jnp.float32(0.0),
                         jnp.full((K,), j_dag.NO_TX, jnp.int32), jnp.float32(0.5),
                         jnp.float32(0.0), jnp.asarray(0, jnp.int32))


class FaultPair:
    """The same faulted overlay in both packages, the reference's edge and
    fault draws fed to the port; ``publish``, ``advance`` and ``converge``
    act on both and compare them. ``faults`` is the ``FaultConfig``'s
    keywords (None: no fault layer). ``reference=False`` builds the port's
    network alone (same draws), for comparisons within the port."""

    def __init__(self, top_args, faults, engine="ticks", bank=None, codec=None,
                 partition=None, seed=7, obs=False, impl="fused", reference=True):
        make, args, kw = top_args
        jtop, ttop = getattr(j_topo, make)(*args, **kw), getattr(t_topo, make)(*args, **kw)
        n = jtop.num_nodes
        jpart = tpart = None
        if partition is not None:
            jpart = j_gossip.PartitionSchedule(*partition)
            tpart = t_gossip.PartitionSchedule(*partition)
        self.seed = seed
        self.draws = reference_fault_draw(seed)
        bank = None if bank is None else dict(bank, codec=codec)
        self.j = None if not reference else j_gossip.GossipNetwork(
            genesis_j(n), jnp.zeros((CAP, 8)), jtop,
            j_gossip.GossipConfig(sync_period=1.0, seed=seed, impl=impl, engine=engine), jpart,
            bank_cfg=None if bank is None else j_bank.BankGossipConfig(
                **dict(bank, codec=codec and JDeltaCodec(codec))),
            obs_cfg=JObsConfig() if obs else None,
            faults_cfg=None if faults is None else j_faults.FaultConfig(**faults))
        self.t = t_gossip.GossipNetwork(
            dag_to_t(genesis_j(n)), t_store.init_bank({"w": torch.zeros(8)}, CAP), ttop,
            t_gossip.GossipConfig(sync_period=1.0, seed=seed, impl=impl, engine=engine), tpart,
            bank_cfg=None if bank is None else t_bank.BankGossipConfig(
                **dict(bank, codec=codec and DeltaCodec(codec))),
            obs_cfg=ObsConfig() if obs else None,
            faults_cfg=None if faults is None else t_faults.FaultConfig(**faults),
            edge_draw=reference_edge_draws(seed, n), fault_draw=self.draws)

    def publish(self, node, seq, t):
        if self.j is not None:
            d = j_replica.publish_local(
                self.j.read(node), seq, jnp.asarray(node, jnp.int32), jnp.float32(t),
                jnp.asarray([seq - 1, j_dag.NO_TX], jnp.int32), jnp.float32(0.5),
                jnp.float32(0.0), jnp.asarray(seq % CAP, jnp.int32))
            self.j.write(node, d)
            if self.t.bank_cfg is not None:
                self.j.bank_commit(node, seq % CAP, jnp.full((8,), float(seq)))
        d = t_replica.publish_local(
            self.t.read(node), seq, node, torch.tensor(t, dtype=torch.float32),
            torch.tensor([seq - 1, t_dag.NO_TX], dtype=torch.int32), torch.tensor(0.5),
            torch.tensor(0.0), seq % CAP)
        self.t.write(node, d)
        if self.t.bank_cfg is not None:
            self.t.bank_commit(node, seq % CAP, {"w": torch.full((8,), float(seq))})

    def advance(self, t):
        self.t.advance(t)
        if self.j is not None:
            self.j.advance(t)
            self.compare(f"t={t}: ")

    def converge(self, at_time):
        synced = self.t.converge(at_time)
        if self.j is not None:
            assert synced == self.j.converge(at_time)
            self.compare("converge: ")

    def compare(self, msg):
        j, t = self.j, self.t
        assert_dags_equal(t.replicas.dags, j.replicas.dags)
        counters = ("tick", "rounds_run", "events_processed", "device_calls", "dispatch_counts")
        assert [getattr(t, c) for c in counters] == [getattr(j, c) for c in counters], msg
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
        assert (t.fault_state is None) == (j._fstate is None), msg
        if t.fault_state is not None:
            for name in ("rejects", "tainted"):
                got, want = getattr(t.fault_state, name).numpy(), np.asarray(getattr(j._fstate,
                                                                                     name))
                assert got.dtype == want.dtype, msg + name
                np.testing.assert_array_equal(got, want, err_msg=msg + name)
        np.testing.assert_array_equal(t.missing_rows(), j.missing_rows(), err_msg=msg)

    def compare_reports(self):
        """The post-mortem: fault report, quarantine, credit, attack success."""
        if self.j is None:
            return self.t.fault_report()
        got, want = self.t.fault_report(), self.j.fault_report()
        assert (got is None) == (want is None)
        if want is None:
            return None
        assert got.keys() == want.keys()
        for key, value in want.items():
            if value is None or isinstance(value, (bool, int)):
                assert got[key] == value, key
            else:
                np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)
                assert got[key].dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(self.t.quarantined_links(), self.j.quarantined_links())
        credit = self.j.rejection_credit()
        if credit is None:
            assert self.t.rejection_credit() is None
        else:
            np.testing.assert_array_equal(self.t.rejection_credit(), credit)
        return got


def run_schedule(pair, pubs, times, converge_at=None):
    """Publish ``pubs`` (node, seq, t) in order before the first advance, then
    advance to each of ``times`` and converge; returns the fault report."""
    for node, seq, t in pubs:
        pair.publish(node, seq, t)
    for t in times:
        pair.advance(float(t))
    if converge_at is not None:
        pair.converge(converge_at)
    return pair.compare_reports()


HONEST6 = dict(roles=(0,) * 6)

# name: (topology, FaultConfig keywords, partition, publishes, advance times,
# converge's instant or None: each converge compiles one more reference program)
CASES = {
    "all_honest": (("ring", (6,), dict(link_latency=1.0, drop=0.3, seed=3)), HONEST6,
                   (j_topo.split_halves(6), 1.5, 3.5), [(0, 1, 0.3), (4, 2, 1.2)],
                   (1, 2.5, 6), 20.0),
    "selective_p0": (("ring", (6,), dict(link_latency=1.0)),
                     dict(roles=(3, 0, 0, 0, 0, 0), forward_prob=0.0), None, [(0, 1, 0.2)],
                     (1, 4, 10), None),
    "selective_p1": (("ring", (6,), dict(link_latency=1.0)),
                     dict(roles=(0, 3, 0, 3, 0, 0), forward_prob=1.0), None, [(0, 1, 0.2)],
                     (1, 3, 5), None),
    "selective_half": (("full", (6,), dict(link_latency=1.0, drop=0.2)),
                       dict(roles=(3, 0, 3, 0, 0, 3), forward_prob=0.5), None,
                       [(0, 1, 0.2), (2, 2, 1.3)], (1, 2, 3, 4), 20.0),
    "crash_window": (("ring", (6,), dict(link_latency=1.0)),
                     dict(roles=(1, 0, 0, 0, 0, 0), crash_start=0.0, crash_end=5.0), None,
                     [(0, 1, 0.2)], (4, 12), 30.0),
    "crash_through_partition": (("full", (6,), dict(link_latency=1.0)),
                                dict(roles=(1, 0, 0, 0, 0, 0), crash_start=0.0, crash_end=6.0),
                                (j_topo.split_halves(6), 1.5, 3.5), [(0, 1, 0.2), (3, 2, 0.3)],
                                (3, 5, 10), 30.0),
    "eclipse_star_hub": (("star", (6,), dict(link_latency=1.0)),
                         dict(roles=(0, 0, 2, 0, 0, 0), eclipse_target=0), None,
                         [(1, 1, 0.2), (2, 2, 0.3)], (1, 3, 7), None),
    "sybil": (("full", (6,), dict(link_latency=1.0)), dict(roles=(0, 0, 5, 0, 0, 0)), None,
              [(2, 1, 0.2), (1, 2, 0.3)], (1, 2), None),
}


def check_role(name, pair):
    """The role's own effect, as the reference's tests state it."""
    t = pair.t
    if name == "selective_p0":
        assert (t.missing_rows() > 0).sum() == 5              # sender 0 never heard
    if name == "crash_window":
        assert t.synced()                                      # back after the window
    if name == "crash_through_partition":
        assert t.synced()
    if name == "eclipse_star_hub":
        pubs = t.read(0).publisher.numpy()
        assert (pubs == 2).any() and not (pubs == 1).any()     # the attacker's monopoly
    if name == "sybil":
        u = t.union()
        assert int(u.approval_count[1]) >= 6 and int(u.approvers[1].sum()) == int(
            u.approval_count[1])
        assert int(u.approval_count[2]) == 0                   # the honest row untouched


@pytest.mark.parametrize("name", sorted(CASES))
def test_ticks_fault_case_matches_reference(name):
    top, faults, part, pubs, times, conv = CASES[name]
    pair = FaultPair(top, faults, partition=part)
    report = run_schedule(pair, pubs, times, conv)
    assert pair.t.fault_state is None and set(report) == {"roles", "verify_digests"}
    check_role(name, pair)
    selective = name.startswith("selective")
    # only SELECTIVE draws here, once per round, at the round's own index
    assert [c[:2] for c in pair.draws.calls] == (
        [("edges", i) for i in range(pair.t.edge_draws)] if selective else [])


def test_all_honest_is_the_unfaulted_run():
    """An all-HONEST config draws nothing and is bitwise ``faults=None``."""
    top, _faults, part, pubs, times, conv = CASES["all_honest"]
    runs = [FaultPair(top, faults, partition=part, reference=False)
            for faults in (None, HONEST6)]
    for pair in runs:
        run_schedule(pair, pubs, times, conv)
    a, b = runs[0].t, runs[1].t
    for x, y in zip(a.replicas.dags, b.replicas.dags):
        assert torch.equal(x, y)
    assert a.edge_draws == b.edge_draws and runs[1].draws.calls == []


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("roles,target", [
    ((0, 1, 2, 3, 4, 5, 2), 0), ((2, 2, 0, 0, 0), 4), ((0,) * 4, -1), ((1, 1, 3, 5), -1)])
def test_role_masks_match_reference(roles, target):
    jm = j_faults._role_masks(j_faults.FaultConfig(roles=roles, eclipse_target=target))
    tm = t_faults._role_masks(t_faults.FaultConfig(roles=roles, eclipse_target=target))
    assert tm._fields == jm._fields
    for name in jm._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tm, name)),
                                      np.asarray(getattr(jm, name)), err_msg=name)


@pytest.mark.parametrize("t", [0.0, 2.0, 4.999999, 5.0, 7.5])
def test_fault_edges_match_reference(t):
    """Crash window (its f32 edges), eclipse and selective on one mask."""
    n = 7
    rng = np.random.default_rng(int(t * 10))
    edges = rng.random((n, n)) < 0.6
    cfg = dict(roles=(1, 2, 0, 3, 2, 0, 3), eclipse_target=5, crash_start=2.0, crash_end=5.0,
               forward_prob=0.4)
    jc, tc = j_faults.FaultConfig(**cfg), t_faults.FaultConfig(**cfg)
    fkey = jax.random.PRNGKey(3)
    want = j_faults.fault_edges(jc, j_faults._role_masks(jc), jnp.float32(t), fkey,
                                jnp.asarray(edges))
    u = torch.from_numpy(np.array(jax.random.uniform(fkey, (n, n))))
    layer = t_faults.FaultLayer(tc, "cpu", lambda stream, index, shape: u, lambda: 1)
    got = layer.edges(float(np.float32(t)), torch.from_numpy(edges))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sybil_inflate_matches_reference():
    rng = np.random.default_rng(5)
    jd = random_stacked(rng, 6, cap=16, num_nodes=6)
    jd = jd._replace(publisher=jnp.asarray(rng.integers(-1, 6, (6, 16)), jnp.int32))
    cfg = dict(roles=(0, 5, 0, 5, 5, 0))
    want = j_faults.sybil_inflate(jd, j_faults._role_masks(j_faults.FaultConfig(**cfg)))
    got = t_faults.sybil_inflate(dag_to_t(jd), torch.tensor([r == 5 for r in cfg["roles"]]))
    assert_dags_equal(got, want)
    assert got.approval_count.dtype == torch.int32


def test_validation_matches_reference():
    top = t_topo.ring(4)
    dag = dag_to_t(genesis_j(4))
    for cfg, bank, match in (
            (dict(roles=(0, 0, 0)), None, "roles"), (dict(roles=(0, 9, 0, 0)), None, "unknown"),
            (dict(roles=(2, 0, 0, 0)), None, "eclipse"), (dict(roles=(4, 0, 0, 0)), None, "bank"),
            (dict(roles=(0,) * 4, quarantine_after=0), t_bank.BankGossipConfig(), "quarantine")):
        with pytest.raises(ValueError, match=match):
            j_faults.validate_faults(j_faults.FaultConfig(**cfg), 4, bank is not None)
        with pytest.raises(ValueError, match=match):
            t_gossip.GossipNetwork(dag, t_store.init_bank({"w": torch.zeros(8)}, CAP), top,
                                   bank_cfg=bank, faults_cfg=t_faults.FaultConfig(**cfg))


@pytest.mark.parametrize("scale,floor", [(1.0, 0.05), (0.5, 0.2)])
def test_rejection_credit_matches_reference(scale, floor):
    rng = np.random.default_rng(int(scale * 10))
    rejects = rng.integers(0, 4, (6, 6)).astype(np.int32) * (rng.random((6, 6)) < 0.3)
    rejects[:, 0] = 0                     # a clean sender: exactly 1.0, log exactly 0
    want = np.asarray(j_anomaly.rejection_credit(jnp.asarray(rejects), floor=floor,
                                                 scale=scale))
    got = t_anomaly.rejection_credit(torch.from_numpy(rejects), floor=floor, scale=scale)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 1.0 and torch.log(got)[0] == 0.0


def test_default_draws_stay_off_the_edge_stream():
    """The default fault draws come from their own generator: a SELECTIVE run
    at p = 1 is bitwise the honest run with the default draws too."""
    top = t_topo.ring(6, link_latency=1.0, drop=0.3)
    nets = []
    for roles in ((0,) * 6, (0, 3, 0, 3, 0, 0)):
        net = t_gossip.GossipNetwork(
            dag_to_t(genesis_j(6)), None, top, t_gossip.GossipConfig(sync_period=1.0, seed=4),
            faults_cfg=t_faults.FaultConfig(roles=roles, forward_prob=1.0))
        d = t_replica.publish_local(
            net.read(0), 1, 0, torch.tensor(0.2), torch.full((K,), t_dag.NO_TX,
                                                             dtype=torch.int32),
            torch.tensor(0.5), torch.tensor(0.0), 1)
        net.write(0, d)
        for t in (1.0, 3.0, 6.0):
            net.advance(t)
        nets.append(net)
    for x, y in zip(nets[0].replicas.dags, nets[1].replicas.dags):
        assert torch.equal(x, y)
