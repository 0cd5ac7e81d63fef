"""The port's inference serving (``repro_torch.net.serve``) against the
reference (``repro.net.serve``): the host replay of the arrivals, the queue
extension, the INFER step on random states, the config checks, the default
counter-based draws, the zero-rate limit, and ``run_dagfl_gossip(serve=...)``
on the bench CNN (the reference's tip draws fed too; parameters within 1e-4,
twenty iterations of f32 SGD computed by two libraries as in
``tests/test_torch_gossip.py``).

The reference's arrival draws are fed to the port through ``serve_draw``
(``reference_serve_draw``: ``jax.random.exponential`` of
``arrival_key(serve_base_key(seed, cfg), node, count)``, vmapped over the
nodes as the reference's engine draws them). The reference's engine runs its
rescheduling jitted, where XLA multiplies by the f32 reciprocal of ``rate``
and fuses the add of the instant; its first gaps and its host replay divide.
At rate 3.0 the two differ, so the tests run it there too. Tolerances:
bitwise everywhere else (times, counters, samples, the queue, the curve).

Whole runs of ``GossipNetwork(engine="events")`` against the reference are
in ``tests/test_torch_serve_runs.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro.net import events as j_events
from repro.net import gossip as j_gossip
from repro.net import serve as j_serve
from repro.net import topology as j_topo
from repro_torch.core import bank as t_store
from repro_torch.core import dag as t_dag
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.net import events as t_events
from repro_torch.net import gossip as t_gossip
from repro_torch.net import replica as t_replica
from repro_torch.net import serve as t_serve
from repro_torch.net import topology as t_topo
from repro_torch.net.bank import BankGossipConfig
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_faults import genesis_j
from test_torch_gossip import (INT_FIELDS, assert_dags_equal, dag_to_t, reference_draws,
                               reference_edge_draws, seeded_task)

CAP = 32


@functools.lru_cache(maxsize=None)
def reference_unit_exponentials(seed, salt, n):
    """The reference's draws for ``n`` nodes, jitted: (n,) counts -> (n,)."""
    base = j_serve.serve_base_key(seed, j_serve.ServeConfig(salt=salt))
    ids = jnp.arange(n, dtype=jnp.int32)

    @jax.jit
    def unit(counts):
        keys = jax.vmap(j_serve.arrival_key, in_axes=(None, 0, 0))(base, ids, counts)
        return jax.vmap(jax.random.exponential)(keys)

    return unit


def reference_serve_draw(seed, cfg, n):
    """The reference's unit exponentials for ``n`` nodes: entry i of
    ``draw(counts)`` is node i's ``counts[i]``-th gap before the division by
    ``rate``; ``draw.calls`` counts the calls."""
    unit = reference_unit_exponentials(seed, cfg.salt, n)

    def draw(counts):
        draw.calls += 1
        got = np.array(unit(jnp.asarray(counts.cpu().numpy(), jnp.int32)))
        return torch.from_numpy(got).to(counts.device)

    draw.calls = 0
    return draw


def configs(**kw):
    return j_serve.ServeConfig(**kw), t_serve.ServeConfig(**kw)


# ---------------------------------------------------------------------------
# the host replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate, horizon", [(0.5, 200.0), (3.0, 40.0)])
def test_arrival_times_match_reference(rate, horizon):
    """Seed 117, node 4: at rate 0.5 the replay holds two equal instants
    (a gap that vanishes against t = 179.5 in f32); at 3.0 the division by
    ``rate`` differs from the engine's reciprocal product, and the replay
    divides as the reference's does."""
    jc, tc = configs(rate=rate)
    want = j_serve.arrival_times(117, jc, 4, horizon)
    got = t_serve.arrival_times(117, tc, 4, horizon, serve_draw=reference_serve_draw(117, jc, 5))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if rate == 0.5:
        assert (np.diff(want) == 0).sum() == 1


def test_default_draws_are_counter_based():
    """``torch_serve_draw`` is a pure function of (seed, salt, node, count):
    a repeat and a fresh draw object give the same bits, entry i moves with
    node i's count alone, seeds and salts give other streams, and 4,096
    gaps have a unit exponential's mean and variance and no negative or
    non-finite value."""
    n = 64
    draw = t_serve.torch_serve_draw(3, 13, n, "cpu")
    counts = torch.arange(n, dtype=torch.int32) * 7
    a = draw(counts)
    assert a.dtype == torch.float32 and a.shape == (n,)
    assert torch.equal(a, draw(counts))
    assert torch.equal(a, t_serve.torch_serve_draw(3, 13, n, "cpu")(counts))
    # entry i depends on node i's own count only
    moved = counts.clone()
    moved[::2] += 1
    b = draw(moved)
    assert torch.equal(b[1::2], a[1::2]) and not torch.equal(b[::2], a[::2])
    for other in (t_serve.torch_serve_draw(4, 13, n, "cpu"),
                  t_serve.torch_serve_draw(3, 14, n, "cpu")):
        assert not torch.equal(a, other(counts))
    assert len(set(a.tolist())) == n
    gaps = torch.cat([draw(torch.full((n,), c, dtype=torch.int32)) for c in range(64)])
    assert bool(torch.isfinite(gaps).all()) and bool((gaps >= 0).all())
    assert abs(float(gaps.double().mean()) - 1.0) < 0.06        # 4,096 draws: sd 0.016
    assert abs(float(gaps.double().var()) - 1.0) < 0.2


def test_default_replay_rate():
    """The default draws' replay arrives at the configured rate (within
    six standard deviations of a Poisson count) and strictly increases."""
    for node, rate in ((0, 0.5), (5, 2.0)):
        cfg = t_serve.ServeConfig(rate=rate)
        times = t_serve.arrival_times(9, cfg, node, 200.0 / rate)
        assert abs(len(times) - 200) <= 6.0 * np.sqrt(200) + 3
        assert np.all(np.diff(times) >= 0) and times[0] > 0


# ---------------------------------------------------------------------------
# the queue extension and the INFER step
# ---------------------------------------------------------------------------


def edge_queues(n, latency):
    jq, jis = j_events.make_edge_queue(j_topo.full(n, link_latency=latency), 1.0,
                                       drain_slots=True)
    tq, tis = t_events.make_edge_queue(t_topo.full(n, link_latency=latency), 1.0,
                                       drain_slots=True, device="cpu")
    return (jq, jis), (tq, tis)


@pytest.mark.parametrize("rate", [1.0, 3.0])
def test_extend_queue_matches_reference(rate):
    n, seed = 5, 21
    jc, tc = configs(rate=rate)
    (jq, jis), (tq, tis) = edge_queues(n, 0.7)
    jq, jis, jib = j_serve.extend_queue(jq, jis, n, jc, seed)
    tq, tis, tib = t_serve.extend_queue(tq, tis, n, tc, reference_serve_draw(seed, jc, n))
    assert tib == jib == 2 * n * (n - 1)
    for name in t_events.EventQueue._fields:
        got, want = getattr(tq, name).numpy(), np.asarray(getattr(jq, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tis.numpy(), np.asarray(jis))
    assert (tq.kind[tib:] == t_events.KIND_INFER).all()


def random_serve_state(rng, n, k, cfg):
    """Counters a loaded server can reach, samples partly filled (the cursor
    near the capacity, so some admits overflow)."""
    inflight = np.where(rng.random(n) < 0.5, rng.integers(1, cfg.slots + 1, n), 0)
    queued = rng.integers(0, cfg.queue_cap + 1, n)
    served = rng.integers(0, 50, n)
    dropped = rng.integers(0, 3, n)
    arrivals = served + inflight + queued + dropped
    cursor = int(rng.integers(k - 3, k + 1))
    kept = min(cursor, k)
    st = np.zeros(k, np.float32)
    st[:kept] = np.sort(rng.uniform(0, 5, kept)).astype(np.float32)
    snode = np.full(k, -1, np.int32)
    snode[:kept] = rng.integers(0, n, kept)
    sstale = np.full(k, -1, np.int32)
    sstale[:kept] = rng.integers(0, 9, kept)
    cols = dict(queued=queued, inflight=inflight, served=served, arrivals=arrivals,
                dropped=dropped, batches=rng.integers(0, 30, n))
    j = j_serve.ServeState(
        **{f: jnp.asarray(v, jnp.int32) for f, v in cols.items()}, st=jnp.asarray(st),
        snode=jnp.asarray(snode), sstale=jnp.asarray(sstale), cursor=jnp.int32(cursor),
        sdropped=jnp.int32(max(cursor - k, 0)))
    pad = dict(st=np.append(st, 0).astype(np.float32), snode=np.append(snode, -1),
               sstale=np.append(sstale, -1))
    t = t_serve.ServeState(
        **{f: torch.tensor(v, dtype=torch.int32) for f, v in cols.items()},
        **{f: torch.from_numpy(v.astype(np.float32 if f == "st" else np.int32))
           for f, v in pad.items()},
        cursor=torch.tensor(cursor, dtype=torch.int32),
        sdropped=torch.tensor(max(cursor - k, 0), dtype=torch.int32))
    return j, t


def assert_serve_reports_equal(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            np.testing.assert_equal(got[key], value, err_msg=key)      # NaN == NaN


def assert_serve_states_equal(got, want, msg=""):
    """Bitwise, the sample columns up to the reference's capacity (the port's
    columns hold one spare slot more)."""
    for name in j_serve.ServeState._fields:
        g, w = getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name))
        if name in ("st", "snode", "sstale"):
            g = g[:w.shape[0]]
        assert g.dtype == w.dtype, msg + name
        np.testing.assert_array_equal(g, w, err_msg=msg + name)


@functools.lru_cache(maxsize=None)
def reference_step(cfg):
    """The reference's INFER step jitted, as its event loops run it."""
    return jax.jit(functools.partial(j_serve.infer_step, cfg))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rate", [1.0, 3.0])
def test_infer_step_matches_reference(rate, seed):
    """Random serve states and INFER schedules on an extended queue: at the
    instant t some arrival and completion slots fire together (arrivals into
    full queues, completions that chain into a re-admit, admits past the
    sample capacity); the step's counters, samples, queue and outputs equal
    the reference's jitted step's."""
    rng = np.random.default_rng(seed)
    n, k = 6, 8
    jc, tc = configs(rate=rate, slots=3, queue_cap=4, sample_capacity=k)
    (jq, jis), (tq, tis) = edge_queues(n, 1.0)
    draw = reference_serve_draw(seed, jc, n)
    jq, jis, ib = j_serve.extend_queue(jq, jis, n, jc, seed)
    tq, tis, _ = t_serve.extend_queue(tq, tis, n, tc, draw)
    layer = t_serve.ServeLayer(tc, draw, ib)
    js, ts = random_serve_state(rng, n, k, tc)
    for step in range(4):
        t = np.float32(2.5 + 0.75 * step)
        # the INFER slots: some fire at t, others later; completions armed
        # where a batch is in flight
        qt = np.asarray(jq.time).copy()
        qv = np.asarray(jq.valid).copy()
        fire = rng.random(2 * n) < 0.5
        later = (t + rng.uniform(0.1, 3.0, 2 * n)).astype(np.float32)
        qt[ib:] = np.where(fire, t, later)
        qv[ib:] = True
        qv[ib + n:] &= rng.random(n) < 0.8
        qt[ib + n:] = np.where(qv[ib + n:], qt[ib + n:], np.inf)
        stale = rng.integers(0, 7, n).astype(np.int32)
        want = reference_step(jc)(js, jnp.float32(t), jnp.asarray(qt), jnp.asarray(qv), jq.kind,
                                  jq.seq, jnp.int32(ib), j_serve.serve_base_key(seed, jc),
                                  jnp.asarray(stale))
        got = layer.step(ts, float(t), torch.from_numpy(qt), torch.from_numpy(qv),
                         torch.from_numpy(stale))
        js, ts = want[0], got[0]
        assert_serve_states_equal(ts, js, f"step {step}: ")
        for name, g, w in zip(("qt", "qv", "admitted", "batch_now"), got[1:5], want[1:]):
            assert g.numpy().dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{step}: {name}")
        s_now = np.max(np.where(np.asarray(want[3]), stale, -1))
        assert int(got[5]) == s_now and got[5].dtype == torch.int32
    assert int(ts.sdropped) > 0           # the sample buffer overflowed on the way


# ---------------------------------------------------------------------------
# configs and the zero-rate limit
# ---------------------------------------------------------------------------


def port_net(top, serve=None, engine="events", bank_cfg=None, **kw):
    return t_gossip.GossipNetwork(
        dag_to_t(genesis_j(top.num_nodes)), t_store.init_bank({"w": torch.zeros(8)}, CAP), top,
        t_gossip.GossipConfig(sync_period=1.0, engine=engine), bank_cfg=bank_cfg,
        serve_cfg=serve, **kw)


def test_validate_serve_rejects_bad_configs():
    top = t_topo.full(4)
    assert t_serve.serve_key(None) is None
    assert t_serve.serve_key(t_serve.ServeConfig(rate=0.0)) is None
    assert t_serve.serve_key(t_serve.ServeConfig(rate=-1.0)) is None
    cfg = t_serve.ServeConfig(rate=2.0)
    assert t_serve.serve_key(cfg) is cfg
    with pytest.raises(ValueError, match="events"):
        port_net(top, t_serve.ServeConfig(), engine="ticks")
    # rate 0 on the ticks engine serves nothing, so it is valid
    assert port_net(top, t_serve.ServeConfig(rate=0.0), engine="ticks").serve_report() is None
    for bad in (dict(slots=0), dict(queue_cap=0), dict(service_time=0.0)):
        with pytest.raises(ValueError):
            port_net(top, t_serve.ServeConfig(**bad))
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        t_serve.validate_serve(cfg, "events", mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        port_net(top, cfg, mesh=object())


def test_queue_built_only_when_serving():
    """None and rate 0 build no INFER slot; an effective config adds 2N."""
    top = t_topo.full(3, link_latency=1.0)
    none, zero = port_net(top), port_net(top, t_serve.ServeConfig(rate=0.0))
    live = port_net(top, t_serve.ServeConfig(rate=2.0))
    assert none._serve is None and zero._serve is None and live._serve is not None
    assert zero._equeue.time.shape == none._equeue.time.shape
    assert live._equeue.time.shape[0] == none._equeue.time.shape[0] + 6
    assert int((live._equeue.kind == t_events.KIND_INFER).sum()) == 6


def publish_port(net, node, seq, t):
    """The reference's ``tests/test_serve.py::publish_on`` on the port: a
    row with no approvals and, with the bank, its payload committed."""
    d = t_replica.publish_local(
        net.read(node), seq, node, torch.tensor(t, dtype=torch.float32),
        torch.full((2,), t_dag.NO_TX, dtype=torch.int32), torch.tensor(0.5), torch.tensor(0.0),
        seq % CAP)
    net.write(node, d)
    if net.bank_cfg is not None:
        net.bank_commit(node, seq % CAP, {"w": torch.full((8,), float(seq))})


def schedule(n):
    """The reference's ``_run_arm`` schedule cut to half its horizon: one
    publish a node, an advance, another publish a node, another advance, as
    ``(advance to, first sequence number, first instant, spacing)``."""
    return ((4.0, 1, 0.25, 0.5), (8.0, 1 + n, 4.5, 0.25))


def drive(net, n):
    for t_end, base, t0, step in schedule(n):
        for i in range(n):
            publish_port(net, i, base + i, t0 + step * i)
        net.advance(t_end)
    return net


@pytest.mark.parametrize("arm", ["plain", "bank"])
def test_zero_rate_is_the_serve_free_run(arm):
    """``serve=None`` and rate 0 are one run bitwise, and a serving run
    makes the same edge draws and ends in the same replicas and transport
    (serving only reads), with its own dispatch label."""
    n = 5
    bank = BankGossipConfig(chunks_per_slot=2) if arm == "bank" else None
    top = t_topo.full(n, link_latency=1.0, bandwidth=64.0)
    nets = [drive(port_net(top, serve, bank_cfg=bank), n)
            for serve in (None, t_serve.ServeConfig(rate=0.0), t_serve.ServeConfig(rate=3.0))]
    base, zero, live = nets
    for other in (zero, live):
        assert other.edge_draws == base.edge_draws
        for x, y in zip(other.replicas.dags, base.replicas.dags):
            assert torch.equal(x, y)
        if bank is not None:
            for x, y in zip(other.bank_state, base.bank_state):
                assert torch.equal(x, y)
    assert zero.dispatch_counts == base.dispatch_counts
    assert zero.events_processed == base.events_processed
    assert base.serve_report() is None and zero.serve_report() is None
    rep = live.serve_report()
    assert rep["served_total"] > 0
    assert live.events_processed > base.events_processed     # INFER batches count
    label = "advance_events_bank_serve" if bank is not None else "advance_events_serve"
    assert set(live.dispatch_counts) - {"bank_commit"} == {label}


def test_run_dagfl_gossip_serve_report_matches_reference():
    """``run_dagfl_gossip(serve=...)`` on the bench CNN: the curve, ledgers
    and ``extras["serve_report"]`` equal the reference's."""
    n, seed = 6, 0
    jc, tc = configs(rate=2.0, service_time=0.05)
    jt, jn, jg, _ = j_exp.make_cnn_setup(num_nodes=n, seed=seed)
    jd, td = j_exp.default_dagfl_config(n), t_exp.default_dagfl_config(n)
    sim = dict(iterations=10, eval_every=5, seed=seed)
    rj = j_sys.run_dagfl_gossip(
        jt, jn, jd, j_sys.SimConfig(**sim), jg, topology=j_topo.full(n, link_latency=0.5),
        gossip=j_gossip.GossipConfig(sync_period=1.0, seed=seed), engine="events", serve=jc)
    _, tn, tg, _ = t_exp.make_cnn_setup(num_nodes=n, seed=seed)
    rt = t_sys.run_dagfl_gossip(
        seeded_task(jt, seed), tn, td, t_sys.SimConfig(**sim), tg,
        topology=t_topo.full(n, link_latency=0.5),
        gossip=t_gossip.GossipConfig(sync_period=1.0, seed=seed), engine="events", serve=tc,
        device="cpu", draw=reference_draws(seed, td.capacity),
        edge_draw=reference_edge_draws(seed, n), serve_draw=reference_serve_draw(seed, jc, n))
    assert rt.avg_latency == rj.avg_latency
    for name in ("iters", "times", "accs"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name), err_msg=name)
    assert_dags_equal(rt.extras["replicas"].dags, rj.extras["replicas"].dags,
                      INT_FIELDS + ("publish_time",))
    for key in ("sync_rounds", "dispatch_counts", "events_processed"):
        assert rt.extras[key] == rj.extras[key], key
    assert_serve_reports_equal(rt.extras["serve_report"], rj.extras["serve_report"])
    assert rt.extras["serve_report"]["served_total"] > 0
    for k in rj.final_params:
        np.testing.assert_allclose(rt.final_params[k].numpy(), np.asarray(rj.final_params[k]),
                                   atol=1e-4, rtol=0)
