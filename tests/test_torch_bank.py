"""The port's priced model bank against the reference: the chunk dedup,
transfer selection, the per-tick chunk step, digests, gating, the bank half
of ``GossipNetwork`` and a whole ``run_dagfl_gossip(bank_gossip=...)``.

The same numpy-made inputs go to both packages; the JAX side runs as its own
tests run it (``ref.chunk_dedup_ref``, and the Pallas kernel in interpret
mode). The reference's threefry edge and tip draws are fed to the port
(``edge_draw``, ``draw``). Tolerances:

- bitwise: everything that is a bitmap, an index, a count or an integer
  ledger column (sat, have, take, spent, pending, missing chunks), and the
  f32 transport arithmetic (credit, sent, bytes), which is elementwise IEEE
  on equal inputs;
- digests: within 1e-5 of the sum of |x_i · proj_i| (two libraries compute
  cos, sin and the dot product in their own order); a port's digests are
  bitwise self-consistent (the bank table against one committed payload);
- trained parameters within 1e-4 (twenty iterations of f32 SGD computed by
  two libraries, as in ``tests/test_torch_gossip.py``).
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
from repro.kernels import chunk_transfer as j_ck
from repro.kernels import ref as j_ref
from repro.net import bank as j_bank
from repro.net import gossip as j_gossip
from repro.net import replica as j_replica
from repro.net import topology as j_topo
from repro_torch.core import bank as t_store
from repro_torch.core import dag as t_dag
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.fl import tasks as t_tasks
from repro_torch.kernels import chunk_transfer as t_ck
from repro_torch.net import bank as t_bank
from repro_torch.net import gossip as t_gossip
from repro_torch.net import replica as t_replica
from repro_torch.net import topology as t_topo
from test_torch_gossip import (INT_FIELDS, assert_dags_equal, dag_to_t, random_stacked,
                               reference_draws, reference_edge_draws, seeded_task, to_t)

INT32_MAX = np.iinfo(np.int32).max
DIGEST_RTOL = 1e-5
j_dedup_ref = jax.jit(j_ref.chunk_dedup_ref)


def assert_state_equal(tb, jb, msg=""):
    for name in ("have", "credit", "sent"):
        np.testing.assert_array_equal(getattr(tb, name).cpu().numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=msg + name)


def digest_scale(flat: np.ndarray, chunks: int) -> np.ndarray:
    """(chunks,) sum of |x_i proj_i| per chunk: the size of a digest's terms."""
    per = -(-flat.shape[0] // chunks)
    x = np.pad(flat.astype(np.float64), (0, per * chunks - flat.shape[0])).reshape(chunks, per)
    idx = np.arange(per)
    proj = np.cos(idx * 0.618033988749895) + 1e-3 * np.sin(idx * 0.318309886)
    return np.abs(x) @ np.abs(proj)


def assert_digests_close(got, want, scale):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= DIGEST_RTOL * scale + 1e-30), (got, want)


# ---------------------------------------------------------------------------
# the dedup reduction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,s,c,classes,special", [
    (6, 13, 3, 5, None),        # dense with collisions
    (5, 130, 2, 4, None),       # S not a multiple of the TPU's 128-slot block
    (3, 200, 4, 3, "nan"),      # NaN digests: never match, not even themselves
    (4, 64, 3, 3, "zero"),      # -0.0 matches +0.0
    (2, 37, 1, 1, None),        # every digest equal in the column
    (1, 192, 4, 50, "nan"),     # the gate call's shape (R = 1)
])
def test_chunk_dedup_plain_matches_reference(r, s, c, classes, special):
    rng = np.random.default_rng(r * 1000 + s)
    dig = rng.integers(0, classes, (s, c)).astype(np.float32)
    if special == "nan":
        dig[rng.random((s, c)) < 0.3] = np.nan
    if special == "zero":
        dig = rng.choice(np.array([-0.0, 0.0, 1.0], np.float32), (s, c))
    have = rng.random((r, s, c)) < 0.3
    want = np.asarray(j_dedup_ref(jnp.asarray(have), jnp.asarray(dig)))
    pallas = np.asarray(j_ck.chunk_dedup_pallas(jnp.asarray(have), jnp.asarray(dig),
                                                block_s=64, interpret=True))
    got = t_ck.chunk_dedup(to_t(have), to_t(dig))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(t_ck.chunk_dedup_plain(to_t(have), to_t(dig)).numpy(), want)


def test_chunk_dedup_same_content_and_nan():
    dig = torch.tensor([[1.0, 2.0], [1.0, 9.0], [7.0, 2.0]])
    have = torch.zeros((1, 3, 2), dtype=torch.bool)
    have[0, 0] = True                                   # only slot 0 held
    np.testing.assert_array_equal(t_ck.chunk_dedup(have, dig)[0].numpy(),
                                  [[True, True], [True, False], [False, True]])
    nan = torch.full((2, 1), float("nan"))
    sat = t_ck.chunk_dedup(torch.tensor([[[True], [False]]]), nan)
    assert bool(sat[0, 0, 0]) and not bool(sat[0, 1, 0])


# ---------------------------------------------------------------------------
# transfer selection, verification, the afford cast
# ---------------------------------------------------------------------------


def test_afford_saturates_as_the_reference_does():
    budget = np.array([[0.0, 7.9, 8.0, 1e4], [3e9, 2.0 ** 31, np.inf, -5.0],
                       [2147483520.0, 1.5e10, 17.0, 0.5]], np.float32)
    chunk_bytes = np.float32(8.0)
    want = np.asarray(jnp.clip(jnp.floor(jnp.asarray(budget) / chunk_bytes), 0,
                               jnp.iinfo(jnp.int32).max).astype(jnp.int32))
    got = t_bank._afford(to_t(budget), float(chunk_bytes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1, 2] == INT32_MAX                      # inf: a plain cast gives int32 min
    inf_chunk = np.float32(1.0)
    got = t_bank._afford(torch.tensor([np.inf, 3e9, 12.0]), float(inf_chunk))
    np.testing.assert_array_equal(got.numpy(), [INT32_MAX, INT32_MAX, 12])


@pytest.mark.parametrize("afford_kind", ["zero", "small", "huge", "inf"])
def test_transfer_select_and_verify_match_reference(afford_kind):
    rng = np.random.default_rng(["zero", "small", "huge", "inf"].index(afford_kind))
    rb, r, m = 5, 7, 40
    need = rng.random((rb, m)) < 0.6
    src = rng.random((r, m)) < 0.4
    edges = rng.random((rb, r)) < 0.6
    if afford_kind == "zero":
        afford = np.zeros((rb, r), np.int32)
    elif afford_kind == "small":
        afford = rng.integers(0, 4, (rb, r)).astype(np.int32)
    elif afford_kind == "huge":
        afford = np.full((rb, r), INT32_MAX, np.int32)
    else:      # what an infinite (ideal-wire) budget buys, through each package's cast
        budget = np.where(edges, np.inf, rng.random((rb, r)) * 30).astype(np.float32)
        afford = np.asarray(jnp.clip(jnp.floor(jnp.asarray(budget) / 8.0), 0,
                                     INT32_MAX).astype(jnp.int32))
        np.testing.assert_array_equal(t_bank._afford(to_t(budget), 8.0).numpy(), afford)
    j_args = tuple(jnp.asarray(x) for x in (need, src, edges, afford))
    t_args = tuple(to_t(x) for x in (need, src, edges, afford))
    want = j_ck.transfer_select(*j_args, return_links=True)
    got = t_ck.transfer_select(*t_args, return_links=True)
    for g, w, name in zip(got, want, ("take", "take_link", "spent", "pending")):
        assert g.dtype == (torch.int32 if name == "spent" else torch.bool), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for g, w in zip(t_ck.transfer_select(*t_args), j_ck.transfer_select(*j_args)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bad = rng.random((rb, r, m)) < 0.2
    for g, w in zip(t_ck.transfer_verify(got[1], to_t(bad)),
                    j_ck.transfer_verify(want[1], jnp.asarray(bad))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_transfer_select_budget_and_striping():
    need = torch.tensor([[True, True, True]])
    src = torch.tensor([[False, False, False], [True, True, False], [True, True, True]])
    edges = torch.tensor([[False, True, True]])
    take, spent, pending = t_ck.transfer_select(need, src, edges,
                                                torch.tensor([[0, 1, 1]], dtype=torch.int32))
    np.testing.assert_array_equal(take.numpy(), [[True, True, False]])
    np.testing.assert_array_equal(spent.numpy(), [[0, 1, 1]])
    np.testing.assert_array_equal(pending.numpy(), [[False, False, True]])


# ---------------------------------------------------------------------------
# the chunk step, and the functions around it
# ---------------------------------------------------------------------------


def random_bank_inputs(rng, r=6, cap=16, c=3, num_nodes=8):
    jd = random_stacked(rng, r, cap=cap, num_nodes=num_nodes)
    dig = rng.integers(0, 6, (cap, c)).astype(np.float32)
    dig[0, 0] = np.nan
    have = rng.random((r, cap, c)) < 0.4
    return jd, dig, have


@pytest.mark.parametrize("cap_per_tick", [np.inf, 3.0, 8.0])
def test_chunk_step_matches_reference(cap_per_tick):
    """Four ticks fed back into themselves: have, credit, sent and pending
    bitwise at every tick (chunk 8 B; 3 B/tick rolls credit over)."""
    rng = np.random.default_rng(int(min(cap_per_tick, 99)))
    r, chunk_bytes = 6, np.float32(8.0)
    jd, dig, have = random_bank_inputs(rng, r=r)
    td = dag_to_t(jd)
    credit = (rng.random((r, r)) * 8).astype(np.float32)
    jb = j_bank.BankState(jnp.asarray(have), jnp.asarray(credit), jnp.zeros((r, r), jnp.float32))
    tb = t_bank.BankState(to_t(have), to_t(credit), torch.zeros((r, r)))
    capm = np.where(~np.eye(r, dtype=bool), cap_per_tick, 0.0).astype(np.float32)
    j_step = jax.jit(functools.partial(j_bank.chunk_step, return_pending=True))
    for tick in range(4):
        edges = rng.random((r, r)) < 0.6
        j_sat = j_dedup_ref(jb.have, jnp.asarray(dig))
        t_sat = t_ck.chunk_dedup(tb.have, to_t(dig))
        np.testing.assert_array_equal(t_sat.numpy(), np.asarray(j_sat))
        jb, jp = j_step(jd, jb, jnp.asarray(dig), j_sat, j_sat, jnp.asarray(edges),
                        jnp.asarray(capm), chunk_bytes)
        tb, tp = t_bank.chunk_step(td, tb, to_t(dig), t_sat, t_sat, to_t(edges), to_t(capm),
                                   float(chunk_bytes), return_pending=True)
        assert_state_equal(tb, jb, msg=f"tick {tick}: ")
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), err_msg=f"tick {tick}: pending")
    assert tb.sent.sum() > 0


def test_referenced_rows_gating_and_missing_match_reference():
    rng = np.random.default_rng(7)
    jd, dig, have = random_bank_inputs(rng)
    td = dag_to_t(jd)
    np.testing.assert_array_equal(t_bank.referenced_slots(td, 16).numpy(),
                                  np.asarray(j_bank.referenced_slots(jd, 16)))
    j_sat = j_dedup_ref(jnp.asarray(have), jnp.asarray(dig))
    t_sat = t_ck.chunk_dedup(to_t(have), to_t(dig))
    np.testing.assert_array_equal(t_bank.rows_available(td, t_sat).numpy(),
                                  np.asarray(j_bank.rows_available(jd, j_sat)))
    assert_dags_equal(t_bank.gate_views(td, t_sat), j_bank.gate_views(jd, j_sat))
    for i in (0, 3, 5):
        j_one = jax.tree_util.tree_map(lambda x: x[i], jd)
        t_one = t_dag.DagState(*(x[i] for x in td))
        np.testing.assert_array_equal(t_bank.rows_available(t_one, t_sat[i]).numpy(),
                                      np.asarray(j_bank.rows_available(j_one, j_sat[i])))
        assert_dags_equal(t_bank.gate_view(t_one, to_t(have[i]), to_t(dig)),
                          j_bank.gate_view_jit(j_one, jnp.asarray(have[i]), jnp.asarray(dig)))
    r = have.shape[0]
    jb = j_bank.init_bank_state(r, 16, 3)._replace(have=jnp.asarray(have))
    tb = t_bank.init_bank_state(r, 16, 3)._replace(have=to_t(have))
    np.testing.assert_array_equal(t_bank.missing_chunks(td, tb, to_t(dig)).numpy(),
                                  np.asarray(j_bank.missing_chunks_jit(jd, jb, jnp.asarray(dig))))
    assert_state_equal(t_bank.init_bank_state(4, 9, 2), j_bank.init_bank_state(4, 9, 2))


def small_params(rng):
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("chunks", [1, 3, 4, 7])
def test_digests_match_reference_and_themselves(chunks):
    rng = np.random.default_rng(chunks)
    params = small_params(rng)
    flat = np.concatenate([params[k].reshape(-1) for k in sorted(params)])
    got = t_bank.chunk_digests({k: to_t(v) for k, v in params.items()}, chunks)
    want = j_bank.chunk_digests({k: jnp.asarray(v) for k, v in params.items()}, chunks)
    assert got.dtype == torch.float32 and got.shape == (chunks,)
    assert_digests_close(got.numpy(), want, digest_scale(flat, chunks))
    # a bit flip moves a digest; equal content gives equal digests
    moved = dict(params, w=params["w"].copy())
    moved["w"][1, 1] += 1e-3
    assert not torch.equal(t_bank.chunk_digests({k: to_t(v) for k, v in moved.items()}, chunks),
                           got)
    # the store's table, slot by slot, against the one-payload path
    bank = t_store.init_bank({k: torch.zeros(v.shape) for k, v in params.items()}, 5)
    for s in range(5):
        t_store.bank_write(bank, s, {k: to_t(rng.normal(size=v.shape).astype(np.float32))
                                     for k, v in params.items()})
    t_store.bank_write(bank, 3, t_store.bank_read(bank, 1))          # a lazy republish
    table = t_bank.bank_digests(bank, chunks)
    for s in range(5):
        assert torch.equal(table[s], t_bank.chunk_digests(t_store.bank_read(bank, s), chunks))
    assert torch.equal(table[3], table[1])
    j_store = {k: jnp.asarray(np.stack([t_store.bank_read(bank, s)[k].numpy()
                                        for s in range(5)])) for k in params}
    j_table = np.asarray(jax.jit(j_bank.bank_digests, static_argnames="chunks")(
        j_store, chunks=chunks))
    for s in range(5):
        flat = bank.rows[s, :17].numpy()
        assert_digests_close(table[s].numpy(), j_table[s], digest_scale(flat, chunks))


def test_slot_nbytes_and_chunking_use_the_model_not_the_padded_row():
    params = t_tasks.CNNTask().init(0, "cpu")
    bank = t_store.init_bank(params, 2)
    p = sum(v.numel() for v in params.values())
    assert p == 1_663_370 and bank.rows.stride(0) != p            # the row stride is padded
    assert t_bank.slot_nbytes(bank) == 6_653_480.0
    j_like = {k: jnp.zeros((2,) + tuple(v.shape)) for k, v in params.items()}
    assert t_bank.slot_nbytes(bank) == j_bank.slot_nbytes(j_like)
    t_store.bank_write(bank, 1, params)
    bank.rows[1, p:] = 7.0                      # the padding is not payload
    table = t_bank.bank_digests(bank, 4)
    assert torch.equal(table[1], t_bank.chunk_digests(params, 4))
    assert -(-p // 4) == 415_843


def test_commit_chunks_matches_reference():
    rng = np.random.default_rng(3)
    r, s, c = 5, 9, 4
    have = rng.random((r, s, c)) < 0.5
    dig = rng.normal(size=(s, c)).astype(np.float32)
    params = small_params(rng)
    t_have, t_dig = to_t(have), to_t(dig)
    got_have, got_dig = t_bank.commit_chunks(t_have, t_dig, {k: to_t(v) for k, v in params.items()},
                                             6, 2)
    want_have, want_dig = jax.jit(j_bank.commit_chunks)(
        jnp.asarray(have), jnp.asarray(dig), {k: jnp.asarray(v) for k, v in params.items()},
        jnp.int32(6), jnp.int32(2))
    np.testing.assert_array_equal(got_have.numpy(), np.asarray(want_have))
    np.testing.assert_array_equal(np.delete(got_dig.numpy(), 6, 0), np.delete(dig, 6, 0))
    flat = np.concatenate([params[k].reshape(-1) for k in sorted(params)])
    assert_digests_close(got_dig[6].numpy(), np.asarray(want_dig)[6], digest_scale(flat, c))
    assert torch.equal(t_have, to_t(have)) and torch.equal(t_dig, to_t(dig))   # inputs kept


# ---------------------------------------------------------------------------
# GossipNetwork transport semantics (the reference's test_net_bank cases)
# ---------------------------------------------------------------------------

CAP, K = 16, 2


def genesis_j(num_nodes):
    d = j_dag.empty_dag(CAP, K, num_nodes + 1)
    return j_dag.publish(d, jnp.asarray(num_nodes, jnp.int32), jnp.float32(0.0),
                         jnp.full((K,), j_dag.NO_TX, jnp.int32), jnp.float32(0.5),
                         jnp.float32(0.0), jnp.asarray(0, jnp.int32))


def make_net(top, bank_cfg=None, sync_period=1.0, partition=None, seed=0, impl="fused",
             edge_draw=None):
    bank = t_store.init_bank({"w": torch.zeros(8)}, CAP)
    return t_gossip.GossipNetwork(
        dag_to_t(genesis_j(top.num_nodes)), bank, top,
        t_gossip.GossipConfig(sync_period=sync_period, seed=seed, impl=impl),
        partition=partition, bank_cfg=bank_cfg, edge_draw=edge_draw)


def publish_on(net, node, seq, t, params=None):
    d = t_replica.publish_local(
        net.read(node), seq, node, torch.tensor(t, dtype=torch.float32),
        torch.full((K,), t_dag.NO_TX, dtype=torch.int32), torch.tensor(0.5), torch.tensor(0.0),
        seq % CAP)
    net.write(node, d)
    if net.bank_cfg is not None:
        net.bank_commit(node, seq % CAP, {"w": torch.full((8,), float(seq))
                                          if params is None else params})


def test_striping_uses_parallel_links_to_distinct_holders():
    cfg = t_bank.BankGossipConfig(chunks_per_slot=4)
    payload = torch.arange(8.0)
    striped = make_net(t_topo.full(3, bandwidth=64.0), bank_cfg=cfg)
    publish_on(striped, 0, 1, 0.1, params=payload)
    publish_on(striped, 1, 2, 0.2, params=payload)          # identical content
    control = make_net(t_topo.full(3, bandwidth=64.0), bank_cfg=cfg)
    publish_on(control, 0, 1, 0.1, params=payload)
    publish_on(control, 1, 2, 0.2, params=payload + 100.0)  # distinct
    striped.advance(2.0)
    control.advance(2.0)
    assert int(striped.missing_chunks()[2]) == 0
    assert int(control.missing_chunks()[2]) > 0
    sent = striped.bank_state.sent.numpy()
    assert sent[2, 0] > 0 and sent[2, 1] > 0


def test_nan_payload_still_transfers_at_physical_identity():
    cfg = t_bank.BankGossipConfig(chunks_per_slot=2)
    net = make_net(t_topo.ring(3, bandwidth=1e9), bank_cfg=cfg)
    publish_on(net, 0, 1, 0.2, params=torch.full((8,), float("nan")))
    assert net.converge(at_time=10.0)
    assert net.missing_chunks().max() == 0
    assert net.synced()


def test_finite_bandwidth_availability_lags_visibility():
    """slot = 32 B over 4 chunks; 8 B/s links move one chunk per tick."""
    cfg = t_bank.BankGossipConfig(chunks_per_slot=4)
    net = make_net(t_topo.ring(4, bandwidth=64.0), bank_cfg=cfg)
    publish_on(net, 0, 1, 0.5)
    net.advance(1.0)
    assert int(net.missing_rows()[1]) == 0
    assert int(net.missing_chunks()[1]) == 3
    for t in (2.0, 3.0, 4.0):
        net.advance(t)
    assert int(net.missing_chunks()[1]) == 0
    net2 = make_net(t_topo.ring(4, bandwidth=64.0), bank_cfg=cfg)
    publish_on(net2, 0, 1, 0.5)
    net2.advance(1.0)
    assert int(net2.read(1).publisher[1]) == 0            # the raw replica sees the row
    assert int(net2.read_view(1).publisher[1]) == -1      # the usable view does not
    assert int(net2.read_view(0).publisher[1]) == 0       # the committer has its chunks


def test_dedup_makes_identical_payload_free():
    cfg = t_bank.BankGossipConfig(chunks_per_slot=4)
    payload = torch.full((8,), 7.0)
    net = make_net(t_topo.ring(2, bandwidth=1e9), bank_cfg=cfg)
    publish_on(net, 0, 1, 0.2, params=payload)
    net.advance(1.0)
    bytes_first = net.bytes_sent()
    assert bytes_first > 0 and net.missing_chunks().max() == 0
    publish_on(net, 0, 2, 1.5, params=payload)
    net.advance(2.0)
    assert net.missing_chunks().max() == 0
    assert net.bytes_sent() == bytes_first


def test_credit_rolls_over_for_subchunk_bandwidth():
    cfg = t_bank.BankGossipConfig(chunks_per_slot=4)
    net = make_net(t_topo.ring(2, bandwidth=24.0), bank_cfg=cfg)     # 3 B/tick
    publish_on(net, 0, 1, 0.2)
    for t, expect in ((1.0, 4), (2.0, 4), (3.0, 3)):
        net.advance(t)
        assert int(net.missing_chunks()[1]) == expect, t
    credit = net.bank_state.credit.numpy()
    assert 0.0 < credit[1, 0] < net._chunk_bytes


def test_partition_blocks_chunks_then_heals():
    n = 4
    part = t_gossip.PartitionSchedule(t_topo.split_halves(n), 1.5, 6.5)
    cfg = t_bank.BankGossipConfig(chunks_per_slot=2)
    net = make_net(t_topo.full(n, bandwidth=64.0), bank_cfg=cfg, partition=part)
    publish_on(net, 0, 1, 0.2)
    net.advance(1.0)
    assert int(net.missing_rows().max()) == 0
    assert (net.missing_chunks() > 0).sum() == 3
    net.advance(5.0)
    missing = net.missing_chunks()
    assert missing[1] == 0 and missing[2] > 0 and missing[3] > 0
    assert not net.converge(at_time=5.0)
    assert net.converge(at_time=7.0)
    assert net.missing_chunks().max() == 0
    assert net.synced()


def test_zero_bandwidth_never_delivers_payload():
    cfg = t_bank.BankGossipConfig(chunks_per_slot=2)
    net = make_net(t_topo.ring(3, bandwidth=0.0), bank_cfg=cfg)
    publish_on(net, 0, 1, 0.2)
    net.advance(10.0)
    assert int(net.missing_rows().max()) == 0
    assert (net.missing_chunks() > 0).sum() == 2
    assert not net.converge(at_time=20.0)


@pytest.mark.parametrize("impl", ["fused", "scan", "lax"])
def test_infinite_bandwidth_schedule_bitwise_equal(impl):
    part = t_gossip.PartitionSchedule(t_topo.split_halves(6), 1.5, 4.5)
    a = make_net(t_topo.ring(6, drop=0.3, seed=3), partition=part, impl=impl)
    b = make_net(t_topo.ring(6, drop=0.3, seed=3), partition=part, impl=impl,
                 bank_cfg=t_bank.BankGossipConfig(chunks_per_slot=4))
    for seq, node in ((1, 0), (2, 3), (3, 5)):
        publish_on(a, node, seq, 0.1 * seq)
        publish_on(b, node, seq, 0.1 * seq)
    for t in (1.0, 3.0, 6.0):
        a.advance(t)
        b.advance(t)
        for f in t_dag.DagState._fields:
            assert torch.equal(getattr(a.replicas.dags, f), getattr(b.replicas.dags, f)), (t, f)
        assert b.missing_chunks().max() == 0
    assert a.converge(at_time=50.0) == b.converge(at_time=50.0)
    for f in t_dag.DagState._fields:
        assert torch.equal(getattr(a.replicas.dags, f), getattr(b.replicas.dags, f)), f
    assert b.missing_chunks().max() == 0 and a.rounds_run == b.rounds_run


def test_network_schedule_matches_reference():
    """A priced schedule with losses, strides, a partition, a lazy
    republish, a fast-forward and a final converge, run by both packages
    with the same edge draws: rows, transport state, missing chunks, gated
    views and counters equal after every step."""
    n, seed = 6, 5
    part_j = j_gossip.PartitionSchedule(j_topo.split_halves(n), 3.0, 7.0)
    cfg_j = j_gossip.GossipConfig(sync_period=1.0, seed=seed, max_ticks_per_advance=3)
    jnet = j_gossip.GossipNetwork(
        genesis_j(n), jnp.zeros((CAP, 8)), j_topo.ring(n, link_latency=1.5, drop=0.3, seed=0,
                                                       bandwidth=80.0),
        cfg_j, part_j, bank_cfg=j_bank.BankGossipConfig(chunks_per_slot=4))
    tnet = t_gossip.GossipNetwork(
        dag_to_t(genesis_j(n)), t_store.init_bank({"w": torch.zeros(8)}, CAP),
        t_topo.ring(n, link_latency=1.5, drop=0.3, seed=0, bandwidth=80.0),
        t_gossip.GossipConfig(sync_period=1.0, seed=seed, max_ticks_per_advance=3),
        t_gossip.PartitionSchedule(t_topo.split_halves(n), 3.0, 7.0),
        bank_cfg=t_bank.BankGossipConfig(chunks_per_slot=4),
        edge_draw=reference_edge_draws(seed, n))
    schedule = [(0, 0.5, 1.0), (3, 1.2, 2.0), (5, 2.7, 2.0), (1, 3.1, 1.0), (4, 4.0, 4.0),
                (2, 6.5, 1.0), (0, 9.9, 3.0), (5, 11.0, 5.0)]

    def compare(msg):
        assert_dags_equal(tnet.replicas.dags, jnet.replicas.dags)
        assert_state_equal(tnet.bank_state, jnet.bank_state, msg=msg)
        np.testing.assert_array_equal(tnet.missing_chunks(), jnet.missing_chunks(), err_msg=msg)
        for i in range(n):
            assert_dags_equal(tnet.read_view(i), jnet.read_view(i))
        assert (tnet.tick, tnet.rounds_run, tnet.device_calls, tnet.dispatch_counts) == (
            jnet.tick, jnet.rounds_run, jnet.device_calls, jnet.dispatch_counts), msg
        assert tnet.bytes_sent() == jnet.bytes_sent(), msg

    for seq, (node, t, value) in enumerate(schedule, start=1):
        d = j_replica.publish_local(
            jnet.read(node), seq, jnp.asarray(node, jnp.int32), jnp.float32(t),
            jnp.asarray([seq - 1, j_dag.NO_TX], jnp.int32), jnp.float32(0.5), jnp.float32(0.0),
            jnp.asarray(seq % CAP, jnp.int32))
        jnet.write(node, d)
        jnet.bank_commit(node, seq % CAP, jnp.full((8,), value))
        d = t_replica.publish_local(
            tnet.read(node), seq, node, torch.tensor(t, dtype=torch.float32),
            torch.tensor([seq - 1, t_dag.NO_TX], dtype=torch.int32), torch.tensor(0.5),
            torch.tensor(0.0), seq % CAP)
        tnet.write(node, d)
        tnet.bank_commit(node, seq % CAP, {"w": torch.full((8,), value)})
        jnet.advance(t)
        tnet.advance(t)
        compare(f"step {seq}: ")
    assert tnet.converge() == jnet.converge()
    compare("converge: ")
    assert tnet.synced() == jnet.synced()


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def test_run_dagfl_gossip_bank_matches_reference():
    """A starved ring (10 Mbit/s links, 7 MB slots: a chunk takes 1.4 ticks
    per link, so credit rolls over and gating holds rows back) with losses,
    strides and a partition that heals."""
    n, seed, gseed = 8, 0, 3
    jt, jn, jg, _ = j_exp.make_cnn_setup(num_nodes=n, seed=seed)
    _, tn, tg, _ = t_exp.make_cnn_setup(num_nodes=n, seed=seed)
    jd, td = j_exp.default_dagfl_config(n), t_exp.default_dagfl_config(n)
    rj = j_sys.run_dagfl_gossip(
        jt, jn, jd, j_sys.SimConfig(iterations=20, eval_every=5, seed=seed), jg,
        topology=j_topo.ring(n, link_latency=1.5, drop=0.3, bandwidth=1e7),
        gossip=j_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        partition=j_gossip.PartitionSchedule(j_topo.split_halves(n), 5.0, 12.0),
        bank_gossip=j_bank.BankGossipConfig(chunks_per_slot=4, slot_bytes=7e6))
    rt = t_sys.run_dagfl_gossip(
        seeded_task(jt, seed), tn, td, t_sys.SimConfig(iterations=20, eval_every=5, seed=seed),
        tg, topology=t_topo.ring(n, link_latency=1.5, drop=0.3, bandwidth=1e7),
        gossip=t_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        partition=t_gossip.PartitionSchedule(t_topo.split_halves(n), 5.0, 12.0),
        bank_gossip=t_bank.BankGossipConfig(chunks_per_slot=4, slot_bytes=7e6),
        device="cpu", draw=reference_draws(seed, td.capacity),
        edge_draw=reference_edge_draws(gseed, n))
    assert rt.avg_latency == rj.avg_latency
    for name in ("iters", "times", "accs"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name), err_msg=name)
    assert_dags_equal(rt.extras["dag"], rj.extras["dag"], INT_FIELDS + ("publish_time",))
    assert_dags_equal(rt.extras["replicas"].dags, rj.extras["replicas"].dags,
                      INT_FIELDS + ("publish_time",))
    assert_state_equal(rt.extras["replicas"].bank_state, rj.extras["replicas"].bank_state)
    for key in ("divergence_curve", "bank_lag_curve", "bank_missing_final",
                "missing_rows_final"):
        np.testing.assert_array_equal(rt.extras[key], np.asarray(rj.extras[key]), err_msg=key)
    for key in ("bank_bytes_sent", "sync_rounds", "device_calls", "dispatch_counts",
                "approvals_issued", "approvals_in_union", "synced_final"):
        assert rt.extras[key] == rj.extras[key], key
    lag = rt.extras["bank_lag_curve"]
    assert lag.shape == (4, 3) and lag[:, 2].max() > 0            # payloads really lag
    assert 0 < rt.extras["bank_bytes_sent"]
    assert rt.extras["dispatch_counts"]["bank_commit"] == 20
    for k in rj.final_params:
        np.testing.assert_allclose(rt.final_params[k].numpy(), np.asarray(rj.final_params[k]),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_unlimited_bandwidth_run_is_the_bankless_run(impl):
    """With unlimited bandwidth the banked run is bitwise the bankless one:
    curve, union, every replica, parameters; only the transport extras and
    the bank's own dispatch labels differ."""
    n = 8
    dcfg = t_exp.default_dagfl_config(num_nodes=n)
    sim = t_sys.SimConfig(iterations=10, eval_every=5, seed=0)
    results = []
    for bank_gossip in (None, t_bank.BankGossipConfig(chunks_per_slot=4)):
        task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=n, seed=0)
        results.append(t_sys.run_dagfl_gossip(
            task, nodes, dcfg, sim, gval, topology=t_topo.ring(n, seed=0),
            gossip=t_gossip.GossipConfig(sync_period=1.0, seed=0, impl=impl),
            bank_gossip=bank_gossip, device="cpu"))
    base, banked = results
    for name in ("iters", "times", "accs"):
        np.testing.assert_array_equal(getattr(base, name), getattr(banked, name), err_msg=name)
    for a, b in ((base.extras["dag"], banked.extras["dag"]),
                 (base.extras["replicas"].dags, banked.extras["replicas"].dags)):
        for f in t_dag.DagState._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for k in base.final_params:
        assert torch.equal(base.final_params[k], banked.final_params[k]), k
    assert base.extras["sync_rounds"] == banked.extras["sync_rounds"]
    assert banked.extras["bank_missing_final"].max() == 0 and banked.extras["bank_bytes_sent"] > 0
    assert banked.extras["bank_lag_curve"][:, 2].max() == 0
    assert base.extras["dispatch_counts"]["advance"] == \
        banked.extras["dispatch_counts"]["advance_bank"]
