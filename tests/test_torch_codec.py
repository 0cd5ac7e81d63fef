"""The port's wire codec against the reference: the plain quantisation,
dequantisation and top-k, ``DeltaCodec`` (ratios, keys, encode/decode blocked
leaf by leaf), the digest of the wire form, the codec's pricing in a scripted
priced ``GossipNetwork`` schedule and whole ``run_dagfl_gossip`` runs.

The same numpy-made inputs go to both packages; the JAX side runs as its own
tests run it (``repro.kernels.ref`` eagerly, the Pallas kernels in interpret
mode). Tolerances:

- bitwise: codes, scales, masked deltas and decoded payloads against the
  eager ``ref`` functions and the reference's ``DeltaCodec`` (both divide
  with true IEEE division and round half to even); against the interpreted
  Pallas kernels codes and masks are bitwise and scales within one ulp, since
  the jitted kernel computes ``amax / qmax`` as a reciprocal multiply (the
  reference's own ``tests/test_delta_codec.py`` notes the same);
- bitwise: bitmaps, counts, the f32 transport arithmetic (have, credit,
  sent, bytes) and integer ledger columns;
- digests: within 1e-5 of the sum of |x_i · proj_i| (as
  ``tests/test_torch_bank.py``), and bitwise self-consistent in the port;
- trained parameters of a lossy run against the reference within 1e-4 plus
  one quantisation step of the value: training in two libraries differs by
  about 1e-7, and a value that lies that close to a rounding boundary moves
  its code by one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dag as j_dag
from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro.kernels import delta_codec as j_dc
from repro.kernels import ref as j_ref
from repro.net import bank as j_bank
from repro.net import gossip as j_gossip
from repro.net import replica as j_replica
from repro.net import topology as j_topo
from repro_torch.core import bank as t_store
from repro_torch.core import dag as t_dag
from repro_torch.core.aggregation import leaf_shapes
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.fl import tasks as t_tasks
from repro_torch.kernels import cuda_build
from repro_torch.kernels import delta_codec as t_dc
from repro_torch.net import bank as t_bank
from repro_torch.net import gossip as t_gossip
from repro_torch.net import replica as t_replica
from repro_torch.net import topology as t_topo
from test_torch_bank import CAP, assert_state_equal, genesis_j
from test_torch_gossip import (INT_FIELDS, assert_dags_equal, dag_to_t, reference_draws,
                               reference_edge_draws, seeded_task)

KINDS = ("int8", "int4", "topk")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: the suite runs several
    processes at once, and PyTorch's default of one spinning thread per core
    in each of them slows the whole-run tests a hundredfold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
QMAX = {"int8": 127, "int4": 7}
DIGEST_RTOL = 1e-5


def bits(x) -> np.ndarray:
    """The bit pattern of an f32 array: equal bits, NaN and -0.0 included."""
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def assert_bitwise(got, want, msg=""):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=msg)


# ---------------------------------------------------------------------------
# plain versions against ref and the interpreted Pallas kernels
# ---------------------------------------------------------------------------


def quant_input(case: str, qmax: int, nb: int, rng) -> np.ndarray:
    x = (rng.standard_normal((nb, t_dc.BLOCK)) * rng.uniform(1e-3, 1e2, (nb, 1)))
    if case == "zero_blocks":
        x[::3] = 0.0
        x[1::3] = np.where(rng.random((len(x[1::3]), t_dc.BLOCK)) < 0.5, -0.0, 0.0)
    if case == "halves":
        # amax = qmax * 2**e gives scale = 2**e exactly, so x / scale = m + 0.5
        e = rng.integers(-12, 12, nb)
        m = rng.integers(-qmax, qmax, (nb, t_dc.BLOCK)) + 0.5
        x = m * np.exp2(e)[:, None]
        x[:, 0] = qmax * np.exp2(e) * np.where(rng.random(nb) < 0.5, -1, 1)
    return x.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "zero_blocks", "halves"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quant_plain_matches_reference(case, kind):
    qmax = QMAX[kind]
    rng = np.random.default_rng(len(case) * qmax)
    nb = 37                                    # not a multiple of the kernel's BLOCK_T = 8
    x = quant_input(case, qmax, nb, rng)
    codes, scales = t_dc.quant_blocks_plain(torch.from_numpy(x), qmax)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    want_c, want_s = j_ref.quant_blocks_ref(x, qmax)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
    assert_bitwise(scales.numpy(), want_s)
    deq = t_dc.dequant_blocks_plain(codes, scales)
    assert_bitwise(deq.numpy(), j_ref.dequant_blocks_ref(want_c, want_s))
    pal_c, pal_s = j_dc.quant_blocks_pallas(jnp.asarray(x), qmax, interpret=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(pal_c))
    pal_s = np.asarray(pal_s)
    assert np.all(np.abs(scales.numpy() - pal_s) <= np.spacing(np.abs(pal_s)))
    if case == "zero_blocks":
        assert np.all(scales.numpy()[::3] == 1.0) and np.all(codes.numpy()[::3] == 0)
    if case == "halves":                        # round half to even happened somewhere
        q = x / scales.numpy()[:, None]
        assert np.any(np.abs(q - np.round(q)) == 0.5)


def topk_input(case: str, nb: int, rng) -> np.ndarray:
    d = rng.standard_normal((nb, t_dc.BLOCK)).astype(np.float32)
    if case == "ties":
        d = rng.integers(-3, 4, (nb, t_dc.BLOCK)).astype(np.float32)
    if case == "nan_and_zeros":                 # few values: zeros of both signs reach rank < k
        d = np.where(rng.random(d.shape) < 0.5, -0.0, 0.0).astype(np.float32)
        u = rng.random(d.shape)
        d[u < 0.03] = rng.integers(-2, 3, int((u < 0.03).sum()))
        d[u > 0.98] = np.nan
    if case == "sparse":                        # k >= nnz keeps the delta exactly
        d[rng.random(d.shape) < 0.95] = 0.0
        d[::2] = 0.0
    return d


@pytest.mark.parametrize("case,k", [("random", 8), ("random", 1), ("ties", 8),
                                    ("nan_and_zeros", 8), ("sparse", 8), ("sparse", 128),
                                    ("random", 300)])
def test_topk_plain_matches_reference(case, k):
    rng = np.random.default_rng(k + len(case))
    d = topk_input(case, 21, rng)
    got = t_dc.topk_blocks_plain(torch.from_numpy(d), k).numpy()
    assert_bitwise(got, j_ref.topk_blocks_ref(d, k))
    assert_bitwise(got, j_dc.topk_blocks_pallas(jnp.asarray(d), k, interpret=True))
    if case == "sparse" and k == 128:
        assert_bitwise(got, d)
    if case == "nan_and_zeros":                 # NaNs are kept, dropped values are +0.0
        assert np.isnan(got[np.isnan(d)]).all()
        assert np.any(bits(got) == bits(np.float32(-0.0)))


def test_topk_plain_slabs_do_not_change_the_result(monkeypatch):
    d = torch.from_numpy(topk_input("ties", 11, np.random.default_rng(4)))
    whole = t_dc.topk_blocks_plain(d, 8)
    monkeypatch.setattr(t_dc, "PLAIN_SLAB", 3)
    assert torch.equal(t_dc.topk_blocks_plain(d, 8), whole)


# ---------------------------------------------------------------------------
# DeltaCodec: ratios, keys, blocking, encode/decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(kind="none"), dict(kind="int8"), dict(kind="int4"),
                                dict(kind="topk"), dict(kind="topk", topk_frac=1.0),
                                dict(kind="int8", block=64), dict(kind="topk", block=96,
                                                                   topk_frac=0.1)])
def test_ratio_k_and_key_match_reference(kw):
    tc, jc = t_dc.DeltaCodec(**kw), j_dc.DeltaCodec(**kw)
    assert tc.is_identity == jc.is_identity
    assert tc.topk_k() == jc.topk_k()
    assert tc.wire_ratio() == jc.wire_ratio()
    assert (t_dc.codec_key(tc) is None) == (j_dc.codec_key(jc) is None)
    if t_dc.codec_key(tc) is not None:
        assert t_dc.codec_key(tc) is tc
    assert t_dc.codec_key(None) is None
    with pytest.raises(ValueError, match="kind"):
        t_dc.DeltaCodec(kind="zstd")


def test_the_paper_cnn_is_blocked_leaf_by_leaf():
    params = t_tasks.CNNTask().init(0, "cpu")
    layout = t_dc.leaf_layout(leaf_shapes(params))
    assert layout.num_values == 1_663_370
    assert layout.num_blocks == 12_998                   # a flat blocking gives 12,996
    assert layout.names[:5] == ("b1", "b2", "bfc", "bout", "conv1")
    assert layout.first_value[3:5] == (608, 618)         # offsets not 16-byte aligned
    enc = t_dc.DeltaCodec("int8").encode(params, params)
    assert t_bank._leaves_flat(enc).shape == (1_676_742,)    # 1,663,744 codes + 12,998 scales
    assert sum(v.numel() for v in enc["codes"].values()) == 1_663_744


def small_cnn_pair(seed):
    """Payload and base of the bench CNN (leaves of 72, 8, 1152, ... values:
    none a multiple of 128), from the reference's init, as numpy."""
    jtask = j_exp.bench_cnn_task()
    p = {k: np.asarray(v) for k, v in jtask.init(jax.random.PRNGKey(seed)).items()}
    rng = np.random.default_rng(seed)
    p = {k: (v + 0.01 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p.items()}
    b = {k: (v + 0.001 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p.items()}
    b["b1"][:] = p["b1"]                        # a leaf whose delta is all zero
    return p, b


def leaves_in_order(tree):
    out = []

    def walk(node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        else:
            out.append(node)

    walk(tree)
    return out


@pytest.mark.parametrize("kind", KINDS + ("none",))
def test_encode_decode_match_reference(kind):
    p, b = small_cnn_pair(1)
    assert any(v.size % t_dc.BLOCK for v in p.values())
    tp, tb = t_tasks.params_from_jax(p, "cpu"), t_tasks.params_from_jax(b, "cpu")
    jp, jb = ({k: jnp.asarray(v) for k, v in d.items()} for d in (p, b))
    tc, jc = t_dc.DeltaCodec(kind), j_dc.DeltaCodec(kind, impl="lax")
    t_enc, j_enc = tc.encode(tp, tb), jc.encode(jp, jb)
    got, want = leaves_in_order(t_enc), jax.tree_util.tree_leaves(j_enc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.numpy().dtype == np.asarray(w).dtype
        assert_bitwise(g.numpy().astype(np.float32), np.asarray(w).astype(np.float32))
    t_dec, j_dec = tc.decode(t_enc, tb), jc.decode(j_enc, jb)
    for name in p:
        assert_bitwise(t_dec[name].numpy(), j_dec[name])
        assert tuple(t_dec[name].shape) == p[name].shape
    if kind == "topk":                          # an all-zero delta leaf stays the base
        assert torch.equal(t_dec["b1"], tb["b1"])


@pytest.mark.parametrize("kind", KINDS)
def test_wire_digests_match_reference_and_themselves(kind):
    p, b = small_cnn_pair(2)
    tp, tb = t_tasks.params_from_jax(p, "cpu"), t_tasks.params_from_jax(b, "cpu")
    tc = t_dc.DeltaCodec(kind)
    enc = tc.encode(tp, tb)
    got = t_bank.chunk_digests(enc, 4)
    again = t_bank.chunk_digests(tc.encode({k: v.clone() for k, v in tp.items()}, tb), 4)
    assert torch.equal(got, again)
    j_enc = j_dc.DeltaCodec(kind, impl="lax").encode(
        {k: jnp.asarray(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in b.items()})
    want = np.asarray(j_bank.chunk_digests(j_enc, 4))
    flat = t_bank._leaves_flat(enc).numpy().astype(np.float64)
    per = -(-flat.shape[0] // 4)
    x = np.pad(flat, (0, 4 * per - flat.shape[0])).reshape(4, per)
    idx = np.arange(per)
    scale = np.abs(x) @ np.abs(np.cos(idx * 0.618033988749895) + 1e-3 * np.sin(idx * 0.318309886))
    assert np.all(np.abs(got.numpy() - want) <= DIGEST_RTOL * scale)
    # the wire form digests differently from the payload it encodes
    assert not torch.equal(got, t_bank.chunk_digests(tp, 4))


def test_wrappers_launch_nothing_off_the_card():
    before = dict(cuda_build.LAUNCHES)
    x = torch.randn(3, t_dc.BLOCK)
    c, s = t_dc.quant_blocks(x, 127)
    assert c.shape == (3, t_dc.BLOCK) and s.shape == (3,)
    assert t_dc.topk_blocks(x, 4).shape == (3, t_dc.BLOCK)
    layout = t_dc.leaf_layout((("a", (5,)), ("b", (130,))))
    assert t_dc.quant_leaves(torch.randn(135), layout, 7)[0].shape == (3, t_dc.BLOCK)
    assert dict(cuda_build.LAUNCHES) == before


# ---------------------------------------------------------------------------
# the codec on the priced network
# ---------------------------------------------------------------------------


def t_net(top, codec, seed=0, max_ticks=1000):
    return t_gossip.GossipNetwork(
        dag_to_t(genesis_j(top.num_nodes)), t_store.init_bank({"w": torch.zeros(8)}, CAP), top,
        t_gossip.GossipConfig(sync_period=1.0, seed=seed, max_ticks_per_advance=max_ticks),
        bank_cfg=t_bank.BankGossipConfig(chunks_per_slot=4, codec=codec),
        edge_draw=reference_edge_draws(seed, top.num_nodes))


def t_commit(net, node, seq, t, payload, approve=t_dag.NO_TX, encode=True):
    """What ``_GossipLedger.commit`` does: encode against the slot's content
    before the overwrite, store the decoded values, digest the wire form.
    ``encode=False`` commits the raw payload, as the reference's network
    tests do."""
    d = t_replica.publish_local(
        net.read(node), seq, node, torch.tensor(t, dtype=torch.float32),
        torch.tensor([approve, t_dag.NO_TX], dtype=torch.int32), torch.tensor(0.5),
        torch.tensor(0.0), seq % CAP)
    codec, slot = net.bank_cfg.codec, seq % CAP
    params = {"w": payload}
    enc = params
    if encode and codec is not None and not codec.is_identity:
        base = t_store.bank_read(net.bank, slot)
        enc = codec.encode(params, base)
        params = codec.decode(enc, base)
    net.write(node, d, t_store.bank_write(net.bank, slot, params))
    net.bank_commit(node, slot, enc)


def test_active_codec_prices_bytes_at_wire_ratio():
    """With capacity to move every needed chunk, each codec run moves the
    raw run's chunks and its meter records ``wire_ratio()`` times the bytes.
    The same payload is committed unencoded in every run (as in the
    reference's test), so dedup treats every run alike."""
    top = t_topo.ring(4, link_latency=1.0, bandwidth=1e9, seed=3)
    runs = {}
    for kind in (None,) + KINDS:
        net = t_net(top, None if kind is None else t_dc.DeltaCodec(kind))
        t_commit(net, 0, 1, 0.2, torch.linspace(-1.0, 1.0, 8), encode=False)
        for t in (1.0, 2.0, 3.0):
            net.advance(t)
        runs[kind] = net
    sent = runs[None].bank_state.sent.numpy()
    assert sent.sum() > 0
    for kind in KINDS:
        ratio = t_dc.DeltaCodec(kind).wire_ratio()
        assert torch.equal(runs[kind].bank_state.have, runs[None].bank_state.have), kind
        np.testing.assert_allclose(runs[kind].bank_state.sent.numpy(), sent * ratio, rtol=1e-6)


def test_commit_store_holds_dequantized_values():
    """The store holds what a receiver decodes, and re-encoding it gives
    the same wire bytes."""
    net = t_net(t_topo.ring(4, bandwidth=1e9), t_dc.DeltaCodec("int8"))
    payload = torch.from_numpy(np.random.default_rng(0).standard_normal(8).astype(np.float32))
    t_commit(net, 0, 1, 0.2, payload)
    codec, zero = t_dc.DeltaCodec("int8"), {"w": torch.zeros(8)}
    enc = codec.encode({"w": payload}, zero)
    stored = t_store.bank_read(net.bank, 1)
    assert torch.equal(stored["w"], codec.decode(enc, zero)["w"])
    assert not torch.equal(stored["w"], payload)
    assert torch.equal(codec.encode(stored, zero)["codes"]["w"], enc["codes"]["w"])


@pytest.mark.parametrize("kind", KINDS)
def test_network_codec_schedule_matches_reference(kind):
    """A priced schedule (0.5 B per link per tick against 8 B raw chunks) with
    losses, strides, a lazy republish and a final converge, committed through
    the codec by both packages: rows, transport state, missing chunks, bytes
    and the store's rows equal after every step."""
    n, seed = 5, 4
    top_args = dict(link_latency=1.5, drop=0.2, seed=0, bandwidth=4.0)
    jc = j_dc.DeltaCodec(kind, impl="lax")
    jnet = j_gossip.GossipNetwork(
        genesis_j(n), jnp.zeros((CAP, 8)), j_topo.ring(n, **top_args),
        j_gossip.GossipConfig(sync_period=1.0, seed=seed),
        bank_cfg=j_bank.BankGossipConfig(chunks_per_slot=4, codec=jc))
    tnet = t_net(t_topo.ring(n, **top_args), t_dc.DeltaCodec(kind), seed=seed)
    rng = np.random.default_rng(7)
    payloads = [rng.standard_normal(8).astype(np.float32) for _ in range(3)]
    schedule = [(0, 0.5, 0), (2, 1.2, 1), (4, 2.7, 0), (1, 3.1, 2), (3, 5.5, 1)]
    lagged = 0
    for seq, (node, t, which) in enumerate(schedule, start=1):
        d = j_replica.publish_local(
            jnet.read(node), seq, jnp.asarray(node, jnp.int32), jnp.float32(t),
            jnp.asarray([seq - 1, j_dag.NO_TX], jnp.int32), jnp.float32(0.5), jnp.float32(0.0),
            jnp.asarray(seq % CAP, jnp.int32))
        base = jnet.bank[seq % CAP]
        enc = jc.encode(jnp.asarray(payloads[which]), base)
        jnet.write(node, d, jnet.bank.at[seq % CAP].set(jc.decode(enc, base)))
        jnet.bank_commit(node, seq % CAP, enc)
        t_commit(tnet, node, seq, t, torch.from_numpy(payloads[which]), approve=seq - 1)
        jnet.advance(t)
        tnet.advance(t)
        msg = f"step {seq}: "
        assert_dags_equal(tnet.replicas.dags, jnet.replicas.dags)
        assert_state_equal(tnet.bank_state, jnet.bank_state, msg=msg)
        np.testing.assert_array_equal(tnet.missing_chunks(), jnet.missing_chunks(), err_msg=msg)
        assert tnet.bytes_sent() == jnet.bytes_sent(), msg
        assert_bitwise(tnet.bank.rows.numpy(), jnet.bank)
        lagged = max(lagged, int(tnet.missing_chunks().max()))
    assert lagged > 0                                  # payloads lagged their rows
    assert tnet.converge() == jnet.converge()
    assert_state_equal(tnet.bank_state, jnet.bank_state, msg="converge: ")
    assert tnet.tick == jnet.tick and tnet.rounds_run == jnet.rounds_run
    assert tnet.bytes_sent() == jnet.bytes_sent() > 0


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def small_run(device="cpu", codec=None, draws=None, task=None, gseed=3):
    n = 8
    t_task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=n, seed=0)
    kw = {} if draws is None else dict(draw=draws[0], edge_draw=draws[1])
    return t_sys.run_dagfl_gossip(
        task or t_task, nodes, t_exp.default_dagfl_config(n),
        t_sys.SimConfig(iterations=20, eval_every=5, seed=0), gval,
        topology=t_topo.ring(n, link_latency=1.5, drop=0.3, bandwidth=1e7),
        gossip=t_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        partition=t_gossip.PartitionSchedule(t_topo.split_halves(n), 5.0, 12.0),
        bank_gossip=t_bank.BankGossipConfig(chunks_per_slot=4, slot_bytes=7e6, codec=codec),
        device=device, **kw)


def test_identity_codec_run_is_the_uncompressed_run():
    base, ident = small_run(), small_run(codec=t_dc.DeltaCodec("none"))
    for name in ("iters", "times", "accs"):
        np.testing.assert_array_equal(getattr(base, name), getattr(ident, name), err_msg=name)
    for a, b in ((base.extras["dag"], ident.extras["dag"]),
                 (base.extras["replicas"].dags, ident.extras["replicas"].dags)):
        for f in t_dag.DagState._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("have", "credit", "sent"):
        assert torch.equal(getattr(base.extras["replicas"].bank_state, f),
                           getattr(ident.extras["replicas"].bank_state, f)), f
    for key in ("bank_lag_curve", "bank_missing_final", "divergence_curve"):
        np.testing.assert_array_equal(base.extras[key], ident.extras[key], err_msg=key)
    assert base.extras["bank_bytes_sent"] == ident.extras["bank_bytes_sent"]
    assert base.extras["dispatch_counts"] == ident.extras["dispatch_counts"]
    for k in base.final_params:
        assert torch.equal(base.final_params[k], ident.final_params[k]), k
    assert base.extras["bank_lag_curve"][:, 2].max() > 0


def test_run_dagfl_gossip_int8_matches_reference():
    """The starved lossy ring of ``tests/test_torch_bank.py`` with an int8
    codec, the reference's draws fed to the port: the ledgers, transport
    state, lag and bytes are held bitwise."""
    n, seed, gseed = 8, 0, 3
    jt, jn, jg, _ = j_exp.make_cnn_setup(num_nodes=n, seed=seed)
    rj = j_sys.run_dagfl_gossip(
        jt, jn, j_exp.default_dagfl_config(n),
        j_sys.SimConfig(iterations=20, eval_every=5, seed=seed), jg,
        topology=j_topo.ring(n, link_latency=1.5, drop=0.3, bandwidth=1e7),
        gossip=j_gossip.GossipConfig(sync_period=1.0, seed=gseed),
        partition=j_gossip.PartitionSchedule(j_topo.split_halves(n), 5.0, 12.0),
        bank_gossip=j_bank.BankGossipConfig(chunks_per_slot=4, slot_bytes=7e6,
                                            codec=j_dc.DeltaCodec("int8")))
    rt = small_run(codec=t_dc.DeltaCodec("int8"), task=seeded_task(jt, seed), gseed=gseed,
                   draws=(reference_draws(seed, t_exp.default_dagfl_config(n).capacity),
                          reference_edge_draws(gseed, n)))
    assert rt.avg_latency == rj.avg_latency
    np.testing.assert_array_equal(rt.iters, rj.iters)
    np.testing.assert_array_equal(rt.times, rj.times)
    assert_dags_equal(rt.extras["dag"], rj.extras["dag"], INT_FIELDS + ("publish_time",))
    assert_dags_equal(rt.extras["replicas"].dags, rj.extras["replicas"].dags,
                      INT_FIELDS + ("publish_time",))
    assert_state_equal(rt.extras["replicas"].bank_state, rj.extras["replicas"].bank_state)
    for key in ("divergence_curve", "bank_lag_curve", "bank_missing_final"):
        np.testing.assert_array_equal(rt.extras[key], np.asarray(rj.extras[key]), err_msg=key)
    for key in ("bank_bytes_sent", "sync_rounds", "dispatch_counts", "approvals_issued"):
        assert rt.extras[key] == rj.extras[key], key
    assert rt.extras["bank_lag_curve"][:, 2].max() > 0
    # the store: every slot decodes from codes; a code one step apart is a flip
    j_rows = np.stack([np.concatenate([np.asarray(rj.extras["replicas"].bank[k][s]).ravel()
                                       for k in sorted(rj.extras["replicas"].bank)])
                       for s in range(t_exp.default_dagfl_config(n).capacity)])
    t_rows = rt.extras["replicas"].bank.rows.numpy()
    step = np.abs(j_rows).max() / 127.0
    diff = np.abs(t_rows - j_rows)
    assert diff.max() <= 1e-4 + step, diff.max()
    for k in rj.final_params:
        np.testing.assert_allclose(rt.final_params[k].numpy(), np.asarray(rj.final_params[k]),
                                   atol=1e-4 + step, rtol=0)
