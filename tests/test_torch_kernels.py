"""The port's kernel modules against the reference.

Eq. (1), ``kernels/fedavg.py``:

On the CPU the wrapper takes its plain version, which is held against the
reference's oracle ``ref.fedavg_ref``, its Pallas kernel (interpret mode,
as the reference's own tests run it) and ``bank_average``. The kernel itself
runs only on a CUDA card: ``test_fedavg_kernel_on_card`` holds it against the
plain version there and skips elsewhere. JAX is imported inside the tests
that use it, so that test also runs where JAX is not installed.

Tolerances: f32 rtol 1e-6 of the sum's scale ``sum_j |w_j x_j|`` (the sums
differ only in order and fma, so their rounding error scales with the terms,
not with a result that may cancel to near 0); bf16 one unit in the last place
of the result on top of that (both sides round their f32 sum to bf16 once,
and two sums a hair apart may round to neighbouring values).

The gossip-merge winner, ``kernels/gossip_merge.py``: its outputs are
indices and counters, so the kernel must equal the plain version bitwise
(``test_gossip_winner_kernel_on_card``, ``test_gossip_winner_kernel_masks_on_card``:
the full overlay, an events batch's few live edges, receivers that hear only
themselves, every sender winning with negative counters); the plain version
is held against the reference in ``tests/test_torch_gossip.py``, the
kernel's walk in ``tests/test_torch_gossip_tiles.py``.

The chunk dedup, ``kernels/chunk_transfer.py``: a bitmap, so the kernel must
equal the plain version bitwise (``test_chunk_dedup_kernel_on_card``,
``test_chunk_dedup_kernel_edge_columns_on_card``: all-NaN, only +-0.0 and
one-class columns, S past one and two hash tables); the plain version is
held against the reference in ``tests/test_torch_bank.py``, the kernel's
hash classes in ``tests/test_torch_dedup_classes.py``.

The event-queue head, ``kernels/event_pop.py``: an index, a flag, the head's
time bits and kind, so the kernel must equal the plain version bitwise
(``test_event_pop_kernel_on_card``: Q either side of a block and of a pass
of the thread block cluster, and a million slots), NaN and -0.0 included,
and ``pop_head``'s pinned host mirror must equal the device words
(``test_pop_head_mirror_on_card``); the plain version is held against the
reference in ``tests/test_torch_events.py``, the kernel's fold in
``tests/test_torch_event_pop_keys.py``.

The wire codec, ``kernels/delta_codec.py``: codes, scales, decoded payloads
and masked deltas must equal the plain versions bitwise
(``test_quant_kernel_on_card``, ``test_quant_params_kernel_on_card``: leaves
read through their own pointers, aligned or not, blocks of 32 to 1,024 and
not a multiple of 4, 41 leaves in two launches, the decoded payload in the
same launch; ``test_encode_decode_on_card_is_decode_of_encode``;
``test_topk_kernel_on_card``, ``test_topk_kernel_dense_on_card``: blocks of
32, 33 and 1,024, k from 0 to B, blocks all equal and all NaN;
``test_encode_on_card_equals_the_cpu``); the plain versions are held
against the reference in ``tests/test_torch_codec.py``, the quantisation
kernel's lanes and leaf table in ``tests/test_torch_quant_lanes.py``, the
top-k kernel's selection in ``tests/test_torch_topk_select.py``.

The histogram update, ``kernels/hist_bincount.py``: integer sums, so the
kernel must equal the plain version bitwise, by its idx route
(``test_hist_bincount_kernel_on_card``, out-of-range and negative indices
dropped) and by its fused route, which bins as ``obs.hist.bin_index`` does
(``test_record_kernel_on_card``: every f32 edge of two configurations,
special values, bool and i32 weights, one cluster and the grid-stride
route); the plain version is held against the reference's oracle and its
Pallas kernel in ``tests/test_torch_hist.py`` and here
(``test_hist_bincount_plain_matches_ref_and_pallas``), the fused route's
arithmetic and partition in ``tests/test_torch_hist_record.py``.

The pairwise model distance, ``kernels/model_distance.py``: sums of N
products in another order, and a diagonal that cancels to near 0, so each
entry is held to a bound on its sum of absolute terms, ``sq_i + sq_j + 2
|x_i . x_j|``: the plain version within 1e-6 of it against the reference's
oracle and its interpreted Pallas kernel, the kernel within 1e-5 of it
against the plain version on the card (``test_model_distance_kernel_on_card``:
k = 1, 5, 16, 32, N not a multiple of a chunk, a row of zeros, a strided
view), and bitwise against itself from call to call.

Prefill and decode attention, ``kernels/flash_attention.py``: the kernels
compute scores and probabilities in f32 (bf16 on the tensor cores with p
split into two bf16 parts) and round only the output, so each output is
held within 1e-5 of the sum ``sum_j p_j |v_j|`` of the plain version run in
f32 on the same inputs, plus one bf16 unit in the last place for bf16
(``test_flash_attention_kernel_on_card``,
``test_decode_attention_kernel_on_card``: f32 and bf16, hd 64, 128, 256,
G = 1, 2, 3, 5, 8, ragged S, S either side of the bf16 route's query and key
tiles, windows, one narrower than a key tile, lengths 0, 1 and S and either
side of a chunk, rows with one chunk to read, the model's permuted views),
and bitwise against itself from call to call; the plain versions are held
against the reference in ``tests/test_torch_attention.py``, the bf16
route's arithmetic in ``tests/test_torch_attention_split.py``.

The RWKV6 WKV recurrence, ``kernels/wkv.py``, two routes of one source. The
chunked route (``wkv``): y and the final state are held within 1e-5 of the
same function on the absolute values of r, k, v, u and the state (the
decays are positive, so that is each output's sum of absolute terms)
against ``wkv_chunked_plain`` run in f32 on the same inputs, and within
5e-4 of it against the sequential ``wkv_scan_plain``, from which the
chunked form itself lies up to 1.1e-4 away when decays are wide
(``cum_prev[t] - cum[s]`` cancels); f32 and bf16, hd 64 and 128,
model-like, strong and wide decays, a nonzero initial state, strided views,
state carried across calls, and bitwise against itself from call to call.
The sequential route (``wkv_scan``): within 1e-5 of ``wkv_scan_plain`` on
the same bar, any T >= 1, bitwise from call to call, and in place (``out``
the state itself) bitwise equal to out of place. The plain versions are
held against the reference in ``tests/test_torch_wkv.py``, the chunked
route's split TF32 arithmetic in ``tests/test_torch_wkv_split.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import aggregation as t_agg
from repro_torch.core import bank as t_bank
from repro_torch.kernels import chunk_transfer as t_ck
from repro_torch.kernels import delta_codec as t_dc
from repro_torch.kernels import cuda_build
from repro_torch.kernels import event_pop as t_pop
from repro_torch.kernels import fedavg as t_fedavg
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import gossip_merge as t_gm
from repro_torch.kernels import hist_bincount as t_hb
from repro_torch.kernels import model_distance as t_md
from repro_torch.kernels import wkv as t_wkv
from repro_torch.obs import hist as t_hist


@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    from repro.core import bank as j_bank
    from repro.kernels import ops, ref

    return jax, ops, ref, j_bank


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    return torch.device("cuda")


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_close(got: np.ndarray, want: np.ndarray, bf16: bool, scale: np.ndarray):
    """``scale``: sum_j |w_j x_j| per element, the size of the summed terms."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    tol = 1e-6 * scale
    if bf16:
        tol = tol + _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(1, 1), (2, 1000), (3, 4099), (8, 16385)])
def test_fedavg_plain_matches_ref_and_pallas(jax_ref, k, n, dtype):
    jax, ops, ref, _ = jax_ref
    import jax.numpy as jnp

    rng = np.random.default_rng(k * 1000 + n)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    models = rng.normal(size=(k, n)).astype(np.float32)
    jm = jnp.asarray(models).astype(getattr(jnp, dtype))
    tm = torch.from_numpy(models).to(getattr(torch, dtype))
    bf16 = dtype == "bfloat16"

    out = t_fedavg.fedavg(torch.from_numpy(w), tm)
    assert out.shape == (n,) and out.dtype == tm.dtype
    got = out.float().numpy()
    scale = np.abs(w) @ np.abs(tm.float().numpy())
    _assert_close(got, np.asarray(ref.fedavg_ref(jnp.asarray(w), jm)).astype(np.float32), bf16,
                  scale)
    _assert_close(got, np.asarray(ops.fedavg(jnp.asarray(w), jm, block_n=4096)).astype(np.float32),
                  bf16, scale)


def _param_sets(rng, count):
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    return [{name: rng.normal(size=s).astype(np.float32) for name, s in shapes.items()}
            for _ in range(count)]


def _banks(jax_ref, params, cap):
    """The same models in the reference's pytree bank and the port's flat bank."""
    _, _, _, j_bank = jax_ref
    import jax.numpy as jnp

    jb = j_bank.init_bank({k: jnp.asarray(v) for k, v in params[0].items()}, cap)
    tb = t_bank.init_bank({k: torch.from_numpy(v) for k, v in params[0].items()}, cap)
    for slot, p in enumerate(params):
        jb = j_bank.bank_write(jb, jnp.asarray(slot), {k: jnp.asarray(v) for k, v in p.items()})
        tb = t_bank.bank_write(tb, slot, {k: torch.from_numpy(v) for k, v in p.items()})
    return jb, tb


@pytest.mark.parametrize("slots", [
    [3, 5],              # the main path: k = 2 valid tips
    [4, -1],             # one NO_TX: its weight is 0, the rest renormalise
    [2, 2, 6],           # a duplicate slot adds twice, as the one-hot sum does
    [-1, -1],            # no valid slot: all weights 0, output 0
    [7, 0, 1, 5, 3, 2, -1, 6],
])
def test_bank_average_matches_reference(jax_ref, slots):
    _, _, _, j_bank = jax_ref
    import jax.numpy as jnp

    rng = np.random.default_rng(len(slots))
    params = _param_sets(rng, 8)
    jb, tb = _banks(jax_ref, params, 8)
    w = rng.uniform(0.1, 1.0, len(slots)).astype(np.float32)
    want = j_bank.bank_average(jb, jnp.asarray(slots, jnp.int32), jnp.asarray(w))
    got = t_bank.bank_average(tb, torch.tensor(slots, dtype=torch.int32), torch.from_numpy(w))
    assert sorted(got) == sorted(want)
    wn = np.where(np.asarray(slots) >= 0, w, 0.0)
    wn = wn / max(wn.sum(), 1e-9)
    for name in want:
        stacked = np.stack([p[name] for p in params])[np.maximum(slots, 0)]
        scale = np.tensordot(np.abs(wn), np.abs(stacked), axes=1)
        _assert_close(got[name].numpy(), np.asarray(want[name]), False, scale)


def test_fedavg_pytree_matches_reference(jax_ref):
    import jax.numpy as jnp
    from repro.core import aggregation as j_agg

    rng = np.random.default_rng(0)
    stacked = {"w": rng.normal(size=(3, 4, 5)).astype(np.float32),
               "b": rng.normal(size=(3, 7)).astype(np.float32)}
    w = np.array([0.2, 0.3, 0.5], np.float32)
    want = j_agg.fedavg_pytree({k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(w))
    got = t_agg.fedavg_pytree({k: torch.from_numpy(v) for k, v in stacked.items()},
                              torch.from_numpy(w))
    for name, leaf in stacked.items():
        scale = np.tensordot(np.abs(w), np.abs(leaf), axes=1)
        _assert_close(got[name].numpy(), np.asarray(want[name]), False, scale)


@pytest.mark.parametrize("dtype,per_row", [(torch.float32, 4), (torch.bfloat16, 8)])
def test_alloc_rows_pads_the_stride_to_16_bytes(dtype, per_row):
    rows = t_fedavg.alloc_rows(3, 1_000_003, dtype)
    assert rows.shape == (3, 1_000_003) and rows.dtype == dtype
    assert rows.stride(0) % per_row == 0 and rows.stride(0) - 1_000_003 < per_row
    assert rows.stride(1) == 1 and not rows.any()


def test_plain_version_clamps_slots_as_the_kernel_does():
    rows = torch.arange(12.0).reshape(3, 4)
    out = t_fedavg.fedavg_gather(rows, torch.tensor([-4, 9], dtype=torch.int32),
                                 torch.tensor([1.0, 1.0]))
    torch.testing.assert_close(out, rows[0] + rows[2])


def test_wrapper_launches_nothing_off_the_card():
    before = cuda_build.LAUNCHES["fedavg_gather"]
    t_fedavg.fedavg(torch.tensor([0.5, 0.5]), torch.ones(2, 8))
    assert cuda_build.LAUNCHES["fedavg_gather"] == before
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_fedavg.fedavg(torch.empty(2, device="meta"), meta)


def test_build_targets_sm90a_without_fast_math(tmp_path):
    cmd = cuda_build.build_command("nvcc", cuda_build.CSRC / "fedavg.cu", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cuda_build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    # an edited source builds into another library
    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = cuda_build.library_path(src)
    src.write_text("// two")
    assert cuda_build.library_path(src) != first


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,padded", [(2, 1_663_370, True), (8, 1_000_003, True),
                                        (3, 1_000_003, False), (1, 5, True)])
def test_fedavg_kernel_on_card(cuda, dtype, k, n, padded):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    rows = (t_fedavg.alloc_rows(16, n, dtype, cuda) if padded
            else torch.empty((16, n), dtype=dtype, device=cuda))
    rows.normal_(generator=gen)
    slots = torch.randint(-2, 18, (k,), generator=gen, device=cuda, dtype=torch.int32)
    w = torch.rand((k,), generator=gen, device=cuda)
    before = cuda_build.LAUNCHES["fedavg_gather"]
    got = t_fedavg.fedavg_gather(rows, slots, w)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["fedavg_gather"] == before + 1
    want = t_fedavg.fedavg_gather_plain(rows, slots, w)
    picked = rows[slots.long().clamp(0, 15)].float()
    scale = (w.abs()[:, None] * picked.abs()).sum(0)
    _assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), dtype == torch.bfloat16,
                  scale.cpu().numpy())
    with pytest.raises(TypeError):
        t_fedavg.fedavg_gather(rows, slots.long(), w)


def gossip_state(gen, r, cap, device):
    """Winner inputs with key ties, equal times under other publishers,
    rows nobody holds, and negative, zero and positive counters."""
    kw = dict(generator=gen, device=device)
    pub = torch.randint(-1, 4, (r, cap), dtype=torch.int32, **kw)
    pub[:, ::37] = -1
    t = torch.randint(0, 4, (r, cap), **kw).float() * 0.5
    ac = torch.randint(-1, 6, (r, cap), dtype=torch.int32, **kw)
    return t, pub, ac


def test_gossip_wrapper_launches_nothing_off_the_card():
    gen = torch.Generator().manual_seed(0)
    t, pub, ac = gossip_state(gen, 5, 7, "cpu")
    before = cuda_build.LAUNCHES["gossip_winner"]
    src, acc = t_gm.gossip_winner(t, pub, ac, torch.ones((2, 5), dtype=torch.uint8), row_offset=3)
    assert cuda_build.LAUNCHES["gossip_winner"] == before
    assert src.shape == acc.shape == (2, 7) and src.dtype == acc.dtype == torch.int32
    assert bool(((src >= 0) & (src < 5)).all())
    meta = torch.empty((5, 7), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_gm.gossip_winner(meta, meta.int(), meta.int(), torch.ones((5, 5), device="meta"))
    source = cuda_build.CSRC / "gossip_merge.cu"
    cmd = cuda_build.build_command("nvcc", source, "x.so")
    assert source.exists() and "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(source)


@pytest.mark.cuda
@pytest.mark.parametrize("r,rr,cap,offset,density", [
    (100, 100, 512, None, 0.5),     # a round at the main path's shape
    (100, 100, 512, None, 1.0),     # a round on the full overlay: every edge live
    (100, 1, 512, None, 1.0),       # the union fold (merge_all)
    (100, 25, 512, 50, 0.5),        # a receiver block
    (100, 100, 1000, None, 0.5),    # cap not a multiple of the block
    (5000, 3, 129, 4990, 0.3),      # more senders than one staged window
    (300, 40, 70, 100, 0.02),       # sparse rows over three windows
    (300, 4, 40, 50, 0.005),        # a few senders past one window
    (7, 7, 5, None, 0.0),           # nobody hears anybody: every receiver keeps its rows
])
def test_gossip_winner_kernel_on_card(cuda, r, rr, cap, offset, density):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(r + cap)
    t, pub, ac = gossip_state(gen, r, cap, cuda)
    mask = torch.rand((rr, r), generator=gen, device=cuda) < density
    before = cuda_build.LAUNCHES["gossip_winner"]
    got = t_gm.gossip_winner(t, pub, ac, mask, row_offset=offset)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["gossip_winner"] == before + 1
    row_ids = None if offset is None else offset + torch.arange(rr, device=cuda)
    want = t_gm.gossip_winner_plain(t, pub, ac, mask, row_ids=row_ids)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the mask may be bytes too, and a NaN time wins nothing
    t[0, :] = float("nan")
    got = t_gm.gossip_winner(t, pub, ac, mask.to(torch.uint8), row_offset=offset)
    want = t_gm.gossip_winner_plain(t, pub, ac, mask, row_ids=row_ids)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(TypeError):
        t_gm.gossip_winner(t, pub.long(), ac, mask)
    with pytest.raises(ValueError, match="row_offset"):
        t_gm.gossip_winner(t, pub, ac, mask, row_offset=r - rr + 1)


def events_batch_mask(gen, n, device, live):
    """An events batch's mask on the full-width path: ``live`` edges of
    ``k_regular(n, 8)`` fire at one instant, and the round adds the diagonal."""
    from repro_torch.net.topology import k_regular

    edges = torch.nonzero(torch.from_numpy(k_regular(n, 8).adjacency))
    pick = torch.randperm(len(edges), generator=gen, device=device)[:live].cpu()
    mask = torch.eye(n, dtype=torch.bool, device=device)
    mask[edges[pick, 0].to(device), edges[pick, 1].to(device)] = True
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["events_batch", "events_batch_4", "self_only",
                                  "every_sender_wins", "every_sender_wins_r1",
                                  "every_sender_wins_block"])
def test_gossip_winner_kernel_masks_on_card(cuda, case):
    """The masks and states the new walk branches on: a (d) batch's few
    live edges (nearly every receiver self-only), nobody hearing anybody,
    and every sender holding one key with negative counters."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(len(case))
    r, rr, cap, offset = 100, 100, 512, None
    t, pub, ac = gossip_state(gen, r, cap, cuda)
    if case.startswith("events_batch"):
        mask = events_batch_mask(gen, r, cuda, 4 if case.endswith("4") else 1)
    elif case == "self_only":
        mask = torch.zeros((rr, r), dtype=torch.uint8, device=cuda)
    else:
        if case.endswith("r1"):
            r = rr = 1
        elif case.endswith("block"):
            rr, offset = 25, 50
        t, pub = t[:1].expand(r, cap).contiguous(), pub[:1].expand(r, cap).contiguous()
        t[:, 3] = -0.0
        t[::2, 3] = 0.0                       # -0.0 and +0.0 one key
        ac = -torch.randint(1, 6, (r, cap), generator=gen, device=cuda, dtype=torch.int32)
        mask = torch.ones((rr, r), dtype=torch.bool, device=cuda)
    row_ids = None if offset is None else offset + torch.arange(rr, device=cuda)
    before = cuda_build.LAUNCHES["gossip_winner"]
    got = t_gm.gossip_winner(t, pub, ac, mask, row_offset=offset)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["gossip_winner"] == before + 1
    want = t_gm.gossip_winner_plain(t, pub, ac, mask.bool(), row_ids=row_ids)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case.startswith("every_sender_wins") and rr == r:
        assert bool((got[1][:, pub[0] >= 0] < 0).all())   # a negative counter survives
    if case == "self_only":
        own = torch.arange(r, device=cuda, dtype=torch.int32)[:, None].expand(r, cap)
        assert torch.equal(got[0], own)
        assert torch.equal(got[1], torch.where(pub >= 0, ac.clamp(min=0), 0))


def dedup_state(gen, r, s, c, classes, device):
    """Dedup inputs with duplicate digest classes, NaN digests, -0.0 beside
    +0.0, and a mixed presence."""
    kw = dict(generator=gen, device=device)
    dig = torch.randint(0, classes, (s, c), **kw).float()
    dig[torch.rand((s, c), **kw) < 0.05] = float("nan")
    zero = torch.rand((s, c), **kw) < 0.05
    dig[zero] = torch.where(torch.rand((s, c), **kw) < 0.5, -0.0, 0.0)[zero]
    have = torch.rand((r, s, c), **kw) < 0.3
    return have, dig


def test_chunk_dedup_wrapper_launches_nothing_off_the_card():
    gen = torch.Generator().manual_seed(0)
    have, dig = dedup_state(gen, 3, 11, 2, 3, "cpu")
    before = cuda_build.LAUNCHES["chunk_dedup"]
    sat = t_ck.chunk_dedup(have, dig)
    assert cuda_build.LAUNCHES["chunk_dedup"] == before
    assert sat.dtype == torch.bool and torch.equal(sat, t_ck.chunk_dedup_plain(have, dig))
    assert bool((sat | ~have).all())           # physical presence always counts
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_ck.chunk_dedup(torch.empty((3, 11, 2), dtype=torch.bool, device="meta"),
                         torch.empty((11, 2), device="meta"))
    source = cuda_build.CSRC / "chunk_dedup.cu"
    cmd = cuda_build.build_command("nvcc", source, "x.so")
    assert source.exists() and "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(source)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,c,classes", [
    (100, 512, 4, 40),      # a tick and the checks at the main path's shape
    (1, 512, 4, 40),        # each gated view (gate_view)
    (37, 1000, 3, 100),     # ragged: S and R not multiples of a block
    (400, 512, 4, 40),      # more receivers
    (5, 2049, 2, 7),        # more slots than one shared-memory tile
    (9, 64, 3, 1),          # every digest equal in a column
])
def test_chunk_dedup_kernel_on_card(cuda, r, s, c, classes):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(r + s)
    have, dig = dedup_state(gen, r, s, c, classes, cuda)
    before = cuda_build.LAUNCHES["chunk_dedup"]
    got = t_ck.chunk_dedup(have, dig)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["chunk_dedup"] == before + 1
    assert got.dtype == torch.bool
    assert torch.equal(got, t_ck.chunk_dedup_plain(have, dig))
    # presence may be bytes too
    assert torch.equal(t_ck.chunk_dedup(have.to(torch.uint8), dig), got)
    with pytest.raises(TypeError):
        t_ck.chunk_dedup(have, dig.double())
    with pytest.raises(ValueError):
        t_ck.chunk_dedup(have, dig[:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(100, 512), (1, 512), (33, 2049), (5, 4097)])
def test_chunk_dedup_kernel_edge_columns_on_card(cuda, r, s):
    """Columns that stress the classes: every digest NaN (presence only),
    only -0.0 and +0.0 (one class), one value, and the main path's empty
    slots (one class of zeros beside distinct digests); S up to two tables
    past one."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(r + s)
    kw = dict(generator=gen, device=cuda)
    dig = torch.randint(0, 1 << 20, (s, 5), **kw).float()
    dig[:, 0] = float("nan")
    dig[:, 1] = torch.where(torch.rand(s, **kw) < 0.5, -0.0, 0.0)
    dig[:, 2] = 3.5
    dig[: s // 2, 3] = 0.0
    have = torch.rand((r, s, 5), **kw) < 0.02
    got = t_ck.chunk_dedup(have, dig)
    torch.cuda.synchronize()
    assert torch.equal(got, t_ck.chunk_dedup_plain(have, dig))
    assert torch.equal(got[:, :, 0], have[:, :, 0])
    for col in (1, 2):
        assert torch.equal(got[:, :, col], have[:, :, col].any(1, keepdim=True).expand(r, s))


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------

# leaf sizes: the paper's CNN (8 leaves, 12,998 blocks), a ragged model with a
# one-value leaf and an empty one, and a dense matrix of whole blocks
CNN_SIZES = (32, 64, 512, 10, 800, 51_200, 1_605_632, 5_120)
RAGGED_SIZES = (1, 127, 0, 129, 100_003)


def codec_payload(gen, sizes, case, device):
    """A flat payload and its leaf-by-leaf layout. ``case``: "random",
    "zero" (every other leaf all zero), "halves" (x / scale lands on exact
    halves: amax = 127 * 2**e makes scale = 2**e), "ties" (few distinct
    values, NaN, -0.0 beside +0.0), "sparse" (a few nonzeros per block)."""
    layout = t_dc.leaf_layout(tuple((f"l{i:02d}", (n,)) for i, n in enumerate(sizes)))
    n = layout.num_values
    kw = dict(generator=gen, device=device)
    x = torch.randn(n, **kw) * 0.05
    if case == "zero":
        for i, (v0, v1) in enumerate(zip(layout.first_value, layout.first_value[1:])):
            if i % 2:
                x[v0:v1] = 0.0
    if case == "halves":
        blocks = t_dc.blocked(x, layout)
        e = torch.randint(-10, 10, (blocks.shape[0], 1), **kw).float()
        m = torch.randint(-127, 127, blocks.shape, **kw).float() + 0.5
        blocks = m * torch.exp2(e)
        blocks[:, 0] = 127 * torch.exp2(e[:, 0])
        x = torch.cat([blocks[b0:b1].reshape(-1)[:v1 - v0] for b0, b1, v0, v1 in zip(
            layout.first_block, layout.first_block[1:], layout.first_value,
            layout.first_value[1:])])
    if case in ("ties", "sparse"):
        x = torch.randint(-2, 3, (n,), **kw).float()
        if case == "sparse":
            x[torch.rand(n, **kw) < 0.97] = 0.0
        x[torch.rand(n, **kw) < 0.02] = float("nan")
        zero = x == 0
        x[zero] = torch.where(torch.rand(n, **kw) < 0.5, -0.0, 0.0)[zero]
    return x.contiguous(), layout


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_codec_wrappers_launch_nothing_off_the_card():
    gen = torch.Generator().manual_seed(0)
    x, layout = codec_payload(gen, RAGGED_SIZES, "random", "cpu")
    before = dict(cuda_build.LAUNCHES)
    codes, scales = t_dc.quant_leaves(x, layout, 127)
    assert codes.shape == (layout.num_blocks, t_dc.BLOCK) and scales.shape == (layout.num_blocks,)
    assert t_dc.topk_leaves(x, x.flip(0), layout, 8).shape == codes.shape
    assert dict(cuda_build.LAUNCHES) == before
    assert layout.num_blocks == 1 + 1 + 1 + 2 + 782        # an empty leaf is one zero block
    meta = torch.empty((2, t_dc.BLOCK), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_dc.quant_blocks(meta, 127)
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_dc.topk_blocks(meta, 8)
    source = cuda_build.CSRC / "delta_codec.cu"
    assert source.exists() and cuda_build.build_command("nvcc", source, "x.so")[-1] == str(source)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,case", [(CNN_SIZES, "random"), (RAGGED_SIZES, "random"),
                                        (RAGGED_SIZES, "zero"), (CNN_SIZES, "halves"),
                                        (RAGGED_SIZES, "ties")])
@pytest.mark.parametrize("qmax", [127, 7])
def test_quant_kernel_on_card(cuda, sizes, case, qmax):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(len(sizes) + qmax)
    x, layout = codec_payload(gen, sizes, case, cuda)
    before = cuda_build.LAUNCHES[t_dc.QUANT_NAME]
    codes, scales = t_dc.quant_leaves(x, layout, qmax)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[t_dc.QUANT_NAME] == before + 1
    want_c, want_s = t_dc.quant_blocks_plain(t_dc.blocked(x, layout), qmax)
    finite = ~torch.isnan(t_dc.blocked(x, layout))        # NaN codes are not specified
    assert torch.equal(codes[finite], want_c[finite]) and same_bits(scales, want_s)
    dense_c, dense_s = t_dc.quant_blocks(t_dc.blocked(x, layout), qmax)
    assert torch.equal(dense_c[finite], want_c[finite]) and same_bits(dense_s, want_s)
    with pytest.raises(ValueError):
        t_dc.quant_leaves(x[:-1], layout, qmax)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,case,k", [(CNN_SIZES, "random", 8), (RAGGED_SIZES, "ties", 8),
                                          (RAGGED_SIZES, "sparse", 8), (CNN_SIZES, "random", 1),
                                          (RAGGED_SIZES, "random", 128),
                                          (RAGGED_SIZES, "zero", 8)])
def test_topk_kernel_on_card(cuda, sizes, case, k):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(len(sizes) + k)
    x, layout = codec_payload(gen, sizes, case, cuda)
    base = x.flip(0).contiguous() * 0.5
    before = cuda_build.LAUNCHES[t_dc.TOPK_NAME]
    got = t_dc.topk_leaves(x, base, layout, k)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[t_dc.TOPK_NAME] == before + 1
    assert same_bits(got, t_dc.topk_blocks_plain(t_dc.blocked(x - base, layout), k))
    d = t_dc.blocked(x, layout)
    assert same_bits(t_dc.topk_blocks(d, k), t_dc.topk_blocks_plain(d, k))


def dense_topk_blocks(gen, nb, block, case, device):
    """(nb, block) f32 deltas for the dense layouts: "random", "ties" (few
    distinct magnitudes, NaN, -0.0 beside +0.0, subnormals and +inf),
    "equal" (every value of a block the same), "nan" (every value NaN)."""
    kw = dict(generator=gen, device=device)
    if case == "random":
        return torch.randn((nb, block), **kw)
    if case == "equal":
        return torch.randn((nb, 1), **kw).expand(nb, block).contiguous()
    if case == "nan":
        return torch.full((nb, block), float("nan"), device=device)
    pick = torch.randint(0, 9, (nb, block), **kw)
    values = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0, float("inf"), float("nan"),
                           1e-45, -1e-40], device=device)
    return values[pick]


@pytest.mark.cuda
@pytest.mark.parametrize("block,case", [(32, "random"), (33, "ties"), (1024, "random"),
                                        (1024, "ties"), (128, "equal"), (33, "equal"),
                                        (128, "nan"), (1024, "nan")])
def test_topk_kernel_dense_on_card(cuda, block, case):
    """The dense layouts of ``test_topk_kernel_on_card``: blocks of 32, 33
    and 1,024, k = 0, 1, 8, B - 1 and B (and the warp's two selections
    either side of its 32), blocks all equal, all NaN."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(block)
    d = dense_topk_blocks(gen, 37, block, case, cuda)
    for k in sorted({0, 1, 8, 32, 33, block - 1, block}):
        before = cuda_build.LAUNCHES[t_dc.TOPK_NAME]
        got = t_dc.topk_blocks(d, k)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES[t_dc.TOPK_NAME] == before + 1
        assert same_bits(got, t_dc.topk_blocks_plain(d, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4", "topk"])
def test_encode_on_card_equals_the_cpu(cuda, kind):
    from repro_torch.fl.tasks import CNNTask

    params = {k: v + 0.01 * torch.randn_like(v) for k, v in CNNTask().init(0, "cpu").items()}
    base = {k: v * 0.9 for k, v in params.items()}
    codec = t_dc.DeltaCodec(kind)
    on_card = codec.encode({k: v.to(cuda) for k, v in params.items()},
                           {k: v.to(cuda) for k, v in base.items()})
    on_cpu = codec.encode(params, base)
    for part in on_cpu:
        for name in on_cpu[part]:
            a, b = on_card[part][name].cpu(), on_cpu[part][name]
            assert a.dtype == b.dtype and (torch.equal(a, b) if a.dtype == torch.int8
                                           else same_bits(a, b)), (part, name)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,case,block", [
    (CNN_SIZES, "random", 128), (RAGGED_SIZES, "random", 128), (RAGGED_SIZES, "zero", 128),
    (CNN_SIZES, "halves", 128), (RAGGED_SIZES, "random", 100), (RAGGED_SIZES, "random", 32),
    (RAGGED_SIZES, "random", 256), (RAGGED_SIZES, "random", 1024),
    (tuple(range(41)), "random", 128)])
@pytest.mark.parametrize("qmax", [127, 7])
def test_quant_params_kernel_on_card(cuda, sizes, case, block, qmax):
    """Leaves read in place through their own pointers (slices of one flat
    payload, offsets not 16-byte aligned, and tensors of their own), codes,
    scales and the decoded payload bitwise the plain versions; blocks not a
    multiple of 4 values, of 32 to 1,024, and 41 leaves (two launches)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(len(sizes) + qmax + block)
    x, _ = codec_payload(gen, sizes, case, cuda)
    layout = t_dc.leaf_layout(tuple((f"l{i:02d}", (n,)) for i, n in enumerate(sizes)), block)
    fv = layout.first_value
    sliced = {name: x[v0:v1] for name, v0, v1 in zip(layout.names, fv, fv[1:])}
    want_c, want_s = t_dc.quant_blocks_plain(t_dc.blocked(x, layout), qmax)
    want_d = t_dc._unblocked(t_dc.dequant_blocks_plain(want_c, want_s), layout)
    launches = -(-len(sizes) // 32)
    for params in (sliced, {name: v.clone() for name, v in sliced.items()}):
        before = cuda_build.LAUNCHES[t_dc.QUANT_NAME]
        codes, scales, decoded = t_dc.quant_params(params, layout, qmax, decode=True)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES[t_dc.QUANT_NAME] == before + launches
        assert torch.equal(codes, want_c) and same_bits(scales, want_s)
        assert same_bits(decoded, want_d)
        codes, scales, none = t_dc.quant_params(params, layout, qmax)
        assert none is None and torch.equal(codes, want_c) and same_bits(scales, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4", "topk"])
def test_encode_decode_on_card_is_decode_of_encode(cuda, kind):
    """``encode_decode`` on the card: the keys and tensors of ``encode``, the
    payload of ``decode``, bitwise, in one quantisation launch; and both
    equal to the CPU's."""
    from repro_torch.fl.tasks import CNNTask

    params = {k: v + 0.01 * torch.randn_like(v) for k, v in CNNTask().init(0, "cpu").items()}
    base = {k: v * 0.9 for k, v in params.items()}
    on_card = ({k: v.to(cuda) for k, v in params.items()},
               {k: v.to(cuda) for k, v in base.items()})
    codec = t_dc.DeltaCodec(kind)
    before = cuda_build.LAUNCHES[t_dc.QUANT_NAME]
    enc, dec = codec.encode_decode(*on_card)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[t_dc.QUANT_NAME] == before + (kind != "topk")
    want_enc = codec.encode(*on_card)
    want_dec = codec.decode(want_enc, on_card[1])
    cpu_enc, cpu_dec = codec.encode_decode(params, base)
    assert enc.keys() == want_enc.keys() == cpu_enc.keys()
    for part in enc:
        assert enc[part].keys() == want_enc[part].keys()
        for name in enc[part]:
            a, b, c = enc[part][name], want_enc[part][name], cpu_enc[part][name]
            assert a.dtype == b.dtype and a.shape == b.shape, (part, name)
            if a.dtype == torch.int8:
                assert torch.equal(a, b) and torch.equal(a.cpu(), c), (part, name)
            else:
                assert same_bits(a, b) and same_bits(a.cpu(), c), (part, name)
    assert dec.keys() == want_dec.keys()
    for name in dec:
        assert dec[name].shape == base[name].shape
        assert same_bits(dec[name], want_dec[name]) and same_bits(dec[name].cpu(), cpu_dec[name])


@pytest.mark.cuda
def test_afford_divides_exactly_on_card(cuda):
    """A budget of exactly m chunks buys m chunks on the card as on the CPU,
    for the raw and the encoded granules of the 7 MB model."""
    from repro_torch.net import bank as t_net_bank

    for chunk in (1_750_000.0, 451_171.875, 232_421.875, 218_750.0, 3.0, 0.1):
        chunk = float(np.float32(chunk))
        budget = torch.arange(0, 4096, dtype=torch.float32) * np.float32(chunk)
        got = t_net_bank._afford(budget.to(cuda), chunk).cpu()
        assert torch.equal(got, t_net_bank._afford(budget, chunk)), chunk


def pop_queue(rng, q, times, device):
    """(time, kind, seq, valid) of a queue with ties on time, kind and seq."""
    t = rng.choice(np.asarray(times, np.float32), q).astype(np.float32)
    k = rng.integers(0, 4, q).astype(np.int32)
    s = rng.integers(0, 6, q).astype(np.int32)
    v = rng.random(q) < rng.choice([0.0, 0.3, 0.7, 1.0])
    return [torch.from_numpy(x).to(device) for x in (t, k, s, v)]


POP_TIMES = {"ties": [0.25, 1.0, 1.5, 7.75], "signed_zeros": [-0.0, 0.0, 0.5, -1.0],
             "inf_and_nan": [np.inf, 1.0, np.nan, -np.inf, 1.0]}


def test_event_pop_wrapper_launches_nothing_off_the_card():
    args = pop_queue(np.random.default_rng(0), 33, POP_TIMES["ties"] + [np.inf], "cpu")
    before = cuda_build.LAUNCHES["event_pop"]
    head = t_pop.event_head(*args)
    idx, found = t_pop.event_pop(*args)
    assert cuda_build.LAUNCHES["event_pop"] == before
    assert head.dtype == torch.int32 and head.shape == (4,)
    assert (int(head[0]), bool(head[1])) == (int(idx), bool(found))
    source = cuda_build.CSRC / "event_pop.cu"
    cmd = cuda_build.build_command("nvcc", source, "x.so")
    assert source.exists() and "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(source)


POP_CARD_CASES = [(1, "ties"), (70, "ties"), (1_025, "signed_zeros"), (8_191, "ties"),
                  (8_192, "signed_zeros"), (8_193, "inf_and_nan"), (9_900, "ties"),
                  (19_800, "signed_zeros"), (9_965, "inf_and_nan"), (1_000_003, "ties")]


@pytest.mark.cuda
@pytest.mark.parametrize("q,times", POP_CARD_CASES)
def test_event_pop_kernel_on_card(cuda, q, times):
    rng = np.random.default_rng(q)
    for _ in range(5):
        args = pop_queue(rng, q, POP_TIMES[times], cuda)
        before = cuda_build.LAUNCHES["event_pop"]
        got = t_pop.event_head(*args)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["event_pop"] == before + 1
        assert torch.equal(got.cpu(), t_pop.event_head_plain(*(x.cpu() for x in args)))


@pytest.mark.cuda
@pytest.mark.parametrize("q,times", POP_CARD_CASES)
def test_pop_head_mirror_on_card(cuda, q, times):
    """``pop_head``'s host words (the pinned mirror) equal its device words,
    ``event_head``'s and the plain version's, on every draw; one launch a
    call."""
    rng = np.random.default_rng(q + 1)
    for _ in range(5):
        args = pop_queue(rng, q, POP_TIMES[times], cuda)
        want = t_pop.event_head_plain(*(x.cpu() for x in args))
        before = cuda_build.LAUNCHES["event_pop"]
        idx, found, head_t, kind, head = t_pop.pop_head(*args)
        assert cuda_build.LAUNCHES["event_pop"] == before + 1
        words = torch.tensor([idx, int(found), 0, kind], dtype=torch.int32)
        words[2] = torch.tensor([head_t], dtype=torch.float32).view(torch.int32)[0]
        assert torch.equal(words, head.cpu()) and torch.equal(words, want)
        assert torch.equal(t_pop.event_head(*args).cpu(), want)


# ---------------------------------------------------------------------------
# the histogram bincount
# ---------------------------------------------------------------------------


def bincount_batch(rng, m, num_bins, device="cpu"):
    """(idx, w) i32: indices mostly in range, some past the end and negative,
    weights with zeros (the masked samples of a round) and a few large ones."""
    idx = rng.integers(-3, num_bins + 3, m).astype(np.int32)
    idx[rng.random(m) < 0.05] = np.iinfo(np.int32).min
    w = rng.integers(0, 3, m).astype(np.int32)
    w[rng.random(m) < 0.01] = 1_000_000
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


@pytest.mark.parametrize("m,num_bins", [(0, 65), (1, 65), (700, 65), (4_097, 8), (51_200, 65)])
def test_hist_bincount_plain_matches_ref_and_pallas(jax_ref, m, num_bins):
    jax, _, ref, _ = jax_ref
    from repro.kernels.hist_bincount import hist_bincount_pallas

    idx, w = bincount_batch(np.random.default_rng(m), m, num_bins)
    got = t_hb.hist_bincount_plain(idx, w, num_bins)
    want = np.asarray(ref.hist_bincount_ref(jax.numpy.asarray(idx.numpy()),
                                            jax.numpy.asarray(w.numpy()), num_bins))
    assert got.dtype == torch.int32 and got.shape == (num_bins,)
    np.testing.assert_array_equal(got.numpy(), want)
    if 0 < m <= 4_097:
        pallas = hist_bincount_pallas(jax.numpy.asarray(idx.numpy()),
                                      jax.numpy.asarray(w.numpy()), num_bins, block_m=512,
                                      interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_hist_bincount_wrapper_launches_nothing_off_the_card():
    idx, w = bincount_batch(np.random.default_rng(1), 300, 65)
    before = cuda_build.LAUNCHES["hist_bincount"]
    got = t_hb.hist_bincount(idx, w, 65)
    assert cuda_build.LAUNCHES["hist_bincount"] == before
    assert torch.equal(got, t_hb.hist_bincount_plain(idx, w, 65))
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_hb.hist_bincount(idx.to("meta"), w.to("meta"), 65)
    source = cuda_build.CSRC / "hist_bincount.cu"
    cmd = cuda_build.build_command("nvcc", source, "x.so")
    assert source.exists() and "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(source)


@pytest.mark.cuda
@pytest.mark.parametrize("m,num_bins", [(1, 65), (512, 65), (51_200, 65), (300_001, 65),
                                        (9_999, 12_288), (4_096, 1)])
def test_hist_bincount_kernel_on_card(cuda, m, num_bins):
    rng = np.random.default_rng(m + num_bins)
    for _ in range(3):
        idx, w = bincount_batch(rng, m, num_bins, cuda)
        before = cuda_build.LAUNCHES["hist_bincount"]
        got = t_hb.hist_bincount(idx, w, num_bins)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["hist_bincount"] == before + 1
        assert torch.equal(got.cpu(), t_hb.hist_bincount_plain(idx.cpu(), w.cpu(), num_bins))
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda)
    before = cuda_build.LAUNCHES["hist_bincount"]
    assert int(t_hb.hist_bincount(empty, empty, 9).abs().sum()) == 0
    assert cuda_build.LAUNCHES["hist_bincount"] == before
    with pytest.raises(ValueError, match="num_bins"):
        t_hb.hist_bincount(idx, w, t_hb.MAX_BINS + 1)


def record_values(rng, cfg, m):
    """(m,) f32: every edge of ``cfg`` with its two neighbours, 0, -0.0,
    negatives, subnormals, NaN, +-inf, 3e38 and the sync-period multiples
    first, then log-uniform values over the bins and past them."""
    e = t_hist.edges(cfg).astype(np.float32)
    special = np.concatenate([
        e, np.nextafter(e, np.float32(np.inf)), np.nextafter(e, np.float32(-np.inf)),
        np.arange(1, 33, dtype=np.float32) * np.float32(0.25),
        np.float32([0.0, -0.0, -1.0, -3e38, 1e-45, 1e-40, np.nan, np.inf, -np.inf, 3e38])])
    wide = np.exp(rng.uniform(np.log(cfg.lo) - 3, np.log(cfg.hi) + 3, max(m, 1))).astype(
        np.float32)
    return np.concatenate([special, wide])[:m] if m >= special.size else wide[:m]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [t_hist.HistConfig(), t_hist.HistConfig(bins=16, lo=1e-3, hi=1e3)])
@pytest.mark.parametrize("m", [1, 512, 51_200, 65_536, 65_537, 300_001])
@pytest.mark.parametrize("weights", ["bool", "i32"])
def test_record_kernel_on_card(cuda, cfg, m, weights):
    """``record`` on the card, one launch binning as ``bin_index`` does,
    bitwise ``record_plain`` on the card and on the CPU, ``counts`` left as
    they were; most weights zero, some large i32 ones."""
    rng = np.random.default_rng(m + cfg.bins)
    values = record_values(rng, cfg, m)
    if weights == "bool":
        w = rng.random(m) < 0.3
    else:
        w = rng.integers(0, 4, m).astype(np.int32) * (rng.random(m) < 0.3)
        w[rng.random(m) < 0.01] = 1_000_000
    counts = rng.integers(0, 1_000, cfg.bins + 1).astype(np.int32)
    v, wt, c = (torch.from_numpy(np.asarray(a)) for a in (values, w, counts))
    vc, wc, cc = v.to(cuda), wt.to(cuda), c.to(cuda)
    before = cuda_build.LAUNCHES["hist_bincount"]
    got = t_hist.record(cc, vc, wc, cfg)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["hist_bincount"] == before + 1
    assert torch.equal(cc.cpu(), c) and got.data_ptr() != cc.data_ptr()
    assert torch.equal(got, t_hist.record_plain(cc, vc, wc, cfg))
    assert torch.equal(got.cpu(), t_hist.record_plain(c, v, wt, cfg))
    # the same samples as (R, cap) batches, as observe gives them
    if m % 512 == 0:
        assert torch.equal(t_hist.record(cc, vc.view(-1, 512), wc.view(-1, 512), cfg), got)


@pytest.mark.cuda
def test_record_binned_checks_its_arguments(cuda):
    cfg = t_hist.HistConfig()
    counts = torch.zeros(cfg.bins + 1, dtype=torch.int32, device=cuda)
    v = torch.ones(10, device=cuda)
    w = torch.ones(10, dtype=torch.bool, device=cuda)
    lo, ratio, bins = t_hist.bin_params(cfg)
    before = cuda_build.LAUNCHES["hist_bincount"]
    assert torch.equal(t_hb.record_binned(counts, v[:0], w[:0], lo, ratio, bins), counts)
    assert cuda_build.LAUNCHES["hist_bincount"] == before
    with pytest.raises(ValueError, match="counts"):
        t_hb.record_binned(counts[:-1], v, w, lo, ratio, bins)
    with pytest.raises(TypeError, match="f32"):
        t_hb.record_binned(counts, v.double(), w, lo, ratio, bins)
    with pytest.raises(ValueError, match="lo > 0"):
        t_hb.record_binned(counts, v, w, 0.0, ratio, bins)
    with pytest.raises(ValueError, match="cuda"):
        t_hb.record_binned(counts.cpu(), v.cpu(), w.cpu(), lo, ratio, bins)


# ---------------------------------------------------------------------------
# the pairwise model distance
# ---------------------------------------------------------------------------

# both sides sum N products in their own order and the diagonal cancels to
# near 0: each entry is held to a bound on its sum of absolute terms
DIST_RTOL_CPU = 1e-6      # plain version against the reference (f32 on the CPU)
DIST_RTOL_CARD = 1e-5     # kernel against plain: per-thread, warp, block and chunk sums


def distance_models(rng, k, n, zero_row=False):
    x = (rng.standard_normal((k, n)) * rng.choice([0.01, 1.0, 30.0], (k, 1))).astype(np.float32)
    if zero_row:
        x[k // 2] = 0.0
    return x


def distance_scale(x) -> np.ndarray:
    """(k, k) sq_i + sq_j + 2 |x_i . x_j| in f64."""
    x = np.asarray(x, np.float64)
    sq = (x * x).sum(1)
    return sq[:, None] + sq[None, :] + 2.0 * np.abs(x @ x.T)


@pytest.mark.parametrize("k,n,zero_row", [(1, 1, False), (2, 1000, False), (5, 16_385, True),
                                          (16, 8_192, False), (32, 3, True)])
def test_model_distance_plain_matches_ref_and_pallas(jax_ref, k, n, zero_row):
    jax, ops, ref, _ = jax_ref
    x = distance_models(np.random.default_rng(k * 7 + n), k, n, zero_row)
    got = t_md.model_distance_plain(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (k, k)
    tol = DIST_RTOL_CPU * distance_scale(x)
    for want in (ref.model_distance_ref(jax.numpy.asarray(x)),
                 ops.model_distance(jax.numpy.asarray(x), block_n=8192)):
        assert (np.abs(got.numpy() - np.asarray(want)) <= tol).all()


def test_model_distance_wrapper_launches_nothing_off_the_card():
    x = torch.from_numpy(distance_models(np.random.default_rng(0), 5, 100))
    before = cuda_build.LAUNCHES["model_distance"]
    assert torch.equal(t_md.model_distance(x), t_md.model_distance_plain(x))
    assert cuda_build.LAUNCHES["model_distance"] == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_md.model_distance(x.to("meta"))
    # the kernel's limits, checked before any launch
    with pytest.raises(ValueError, match="k <= 32"):
        t_md._check_cuda_args(torch.zeros((33, 10)))
    with pytest.raises(ValueError, match="k <= 32"):
        t_md._check_cuda_args(torch.zeros((0, 10)))
    with pytest.raises(TypeError, match="float32"):
        t_md._check_cuda_args(torch.zeros((4, 10), dtype=torch.float64))
    with pytest.raises(ValueError, match="unit column stride"):
        t_md._check_cuda_args(torch.zeros((10, 4)).T)
    source = cuda_build.CSRC / "model_distance.cu"
    cmd = cuda_build.build_command("nvcc", source, "x.so")
    assert source.exists() and "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(source)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,zero_row", [(1, 1_663_370, False), (5, 1_663_370, True),
                                          (16, 1_663_370, False), (32, 100_003, True),
                                          (5, 4_097, False), (7, 1, False), (9, 33, True)])
def test_model_distance_kernel_on_card(cuda, k, n, zero_row):
    x = torch.from_numpy(distance_models(np.random.default_rng(k + n), k, n, zero_row)).to(cuda)
    before = cuda_build.LAUNCHES["model_distance"]
    got = t_md.model_distance(x)
    again = t_md.model_distance(x)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["model_distance"] == before + 2
    assert torch.equal(got, again)                  # a fixed summation order
    assert torch.equal(got, got.T)
    want = t_md.model_distance_plain(x)
    tol = DIST_RTOL_CARD * distance_scale(x.cpu().numpy())
    assert (np.abs(got.cpu().numpy() - want.cpu().numpy()) <= tol).all()
    # a strided view: rows of a wider buffer
    wide = torch.zeros((k, n + 5), device=cuda)
    wide[:, :n] = x
    assert torch.equal(t_md.model_distance(wide[:, :n]), got)


# ---------------------------------------------------------------------------
# prefill and decode attention
# ---------------------------------------------------------------------------

ATTN_TOL = 1e-5           # of sum_j p_j |v_j|: f32 sums in another order


def attention_scale(plain, q, k, v, *args):
    """The plain version in f32 on |v|: sum_j p_j |v_j| per output."""
    return plain(q.float(), k.float(), v.float().abs(), *args)


def assert_attention_close(got, q, k, v, plain, *args):
    want = plain(q.float(), k.float(), v.float(), *args)
    tol = ATTN_TOL * attention_scale(plain, q, k, v, *args)
    if got.dtype == torch.bfloat16:
        tol = tol + torch.from_numpy(_bf16_ulp(want.cpu().numpy())).to(tol.device)
    assert got.shape == want.shape and got.dtype == q.dtype
    assert bool(((got.float() - want).abs() <= tol).all())


def test_attention_wrappers_refuse_what_the_kernels_do_not_take():
    q, k = torch.zeros((1, 4, 8, 64)), torch.zeros((1, 2, 8, 64))
    t_fa._check("flash_attention", q, k, k, 4, 4)
    with pytest.raises(ValueError, match="head dim"):
        t_fa._check("flash_attention", q[..., :48], k[..., :48], k[..., :48], 4, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_fa._check("flash_attention", q.half(), k.half(), k.half(), 4, 4)
    with pytest.raises(ValueError, match="layouts"):
        t_fa._check("decode_attention", q, k, k, 3, 4)
    source = cuda_build.CSRC / "flash_attention.cu"
    cmd = cuda_build.build_command("nvcc", source, "x.so")
    assert source.exists() and "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(source)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd,window", [
    (2, 4, 2, 200, 64, 0), (1, 16, 8, 1024, 128, 0), (1, 8, 1, 333, 256, 0),
    (1, 10, 2, 1000, 64, 0), (2, 5, 1, 130, 128, 48), (1, 8, 8, 700, 128, 96), (1, 4, 4, 1, 64, 0),
    # the bf16 route's tiles: 64 query rows a warpgroup (a block takes 64 positions
    # of two heads, or 128 of one), keys in tiles of 128 (64 at hd 256)
    (1, 16, 8, 127, 128, 0), (1, 16, 8, 129, 128, 0), (2, 4, 4, 255, 64, 0),
    (1, 6, 3, 257, 128, 0), (1, 8, 1, 63, 256, 0), (1, 8, 1, 65, 256, 0),
    (2, 8, 1, 300, 256, 0), (1, 16, 8, 600, 128, 17), (1, 8, 1, 250, 256, 40),
])
def test_flash_attention_kernel_on_card(cuda, dtype, B, H, KV, S, hd, window):
    gen = torch.Generator(device=cuda).manual_seed(S + H + hd)
    # the model's layout, (B, S, H, hd), passed permuted
    q = (torch.randn((B, S, H, hd), generator=gen, device=cuda) * 0.5).to(dtype).transpose(1, 2)
    k = (torch.randn((B, S, KV, hd), generator=gen, device=cuda) * 0.5).to(dtype).transpose(1, 2)
    v = torch.randn((B, S, KV, hd), generator=gen, device=cuda).to(dtype).transpose(1, 2)
    before = cuda_build.LAUNCHES["flash_attention"]
    got = t_fa.flash_attention(q, k, v, window)
    again = t_fa.flash_attention(q, k, v, window)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["flash_attention"] == before + 2
    assert torch.equal(got, again)
    assert_attention_close(got, q, k, v, t_fa.flash_attention_plain, window)
    assert torch.equal(t_fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                            window), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,S,hd,lengths", [
    (4, 4, 256, 64, [85, 256, 1]), (16, 8, 2048, 128, [2032, 0, 1, 2048]),
    (8, 1, 777, 256, [777, 513]), (40, 8, 600, 128, [600, 3, 0]), (20, 2, 33, 64, [33, 32]),
    # either side of a chunk boundary (512 slots in f32, 1,024 in bf16); rows whose
    # every chunk is skipped but the first; gemma-2b's G = 8 at hd 256 with B > 1
    (16, 8, 2100, 128, [1023, 1024, 1025, 511, 512, 513]), (16, 8, 5000, 128, [3, 1000, 5000]),
    (8, 1, 4096, 256, [700, 1025, 4096]), (12, 1, 1500, 64, [1500, 0, 1024]),
    # more chunks in a row than the fold stages at once (768 at hd 256, G = 8)
    (8, 1, 800_000, 256, [800_000]),
])
def test_decode_attention_kernel_on_card(cuda, dtype, H, KV, S, hd, lengths):
    B = len(lengths)
    gen = torch.Generator(device=cuda).manual_seed(S + H)
    q = (torch.randn((B, H, hd), generator=gen, device=cuda) * 0.5).to(dtype)
    k = (torch.randn((B, S, KV, hd), generator=gen, device=cuda) * 0.3).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=gen, device=cuda).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = cuda_build.LAUNCHES["decode_attention"]
    got = t_fa.decode_attention(q, k, v, lens)
    again = t_fa.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["decode_attention"] == before + 2
    assert torch.equal(got, again)
    assert_attention_close(got, q, k, v, t_fa.decode_attention_plain, lens)
    with pytest.raises(ValueError, match="lengths"):
        t_fa.decode_attention(q, k, v, lens.long())


# ---------------------------------------------------------------------------
# the RWKV6 WKV recurrence
# ---------------------------------------------------------------------------

# of the same function on |r|, |k|, |v|, |u|, |state|: f32 sums in another order;
# against the sequential scan, the chunked form's cum_prev - cum cancels
WKV_TOL, WKV_SCAN_TOL = 1e-5, 5e-4


def wkv_inputs(gen, B, T, H, hd, dtype, decay, device, state=True):
    """r, k, v, u in ``dtype``; logw f32 drawn like the model's (``-exp(-1 +
    small)``), or strong (``-exp(min(2 + N, 10))``) or wide (``-exp(2 N)``);
    a nonzero f32 state."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    r, k, v = (randn(B, T, H, hd).to(dtype) for _ in range(3))
    dd = {"model": -1.0 + 0.3 * randn(B, T, H, hd), "strong": 2.0 + randn(B, T, H, hd),
          "wide": 2.0 * randn(B, T, H, hd)}[decay]
    logw = -torch.exp(torch.clamp(dd, max=10.0))
    u = torch.rand((H, hd), generator=gen, device=device).to(dtype)
    s0 = randn(B, H, hd, hd) if state else torch.zeros((B, H, hd, hd), device=device)
    return r, k, v, logw, u, s0


def assert_wkv_close(got, args, plain, tol):
    """y and state of ``got`` within ``tol`` of ``plain`` run in f32 on the
    same inputs, relative to ``plain`` on their absolute values."""
    r, k, v, logw, u, s0 = args
    want = plain(r.float(), k.float(), v.float(), logw, u.float(), s0)
    scale = plain(r.float().abs(), k.float().abs(), v.float().abs(), logw, u.float().abs(),
                  s0.abs())
    for g, w, sc in zip(got, want, scale):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(((g - w).abs() <= tol * sc).all()), float(((g - w).abs() / sc).max())


def test_wkv_wrapper_refuses_what_the_kernel_does_not_take():
    gen = torch.Generator().manual_seed(0)
    args = wkv_inputs(gen, 1, 64, 2, 64, torch.float32, "model", "cpu")
    t_wkv._check(*args)
    r, k, v, logw, u, s0 = args
    with pytest.raises(ValueError, match="head dim"):
        t_wkv._check(r[..., :32], k[..., :32], v[..., :32], logw[..., :32], u[:, :32],
                     s0[:, :, :32, :32])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_wkv._check(r[:, :48], k[:, :48], v[:, :48], logw[:, :48], u, s0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_wkv.wkv(r[:, :48], k[:, :48], v[:, :48], logw[:, :48], u, s0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_wkv._check(r.half(), k.half(), v.half(), logw, u.half(), s0)
    with pytest.raises(ValueError, match="logw and state"):
        t_wkv._check(r, k, v, logw.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="u .* and state"):
        t_wkv._check(r, k, v, logw, u[:1], s0)
    before = cuda_build.LAUNCHES["wkv"]
    t_wkv.wkv(*args)
    assert cuda_build.LAUNCHES["wkv"] == before
    source = cuda_build.CSRC / "wkv.cu"
    cmd = cuda_build.build_command("nvcc", source, "x.so")
    assert source.exists() and "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(source)


def test_wkv_scan_wrapper_refuses_what_the_kernel_does_not_take():
    gen = torch.Generator().manual_seed(1)
    args = wkv_inputs(gen, 2, 9, 2, 64, torch.float32, "model", "cpu")
    t_wkv._check(*args, chunked=False)
    r, k, v, logw, u, s0 = args
    t_wkv._check(r[:, :1], k[:, :1], v[:, :1], logw[:, :1], u, s0, chunked=False)
    with pytest.raises(ValueError, match="not positive"):
        t_wkv._check(r[:, :0], k[:, :0], v[:, :0], logw[:, :0], u, s0, chunked=False)
    with pytest.raises(ValueError, match="wkv_scan: head dim"):
        t_wkv._check(r[..., :32], k[..., :32], v[..., :32], logw[..., :32], u[:, :32],
                     s0[:, :, :32, :32], chunked=False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_wkv._check(r.half(), k.half(), v.half(), logw, u.half(), s0, chunked=False)
    for bad in (s0[:1], s0.double(), s0.transpose(2, 3)):
        with pytest.raises(ValueError, match="out must be"):
            t_wkv.wkv_scan(*args, out=bad)
    before = cuda_build.LAUNCHES[t_wkv.SCAN_NAME]
    t_wkv.wkv_scan(*args)
    assert cuda_build.LAUNCHES[t_wkv.SCAN_NAME] == before


@pytest.mark.cuda
def test_wkv_wrappers_refuse_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    r, k, v, logw, u, s0 = wkv_inputs(gen, 1, 64, 2, 64, torch.float32, "model", cuda)
    before = dict(cuda_build.LAUNCHES)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_wkv.wkv(r[:, :48], k[:, :48], v[:, :48], logw[:, :48], u, s0)
    for fn in (t_wkv.wkv, t_wkv.wkv_scan):
        with pytest.raises(ValueError, match="head dim"):
            fn(r[..., :32], k[..., :32], v[..., :32], logw[..., :32], u[:, :32],
               s0[:, :, :32, :32])
        with pytest.raises(ValueError, match="logw and state"):
            fn(r, k, v, logw.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="out must be"):
        t_wkv.wkv_scan(r, k, v, logw, u, s0, out=s0.cpu())
    assert dict(cuda_build.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd,decay", [
    (1, 32, 4, 64, "model"), (2, 256, 3, 64, "model"), (1, 96, 2, 128, "strong"),
    (2, 64, 2, 64, "wide"), (3, 1024, 2, 64, "strong"), (1, 160, 5, 128, "model"),
    (1, 512, 64, 64, "model"), (2, 128, 3, 128, "wide"),
])
def test_wkv_kernel_on_card(cuda, dtype, B, T, H, hd, decay):
    gen = torch.Generator(device=cuda).manual_seed(T + H + hd)
    args = wkv_inputs(gen, B, T, H, hd, dtype, decay, cuda)
    before = cuda_build.LAUNCHES["wkv"]
    got, again = t_wkv.wkv(*args), t_wkv.wkv(*args)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["wkv"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert_wkv_close(got, args, t_wkv.wkv_chunked_plain, WKV_TOL)
    assert_wkv_close(got, args, t_wkv.wkv_scan_plain, WKV_SCAN_TOL)


@pytest.mark.cuda
def test_wkv_kernel_reads_strided_views_and_carries_state(cuda):
    """The model's (B, T, H, hd) views of wider rows are read in place, and
    two calls over the halves of a sequence equal one call over all of it."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    r, k, v, logw, u, s0 = wkv_inputs(gen, 2, 128, 4, 64, torch.bfloat16, "model", cuda)
    wide = torch.zeros((2, 128, 4, 192), dtype=torch.bfloat16, device=cuda)
    wide[..., :64], wide[..., 64:128], wide[..., 128:] = r, k, v
    got = t_wkv.wkv(wide[..., :64], wide[..., 64:128], wide[..., 128:], logw, u, s0)
    assert all(torch.equal(a, b) for a, b in zip(got, t_wkv.wkv(r, k, v, logw, u, s0)))
    y1, mid = t_wkv.wkv(r[:, :64], k[:, :64], v[:, :64], logw[:, :64], u, s0)
    y2, end = t_wkv.wkv(r[:, 64:], k[:, 64:], v[:, 64:], logw[:, 64:], u, mid)
    assert torch.equal(torch.cat([y1, y2], dim=1), got[0]) and torch.equal(end, got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd,decay", [
    (1, 1, 4, 64, "model"), (3, 9, 2, 128, "strong"), (2, 33, 3, 64, "wide"),
    (8, 1, 2, 128, "model"), (128, 1, 8, 64, "model"), (2, 5, 4, 64, "strong"),
    (1, 64, 2, 128, "wide"),
])
def test_wkv_scan_kernel_on_card(cuda, dtype, B, T, H, hd, decay):
    gen = torch.Generator(device=cuda).manual_seed(B + T + H + hd)
    args = wkv_inputs(gen, B, T, H, hd, dtype, decay, cuda)
    before = cuda_build.LAUNCHES[t_wkv.SCAN_NAME]
    got, again = t_wkv.wkv_scan(*args), t_wkv.wkv_scan(*args)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[t_wkv.SCAN_NAME] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert_wkv_close(got, args, t_wkv.wkv_scan_plain, WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd", [(16, 1, 64, 64), (3, 9, 2, 128)])
def test_wkv_scan_kernel_in_place_equals_out_of_place(cuda, dtype, B, T, H, hd):
    """``out`` the state itself: the state is updated in place, bitwise as
    a fresh output; the model's strided (B, T, H, hd) views read in place."""
    gen = torch.Generator(device=cuda).manual_seed(B * T + hd)
    r, k, v, logw, u, s0 = wkv_inputs(gen, B, T, H, hd, dtype, "model", cuda)
    y, s = t_wkv.wkv_scan(r, k, v, logw, u, s0)
    kept = s0.clone()
    other = torch.empty_like(s0)
    y2, s2 = t_wkv.wkv_scan(r, k, v, logw, u, s0, out=other)
    assert s2 is other and torch.equal(s0, kept) and torch.equal(s2, s) and torch.equal(y2, y)
    state = s0.clone()
    y3, s3 = t_wkv.wkv_scan(r, k, v, logw, u, state, out=state)
    assert s3 is state and torch.equal(state, s) and torch.equal(y3, y)
    wide = torch.zeros((B, T, H, 3 * hd), dtype=dtype, device=cuda)
    wide[..., :hd], wide[..., hd:2 * hd], wide[..., 2 * hd:] = r, k, v
    got = t_wkv.wkv_scan(wide[..., :hd], wide[..., hd:2 * hd], wide[..., 2 * hd:], logw, u, s0)
    assert torch.equal(got[0], y) and torch.equal(got[1], s)
