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
(``test_gossip_winner_kernel_on_card``); the plain version is held against
the reference in ``tests/test_torch_gossip.py``.

The chunk dedup, ``kernels/chunk_transfer.py``: a bitmap, so the kernel must
equal the plain version bitwise (``test_chunk_dedup_kernel_on_card``); the
plain version is held against the reference in ``tests/test_torch_bank.py``.

The event-queue head, ``kernels/event_pop.py``: an index, a flag, the head's
time bits and kind, so the kernel must equal the plain version bitwise
(``test_event_pop_kernel_on_card``), NaN and -0.0 included; the plain
version is held against the reference in ``tests/test_torch_events.py``.

The wire codec, ``kernels/delta_codec.py``: codes, scales and masked deltas
must equal the plain versions bitwise (``test_quant_kernel_on_card``,
``test_topk_kernel_on_card``, ``test_encode_on_card_equals_the_cpu``); the
plain versions are held against the reference in
``tests/test_torch_codec.py``.

The histogram bincount, ``kernels/hist_bincount.py``: integer sums, so the
kernel must equal the plain version bitwise (``test_hist_bincount_kernel_on_card``),
out-of-range and negative indices dropped; the plain version is held against
the reference's oracle and its Pallas kernel in ``tests/test_torch_hist.py``
and here (``test_hist_bincount_plain_matches_ref_and_pallas``).

The pairwise model distance, ``kernels/model_distance.py``: sums of N
products in another order, and a diagonal that cancels to near 0, so each
entry is held to a bound on its sum of absolute terms, ``sq_i + sq_j + 2
|x_i . x_j|``: the plain version within 1e-6 of it against the reference's
oracle and its interpreted Pallas kernel, the kernel within 1e-5 of it
against the plain version on the card (``test_model_distance_kernel_on_card``:
k = 1, 5, 16, 32, N not a multiple of a chunk, a row of zeros, a strided
view), and bitwise against itself from call to call.
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
from repro_torch.kernels import gossip_merge as t_gm
from repro_torch.kernels import hist_bincount as t_hb
from repro_torch.kernels import model_distance as t_md


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
    (100, 1, 512, None, 1.0),       # the union fold (merge_all)
    (100, 25, 512, 50, 0.5),        # a receiver block
    (100, 100, 1000, None, 0.5),    # cap not a multiple of the block
    (5000, 3, 129, 4990, 0.3),      # more senders than one shared-memory chunk
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


@pytest.mark.cuda
@pytest.mark.parametrize("q,times", [(1, "ties"), (70, "ties"), (1_025, "signed_zeros"),
                                     (9_900, "ties"), (19_800, "signed_zeros"),
                                     (9_965, "inf_and_nan")])
def test_event_pop_kernel_on_card(cuda, q, times):
    rng = np.random.default_rng(q)
    for _ in range(5):
        args = pop_queue(rng, q, POP_TIMES[times], cuda)
        before = cuda_build.LAUNCHES["event_pop"]
        got = t_pop.event_head(*args)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["event_pop"] == before + 1
        assert torch.equal(got.cpu(), t_pop.event_head_plain(*(x.cpu() for x in args)))


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
