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
"""
import numpy as np
import pytest
import torch

from repro_torch.core import aggregation as t_agg
from repro_torch.core import bank as t_bank
from repro_torch.kernels import chunk_transfer as t_ck
from repro_torch.kernels import cuda_build
from repro_torch.kernels import fedavg as t_fedavg
from repro_torch.kernels import gossip_merge as t_gm


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
