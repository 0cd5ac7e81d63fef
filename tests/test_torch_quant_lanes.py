"""The codec's fused quantisation, on the CPU: a numpy model of
``csrc/delta_codec.cu``'s ``quant_leaves_kernel`` (the leaf table passed by
value, groups of at most ``kMaxLeaves`` leaves a launch, the binary search
for a codec block's leaf, each leaf read through its own pointer, a warp
taking codec blocks a wave apart, a batch of them loaded at a time, lane l
holding values 4l .. 4l + 3 of each 128 with zeros past the leaf's end,
the amax by a shuffle butterfly, the four codes of a lane packed into one
little-endian word, and the decoded payload written at each value's flat
place) against the
reference's ``ref.quant_blocks_ref`` and ``ref.dequant_blocks_ref`` on its
leaf-by-leaf blocking; and ``DeltaCodec.encode_decode`` on the CPU against
the reference's ``encode`` and ``decode``. The kernel's constants are read
from the source.

Every comparison is bitwise (codes, scales, decoded f32 values): both sides
divide with IEEE division and round half to even. NaN is left out: its
codes are not specified.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import delta_codec as j_dc
from repro.kernels import ref as j_ref
from repro_torch.core.aggregation import leaf_shapes
from repro_torch.fl import tasks as t_tasks
from repro_torch.kernels import cuda_build
from repro_torch.kernels import delta_codec as t_dc
from test_torch_codec import assert_bitwise, leaves_in_order, one_torch_thread  # noqa: F401

SOURCE = (cuda_build.CSRC / "delta_codec.cu").read_text()
F32 = np.float32
SMS = 132                       # an H100's SMs: the grid the model walks


def constant(name: str) -> int:
    m = re.search(rf"\bconstexpr int {name}\s*=\s*(\d+)", SOURCE)
    assert m, name
    return int(m.group(1))


MAX_LEAVES, WARPS, BLOCKS_PER_SM, BATCH = (constant(n) for n in (
    "kMaxLeaves", "kQuantWarps", "kQuantBlocksPerSm", "kQuantBatch"))


def nan_max(a, b):
    return np.where((b > a) | np.isnan(b), b, a)


def model_quant(leaves, addresses, block: int, qmax: int):
    """The launches over ``leaves`` (1-D f32 arrays, leaf l's first value at
    byte ``addresses[l]``): ``(codes (NB, block) int8, scales (NB,) f32,
    decoded (P,) f32, vectorised loads)``."""
    sizes = [leaf.size for leaf in leaves]
    first_block = np.concatenate([[0], np.cumsum([max(1, -(-n // block)) for n in sizes])])
    first_value = np.concatenate([[0], np.cumsum(sizes)])
    nb = int(first_block[-1])
    codes = np.full((nb, block), 99, np.int8)            # every byte must be written
    scales = np.full(nb, np.nan, F32)
    decoded = np.full(int(first_value[-1]), np.nan, F32)
    visits = np.zeros(nb, np.int64)
    runs = -(-block // 128)
    lanes = np.arange(32)
    vec_loads = 0
    for l0 in range(0, len(leaves), MAX_LEAVES):                 # one launch a group
        fb, fv = first_block[l0:l0 + MAX_LEAVES + 1], first_value[l0:l0 + MAX_LEAVES + 1]
        group = len(fb) - 1
        grid = min(-(-int(fb[-1] - fb[0]) // WARPS), SMS * BLOCKS_PER_SM)
        warps = grid * WARPS
        batch = 1 if runs >= BATCH else BATCH // runs
        steps = [(b0, slot) for w in range(warps)           # a wave apart, a batch a step
                 for b0 in range(int(fb[0]) + w, int(fb[-1]), warps * batch)
                 for slot in range(batch)]
        for b in (b0 + slot * warps for b0, slot in steps):
            if b < fb[-1]:
                visits[b] += 1
                lo, hi = 0, group                              # the binary search
                while hi - lo > 1:
                    mid = (lo + hi) // 2
                    lo, hi = (mid, hi) if fb[mid] <= b else (lo, mid)
                leaf = leaves[l0 + lo]
                offset = (b - int(fb[lo])) * block
                count = max(0, min(block, leaf.size - offset))
                vec = count == block and block % 4 == 0 and \
                    (addresses[l0 + lo] + 4 * offset) % 16 == 0
                vec_loads += vec
                # v[lane, j, k]: value 128 j + 4 lane + k of the block
                i = 128 * np.arange(runs)[None, :, None] + 4 * lanes[:, None, None] \
                    + np.arange(4)[None, None, :]
                v = np.where(i < count, leaf[np.minimum(offset + i, leaf.size - 1)]
                             if leaf.size else F32(0), F32(0)).astype(F32)
                amax = np.zeros(32, F32)
                for x in v.reshape(32, -1).T:
                    amax = nan_max(amax, np.abs(x))
                for d in (16, 8, 4, 2, 1):                         # shfl_xor butterfly
                    amax = nan_max(amax, amax[lanes ^ d])
                assert (amax == amax[0]).all()
                scale = amax[0] / F32(qmax) if amax[0] > 0 else F32(1.0)
                c = np.clip(np.rint(v / scale), -qmax, qmax).astype(np.int32)
                if block % 4 == 0:        # one word a lane a run, at byte 128 j + 4 lane
                    word = sum((c[..., k].astype(np.uint32) & np.uint32(0xFF)) << np.uint32(8 * k)
                               for k in range(4))
                    codes[b] = word.T.astype("<u4").reshape(-1).view(np.int8)[:block]
                else:
                    keep = i < block
                    codes[b, i[keep]] = c[keep]
                keep = i < count
                decoded[fv[lo] + offset + i[keep]] = c[keep].astype(F32) * scale
                scales[b] = scale
    assert (visits == 1).all()
    return codes, scales, decoded, vec_loads


def reference(leaves, block: int, qmax: int):
    """The reference's leaf-by-leaf blocking, quantisation and decode."""
    codes, scales, decoded = [], [], []
    for leaf in leaves:
        c, s = j_ref.quant_blocks_ref(j_dc._to_blocks(jnp.asarray(leaf), block), qmax)
        codes.append(np.asarray(c))
        scales.append(np.asarray(s))
        decoded.append(np.asarray(j_ref.dequant_blocks_ref(c, s)).reshape(-1)[:leaf.size])
    return np.concatenate(codes), np.concatenate(scales), np.concatenate(decoded)


CNN_SIZES = (32, 64, 512, 10, 800, 51_200, 1_605_632, 5_120)    # the paper's CNN, sorted
RAGGED_SIZES = (1, 127, 0, 129, 1_000, 77, 4)


def payload(rng, sizes, case, qmax):
    """Leaves of these sizes: "random"; "zero" (every other leaf zero, -0.0
    among them); "halves" (each 128 values' amax qmax * 2**e: x / scale on
    exact halves)."""
    leaves = [(rng.standard_normal(n) * 0.05).astype(F32) for n in sizes]
    for l, leaf in enumerate(leaves):
        if case == "zero" and l % 2:
            leaf[:] = np.where(rng.random(leaf.size) < 0.5, F32(-0.0), F32(0.0))
        if case == "halves" and leaf.size:
            e = np.repeat(rng.integers(-10, 10, -(-leaf.size // 128)), 128)[:leaf.size]
            leaf[:] = ((rng.integers(-qmax, qmax, leaf.size) + 0.5) * np.exp2(e)).astype(F32)
            leaf[::128] = (qmax * np.exp2(e[::128])).astype(F32)
    return leaves


@pytest.mark.parametrize("sizes,case,block,flat", [
    (CNN_SIZES, "random", 128, False), (CNN_SIZES, "halves", 128, True),
    (RAGGED_SIZES, "random", 128, True), (RAGGED_SIZES, "zero", 128, True),
    (RAGGED_SIZES, "random", 100, True), (RAGGED_SIZES, "random", 32, False),
    (RAGGED_SIZES, "random", 256, True), (RAGGED_SIZES, "halves", 1024, True),
    (tuple(range(41)), "random", 128, True)])
@pytest.mark.parametrize("qmax", [127, 7])
def test_model_lanes_match_reference(sizes, case, block, flat, qmax):
    """The kernel's lanes and leaf table, modelled, against the reference:
    leaves of their own (16-byte aligned) or views of one flat payload
    (offsets such as the CNN's 608 and 618 values not 16-byte aligned),
    empty and one-value leaves, blocks padded at every leaf's end, blocks
    not a multiple of 4 values, 41 leaves (two launches)."""
    rng = np.random.default_rng(len(sizes) + block + qmax)
    leaves = payload(rng, sizes, case, qmax)
    starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    addresses = 4 * starts if flat else [256 * (l + 1) for l in range(len(leaves))]
    codes, scales, decoded, vec = model_quant(leaves, addresses, block, qmax)
    want_c, want_s, want_d = reference(leaves, block, qmax)
    np.testing.assert_array_equal(codes, want_c)
    assert_bitwise(scales, want_s)
    assert_bitwise(decoded, want_d)
    if sizes == CNN_SIZES:
        assert codes.shape[0] == 12_998 and vec > 0
        # the port's own plain route, on the flat payload
        flat_t = torch.from_numpy(np.concatenate(leaves))
        layout = t_dc.leaf_layout(tuple((f"l{i}", (n,)) for i, n in enumerate(sizes)), block)
        got_c, got_s = t_dc.quant_leaves(flat_t, layout, qmax)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        assert_bitwise(got_s.numpy(), want_s)


def ragged_model(rng):
    """A model whose leaves are no multiple of a block and one a single
    value, as a dict (sorted names differ from insertion order)."""
    shapes = {"z": (3, 5), "a": (1,), "m": (129,), "b": (7, 19, 2), "k": (1_000,)}
    return {name: (rng.standard_normal(shape) * 0.1).astype(F32) for name, shape in shapes.items()}


@pytest.mark.parametrize("model", ["cnn", "ragged"])
@pytest.mark.parametrize("kind", ["int8", "int4", "topk", "none"])
def test_encode_decode_matches_reference(model, kind):
    """``encode_decode`` on the CPU: ``enc`` with the reference's keys and
    tensors, and the reference's ``decode`` of it, bitwise; the same as the
    port's ``encode`` and ``decode``."""
    rng = np.random.default_rng(3)
    if model == "cnn":
        p = {k: (v.numpy() + 0.01 * rng.standard_normal(v.shape)).astype(F32)
             for k, v in t_tasks.CNNTask().init(0, "cpu").items()}
    else:
        p = ragged_model(rng)
    b = {k: (v + 0.001 * rng.standard_normal(v.shape)).astype(F32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jp, jb = ({k: jnp.asarray(v) for k, v in d.items()} for d in (p, b))
    codec, j_codec = t_dc.DeltaCodec(kind), j_dc.DeltaCodec(kind, impl="lax")
    enc, dec = codec.encode_decode(tp, tb)
    j_enc = j_codec.encode(jp, jb)
    j_dec = j_codec.decode(j_enc, jb)
    if kind != "none":
        assert set(enc) == set(j_enc) and all(set(enc[k]) == set(p) for k in enc)
    got, want = leaves_in_order(enc), [np.asarray(w) for w in leaves_in_order(j_enc)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype
        assert_bitwise(g.numpy().astype(F32), w.astype(F32))
    port_dec = codec.decode(codec.encode(tp, tb), tb)
    for name in p:
        assert tuple(dec[name].shape) == p[name].shape
        assert_bitwise(dec[name].numpy(), np.asarray(j_dec[name]))
        assert_bitwise(dec[name].numpy(), port_dec[name].numpy())


@pytest.mark.parametrize("kind,qmax", [("int8", 127), ("int4", 7)])
def test_quant_params_plain_route_decodes_in_place(kind, qmax):
    """``quant_params`` on the CPU, with the decoded payload: the plain
    versions leaf by leaf, padding dropped, in the layout's flat order;
    leaves out of the layout's order or size are refused."""
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy(v) for k, v in ragged_model(rng).items()}
    layout = t_dc.leaf_layout(leaf_shapes(p))
    codes, scales, decoded = t_dc.quant_params(p, layout, qmax, decode=True)
    want_c, want_s, want_d = reference([p[n].numpy().reshape(-1) for n in layout.names],
                                       t_dc.BLOCK, qmax)
    np.testing.assert_array_equal(codes.numpy(), want_c)
    assert_bitwise(scales.numpy(), want_s)
    assert_bitwise(decoded.numpy(), want_d)
    assert t_dc.quant_params(p, layout, qmax)[2] is None
    with pytest.raises(ValueError, match="leaves"):
        t_dc.quant_params({k: v for k, v in p.items() if k != "a"}, layout, qmax)
    with pytest.raises(ValueError, match="holds"):
        t_dc.quant_params(dict(p, a=torch.zeros(2)), layout, qmax)
