"""Wire codec of the gossiped model bank: blocked quantisation and per-block
top-k (kernels, plain versions, dispatchers) and ``DeltaCodec``.

The codec sits between a committer and the wire (``repro_torch.net.bank``):
on the 1 Mbit/s link class raw f32 chunks saturate the links, and the codec
trades accuracy for bytes. As in the reference
(``repro/kernels/delta_codec.py``):

``quant_blocks``   per codec block of ``BLOCK`` values: ``scale = amax /
                   qmax`` (exactly 1.0 on an all-zero block, so padding
                   round-trips to zero) and ``codes = clip(round(x /
                   scale), -qmax, qmax)`` as int8, rounding half to even.
                   int4 uses the same int8 carrier with ``qmax = 7`` and is
                   priced at two codes per byte by ``wire_ratio``. Replaces
                   the TPU kernel ``quant_blocks_pallas``.

``topk_blocks``    per block keep the k largest-|d| values and zero the
                   rest, where j ranks ahead of i when ``|d_j| > |d_i|`` or
                   (``|d_j| == |d_i|`` and ``j < i``): ties go to the earlier
                   index, a NaN ranks ahead of nothing and is itself kept,
                   and ``k >= nnz(block)`` keeps the delta exactly. Replaces
                   the TPU kernel ``topk_blocks_pallas``.

Both run as the CUDA kernels of ``repro_torch/csrc/delta_codec.cu`` for
CUDA tensors (raising if they cannot build or launch) and as their plain
versions (the ports of ``repro.kernels.ref.quant_blocks_ref``,
``dequant_blocks_ref`` and ``topk_blocks_ref``) only for CPU tensors. The
codes of a NaN or infinite value are not specified (the reference casts a
NaN to int8).

A model is blocked leaf by leaf, in sorted-name order, each leaf zero-padded
to whole blocks (``BlockLayout``): the paper's CNN gives 12,998 blocks, not
the 12,996 of its flat 1,663,370 values. ``quant_params`` takes the leaves
themselves, ``quant_leaves`` and ``topk_leaves`` the flat payload, with its
layout; each launches its kernel once for all leaves (quantisation once per
32 leaves), reading the payload (and the base) in place.

``DeltaCodec.encode(params, base)`` maps a commit's payload (a dict of
leaves) to its wire form: ``{"codes": {name: (nb, block) int8}, "scales":
{name: (nb,) f32}}`` for int8/int4, ``{"delta": {name: (nb, block) f32}}``
for topk (the masked delta against ``base``, the slot's content before the
commit overwrites it). ``decode(enc, base)`` inverts it, and
``encode_decode`` gives both: for int8/int4 on a card one launch
(``quant_params`` with ``decode``) reads the leaves in place and writes the
codes, the scales and the decoded payload. ``codec_key`` maps every codec
that prices like raw bytes to ``None``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.aggregation import Shapes, flatten_params, leaf_shapes
from repro_torch.kernels import cuda_build

BLOCK = 128                 # codec block length
MAX_BLOCK = 1024            # the kernels' limit: top-k holds up to 32 values a lane of a warp
PLAIN_SLAB = 1024           # blocks per (slab, block, block) compare in topk_blocks_plain
QUANT_NAME = "quant_blocks"
TOPK_NAME = "topk_blocks"

_QMAX = {"int8": 127, "int4": 7}


# ---------------------------------------------------------------------------
# Plain versions: the kernels' oracles and the CPU path
# ---------------------------------------------------------------------------


def quant_blocks_plain(x: torch.Tensor, qmax: int):
    """(nb, B) f32 -> ``(codes (nb, B) int8, scales (nb,) f32)``, as
    ``ref.quant_blocks_ref``.

    ``qmax`` divides as a tensor filled on the device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which is not
    the IEEE quotient.
    """
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0.0, amax / torch.full_like(amax, qmax), 1.0)
    codes = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return codes, scale[:, 0]


def dequant_blocks_plain(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quant_blocks``: codes times their block's scale, in f32."""
    return codes.float() * scales[:, None]


def topk_blocks_plain(d: torch.Tensor, k: int) -> torch.Tensor:
    """(nb, B) f32 -> the dense masked delta, as ``ref.topk_blocks_ref``.

    The rank compare is (blocks, B, B); it runs ``PLAIN_SLAB`` blocks at a
    time, so memory stays bounded at full width.
    """
    d = d.float()
    b = d.shape[-1]
    idx = torch.arange(b, device=d.device)
    earlier = idx[:, None] < idx[None, :]                          # [j, i]
    out = torch.empty_like(d)
    for s in range(0, d.shape[0], PLAIN_SLAB):
        ds = d[s:s + PLAIN_SLAB]
        a = ds.abs()
        gt = a[:, :, None] > a[:, None, :]                         # [n, j, i]
        eq = (a[:, :, None] == a[:, None, :]) & earlier
        rank = (gt | eq).sum(dim=1, dtype=torch.int32)
        out[s:s + PLAIN_SLAB] = torch.where(rank < k, ds, 0.0)
    return out


def _to_blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad a flat vector to whole codec blocks: (n,) -> (max(1, ceil(n / block)), block)."""
    n = flat.shape[0]
    nb = max(1, -(-n // block))
    out = torch.zeros(nb * block, dtype=torch.float32, device=flat.device)
    out[:n] = flat
    return out.view(nb, block)


# ---------------------------------------------------------------------------
# Leaf-by-leaf blocking of a flat payload
# ---------------------------------------------------------------------------


class BlockLayout(NamedTuple):
    """Codec blocks of a flat payload, leaf by leaf.

    ``first_block[l]`` is leaf l's first codec block and ``first_value[l]``
    its first flat value; both end with the totals (NB, P).
    """

    names: Tuple[str, ...]
    first_block: Tuple[int, ...]
    first_value: Tuple[int, ...]
    block: int

    @property
    def num_blocks(self) -> int:
        return self.first_block[-1]

    @property
    def num_values(self) -> int:
        return self.first_value[-1]

    def split(self, blocked: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Rows of a (NB, ...) result, leaf by leaf: views."""
        return {name: blocked[b0:b1] for name, b0, b1
                in zip(self.names, self.first_block, self.first_block[1:])}


@functools.lru_cache(maxsize=64)
def leaf_layout(shapes: Shapes, block: int = BLOCK) -> BlockLayout:
    """The layout of a model with these ``(name, shape)`` leaves (flatten order)."""
    first_block, first_value = [0], [0]
    for _, shape in shapes:
        n = math.prod(shape)
        first_block.append(first_block[-1] + max(1, -(-n // block)))
        first_value.append(first_value[-1] + n)
    return BlockLayout(tuple(name for name, _ in shapes), tuple(first_block),
                       tuple(first_value), block)


def dense_layout(nb: int, block: int) -> BlockLayout:
    """A (nb, block) matrix as one leaf of whole blocks."""
    return BlockLayout(("x",), (0, nb), (0, nb * block), block)


def blocked(flat: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """(NB, block) f32: every leaf of the flat payload zero-padded to whole blocks."""
    fv = layout.first_value
    return torch.cat([_to_blocks(flat[v0:v1], layout.block) for v0, v1 in zip(fv, fv[1:])])


@functools.lru_cache(maxsize=64)
def _device_table(layout: BlockLayout, device: torch.device) -> torch.Tensor:
    return torch.tensor([layout.first_block, layout.first_value], dtype=torch.int64,
                        device=device)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("delta_codec.cu")
    lib.quant_leaves.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # src, first_block, first_value
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # leaves, block, qmax
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # codes, scales, decoded
        ctypes.c_int, ctypes.c_void_p,                       # device, stream
    ]
    lib.quant_leaves.restype = ctypes.c_int
    lib.quant_leaves_max_leaves.argtypes = []
    lib.quant_leaves_max_leaves.restype = ctypes.c_int
    lib.topk_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, base, table
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,       # leaves, nb, block
        ctypes.c_int, ctypes.c_void_p,                       # k, out
        ctypes.c_int, ctypes.c_void_p,                       # device, stream
    ]
    lib.topk_blocks.restype = ctypes.c_int
    lib.delta_codec_error_string.argtypes = [ctypes.c_int]
    lib.delta_codec_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _host_table(layout: BlockLayout):
    """The layout's first blocks and first values as host int64 arrays, the
    quantisation kernel's leaf table (it travels by value)."""
    row = ctypes.c_longlong * (len(layout.names) + 1)
    return row(*layout.first_block), row(*layout.first_value)


def _check_size(name: str, t: torch.Tensor, layout: BlockLayout) -> None:
    if tuple(t.shape) != (layout.num_values,):
        raise ValueError(f"{name} must have shape ({layout.num_values},), got {tuple(t.shape)}")


def _check_flat(name: str, t: torch.Tensor, layout: BlockLayout, device: torch.device) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous float32 tensor on {device}, got "
                         f"{t.dtype} on {t.device}")
    if not 1 <= layout.block <= MAX_BLOCK:
        raise ValueError(f"the kernels take codec blocks of 1 to {MAX_BLOCK} values, "
                         f"not {layout.block}")


def _launch_args(flat: torch.Tensor, layout: BlockLayout):
    table = _device_table(layout, flat.device)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    return table, flat.device.index or 0, stream


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.delta_codec_error_string(code).decode()} ({code})")


def _on_cpu(flat: torch.Tensor, what: str) -> bool:
    if flat.device.type == "cpu":
        return True
    if flat.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {flat.device}")
    return False


def _unblocked(blocks: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """(P,): the values of (NB, block) rows leaf by leaf, padding dropped."""
    return torch.cat([blocks[b0:b1].reshape(-1)[:v1 - v0] for b0, b1, v0, v1 in zip(
        layout.first_block, layout.first_block[1:], layout.first_value, layout.first_value[1:])])


def _quant_launch(leaves, layout: BlockLayout, qmax: int, decode: bool):
    """One kernel launch per ``quant_leaves_max_leaves()`` leaves, reading
    each leaf (a contiguous f32 tensor of its layout's size) in place."""
    dev = leaves[0].device
    nb, block = layout.num_blocks, layout.block
    codes = torch.empty((nb, block), dtype=torch.int8, device=dev)
    scales = torch.empty((nb,), dtype=torch.float32, device=dev)
    decoded = torch.empty((layout.num_values,), dtype=torch.float32, device=dev) if decode \
        else None
    first_block, first_value = _host_table(layout)
    src = (ctypes.c_void_p * len(leaves))(*(leaf.data_ptr() for leaf in leaves))
    lib = _library()
    code = lib.quant_leaves(src, first_block, first_value, len(leaves), block, int(qmax),
                            codes.data_ptr(), scales.data_ptr(),
                            None if decoded is None else decoded.data_ptr(), dev.index or 0,
                            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, code, QUANT_NAME)
    cuda_build.LAUNCHES[QUANT_NAME] += -(-len(leaves) // lib.quant_leaves_max_leaves())
    return codes, scales, decoded


def quant_leaves(flat: torch.Tensor, layout: BlockLayout, qmax: int):
    """Quantise a flat payload (P,) blocked by ``layout``: ``(codes (NB,
    block) int8, scales (NB,) f32)``. One kernel launch on CUDA, reading the
    payload in place; ``quant_blocks_plain`` of the padded blocks on the CPU."""
    _check_size("payload", flat, layout)
    if _on_cpu(flat, QUANT_NAME):
        return quant_blocks_plain(blocked(flat, layout), qmax)
    _check_flat("payload", flat, layout, flat.device)
    fv = layout.first_value
    codes, scales, _ = _quant_launch([flat[v0:v1] for v0, v1 in zip(fv, fv[1:])], layout, qmax,
                                     decode=False)
    return codes, scales


def quant_params(params: Dict[str, torch.Tensor], layout: BlockLayout, qmax: int,
                 decode: bool = False):
    """Quantise a payload given as leaves (a dict, blocked by ``layout`` in
    its sorted-name order): ``(codes (NB, block) int8, scales (NB,) f32,
    decoded)``, ``decoded`` the flat (P,) f32 ``dequant_blocks`` of the codes
    with the padding dropped when ``decode``, else None. One kernel launch on
    CUDA, reading each leaf in place through its own pointer (no flat copy)
    and, with ``decode``, writing the decoded payload in the same launch;
    the plain versions on the CPU."""
    names = tuple(sorted(params))
    if names != layout.names:
        raise ValueError(f"the payload's leaves {names} are not the layout's {layout.names}")
    leaves = [params[name].reshape(-1) for name in names]
    for name, leaf, v0, v1 in zip(names, leaves, layout.first_value, layout.first_value[1:]):
        if leaf.shape[0] != v1 - v0:
            raise ValueError(f"leaf {name} holds {leaf.shape[0]} values, its layout {v1 - v0}")
    if _on_cpu(leaves[0], QUANT_NAME):
        codes, scales = quant_blocks_plain(blocked(torch.cat(leaves), layout), qmax)
        decoded = _unblocked(dequant_blocks_plain(codes, scales), layout) if decode else None
        return codes, scales, decoded
    dev = leaves[0].device
    leaves = [leaf.to(torch.float32).contiguous() for leaf in leaves]
    if any(leaf.device != dev for leaf in leaves):
        raise ValueError(f"every leaf must lie on {dev}")
    _check_flat("payload", leaves[0], layout, dev)
    return _quant_launch(leaves, layout, qmax, decode)


def topk_leaves(flat: torch.Tensor, base: Optional[torch.Tensor], layout: BlockLayout,
                k: int) -> torch.Tensor:
    """Top-k of the delta ``flat - base`` (or of ``flat`` when ``base`` is
    None) blocked by ``layout``: the dense masked delta (NB, block) f32. One
    kernel launch on CUDA, subtracting in place; ``topk_blocks_plain`` of the
    padded blocks on the CPU."""
    _check_size("payload", flat, layout)
    if base is not None:
        _check_size("base", base, layout)
    if _on_cpu(flat, TOPK_NAME):
        d = flat if base is None else flat - base
        return topk_blocks_plain(blocked(d, layout), k)
    _check_flat("payload", flat, layout, flat.device)
    if base is not None:
        _check_flat("base", base, layout, flat.device)
    nb, block = layout.num_blocks, layout.block
    out = torch.empty((nb, block), dtype=torch.float32, device=flat.device)
    table, device, stream = _launch_args(flat, layout)
    lib = _library()
    code = lib.topk_blocks(flat.data_ptr(), None if base is None else base.data_ptr(),
                           table.data_ptr(), len(layout.names), nb, block,
                           max(0, min(int(k), block)), out.data_ptr(), device, stream)
    _raise_on(lib, code, TOPK_NAME)
    cuda_build.LAUNCHES[TOPK_NAME] += 1
    return out


def quant_blocks(x: torch.Tensor, qmax: int):
    """Blocked quantisation of (nb, B) f32: the kernel for CUDA tensors,
    ``quant_blocks_plain`` for CPU tensors."""
    if _on_cpu(x, QUANT_NAME):
        return quant_blocks_plain(x, qmax)
    if x.shape[0] == 0:
        return quant_blocks_plain(x, qmax)      # nothing to launch
    return quant_leaves(x.float().reshape(-1), dense_layout(*x.shape), qmax)


def topk_blocks(d: torch.Tensor, k: int) -> torch.Tensor:
    """Per-block top-k of (nb, B) f32: the kernel for CUDA tensors,
    ``topk_blocks_plain`` for CPU tensors."""
    if _on_cpu(d, TOPK_NAME):
        return topk_blocks_plain(d, k)
    if d.shape[0] == 0:
        return torch.empty_like(d)
    return topk_leaves(d.float().reshape(-1), None, dense_layout(*d.shape), k)


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeltaCodec:
    """The wire codec for bank commits.

    ``kind`` — "none" (the identity: encode and decode pass through),
    "int8" / "int4" (blocked symmetric quantisation; int4 codes travel two
    per byte, carried one per int8), or "topk" (per-block top-k of the delta
    against the slot's last content); ``block`` — the codec block length;
    ``topk_frac`` — the fraction of each block kept by "topk".

    The reference's ``impl`` (Pallas or lax) has no counterpart: the kernels
    run for CUDA tensors, their plain versions for CPU tensors.
    """

    kind: str = "int8"
    block: int = BLOCK
    topk_frac: float = 0.0625

    def __post_init__(self):
        if self.kind not in ("none", "int8", "int4", "topk"):
            raise ValueError(f"unknown codec kind: {self.kind!r}")
        if self.block < 1:
            raise ValueError(f"codec block must be positive, got {self.block}")

    @property
    def is_identity(self) -> bool:
        return self.kind == "none"

    def topk_k(self) -> int:
        """Values kept per block by "topk" (at least 1)."""
        return max(1, int(round(self.topk_frac * self.block)))

    def wire_ratio(self) -> float:
        """Encoded / raw wire bytes per chunk, the factor on ``chunk_bytes``.

        Raw: 4 bytes per f32 value. int8: one code byte per value plus a
        4-byte scale per block; int4: half a byte per value plus the scale;
        topk: 8 bytes (index and value) per kept value.
        """
        if self.kind == "none":
            return 1.0
        if self.kind == "int8":
            return (self.block + 4.0) / (4.0 * self.block)
        if self.kind == "int4":
            return (self.block / 2.0 + 4.0) / (4.0 * self.block)
        return min(1.0, 8.0 * self.topk_k() / (4.0 * self.block))

    def encode(self, params: Dict[str, torch.Tensor], base: Dict[str, torch.Tensor]):
        """Payload -> wire form (see the module docstring); one kernel launch
        on CUDA. ``base`` (the slot's last content) is read by "topk" only:
        quantisation ignores it, so identical payloads still dedup."""
        if self.kind == "none":
            return params
        layout = leaf_layout(leaf_shapes(params), self.block)
        if self.kind in _QMAX:
            codes, scales, _ = quant_params(params, layout, _QMAX[self.kind])
            return {"codes": layout.split(codes), "scales": layout.split(scales)}
        delta = topk_leaves(flatten_params(params), flatten_params(base), layout, self.topk_k())
        return {"delta": layout.split(delta)}

    def encode_decode(self, params: Dict[str, torch.Tensor], base: Dict[str, torch.Tensor]):
        """``(encode(params, base), decode(that, base))``, bitwise. For int8
        and int4 on a card, one kernel launch writes the codes, the scales
        and the decoded payload (leaves: views of one fresh flat buffer,
        shaped as ``base``'s); otherwise encode, then decode."""
        first = next(iter(params.values()))
        if self.kind not in _QMAX or first.device.type != "cuda":
            enc = self.encode(params, base)
            return enc, self.decode(enc, base)
        layout = leaf_layout(leaf_shapes(params), self.block)
        codes, scales, flat = quant_params(params, layout, _QMAX[self.kind], decode=True)
        enc = {"codes": layout.split(codes), "scales": layout.split(scales)}
        at = dict(zip(layout.names, layout.first_value))
        return enc, {name: flat[at[name]:at[name] + b.numel()].view(b.shape).to(b.dtype)
                     for name, b in base.items()}

    def decode(self, enc, base: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Wire form -> payload, leaves shaped and typed as ``base``'s."""
        if self.kind == "none":
            return enc

        def restore(blocks, b):
            return blocks.reshape(-1)[:b.numel()].reshape(b.shape)

        if self.kind in _QMAX:
            return {name: restore(dequant_blocks_plain(enc["codes"][name], enc["scales"][name]),
                                  b).to(b.dtype)
                    for name, b in base.items()}
        return {name: (b.float() + restore(enc["delta"][name], b)).to(b.dtype)
                for name, b in base.items()}


def codec_key(codec: Optional[DeltaCodec]) -> Optional[DeltaCodec]:
    """``None`` for every codec that prices like raw bytes (``None``, kind
    "none", or a ratio-1.0 configuration such as topk with ``topk_frac=1``),
    else the codec: the engines then keep the uncompressed path untouched."""
    if codec is None or codec.wire_ratio() == 1.0:
        return None
    return codec
