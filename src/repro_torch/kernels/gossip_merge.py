"""Per-(receiver, row) gossip-merge winner selection: kernel, plain versions, dispatcher.

Replaces the TPU kernel ``repro/kernels/gossip_merge.py::gossip_winner_pallas``
(``_winner_kernel``). For receiver i of a (possibly rectangular) receiver
block and ledger row r, over the senders j that ``mask[i, j]`` admits — the
receiver's own global index ``gid = i + row_offset`` always admitted — and
that hold the row (``publisher >= 0``):

  src[i, r]   the lowest j holding the lexicographically largest
              ``(publish_time, publisher)`` key; ``gid`` itself when the
              receiver holds that key or when no candidate holds the row;
  ac[i, r]    the max over all R senders of ``approval_count`` where j holds
              the winning key and 0 where it does not (the winners' max,
              floored at 0 unless every sender wins; 0 when nothing wins).

This is the bitwise order of the sequential merge fold
(``repro_torch.core.dag.merge`` over senders in index order, starting from
the receiver's own replica), so ``dag.merge_select`` of ``src`` is the
fold's result.

``gossip_winner`` launches the CUDA kernel (``repro_torch/csrc/gossip_merge.cu``)
for CUDA tensors and raises if it cannot; it takes ``gossip_winner_plain``
(the port of ``repro.kernels.ref.gossip_winner_ref``) only for CPU tensors.
``gossip_winner_nbr`` is the neighbour-list form (plain PyTorch), the
``impl="lax"`` round of ``repro_torch.net.gossip``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_build

NAME = "gossip_winner"
MAX_RECEIVERS = 65535          # gridDim.y
_INT32_MIN = torch.iinfo(torch.int32).min


def gossip_winner_plain(
    publish_time: torch.Tensor,        # (R, cap) f32
    publisher: torch.Tensor,           # (R, cap) i32, -1 = empty row
    approval_count: torch.Tensor,      # (R, cap) i32
    mask: torch.Tensor,                # (Rr, R) bool: receiver i hears sender j
    row_ids: Optional[torch.Tensor] = None,   # (Rr,) global sender index per receiver
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch: the CPU path and the kernel's oracle.

    A port of ``ref.gossip_winner_ref``: dense (Rr, R, cap) masked reductions.
    ``row_ids=None`` means receiver i is sender i.
    """
    rr, r = mask.shape
    dev = mask.device
    rows = torch.arange(rr, device=dev)
    recv = rows if row_ids is None else row_ids.long()
    # the receiver is a candidate (an OR, not an index-put of a host scalar:
    # that copies the scalar to the card and waits for the stream)
    mask = mask | (recv[:, None] == torch.arange(r, device=dev)[None, :])
    occ = publisher >= 0
    valid = mask[:, :, None] & occ[None]                      # (Rr, R, cap)
    tm = torch.where(valid, publish_time[None], -torch.inf)
    best_t = tm.amax(dim=1)                                   # (Rr, cap)
    tie = valid & (tm == best_t[:, None])
    pm = torch.where(tie, publisher[None], _INT32_MIN)
    best_p = pm.amax(dim=1)
    win = tie & (pm == best_p[:, None])                       # winning identity
    idx = torch.arange(r, dtype=torch.int32, device=dev)[None, :, None]
    first = torch.where(win, idx, r).amin(dim=1)              # (Rr, cap)
    self_win = occ[recv] & (publish_time[recv] == best_t) & (publisher[recv] == best_p)
    src = torch.where(self_win | (first >= r), recv[:, None].to(torch.int32), first)
    ac = torch.where(win, approval_count[None], 0).amax(dim=1)
    return src.to(torch.int32), ac.to(torch.int32)


def gossip_winner_nbr(
    publish_time: torch.Tensor,        # (R, cap) f32
    publisher: torch.Tensor,           # (R, cap) i32
    approval_count: torch.Tensor,      # (R, cap) i32
    nbr_idx: torch.Tensor,             # (Rr, D) i32 candidate sender lists
    nbr_act: torch.Tensor,             # (Rr, D) bool candidate activity
    row_ids: Optional[torch.Tensor] = None,   # (Rr,) global sender index per receiver
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Degree-compressed winner selection over per-receiver candidate lists.

    The same rule as ``gossip_winner_plain``, O(Rr * D * cap) for max degree
    D. A receiver that should be its own candidate (always, in gossip) must
    appear in its list with ``nbr_act`` true; lists may repeat an index.
    """
    r = publish_time.shape[0]
    nbr = nbr_idx.long()
    t = publish_time[nbr]                                     # (Rr, D, cap)
    p = publisher[nbr]
    a = approval_count[nbr]
    valid = nbr_act[:, :, None] & (p >= 0)
    tm = torch.where(valid, t, -torch.inf)
    best_t = tm.amax(dim=1)                                   # (Rr, cap)
    tie = valid & (tm == best_t[:, None])
    pm = torch.where(tie, p, _INT32_MIN)
    best_p = pm.amax(dim=1)
    win = tie & (pm == best_p[:, None])
    first = torch.where(win, nbr_idx[:, :, None], r).amin(dim=1)
    if row_ids is None:
        rows = torch.arange(nbr_idx.shape[0], dtype=torch.int32, device=nbr_idx.device)[:, None]
        own_time, own_pub = publish_time, publisher
    else:
        rows = row_ids.to(torch.int32)[:, None]
        own_time, own_pub = publish_time[rows[:, 0].long()], publisher[rows[:, 0].long()]
    self_act = (nbr_act & (nbr_idx == rows)).any(dim=1)
    self_win = self_act[:, None] & (own_pub >= 0) & (own_time == best_t) & (own_pub == best_p)
    src = torch.where(self_win | (first >= r), rows, first)
    ac = torch.where(win, a, 0).amax(dim=1)
    return src.to(torch.int32), ac.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("gossip_merge.cu")
    lib.gossip_winner.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # publish_time, publisher, ac
        ctypes.c_longlong, ctypes.c_longlong,                # R, cap
        ctypes.c_void_p, ctypes.c_longlong,                  # mask, Rr
        ctypes.c_longlong,                                   # row_offset
        ctypes.c_void_p, ctypes.c_void_p,                    # src, ac out
        ctypes.c_int, ctypes.c_void_p,                       # device, stream
    ]
    lib.gossip_winner.restype = ctypes.c_int
    lib.gossip_error_string.argtypes = [ctypes.c_int]
    lib.gossip_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(publish_time, publisher, approval_count, mask, row_offset: int) -> None:
    if publish_time.dim() != 2 or mask.dim() != 2:
        raise ValueError(f"need (R, cap) columns and an (Rr, R) mask, got "
                         f"{tuple(publish_time.shape)} and {tuple(mask.shape)}")
    r = publish_time.shape[0]
    for name, t in (("publisher", publisher), ("approval_count", approval_count)):
        if t.shape != publish_time.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, publish_time "
                             f"{tuple(publish_time.shape)}")
    rr = mask.shape[0]
    if mask.shape[1] != r:
        raise ValueError(f"mask must be (Rr, {r}), got {tuple(mask.shape)}")
    if publish_time.dtype != torch.float32 or publisher.dtype != torch.int32 \
            or approval_count.dtype != torch.int32:
        raise TypeError("publish_time must be float32, publisher and approval_count int32")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be bool or uint8, not {mask.dtype}")
    for name, t in (("publish_time", publish_time), ("publisher", publisher),
                    ("approval_count", approval_count), ("mask", mask)):
        if t.device != publish_time.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {publish_time.device}")
    if not 0 <= row_offset or row_offset + rr > r:
        raise ValueError(f"row_offset {row_offset} with {rr} receivers leaves [0, {r})")
    if rr > MAX_RECEIVERS:
        raise ValueError(f"at most {MAX_RECEIVERS} receivers per launch, got {rr}")


def gossip_winner(
    publish_time: torch.Tensor,        # (R, cap) f32
    publisher: torch.Tensor,           # (R, cap) i32
    approval_count: torch.Tensor,      # (R, cap) i32
    mask: torch.Tensor,                # (Rr, R) bool/uint8
    row_offset: Optional[int] = None,  # global sender index of receiver 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, ac), each (Rr, cap) int32: per-row winner index and merged counter.

    ``row_offset`` marks ``mask`` as the contiguous receiver block starting
    at that sender index; None is the identity block (receiver i is sender
    i). The receiver is a candidate whatever its own mask entry says.
    """
    offset = 0 if row_offset is None else int(row_offset)
    if publish_time.device.type == "cpu":
        row_ids = None
        if row_offset is not None:
            row_ids = offset + torch.arange(mask.shape[0], dtype=torch.int32)
        return gossip_winner_plain(publish_time, publisher, approval_count, mask.bool(),
                                   row_ids=row_ids)
    if publish_time.device.type != "cuda":
        raise ValueError(f"gossip_winner runs on cuda or cpu tensors, not {publish_time.device}")
    _check_cuda_args(publish_time, publisher, approval_count, mask, offset)
    rr, cap = mask.shape[0], publish_time.shape[1]
    src = torch.empty((rr, cap), dtype=torch.int32, device=publish_time.device)
    ac = torch.empty((rr, cap), dtype=torch.int32, device=publish_time.device)
    lib = _library()
    code = lib.gossip_winner(
        publish_time.data_ptr(), publisher.data_ptr(), approval_count.data_ptr(),
        publish_time.shape[0], cap, mask.data_ptr(), rr, offset,
        src.data_ptr(), ac.data_ptr(),
        publish_time.device.index or 0,
        torch.cuda.current_stream(publish_time.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"gossip_winner launch failed: "
                           f"{lib.gossip_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES[NAME] += 1
    return src, ac
