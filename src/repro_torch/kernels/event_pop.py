"""The head of the continuous-time event queue: kernel, plain version, dispatchers.

Replaces the TPU kernel ``repro/kernels/event_pop.py::event_pop_pallas``
(``_pop_kernel``). Over the queue's (Q,) slots — f32 ``time``, i32 ``kind``
and ``seq``, bool ``valid`` — the head is the valid slot with the
lexicographically smallest ``(time, kind, seq)``, the lowest index on a
full tie. Times compare as floats: -0.0 ties +0.0. A NaN time on a valid
slot makes the head slot 0 (the reference's min is NaN, so nothing ties
it). Nothing valid: slot 0, not found.

``event_head`` gives one (4,) int32 tensor ``[idx, found, time bits,
kind]`` — the head's time as the bits of an f32 (+inf when nothing is
valid, NaN when a valid time is NaN) and its kind, so one read back gives
the loop everything it decides on. It launches the CUDA kernel
(``repro_torch/csrc/event_pop.cu``) for CUDA tensors, raising if it cannot
build or launch, and takes ``event_head_plain`` only for CPU tensors.
``pop_head`` is what the event loop calls once per batch: the same launch,
which also writes the four words to a pinned host mirror, then one stream
synchronisation and a read of the mirror (no allocation, no
device-to-host copy). ``event_pop`` gives the reference's ``(idx, found)``;
``event_pop_plain`` is the port of ``repro.kernels.ref.event_pop_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import cuda_build

NAME = "event_pop"
_INT32_MAX = torch.iinfo(torch.int32).max


def event_pop_plain(
    time: torch.Tensor,     # (Q,) f32 event fire times
    kind: torch.Tensor,     # (Q,) i32 event kind (repro_torch.net.events order)
    seq: torch.Tensor,      # (Q,) i32 insertion order (tie-break)
    valid: torch.Tensor,    # (Q,) bool slot occupancy
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx () i32, found () bool): the kernel's function in PyTorch, its
    oracle and the CPU path; ``ref.event_pop_ref`` step for step."""
    valid = valid.bool()
    t = torch.where(valid, time, torch.inf)
    tie = valid & (t == t.min())                # min propagates NaN: no tie
    kk = torch.where(tie, kind, _INT32_MAX)
    tie = tie & (kk == kk.min())
    ss = torch.where(tie, seq, _INT32_MAX)
    tie = tie & (ss == ss.min())
    # argmax of an integer mask: the first True, 0 when there is none
    return torch.argmax(tie.to(torch.int32)).to(torch.int32), valid.any()


def event_head_plain(time, kind, seq, valid) -> torch.Tensor:
    """(4,) int32 ``[idx, found, time bits, kind]`` in PyTorch (the CPU path)."""
    idx, found = event_pop_plain(time, kind, seq, valid)
    at = idx.long().reshape(1)       # a 0-d tensor index would be read back to the host
    has_nan = (valid.bool() & torch.isnan(time)).any()
    head_t = torch.where(has_nan, torch.nan, torch.where(found, time[at][0], torch.inf))
    return torch.stack([idx, found.to(torch.int32), head_t.view(torch.int32),
                        kind[at][0].to(torch.int32)])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("event_pop.cu")
    lib.event_pop.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # time, kind, seq, valid
        ctypes.c_longlong,                                                   # Q
        ctypes.c_void_p, ctypes.c_void_p,                                    # out, mirror
        ctypes.c_int, ctypes.c_void_p,                                       # device, stream
    ]
    lib.event_pop.restype = ctypes.c_int
    lib.event_pop_map_host.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_void_p)]
    lib.event_pop_map_host.restype = ctypes.c_int
    lib.event_pop_cluster_blocks.argtypes = [ctypes.c_longlong]
    lib.event_pop_cluster_blocks.restype = ctypes.c_int
    lib.event_pop_error_string.argtypes = [ctypes.c_int]
    lib.event_pop_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(time, kind, seq, valid) -> None:
    q = time.shape[0] if time.dim() == 1 else -1
    if q < 1 or any(x.shape != (q,) for x in (kind, seq, valid)):
        raise ValueError(f"need four (Q,) vectors with Q >= 1, got {tuple(time.shape)}, "
                         f"{tuple(kind.shape)}, {tuple(seq.shape)}, {tuple(valid.shape)}")
    if (time.dtype != torch.float32 or kind.dtype != torch.int32 or seq.dtype != torch.int32
            or valid.dtype not in (torch.bool, torch.uint8)):
        raise TypeError(f"need f32 time, i32 kind and seq, bool valid; got {time.dtype}, "
                        f"{kind.dtype}, {seq.dtype}, {valid.dtype}")
    for name, x in (("time", time), ("kind", kind), ("seq", seq), ("valid", valid)):
        if x.device != time.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {time.device}")
    if q > _INT32_MAX:
        raise ValueError(f"at most {_INT32_MAX} slots, got {q}")


class _Mirror:
    """A pinned (4,) int32 host buffer the kernel writes the head's words to,
    with its device address and numpy views of its words."""

    def __init__(self, device: int):
        self.host = torch.empty((4,), dtype=torch.int32, pin_memory=True)
        self.words = self.host.numpy()
        self.time = self.words[2:3].view(np.float32)
        lib = _library()
        ptr = ctypes.c_void_p()
        code = lib.event_pop_map_host(self.host.data_ptr(), device, ctypes.byref(ptr))
        _raise_on(lib, code, "mapping the host mirror")
        self.device_ptr = ptr.value


@functools.lru_cache(maxsize=None)
def _mirror(device: int) -> _Mirror:
    """One mirror per device, allocated at its first ``pop_head``."""
    return _Mirror(device)


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: {lib.event_pop_error_string(code).decode()} ({code})")


def _check_device(time) -> None:
    if time.device.type != "cuda":
        raise ValueError(f"event_pop runs on cuda or cpu tensors, not {time.device}")


def _launch(time, kind, seq, valid, mirror_ptr, stream) -> torch.Tensor:
    _check_cuda_args(time, kind, seq, valid)
    out = torch.empty((4,), dtype=torch.int32, device=time.device)
    lib = _library()
    code = lib.event_pop(
        time.data_ptr(), kind.data_ptr(), seq.data_ptr(), valid.data_ptr(), time.shape[0],
        out.data_ptr(), mirror_ptr, time.device.index or 0, stream.cuda_stream,
    )
    _raise_on(lib, code, "event_pop launch")
    cuda_build.LAUNCHES[NAME] += 1
    return out


def event_head(time, kind, seq, valid) -> torch.Tensor:
    """(4,) int32 ``[idx, found, time bits, kind]`` of the queue head (see the
    module docstring): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if time.device.type == "cpu":
        return event_head_plain(time, kind, seq, valid)
    _check_device(time)
    return _launch(time, kind, seq, valid, None, torch.cuda.current_stream(time.device))


def pop_head(time, kind, seq, valid) -> Tuple[int, bool, float, int, torch.Tensor]:
    """``(idx, found, time, kind, head)``: ``read_head(event_head(...))``
    and the (4,) head itself, in one launch and one stream synchronisation.
    On CUDA tensors the kernel also writes the words to the device's pinned
    mirror, which is read after the synchronisation; on CPU tensors the
    plain version's words are read."""
    if time.device.type == "cpu":
        head = event_head_plain(time, kind, seq, valid)
        return (*read_head(head), head)
    _check_device(time)
    mirror = _mirror(time.device.index or 0)
    stream = torch.cuda.current_stream(time.device)
    head = _launch(time, kind, seq, valid, mirror.device_ptr, stream)
    stream.synchronize()
    idx, found, _, kind_ = mirror.words.tolist()
    return idx, bool(found), float(mirror.time[0]), kind_, head


def cluster_blocks(q: int) -> int:
    """The blocks of the thread block cluster one launch over ``q`` slots
    runs (built on first use)."""
    return _library().event_pop_cluster_blocks(q)


def event_pop(time, kind, seq, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx () i32, found () bool), as ``ref.event_pop_ref`` returns them:
    one ``event_head`` (the kernel on a card) for CUDA tensors,
    ``event_pop_plain`` for CPU tensors."""
    if time.device.type == "cpu":
        return event_pop_plain(time, kind, seq, valid)
    head = event_head(time, kind, seq, valid)
    return head[0], head[1].bool()


def read_head(head: torch.Tensor) -> Tuple[int, bool, float, int]:
    """``(idx, found, time, kind)`` of an ``event_head`` result on the host:
    its one read back. ``time`` is the head's f32 value as a Python float."""
    idx, found, bits, kind = head.cpu().numpy()
    return int(idx), bool(found), float(np.int32(bits).view(np.float32)), int(kind)
