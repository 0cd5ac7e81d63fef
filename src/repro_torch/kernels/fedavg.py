"""Eq. (1) FederatedAveraging over gathered bank rows: kernel, plain version, dispatcher.

Replaces the TPU kernel ``repro/kernels/fedavg.py::fedavg_pallas``
(``_fedavg_kernel``): ``out[p] = sum_j w[j] * rows[slot[j], p]`` for
``j < k <= 8``, accumulated in f32, in the rows' dtype. The CUDA source is
``repro_torch/csrc/fedavg.cu``; its header gives the bound (device-memory
bytes: ``(k + 1) * P * itemsize``, 20.0 MB and about 6 us on an H100 at the
main path's k = 2, P = 1,663,370 f32) and the design.

``fedavg_gather`` launches the kernel for CUDA tensors and raises if it
cannot; it takes the plain version only for CPU tensors. ``fedavg`` is the
reference kernel's own ``(weights, models)`` signature: the same launch with
``slot = arange(k)``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

NAME = "fedavg_gather"
MAX_K = 8
ROW_ALIGN_BYTES = 16        # the kernel's vector width
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def alloc_rows(n: int, size: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Zeroed ``(n, size)`` rows whose stride is padded to 16 bytes.

    Every row then starts 16-byte aligned, which is what lets the kernel
    stream each gathered row with 16-byte loads.
    """
    per = ROW_ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
    stride = -(-size // per) * per
    return torch.zeros((n, stride), dtype=dtype, device=device)[:, :size]


def fedavg_gather_plain(rows: torch.Tensor, slots: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: the CPU path and the kernel's oracle."""
    idx = slots.long().clamp(0, rows.shape[0] - 1)
    out = (weights.float()[:, None] * rows[idx].float()).sum(0)
    return out.to(rows.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("fedavg.cu")
    lib.fedavg_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,    # rows, stride, n_rows
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,           # slots, weights, k
        ctypes.c_longlong, ctypes.c_void_p,                       # P, out
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,              # dtype, device, stream
    ]
    lib.fedavg_gather.restype = ctypes.c_int
    lib.fedavg_error_string.argtypes = [ctypes.c_int]
    lib.fedavg_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(rows, slots, weights) -> None:
    if rows.dim() != 2 or rows.stride(1) != 1:
        raise ValueError(f"rows must be 2-D with unit column stride, got {tuple(rows.shape)} "
                         f"strides {rows.stride()}")
    if rows.dtype not in _DTYPE_CODE:
        raise TypeError(f"rows dtype {rows.dtype} not supported (float32, bfloat16)")
    k = slots.shape[0] if slots.dim() == 1 else -1
    if not 1 <= k <= MAX_K or tuple(weights.shape) != (k,):
        raise ValueError(f"need slots and weights of shape (k,), 1 <= k <= {MAX_K}; got "
                         f"{tuple(slots.shape)} and {tuple(weights.shape)}")
    if slots.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError("slots must be int32 and weights float32")
    for name, t in (("slots", slots), ("weights", weights)):
        if t.device != rows.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {rows.device}")


def fedavg_gather(rows: torch.Tensor, slots: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """``(P,)`` weighted sum of ``rows[slots]``; slots out of range are clamped.

    rows ``(n, P)`` f32/bf16 (any row stride), slots ``(k,)`` int32, weights
    ``(k,)`` f32, all on one device.
    """
    if rows.device.type == "cpu":
        return fedavg_gather_plain(rows, slots, weights)
    if rows.device.type != "cuda":
        raise ValueError(f"fedavg_gather runs on cuda or cpu tensors, not {rows.device}")
    _check_cuda_args(rows, slots, weights)
    lib = _library()
    out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
    code = lib.fedavg_gather(
        rows.data_ptr(), rows.stride(0), rows.shape[0],
        slots.data_ptr(), weights.data_ptr(), slots.shape[0],
        rows.shape[1], out.data_ptr(),
        _DTYPE_CODE[rows.dtype], rows.device.index or 0,
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"fedavg_gather launch failed: "
                           f"{lib.fedavg_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES[NAME] += 1
    return out


def fedavg(weights: torch.Tensor, models: torch.Tensor) -> torch.Tensor:
    """Eq. (1) weighted model average. weights (k,), models (k, N) -> (N,)."""
    slots = torch.arange(models.shape[0], dtype=torch.int32, device=models.device)
    return fedavg_gather(models, slots, weights)
