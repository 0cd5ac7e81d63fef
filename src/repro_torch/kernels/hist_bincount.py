"""The streaming histograms' weighted bincount: kernel, plain version, dispatcher.

Replaces the TPU kernel ``repro/kernels/hist_bincount.py::hist_bincount_pallas``
(``_bincount_kernel``). For i32 indices ``idx`` (m,) and i32 weights (m,),
``out[b]`` is the sum of the weights whose index is ``b``, for ``b`` in
``[0, num_bins)``; an index outside that range, negatives included, is
dropped (never clamped into a neighbouring bin). The sums are integers, so
the kernel equals the plain version bitwise whatever order it adds in.

``hist_bincount`` is what ``repro_torch.obs.hist.record`` calls: it launches
the CUDA kernel (``repro_torch/csrc/hist_bincount.cu``) for CUDA tensors,
raising if it cannot build or launch, and takes ``hist_bincount_plain`` (the
port of ``repro.kernels.ref.hist_bincount_ref``) only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

NAME = "hist_bincount"
MAX_BINS = 12288        # the kernel's shared-memory histogram, 48 KB


def hist_bincount_plain(idx: torch.Tensor, weights: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(num_bins,) i32: the kernel's function in PyTorch, its oracle and the
    CPU path; ``ref.hist_bincount_ref`` step for step (out-of-range indices
    go to one extra bin that is cut off)."""
    idx = idx.to(torch.int32)
    keep = (idx >= 0) & (idx < num_bins)
    at = torch.where(keep, idx, num_bins).long()
    out = torch.zeros((num_bins + 1,), dtype=torch.int32, device=idx.device)
    return out.index_add_(0, at, weights.to(torch.int32))[:num_bins]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("hist_bincount.cu")
    lib.hist_bincount.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,        # idx, weights
        ctypes.c_longlong, ctypes.c_int,         # m, num_bins
        ctypes.c_void_p,                         # out
        ctypes.c_int, ctypes.c_void_p,           # device, stream
    ]
    lib.hist_bincount.restype = ctypes.c_int
    lib.hist_bincount_error_string.argtypes = [ctypes.c_int]
    lib.hist_bincount_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(idx, weights, num_bins: int) -> None:
    if idx.dim() != 1 or weights.shape != idx.shape:
        raise ValueError(f"need two (m,) vectors, got {tuple(idx.shape)} and "
                         f"{tuple(weights.shape)}")
    if idx.dtype != torch.int32 or weights.dtype != torch.int32:
        raise TypeError(f"need i32 idx and weights, got {idx.dtype} and {weights.dtype}")
    if weights.device != idx.device or not idx.is_contiguous() or not weights.is_contiguous():
        raise ValueError(f"idx and weights must be contiguous on {idx.device}")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"need 1 <= num_bins <= {MAX_BINS}, got {num_bins}")


def hist_bincount(idx: torch.Tensor, weights: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(num_bins,) i32 weighted bincount (see the module docstring): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if idx.device.type == "cpu":
        return hist_bincount_plain(idx, weights, num_bins)
    if idx.device.type != "cuda":
        raise ValueError(f"hist_bincount runs on cuda or cpu tensors, not {idx.device}")
    _check_cuda_args(idx, weights, num_bins)
    out = torch.zeros((num_bins,), dtype=torch.int32, device=idx.device)
    if idx.shape[0] == 0:       # nothing to count: no launch
        return out
    lib = _library()
    code = lib.hist_bincount(
        idx.data_ptr(), weights.data_ptr(), idx.shape[0], num_bins, out.data_ptr(),
        idx.device.index or 0, torch.cuda.current_stream(idx.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"hist_bincount launch failed: "
                           f"{lib.hist_bincount_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES[NAME] += 1
    return out
