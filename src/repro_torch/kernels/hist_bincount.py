"""The streaming histograms' weighted bincount: kernel, plain version, dispatchers.

Replaces the TPU kernel ``repro/kernels/hist_bincount.py::hist_bincount_pallas``
(``_bincount_kernel``). For i32 indices ``idx`` (m,) and i32 weights (m,),
``out[b]`` is the sum of the weights whose index is ``b``, for ``b`` in
``[0, num_bins)``; an index outside that range, negatives included, is
dropped (never clamped into a neighbouring bin). The sums are integers, so
the kernel equals the plain version bitwise whatever order it adds in.

One CUDA kernel (``repro_torch/csrc/hist_bincount.cu``) serves two entries:

``hist_bincount(idx, w, num_bins)``   the TPU kernel's contract: the
        kernel for CUDA tensors, raising if it cannot build or launch, and
        ``hist_bincount_plain`` (the port of
        ``repro.kernels.ref.hist_bincount_ref``) only for CPU tensors.
``record_binned(counts, values, weights, lo, ratio, bins)``   what
        ``repro_torch.obs.hist.record`` launches on a card: ``counts`` plus
        the weighted bincount of the f32 ``values`` binned as
        ``obs.hist.bin_index`` bins them, bit for bit, in one launch that
        reads bool or i32 weights as they are and writes a fresh output
        (``counts`` is not modified). CUDA tensors only: its plain version,
        the CPU path, is ``obs.hist.record_plain``.

Each launch adds one to ``cuda_build.LAUNCHES["hist_bincount"]``; an empty
batch launches nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

NAME = "hist_bincount"
MAX_BINS = 12288        # the kernel's shared-memory histogram, 48 KB
WEIGHT_DTYPES = (torch.bool, torch.int32)   # read by the kernel as they are


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
        ctypes.c_void_p, ctypes.c_int,           # x, values (1: f32 to bin; 0: i32 indices)
        ctypes.c_void_p, ctypes.c_int,           # weights, w_bool
        ctypes.c_longlong,                       # m
        ctypes.c_float, ctypes.c_float,          # lo, ratio
        ctypes.c_int,                            # num_bins
        ctypes.c_void_p, ctypes.c_void_p,        # counts (or null), out
        ctypes.c_int, ctypes.c_void_p,           # device, stream
    ]
    lib.hist_bincount.restype = ctypes.c_int
    lib.hist_bincount_cluster_blocks.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.hist_bincount_cluster_blocks.restype = ctypes.c_int
    lib.hist_bincount_error_string.argtypes = [ctypes.c_int]
    lib.hist_bincount_error_string.restype = ctypes.c_char_p
    return lib


def _check_vector(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dim() != 1 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (m,) vector on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")


def _check_bins(num_bins: int) -> None:
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"need 1 <= num_bins <= {MAX_BINS}, got {num_bins}")


def _launch(x, values: bool, weights, lo: float, ratio: float, num_bins: int, counts):
    """One launch of the kernel over ``x`` and ``weights``; a fresh output."""
    weights = weights if weights.dtype in WEIGHT_DTYPES else weights.to(torch.int32)
    _check_vector("weights", weights, x.device)
    if weights.shape != x.shape:
        raise ValueError(f"need (m,) samples and weights, got {tuple(x.shape)} and "
                         f"{tuple(weights.shape)}")
    out = torch.empty((num_bins,), dtype=torch.int32, device=x.device)
    lib = _library()
    code = lib.hist_bincount(
        x.data_ptr(), int(values), weights.data_ptr(), int(weights.dtype == torch.bool),
        x.shape[0], lo, ratio, num_bins, None if counts is None else counts.data_ptr(),
        out.data_ptr(), x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"hist_bincount launch failed: "
                           f"{lib.hist_bincount_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES[NAME] += 1
    return out


def cluster_blocks(m: int, device: int = 0) -> int:
    """The blocks of the cluster one launch over ``m`` samples runs on card
    ``device`` (1 to 16: 16 where the card places a cluster that large, else
    at most 8), or 0 where ``m`` takes the grid-stride route."""
    return _library().hist_bincount_cluster_blocks(m, device)


def hist_bincount(idx: torch.Tensor, weights: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(num_bins,) i32 weighted bincount (see the module docstring): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if idx.device.type == "cpu":
        return hist_bincount_plain(idx, weights, num_bins)
    if idx.device.type != "cuda":
        raise ValueError(f"hist_bincount runs on cuda or cpu tensors, not {idx.device}")
    _check_vector("idx", idx, idx.device)
    if idx.dtype != torch.int32:
        raise TypeError(f"need i32 idx, got {idx.dtype}")
    _check_bins(num_bins)
    if idx.shape[0] == 0:       # nothing to count: no launch
        return torch.zeros((num_bins,), dtype=torch.int32, device=idx.device)
    return _launch(idx, False, weights, 0.0, 0.0, num_bins, None)


def record_binned(counts: torch.Tensor, values: torch.Tensor, weights: torch.Tensor,
                  lo: float, ratio: float, bins: int) -> torch.Tensor:
    """(bins + 1,) i32: ``counts`` + the weighted bincount of the f32
    ``values`` (m,) binned by ``obs.hist.bin_index``'s rule with its f32
    ``lo`` and ``ratio``, in one launch. Weights (m,) bool or i32 are read
    as they are (another integer type is cast to i32 first). CUDA tensors
    only."""
    if values.device.type != "cuda":
        raise ValueError(f"record_binned launches on cuda tensors, not {values.device}")
    _check_vector("values", values, values.device)
    if values.dtype != torch.float32:
        raise TypeError(f"need f32 values, got {values.dtype}")
    _check_bins(bins + 1)
    if (tuple(counts.shape) != (bins + 1,) or counts.dtype != torch.int32
            or counts.device != values.device or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous ({bins + 1},) i32 vector on "
                         f"{values.device}")
    if not lo > 0.0:
        raise ValueError(f"need lo > 0, got {lo}")
    if values.shape[0] == 0:    # nothing to count: no launch
        return counts.clone()
    return _launch(values, True, weights, lo, ratio, bins + 1, counts)
