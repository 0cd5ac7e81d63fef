"""Pairwise squared-L2 distances between k flattened models: kernel, plain
version, dispatcher.

Replaces the TPU kernel ``repro/kernels/model_distance.py::model_distance_pallas``
(``_dist_kernel``). For models ``x`` (k, N), ``d[i, j] = sq_i + sq_j -
2 x_i . x_j`` in f32, with ``sq_i = x_i . x_i``: a (k, k) f32 matrix, the
input of ``repro_torch.core.anomaly.parameter_outlier_scores`` (the §VI.A
model-space screen of the alpha candidate tips).

``model_distance`` launches the CUDA kernel (``repro_torch/csrc/model_distance.cu``:
a Gram matrix over column chunks, then a fixed-order sum of the chunks, so
the same inputs give the same bits) for CUDA tensors, raising if it cannot
build or launch, and takes ``model_distance_plain`` (the port of
``repro.kernels.ref.model_distance_ref``) only for CPU tensors. The diagonal
cancels to near 0 and the two sum in different orders, so they agree within
a tolerance stated against ``sq_i + sq_j + 2 |x_i . x_j|``, not bitwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

NAME = "model_distance"
MAX_K = 32              # four row tiles of 8 in the kernel


def model_distance_plain(models: torch.Tensor) -> torch.Tensor:
    """(k, k) f32: the kernel's function in PyTorch, its oracle and the CPU
    path; ``ref.model_distance_ref`` step for step."""
    x = models.float()
    sq = (x * x).sum(dim=1)
    return sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("model_distance.cu")
    lib.model_distance.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,          # x, row stride
        ctypes.c_int, ctypes.c_longlong,             # k, N
        ctypes.c_void_p, ctypes.c_void_p,            # out, workspace
        ctypes.c_int, ctypes.c_void_p,               # device, stream
    ]
    lib.model_distance.restype = ctypes.c_int
    lib.model_distance_workspace.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.model_distance_workspace.restype = ctypes.c_longlong
    lib.model_distance_error_string.argtypes = [ctypes.c_int]
    lib.model_distance_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(models: torch.Tensor) -> None:
    if models.dim() != 2 or models.stride(1) != 1:
        raise ValueError(f"models must be (k, N) with unit column stride, got "
                         f"{tuple(models.shape)} strides {models.stride()}")
    if models.dtype != torch.float32:
        raise TypeError(f"models must be float32, got {models.dtype}")
    k, n = models.shape
    if not 1 <= k <= MAX_K or n < 1:
        raise ValueError(f"need 1 <= k <= {MAX_K} models of N >= 1 values, got "
                         f"{tuple(models.shape)}")


def model_distance(models: torch.Tensor) -> torch.Tensor:
    """(k, k) f32 pairwise squared-L2 distances of the rows of ``models``
    (k, N): the kernel for CUDA tensors (f32, k <= 32), the plain version
    for CPU tensors."""
    if models.device.type == "cpu":
        return model_distance_plain(models)
    if models.device.type != "cuda":
        raise ValueError(f"model_distance runs on cuda or cpu tensors, not {models.device}")
    _check_cuda_args(models)
    k, n = models.shape
    lib = _library()
    out = torch.empty((k, k), dtype=torch.float32, device=models.device)
    work = torch.empty((lib.model_distance_workspace(k, n),), dtype=torch.float32,
                       device=models.device)
    code = lib.model_distance(
        models.data_ptr(), models.stride(0), k, n, out.data_ptr(), work.data_ptr(),
        models.device.index or 0, torch.cuda.current_stream(models.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"model_distance launch failed: "
                           f"{lib.model_distance_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES[NAME] += 1
    return out
