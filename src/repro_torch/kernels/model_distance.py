"""Pairwise squared-L2 distances between k flattened models, and the
model-space screen's scores: kernel, plain version, dispatchers.

Replaces the TPU kernel ``repro/kernels/model_distance.py::model_distance_pallas``
(``_dist_kernel``). For models ``x`` (k, N), ``d[i, j] = sq_i + sq_j -
2 x_i . x_j`` in f32, with ``sq_i = x_i . x_i``: a (k, k) f32 matrix, the
input of ``repro_torch.core.anomaly.parameter_outlier_scores`` (the §VI.A
model-space screen of the alpha candidate tips), whose scores are each row's
mean distance to the other candidates.

``model_distance`` and ``outlier_scores`` launch the CUDA kernel
(``repro_torch/csrc/model_distance.cu``: one persistent launch that reads the
candidates once, sums fixed column chunks into their own partials and lets
the last block to finish sum those in chunk order, so the same inputs give
the same bits; ``outlier_scores`` has it write the scores too) for CUDA
tensors, raising if it cannot build or launch, and take the plain versions
(``model_distance_plain``, the port of ``repro.kernels.ref.model_distance_ref``;
``outlier_scores_plain``) only for CPU tensors. The diagonal cancels to near
0 and the two sum in different orders, so they agree within a tolerance
stated against ``sq_i + sq_j + 2 |x_i . x_j|``, not bitwise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import cuda_build

NAME = "model_distance"
MAX_K = 32              # four row tiles of 8 in the kernel

# the kernel's ticket counter, one per (device, stream): 0 between calls,
# reset by the kernel itself
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def model_distance_plain(models: torch.Tensor) -> torch.Tensor:
    """(k, k) f32: the kernel's function in PyTorch, its oracle and the CPU
    path; ``ref.model_distance_ref`` step for step."""
    x = models.float()
    sq = (x * x).sum(dim=1)
    return sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)


def scores_plain(d: torch.Tensor) -> torch.Tensor:
    """(k,) mean of each row of ``d`` (k, k) off its diagonal:
    ``repro.core.anomaly.parameter_outlier_scores`` after its distances."""
    k = d.shape[0]
    off = torch.where(torch.eye(k, dtype=torch.bool, device=d.device), 0.0, d)
    total = off.sum(dim=1)
    # a tensor divisor: a Python scalar would be a reciprocal multiply
    return total / torch.full_like(total, max(k - 1, 1))


def outlier_scores_plain(models: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d, scores): the plain distances and their scores, the CPU path."""
    d = model_distance_plain(models)
    return d, scores_plain(d)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("model_distance.cu")
    lib.model_distance.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,          # x, row stride
        ctypes.c_int, ctypes.c_longlong,             # k, N
        ctypes.c_void_p, ctypes.c_void_p,            # out, scores (or null)
        ctypes.c_void_p, ctypes.c_void_p,            # workspace, ticket
        ctypes.c_int, ctypes.c_void_p,               # device, stream
    ]
    lib.model_distance.restype = ctypes.c_int
    lib.model_distance_workspace.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.model_distance_workspace.restype = ctypes.c_longlong
    lib.model_distance_info.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.model_distance_info.restype = ctypes.c_int
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


def _launch(models: torch.Tensor,
            with_scores: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the kernel: the (k, k) distances and, ``with_scores``,
    the (k,) scores."""
    if models.device.type != "cuda":
        raise ValueError(f"model_distance runs on cuda or cpu tensors, not {models.device}")
    _check_cuda_args(models)
    k, n = models.shape
    lib = _library()
    device = models.device.index
    if device is None:
        device = torch.cuda.current_device()
    stream = torch.cuda.current_stream(models.device).cuda_stream
    ticket = _TICKETS.get((device, stream))
    if ticket is None:
        ticket = _TICKETS[(device, stream)] = torch.zeros(1, dtype=torch.int32,
                                                          device=models.device)
    out = torch.empty((k, k), dtype=torch.float32, device=models.device)
    scores = torch.empty((k,), dtype=torch.float32, device=models.device) if with_scores else None
    work = torch.empty((lib.model_distance_workspace(k, n),), dtype=torch.float32,
                       device=models.device)
    code = lib.model_distance(
        models.data_ptr(), models.stride(0), k, n, out.data_ptr(),
        scores.data_ptr() if scores is not None else None, work.data_ptr(),
        ticket.data_ptr(), device, stream,
    )
    if code != 0:
        raise RuntimeError(f"model_distance launch failed: "
                           f"{lib.model_distance_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES[NAME] += 1
    return out, scores


def model_distance(models: torch.Tensor) -> torch.Tensor:
    """(k, k) f32 pairwise squared-L2 distances of the rows of ``models``
    (k, N): the kernel for CUDA tensors (f32, k <= 32), the plain version
    for CPU tensors."""
    if models.device.type == "cpu":
        return model_distance_plain(models)
    return _launch(models, False)[0]


def outlier_scores(models: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d, scores) of the rows of ``models`` (k, N): d as ``model_distance``
    gives it and (k,) scores, each row's mean distance to the others. For
    CUDA tensors (f32, k <= 32) one launch of the kernel writes both; for
    CPU tensors the plain versions."""
    if models.device.type == "cpu":
        return outlier_scores_plain(models)
    return _launch(models, True)


def plan_info(k: int, n: int, device: int = 0) -> dict:
    """The kernel's plan for (k, N) on a card: its chunks, columns a chunk and
    a stage, dynamic shared memory, grid and tile pairs."""
    info = (ctypes.c_longlong * 6)()
    code = _library().model_distance_info(k, n, device, info)
    if code != 0:
        raise RuntimeError(f"model_distance_info failed: "
                           f"{_library().model_distance_error_string(code).decode()} ({code})")
    keys = ("chunks", "stages", "stage_cols", "dynamic_smem", "grid", "tile_pairs")
    return dict(zip(keys, list(info)))
