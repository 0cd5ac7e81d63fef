"""Content-addressed chunk dedup (kernel, plain version, dispatcher) and
bandwidth-limited transfer selection.

The bank-gossip hot spot (``repro_torch.net.bank``): every sync tick each
node decides which model chunks it still needs and which of those its
active neighbours can supply within the tick's per-link byte budget.

``chunk_dedup``        sat[i, s, c] = node i effectively has chunk (s, c):
                       it physically holds it, or holds some chunk (p, c)
                       whose content digest equals ``digest[s, c]`` (float
                       ``==``: a NaN digest matches nothing, not even
                       itself; -0.0 matches +0.0). Chunking is ALIGNED:
                       only chunks at the same offset c are compared.
                       Replaces the TPU kernel
                       ``repro/kernels/chunk_transfer.py::chunk_dedup_pallas``
                       (``_dedup_kernel``): the CUDA kernel
                       ``repro_torch/csrc/chunk_dedup.cu`` for CUDA tensors
                       (raising if it cannot build or launch), and
                       ``chunk_dedup_plain`` (the port of
                       ``repro.kernels.ref.chunk_dedup_ref``) only for CPU
                       tensors.

``transfer_select``    per receiver, stripe the still-needed chunks across
                       the active neighbours that have the content, then
                       admit chunks per link in canonical (slot, chunk)
                       order until the link's whole-chunk budget runs out.
                       Plain PyTorch, deterministic (no draws).

``transfer_verify``    the digest check on receive (plain PyTorch).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

NAME = "chunk_dedup"
MAX_COLUMNS = 2**31 - 1        # gridDim.x
MAX_RECEIVERS = 65535 * 32     # gridDim.y blocks of at most 32 receivers


def chunk_dedup_plain(
    have: torch.Tensor,     # (R, S, C) bool — physical chunk presence per node
    digest: torch.Tensor,   # (S, C) f32 — content digest of every store chunk
) -> torch.Tensor:
    """(R, S, C) bool effective availability: the kernel's function in
    PyTorch, its oracle and the CPU path.

    As ``ref.chunk_dedup_ref``: ``eq[p, s, c] = digest[p, c] == digest[s, c]``
    and ``sat = have | (Σ_p have[i, p, c] · eq[p, s, c] > 0)``. The sum is
    a float32 batched product (CUDA has no integer one); its terms are 0 or
    1 and it stays below 2**24, so ``> 0`` is exact.
    """
    have = have.bool()
    eq = digest[:, None, :] == digest[None, :, :]              # (S, S, C)
    hits = torch.einsum("ipc,psc->isc", have.float(), eq.float())
    return have | (hits > 0)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("chunk_dedup.cu")
    lib.chunk_dedup.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                    # have, digest
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,   # R, S, C
        ctypes.c_void_p,                                     # sat out
        ctypes.c_int, ctypes.c_void_p,                       # device, stream
    ]
    lib.chunk_dedup.restype = ctypes.c_int
    lib.chunk_dedup_error_string.argtypes = [ctypes.c_int]
    lib.chunk_dedup_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(have: torch.Tensor, digest: torch.Tensor) -> None:
    if have.dim() != 3 or digest.dim() != 2 or tuple(digest.shape) != tuple(have.shape[1:]):
        raise ValueError(f"need have (R, S, C) and digest (S, C), got {tuple(have.shape)} "
                         f"and {tuple(digest.shape)}")
    if have.dtype not in (torch.bool, torch.uint8) or digest.dtype != torch.float32:
        raise TypeError(f"have must be bool or uint8 and digest float32, got {have.dtype} "
                        f"and {digest.dtype}")
    for name, t in (("have", have), ("digest", digest)):
        if t.device != have.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {have.device}")
    r, _, c = have.shape
    if c > MAX_COLUMNS or r > MAX_RECEIVERS:
        raise ValueError(f"at most {MAX_COLUMNS} chunks per slot and {MAX_RECEIVERS} "
                         f"receivers per launch, got {c} and {r}")


def chunk_dedup(have: torch.Tensor, digest: torch.Tensor) -> torch.Tensor:
    """(R, S, C) bool content-addressed availability (see the module docstring).

    CUDA tensors launch the kernel, CPU tensors take ``chunk_dedup_plain``.
    """
    if have.device.type == "cpu":
        return chunk_dedup_plain(have, digest)
    if have.device.type != "cuda":
        raise ValueError(f"chunk_dedup runs on cuda or cpu tensors, not {have.device}")
    _check_cuda_args(have, digest)
    sat = torch.empty(have.shape, dtype=torch.bool, device=have.device)
    if sat.numel() == 0:
        return sat
    lib = _library()
    code = lib.chunk_dedup(
        have.data_ptr(), digest.data_ptr(), *have.shape, sat.data_ptr(),
        have.device.index or 0, torch.cuda.current_stream(have.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"chunk_dedup launch failed: "
                           f"{lib.chunk_dedup_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES[NAME] += 1
    return sat


def transfer_select(
    need: torch.Tensor,         # (Rb, M) bool — receiver block's wanted chunks
    src_have: torch.Tensor,     # (R, M) bool — sender effective availability
    edge_active: torch.Tensor,  # (Rb, R) bool — receiver i hears sender j
    afford: torch.Tensor,       # (Rb, R) i32 — whole chunks per link this tick
    return_links: bool = False,
):
    """One tick of bandwidth-limited chunk transfers (no draws).

    Chunk ``m`` is assigned to the ``(m mod holders)``-th lowest-indexed
    active sender whose availability covers it, so links to distinct
    holders drain distinct chunks; each link then admits its assigned
    chunks in ascending flat (slot, chunk) order until ``afford`` whole
    chunks are spent. The reference's integer arithmetic: counts and ranks
    are int32 (a cumsum of bool would otherwise be int64).

    Returns ``(take (Rb, M) bool, spent (Rb, R) i32 chunks moved per link,
    pending (Rb, R) bool — the link had assigned work left over)``; with
    ``return_links=True`` ``(take, take_link (Rb, R, M) bool, spent,
    pending)``.
    """
    m = need.shape[1]
    can = edge_active[:, :, None] & need[:, None, :] & src_have[None, :, :]
    holder_rank = torch.cumsum(can, dim=1, dtype=torch.int32) - 1      # (Rb, R, M)
    holders = can.sum(dim=1, dtype=torch.int32)                         # (Rb, M)
    chunk_idx = torch.arange(m, dtype=torch.int32, device=need.device)[None, :]
    pick = torch.where(holders > 0, torch.remainder(chunk_idx, holders.clamp(min=1)), -1)
    assigned = can & (holder_rank == pick[:, None, :])
    rank = torch.cumsum(assigned, dim=2, dtype=torch.int32) - 1
    take_link = assigned & (rank < afford[:, :, None])
    take = take_link.any(dim=1)
    spent = take_link.sum(dim=2, dtype=torch.int32)
    pending = (assigned & ~take_link).any(dim=2)
    if return_links:
        return take, take_link, spent, pending
    return take, spent, pending


def transfer_verify(
    take_link: torch.Tensor,    # (Rb, R, M) bool — admitted transfers per link
    bad_link: torch.Tensor,     # (Rb, R, M) bool — payload corrupted in flight
):
    """Digest check on receive: a chunk whose payload does not hash to the
    announced digest is dropped and charged to its link.

    Returns ``(ok_take (Rb, M) bool, rejects (Rb, R) i32)``; with
    ``bad_link`` all False this is ``(take_link.any(1), zeros)``.
    """
    rej = take_link & bad_link
    ok_take = (take_link & ~bad_link).any(dim=1)
    return ok_take, rej.sum(dim=2, dtype=torch.int32)
