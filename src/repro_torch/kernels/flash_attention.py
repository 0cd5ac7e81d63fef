"""Causal GQA prefill attention and one-token GQA decode attention: kernels,
plain versions, dispatchers.

Replace the TPU kernels ``repro/kernels/flash_attention.py::flash_attention_pallas``
(``_flash_kernel``) and ``decode_attention_pallas`` (``_decode_kernel``).
Both compute what the Pallas kernels compute: scores ``q . k`` in f32 scaled
by ``1/sqrt(hd)``, masked entries at -1e30, probabilities in f32, output in
q's dtype; head ``h`` reads KV head ``h // (H / KV)``.

- ``flash_attention(q, k, v, window)``: q ``(B, H, S, hd)``, k and v
  ``(B, KV, S, hd)``; causal, and with ``window > 0`` key ``j`` is seen by
  query ``i`` only when ``i - window < j <= i``. Returns ``(B, H, S, hd)``.
- ``decode_attention(q, k, v, lengths)``: q ``(B, H, hd)``, k and v the
  cache ``(B, S, KV, hd)``, lengths ``(B,)`` int32; row ``b`` attends to
  slots ``[0, lengths[b])``. Returns ``(B, H, hd)``.
- ``flash_attention_train(q, k, v, window)``: ``flash_attention`` with a
  gradient, a ``torch.autograd.Function`` whose backward is
  ``flash_attention_bwd(q, k, v, dout, window)`` -> ``(dq, dk, dv)`` in q's
  dtype (dk and dv summed over the G query heads of their KV head). The
  reference has no Pallas backward: its training path differentiates
  ``models/attention.py::chunked_sdpa`` by XLA autodiff.

For CUDA tensors the dispatchers launch ``repro_torch/csrc/flash_attention.cu``
(f32 or bf16, ``hd`` in {64, 128, 256}, any ``H / KV``, any ``S``; anything
else raises ``ValueError``; a failed build or launch raises): bf16 on the
tensor cores (``wgmma`` for prefill, ``mma.sync`` for decode, TMA staging),
f32 on the CUDA cores. They read the
strides of q, k and v, so the model passes its ``(B, S, H, hd)`` tensors
permuted, without a copy, as long as ``hd`` is the unit-stride axis and the
tensors are 16-byte aligned; otherwise the wrapper copies them contiguous
first. The prefill output is laid out ``(B, S, H, hd)`` in memory and
returned as its ``(B, H, S, hd)`` view, so the model's transpose back is
free. For CPU tensors the dispatchers take the plain versions:

- ``flash_attention_plain`` ports ``ref.mqa_attention_ref`` (scores in q's
  dtype, then f32; a softmax in f32; probabilities cast to q's dtype) in
  blocks of ``CHUNK_Q`` query rows, so that a 32k-token call fits in memory:
  that is the reference model's ``models/attention.py::chunked_sdpa``;
- ``decode_attention_plain`` ports ``ref.decode_attention_ref``. A row of
  length 0 gives the mean of v over all S slots (the reference's softmax of
  a row that is all -1e30); the kernel does the same, where the Pallas
  kernel returns 0.

The backward launches ``repro_torch/csrc/flash_attention_bwd.cu`` (its own
library, so the serving kernels' build is untouched; the same dtypes and
head dims, anything else raises): it recomputes the rows' log-sum-exp and
``D = rowsum(dO * O)`` in f32 itself, so the forward saves nothing and the
serving route is unchanged. Its plain version ``flash_attention_bwd_plain``
is autograd through ``flash_attention_plain``, the CPU path and the
kernel's oracle; ``flash_attention_bwd_scale`` gives each gradient entry's
sum of absolute terms, the scale its bar is stated in.

The kernels keep scores and probabilities in f32 (the bf16 route multiplies
by p split into two bf16 parts, p_hi + p_lo, which keep p to 2^-17) and
round only the output, so in bf16 they are held against the plain version
run in f32 on the same bf16 inputs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

NEG_INF = -1e30
CHUNK_Q = 1024          # query rows per block of the plain prefill
HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _root_hd(hd: int, device) -> torch.Tensor:
    """sqrt(f32(hd)) as a device tensor: the reference divides by it, and a
    division by a Python scalar on the card is a reciprocal multiply."""
    return torch.full((), float(hd), dtype=torch.float32, device=device).sqrt()


def flash_attention_block_plain(q, k, v, q_lo: int, window: int = 0) -> torch.Tensor:
    """Query rows ``[q_lo, q_lo + bq)`` of q ``(B, H, bq, hd)`` against the
    keys ``[k_lo, q_lo + bq)`` of k and v ``(B, KV, S, hd)`` that any of them
    may see (the rest of a row is exactly 0 after the softmax)."""
    B, H, bq, hd = q.shape
    k_lo = max(0, q_lo - window + 1) if window else 0
    probs = _block_probs(q, k, q_lo, window).to(q.dtype)
    out = probs @ v[:, :, k_lo:q_lo + bq]
    return out.view(B, H, bq, hd)


def _block_probs(qb, k, q_lo: int, window: int) -> torch.Tensor:
    """f32 probabilities of query rows ``[q_lo, q_lo + bq)`` of qb ``(B, H,
    bq, hd)`` over the keys ``[k_lo, q_lo + bq)`` they may see, ``(B, KV, G *
    bq, n)``: scores in qb's dtype, then f32, scaled, masked, softmax."""
    B, H, bq, hd = qb.shape
    KV = k.shape[1]
    G = H // KV
    k_hi = q_lo + bq
    k_lo = max(0, q_lo - window + 1) if window else 0
    scores = (qb.reshape(B, KV, G * bq, hd) @ k[:, :, k_lo:k_hi].transpose(-1, -2)).float()
    scores = (scores / _root_hd(hd, qb.device)).view(B, KV, G, bq, k_hi - k_lo)
    i = torch.arange(q_lo, k_hi, device=qb.device)[:, None]
    j = torch.arange(k_lo, k_hi, device=qb.device)[None, :]
    ok = j <= i
    if window:
        ok = ok & (j > i - window)
    probs = torch.softmax(torch.where(ok, scores, NEG_INF), dim=-1)
    return probs.view(B, KV, G * bq, k_hi - k_lo)


def flash_attention_plain(q, k, v, window: int = 0, block_q: int = CHUNK_Q) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention in PyTorch, ``block_q``
    query rows at a time: the kernel's oracle and the CPU path."""
    B, H, S, hd = q.shape
    out = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    for q_lo in range(0, S, block_q):
        q_hi = min(S, q_lo + block_q)
        out[:, :, q_lo:q_hi] = flash_attention_block_plain(q[:, :, q_lo:q_hi], k, v, q_lo,
                                                           window)
    return out


def decode_attention_plain(q, k, v, lengths) -> torch.Tensor:
    """One query per row against an S-slot cache, the first ``lengths[b]``
    slots valid: ``ref.decode_attention_ref`` in PyTorch."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k).float() / _root_hd(hd, q.device)
    valid = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskd->bkgd", probs, v).reshape(B, H, hd)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("flash_attention.cu")
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.flash_attention.argtypes = [
        p, p, p, p,                  # q, k, v, out
        i, i, i, i, i, i, i,         # dtype, B, H, KV, S, hd, window
        ll, ll, ll,                  # q strides (b, h, s)
        ll, ll, ll,                  # k strides (b, kv, s)
        ll, ll, ll,                  # v strides (b, kv, s)
        ll, ll, ll,                  # out strides (b, h, s)
        i, p,                        # device, stream
    ]
    lib.flash_attention.restype = i
    lib.decode_attention.argtypes = [
        p, p, p, p, p, p,            # q, k, v, lengths, out, workspace
        i, i, i, i, i, i,            # dtype, B, H, KV, S, hd
        ll, ll,                      # q strides (b, h)
        ll, ll, ll,                  # k strides (b, s, kv)
        ll, ll, ll,                  # v strides (b, s, kv)
        ll, ll,                      # out strides (b, h)
        i, p,                        # device, stream
    ]
    lib.decode_attention.restype = i
    lib.decode_attention_workspace.argtypes = [i, i, i, i, i]
    lib.decode_attention_workspace.restype = ll
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, q, k, v, q_dims, kv_dims):
    if q.dim() != q_dims or k.dim() != kv_dims or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not the kernel's layouts")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS or k.shape[-1] != hd:
        raise ValueError(f"{name}: head dim must be one of {HEAD_DIMS} on both sides, got "
                         f"{hd} and {k.shape[-1]}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k and v lie on {q.device}, {k.device}, {v.device}")


def _raise_on(lib, name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.flash_attention_error_string(code).decode()} ({code})")


def flash_attention(q, k, v, window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention, q ``(B, H, S, hd)``,
    k and v ``(B, KV, S, hd)``: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    _check("flash_attention", q, k, v, 4, 4)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if k.shape[:3] != (B, KV, S) or KV < 1 or H % KV or S < 1 or window < 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} are not "
                         f"(B, H, S, hd) and (B, KV, S, hd) with H a multiple of KV, or the "
                         f"window {window} is negative")
    q, k, v = map(cuda_build.aligned_rows, (q, k, v))
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _library()
    code = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, H, KV, S, hd, int(window),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, "flash_attention", code)
    cuda_build.LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q, k, v, lengths) -> torch.Tensor:
    """One-token GQA attention, q ``(B, H, hd)`` against the cache k, v
    ``(B, S, KV, hd)`` with ``lengths`` ``(B,)`` int32 valid slots a row
    (``0 <= lengths <= S``, the caller's contract, not checked on the card:
    that would be a sync): the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, not {q.device}")
    _check("decode_attention", q, k, v, 3, 4)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or KV < 1 or H % KV or S < 1:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k {tuple(k.shape)} are not "
                         f"(B, H, hd) and (B, S, KV, hd) with H a multiple of KV")
    if (lengths.shape != (B,) or lengths.dtype != torch.int32
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError(f"decode_attention: lengths must be a contiguous ({B},) int32 tensor "
                         f"on {q.device}, got {tuple(lengths.shape)} {lengths.dtype} on "
                         f"{lengths.device}")
    q, k, v = map(cuda_build.aligned_rows, (q, k, v))
    lib = _library()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    work = torch.empty((lib.decode_attention_workspace(B, H, KV, S, hd),),
                       dtype=torch.float32, device=q.device)
    code = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        work.data_ptr(), DTYPES[q.dtype], B, H, KV, S, hd,
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, "decode_attention", code)
    cuda_build.LAUNCHES["decode_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# the backward: plain version, scale, kernel, autograd Function
# ---------------------------------------------------------------------------


def flash_attention_bwd_plain(q, k, v, dout, window: int = 0):
    """(dq, dk, dv) of ``flash_attention_plain`` at ``dout``, by autograd
    through it, in q's dtype: the CPU path and the kernel's oracle (run it
    on f32 copies to hold a bf16 kernel)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*leaves, window)
        return torch.autograd.grad(out, leaves, dout)


def flash_attention_bwd_scale(q, k, v, dout, window: int = 0, block_q: int = CHUNK_Q):
    """Each gradient entry's sum of absolute terms, f32 ``(dq, dk, dv)``:
    the backward's formulas on |q|, |k|, |v|, |dout| with every difference
    made a sum, ``|ds_ij| <= p_ij (a_ij + sum_j p_ij a_ij)`` for ``a_ij =
    |do_i| . |v_j|``, the probabilities p the f32 forward's. Kernel and
    plain version are held within a share of it, since a gradient entry
    may cancel to near 0."""
    q, k, v, dout = (t.detach().float() for t in (q, k, v, dout))
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    root = _root_hd(hd, q.device)
    aq, ak, av, ado = q.abs(), k.abs(), v.abs(), dout.abs()
    mq, mk, mv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for q_lo in range(0, S, block_q):
        q_hi = min(S, q_lo + block_q)
        bq = q_hi - q_lo
        k_lo = max(0, q_lo - window + 1) if window else 0
        n = q_hi - k_lo
        p = _block_probs(q[:, :, q_lo:q_hi], k, q_lo, window)        # (B, KV, G * bq, n)
        a = ado[:, :, q_lo:q_hi].reshape(B, KV, G * bq, hd) @ av[:, :, k_lo:q_hi].transpose(-1, -2)
        m = p * (a + (p * a).sum(-1, keepdim=True))
        mq[:, :, q_lo:q_hi] = (m @ ak[:, :, k_lo:q_hi]).view(B, H, bq, hd) / root
        mk[:, :, k_lo:q_hi] += (m.transpose(-1, -2)
                                @ aq[:, :, q_lo:q_hi].reshape(B, KV, G * bq, hd)) / root
        mv[:, :, k_lo:q_hi] += p.transpose(-1, -2) @ ado[:, :, q_lo:q_hi].reshape(
            B, KV, G * bq, hd)
    return mq, mk, mv


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = cuda_build.load_library("flash_attention_bwd.cu")
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.flash_attention_bwd.argtypes = [
        p, p, p, p,                  # q, k, v, dout
        p, p, p, p,                  # dq, dk, dv, stats workspace
        i, i, i, i, i, i, i,         # dtype, B, H, KV, S, hd, window
        *[ll] * 21,                  # (b, head, s) strides of q, k, v, dout, dq, dk, dv
        i, p,                        # device, stream
    ]
    lib.flash_attention_bwd.restype = i
    lib.flash_attention_bwd_error_string.argtypes = [i]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_attention_bwd_smem_bytes.argtypes = [i, i]
    lib.flash_attention_bwd_smem_bytes.restype = i
    return lib


def flash_attention_bwd_smem(hd: int) -> dict:
    """Dynamic shared memory (bytes) that the backward's two kernels ask
    for at head dim ``hd``, as the CUDA source computes it: {"dq", "dkdv"}."""
    lib = _bwd_library()
    out = {name: lib.flash_attention_bwd_smem_bytes(hd, kernel)
           for kernel, name in enumerate(("dq", "dkdv"))}
    if min(out.values()) < 0:
        raise ValueError(f"flash_attention_bwd_smem: no backward kernel for hd {hd}")
    return out


def flash_attention_bwd(q, k, v, dout, window: int = 0):
    """``(dq, dk, dv)`` of ``flash_attention(q, k, v, window)`` at ``dout``
    (q's shape and dtype), in q's dtype: the kernel for CUDA tensors, the
    plain version for CPU tensors. dq is laid out ``(B, S, H, hd)`` and dk,
    dv ``(B, S, KV, hd)`` in memory, returned as their ``(B, H, S, hd)`` and
    ``(B, KV, S, hd)`` views, the layout the model's transposes give back."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, not {q.device}")
    _check("flash_attention_bwd", q, k, v, 4, 4)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if k.shape[:3] != (B, KV, S) or KV < 1 or H % KV or S < 1 or window < 0:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} and k {tuple(k.shape)} are "
                         f"not (B, H, S, hd) and (B, KV, S, hd) with H a multiple of KV, or "
                         f"the window {window} is negative")
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"flash_attention_bwd: dout {tuple(dout.shape)} {dout.dtype} on "
                         f"{dout.device} is not q's shape, dtype and device")
    q, k, v, dout = map(cuda_build.aligned_rows, (q, k, v, dout))
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, S, KV, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    stats = torch.empty((B, H, S, 2), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    code = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        DTYPES[q.dtype], B, H, KV, S, hd, int(window),
        *[s for t in (q, k, v, dout, dq, dk, dv) for s in t.stride()[:3]],
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: "
                           f"{lib.flash_attention_bwd_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttentionTrain(torch.autograd.Function):
    """``flash_attention`` forward, ``flash_attention_bwd`` backward; saves
    q, k and v (the views it was given), nothing of the forward."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return flash_attention(q, k, v, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout.to(q.dtype), ctx.window)
        return dq, dk, dv, None


def flash_attention_train(q, k, v, window: int = 0) -> torch.Tensor:
    """``flash_attention(q, k, v, window)`` that autograd can differentiate:
    the same output, bit for bit, and a backward through
    ``flash_attention_bwd``."""
    return _FlashAttentionTrain.apply(q, k, v, window)
