"""Chunk-parallel RWKV6 WKV with data-dependent decay: kernel, plain
versions, dispatcher.

Replaces the TPU kernel ``repro/kernels/wkv.py::wkv_pallas`` (``_wkv_kernel``).
Per head, with the (hd_k, hd_v) state S in f32:

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,

``w_t = exp(logw_t)``, ``logw <= 0``. Chunked by ``CHUNK`` = 32 steps: inside a
chunk the pairwise decays ``exp(cum_prev[t] - cum[s])`` (s < t) all have
exponents <= 0, and one state is carried from chunk to chunk.

- ``wkv_scan_plain`` ports ``repro/models/rwkv.py::wkv_scan``, the sequential
  oracle (and the model's path for decode and for lengths that are not a
  multiple of the chunk).
- ``wkv_chunked_plain`` ports ``wkv_chunked`` operation for operation; its
  cumulative sums run sequentially in t in f32, as the kernel's do
  (``torch.cumsum`` on the CPU accumulates in f64, and XLA's reduce-window
  cumsum in another order: with strong decays the chunked form's
  ``cum_prev[t] - cum[s]`` cancels, so the order shows).
- ``wkv(r, k, v, logw, u, state)`` returns ``(y f32 (B, T, H, hd), state f32
  (B, H, hd, hd))``. For CUDA tensors it launches
  ``repro_torch/csrc/wkv.cu`` (r, k, v and u float32 or bfloat16, logw and
  state float32, ``hd`` in {64, 128}, ``T`` a positive multiple of 32;
  anything else raises ``ValueError``, a failed build or launch
  ``RuntimeError``). For CPU tensors it takes ``wkv_chunked_plain``.

The kernel differs from the Pallas kernel in two ways: it starts from the
given state and returns the final one, so that prefill feeds decode, and it
writes ``y`` in f32, as ``wkv_chunked`` returns it to ``time_mix``. It reads
the model's (B, T, H, hd) tensors through their strides (``hd`` unit
stride), with no transposed copy.

Bound (rwkv6-7b: B 1, T 8,192, H 64, hd 64, bf16 r, k, v): 470 MB of
inputs and output, 0.14 ms at 3.35 TB/s; 11.4 GFLOP of f32, 0.17 ms at 67
TFLOP/s; 0.59 G exponentials, 0.14 ms on the special-function units. So
0.17 ms, bound by operations. Design: one block per (b, h, 32 value columns) walks the chunks in order
with the (hd, 32) slice of S in shared memory (the value axis is
independent, so hd 64 gives two blocks a head); the next chunk's inputs
load by ``cp.async`` while this one computes; the cumulative sums run
sequentially in t, in f32; every thread forms pairs (t, s) of the chunk's
(C, C) scores on the CUDA cores. No atomics: the same inputs give the same
bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

NAME = "wkv"
CHUNK = 32
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def wkv_scan_plain(r, k, v, logw, u, state):
    """Sequential WKV: r, k, v, logw (B, T, H, hd), u (H, hd), state (B, H,
    hd, hd). Returns (y f32 (B, T, H, hd), new state f32); ``state`` is not
    written."""
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    uf = u.float()[None, :, :, None]
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]            # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over axis 1, sequential in f32."""
    out = torch.empty_like(x)
    acc = out[:, 0] = x[:, 0]
    for t in range(1, x.shape[1]):
        acc = out[:, t] = acc + x[:, t]
    return out


def wkv_chunked_plain(r, k, v, logw, u, state, chunk: int = CHUNK):
    """Chunk-parallel WKV, ``wkv_chunked`` step for step: the kernel's
    oracle and the CPU path. Returns (y f32 (B, T, H, hd), new state f32)."""
    B, T, H, hd = r.shape
    if T % chunk:
        raise ValueError(f"wkv: T = {T} is not a multiple of the chunk {chunk}")
    C, nc = chunk, T // chunk

    def resh(x):
        return x.reshape(B, nc, C, H, hd).float()

    rc, kc, vc, lwc = map(resh, (r, k, v, logw))
    uf = u.float()
    S = state.float()
    ar = torch.arange(C, device=r.device)
    mask = (ar[:, None] > ar[None, :])[None, :, :, None, None]
    y_out = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    for c in range(nc):
        rb, kb, vb, lw = rc[:, c], kc[:, c], vc[:, c], lwc[:, c]    # (B, C, H, hd)
        cum = cumsum_f32(lw)                                        # inclusive
        cum_prev = cum - lw                                         # exclusive
        expo = cum_prev[:, :, None] - cum[:, None, :, :, :]         # (B, C, C, H, hd)
        W = torch.where(mask, torch.exp(expo), 0.0)
        scores = torch.einsum("bthd,bshd,btshd->bths", rb, kb, W)
        bonus = torch.einsum("bthd,bthd,hd->bth", rb, kb, uf)
        y = torch.einsum("bths,bshd->bthd", scores, vb)
        y = y + bonus[..., None] * vb
        rdec = rb * torch.exp(cum_prev)
        y = y + torch.einsum("bthk,bhkv->bthv", rdec, S)
        total = cum[:, -1]                                          # (B, H, hd)
        kdec = kb * torch.exp(total[:, None] - cum)
        S = torch.exp(total)[..., None] * S + torch.einsum("bshk,bshv->bhkv", kdec, vb)
        y_out[:, c * C:(c + 1) * C] = y
    return y_out, S


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("wkv.cu")
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.wkv_forward.argtypes = [
        p, p, p, p, p, p,            # r, k, v, logw, u, state in
        p, p,                        # y, state out
        i, i, i, i, i,               # dtype, B, T, H, hd
        ll, ll, ll,                  # r strides (b, t, h)
        ll, ll, ll,                  # k strides
        ll, ll, ll,                  # v strides
        ll, ll, ll,                  # logw strides
        i, p,                        # device, stream
    ]
    lib.wkv_forward.restype = i
    lib.wkv_error_string.argtypes = [i]
    lib.wkv_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, logw, u, state) -> None:
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, logw)):
        raise ValueError(f"wkv: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"logw {tuple(logw.shape)} must share one (B, T, H, hd) shape")
    B, T, H, hd = r.shape
    if u.shape != (H, hd) or state.shape != (B, H, hd, hd):
        raise ValueError(f"wkv: u {tuple(u.shape)} and state {tuple(state.shape)} are not "
                         f"({H}, {hd}) and ({B}, {H}, {hd}, {hd})")
    if r.dtype not in DTYPES or any(x.dtype != r.dtype for x in (k, v, u)):
        raise ValueError(f"wkv: r, k, v and u must all be float32 or bfloat16, got {r.dtype}, "
                         f"{k.dtype}, {v.dtype}, {u.dtype}")
    if logw.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"wkv: logw and state must be float32, got {logw.dtype}, "
                         f"{state.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv: head dim must be one of {HEAD_DIMS}, got {hd}")
    if T < 1 or T % CHUNK:
        raise ValueError(f"wkv: T = {T} is not a positive multiple of the chunk {CHUNK}")
    if any(x.device != r.device for x in (k, v, logw, u, state)):
        raise ValueError("wkv: all arguments must lie on one device")


def wkv(r, k, v, logw, u, state):
    """Chunked WKV from ``state``: (y f32 (B, T, H, hd), final state f32 (B,
    H, hd, hd)). The kernel for CUDA tensors, ``wkv_chunked_plain`` for CPU
    tensors."""
    if r.device.type == "cpu":
        return wkv_chunked_plain(r, k, v, logw, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv runs on cuda or cpu tensors, not {r.device}")
    _check(r, k, v, logw, u, state)
    B, T, H, hd = r.shape
    r, k, v, logw = map(cuda_build.aligned_rows, (r, k, v, logw))
    u, state = u.contiguous(), state.contiguous()
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    new_state = torch.empty_like(state)
    lib = _library()
    code = lib.wkv_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state.data_ptr(), y.data_ptr(), new_state.data_ptr(),
        DTYPES[r.dtype], B, T, H, hd,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3],
        r.device.index or 0, torch.cuda.current_stream(r.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"wkv launch failed: {lib.wkv_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES[NAME] += 1
    return y, new_state
