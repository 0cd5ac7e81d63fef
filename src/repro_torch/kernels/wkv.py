"""RWKV6 WKV with data-dependent decay: the kernels' two routes, the plain
versions, the dispatchers.

Per head, with the (hd_k, hd_v) state S in f32:

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,

``w_t = exp(logw_t)``, ``logw <= 0``. Chunked by ``CHUNK`` = 32 steps: inside a
chunk the pairwise decays ``exp(cum_prev[t] - cum[s])`` (s < t) all have
exponents <= 0, and one state is carried from chunk to chunk.

- ``wkv_scan_plain`` ports ``repro/models/rwkv.py::wkv_scan``, the sequential
  oracle.
- ``wkv_chunked_plain`` ports ``wkv_chunked`` operation for operation; its
  cumulative sums run sequentially in t in f32, as the kernel's do
  (``torch.cumsum`` on the CPU accumulates in f64, and XLA's reduce-window
  cumsum in another order: with strong decays the chunked form's
  ``cum_prev[t] - cum[s]`` cancels, so the order shows).
- ``wkv(r, k, v, logw, u, state)``, the chunked route (prefill and forward),
  returns ``(y f32 (B, T, H, hd), state f32 (B, H, hd, hd))``. For CUDA
  tensors it launches ``wkv_forward`` of ``repro_torch/csrc/wkv.cu``, which
  replaces the TPU kernel ``repro/kernels/wkv.py::wkv_pallas``: r, k, v and
  u float32 or bfloat16, logw and state float32, ``hd`` in {64, 128}, ``T``
  a positive multiple of 32; anything else raises ``ValueError``, a failed
  build or launch ``RuntimeError``. For CPU tensors it is
  ``wkv_chunked_plain``. Counted under ``LAUNCHES["wkv"]``.
- ``wkv_scan(r, k, v, logw, u, state, out=None)``, the sequential route
  (decode and every other length), takes any ``T >= 1`` and returns the
  same pair; the state goes into ``out`` when it is given, which may be
  ``state`` itself (updated in place). For CUDA tensors it launches
  ``wkv_scan_forward`` of the same source, which replaces no Pallas kernel
  (the reference's decode is plain JAX); for CPU tensors it is
  ``wkv_scan_plain`` (and a copy into ``out``). Counted under
  ``LAUNCHES["wkv_scan"]``.

The kernels differ from the Pallas kernel in two ways: they start from the
given state and return the final one, so that prefill feeds decode, and they
write ``y`` in f32, as ``wkv_chunked`` returns it to ``time_mix``. They read
the model's (B, T, H, hd) tensors through their strides (``hd`` unit
stride), with no transposed copy.

Bounds on one H100 (``csrc/wkv.cu`` has the derivations). The chunked route
at rwkv6-7b's prefill (B 1, T 8,192, H 64, hd 64, bf16): 470 MB of inputs
and output, 0.141 ms at 3.35 TB/s, above its operations (the products at
the TF32 tensor rate, the factorised scores' exponentials): bound by bytes.
Design: one kernel walks the chunks of each head with the state in mma
accumulators, its products ``r_dec S`` and ``k_dec^T v`` in TF32 split into
hi + lo parts (three products, about f32's accuracy), while producer warps
form the next chunk's decays; a second kernel adds every chunk's
intra-chunk part in parallel, its scores factorised at the start of each
sub-chunk of 8 steps so that only the pairs inside a sub-chunk take one
exponential a term. The sequential route at rwkv6-7b's decode (B
128, T 1): the state read once and written once, with r, k, v, logw and y
276 MB, 0.082 ms a layer: bound by bytes; one block a head and sequence holds the state in registers.
No atomics: the same inputs give the same bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

NAME = "wkv"
SCAN_NAME = "wkv_scan"
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
# the CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library("wkv.cu")
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    for fn in (lib.wkv_forward, lib.wkv_scan_forward):
        fn.argtypes = [
            p, p, p, p, p, p,            # r, k, v, logw, u, state in
            p, p,                        # y, state out
            i, i, i, i, i,               # dtype, B, T, H, hd
            ll, ll, ll,                  # r strides (b, t, h)
            ll, ll, ll,                  # k strides
            ll, ll, ll,                  # v strides
            ll, ll, ll,                  # logw strides
            i, p,                        # device, stream
        ]
        fn.restype = i
    lib.wkv_smem_bytes.argtypes = [i, i, i]
    lib.wkv_smem_bytes.restype = i
    lib.wkv_error_string.argtypes = [i]
    lib.wkv_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, logw, u, state, chunked: bool = True) -> None:
    """Raise ``ValueError`` for what a route's kernel does not take: the
    chunked route needs ``T`` a positive multiple of the chunk, the
    sequential route any ``T >= 1``."""
    name = NAME if chunked else SCAN_NAME
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, logw)):
        raise ValueError(f"{name}: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"logw {tuple(logw.shape)} must share one (B, T, H, hd) shape")
    B, T, H, hd = r.shape
    if u.shape != (H, hd) or state.shape != (B, H, hd, hd):
        raise ValueError(f"{name}: u {tuple(u.shape)} and state {tuple(state.shape)} are not "
                         f"({H}, {hd}) and ({B}, {H}, {hd}, {hd})")
    if r.dtype not in DTYPES or any(x.dtype != r.dtype for x in (k, v, u)):
        raise ValueError(f"{name}: r, k, v and u must all be float32 or bfloat16, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}")
    if logw.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"{name}: logw and state must be float32, got {logw.dtype}, "
                         f"{state.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim must be one of {HEAD_DIMS}, got {hd}")
    if chunked and (T < 1 or T % CHUNK):
        raise ValueError(f"{name}: T = {T} is not a positive multiple of the chunk {CHUNK}")
    if T < 1:
        raise ValueError(f"{name}: T = {T} is not positive")
    if any(x.device != r.device for x in (k, v, logw, u, state)):
        raise ValueError(f"{name}: all arguments must lie on one device")


def _check_out(out, state) -> None:
    if (out.shape != state.shape or out.dtype != torch.float32 or out.device != state.device
            or not out.is_contiguous()):
        raise ValueError(f"{SCAN_NAME}: out must be a contiguous float32 tensor of the state's "
                         f"shape {tuple(state.shape)} on {state.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")


def _launch(fn, name, r, k, v, logw, u, state, new_state):
    """Launch ``fn`` (``wkv_forward`` or ``wkv_scan_forward``) into a fresh
    y and ``new_state``; returns y."""
    B, T, H, hd = r.shape
    r, k, v, logw = map(cuda_build.aligned_rows, (r, k, v, logw))
    u = u.contiguous()
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    code = fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state.data_ptr(), y.data_ptr(), new_state.data_ptr(),
        DTYPES[r.dtype], B, T, H, hd,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3],
        r.device.index or 0, torch.cuda.current_stream(r.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_library().wkv_error_string(code).decode()} ({code})")
    cuda_build.LAUNCHES[name] += 1
    return y


def wkv(r, k, v, logw, u, state):
    """Chunked WKV from ``state``: (y f32 (B, T, H, hd), final state f32 (B,
    H, hd, hd)). The kernel for CUDA tensors, ``wkv_chunked_plain`` for CPU
    tensors."""
    if r.device.type == "cpu":
        return wkv_chunked_plain(r, k, v, logw, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv runs on cuda or cpu tensors, not {r.device}")
    _check(r, k, v, logw, u, state)
    state = state.contiguous()
    new_state = torch.empty_like(state)
    y = _launch(_library().wkv_forward, NAME, r, k, v, logw, u, state, new_state)
    return y, new_state


def wkv_scan(r, k, v, logw, u, state, out=None):
    """Sequential WKV from ``state`` for any ``T >= 1``: (y f32 (B, T, H,
    hd), final state f32 (B, H, hd, hd)). The final state is written into
    ``out`` when it is given (``out`` may be ``state``: the state is then
    updated in place) and returned. The kernel for CUDA tensors,
    ``wkv_scan_plain`` for CPU tensors."""
    if out is not None:
        _check_out(out, state)
    if r.device.type == "cpu":
        y, new_state = wkv_scan_plain(r, k, v, logw, u, state)
        return (y, new_state) if out is None else (y, out.copy_(new_state))
    if r.device.type != "cuda":
        raise ValueError(f"wkv_scan runs on cuda or cpu tensors, not {r.device}")
    _check(r, k, v, logw, u, state, chunked=False)
    state = state.contiguous()
    new_state = torch.empty_like(state) if out is None else out
    y = _launch(_library().wkv_scan_forward, SCAN_NAME, r, k, v, logw, u, state, new_state)
    return y, new_state
