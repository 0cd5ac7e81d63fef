"""The port's WKV recurrence (``kernels/wkv.py``) against the reference, on
the CPU.

Every comparison is relative to each output's sum of absolute terms: the
same function on |r|, |k|, |v|, |u| and |state| (the decays are positive),
so an output that cancels to near 0 is held to the size of what it sums.

- ``wkv_scan_plain`` against ``repro.models.rwkv.wkv_scan``, y and final
  state from a nonzero initial state, within 1e-5 (f32 sums in other
  orders; 2.7e-7 seen).
- ``wkv_chunked_plain`` against ``wkv_chunked`` within 1e-5 with the
  model's decays (1.7e-6 seen), and within 1e-4 with strong and wide ones
  (5.1e-5 seen): XLA's cumsum is a reduce-window in another order than the
  port's sequential f32 sum, and the chunked form's ``cum_prev[t] -
  cum[s]`` and ``total - cum[s]`` cancel when ``|cum|`` is large, which
  magnifies the last bits of ``cum``.
- The dispatcher ``wkv`` on CPU tensors against the reference's Pallas
  kernel ``repro.kernels.wkv.wkv_pallas`` in interpret mode, from a zero
  state (the Pallas kernel starts there and returns only y), within 1e-4.
- The chunked plain version against the sequential one within 5e-4 (the
  reference's own bound for its pair; up to 1.1e-4 seen with wide decays).
- The sequential dispatcher ``wkv_scan`` on CPU tensors against
  ``repro.models.rwkv.wkv_scan`` within 1e-5 for T = 1 (decode), 9 and 33
  (lengths the chunked form does not take), and its ``out``: the state goes
  into ``out`` and is returned, and the ``state`` passed in is unchanged
  when ``out`` is another tensor (``out`` may be ``state`` itself).

Inputs are drawn with numpy from fixed seeds: r, k and v standard normal,
u uniform in [0, 1), the state standard normal, and log decays
``-exp(N)`` in three spreads: the model's (``-exp(-1 + 0.3 N)``), strong
(``-exp(min(2 + N, 10))``, the model's clamp) and wide (``-exp(2 N)``, the
reference's ``test_wkv_chunked_equals_scan``). The kernels themselves run only
on a card: ``tests/test_torch_kernels.py::test_wkv_kernel_on_card`` and
``test_wkv_scan_kernel_on_card``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import wkv_pallas
from repro.models.rwkv import wkv_chunked, wkv_scan
from repro_torch.kernels import wkv as t_wkv

TOL = 1e-5
CANCEL_TOL = 1e-4     # strong and wide decays against XLA's cumsum order
PALLAS_TOL = 1e-4
SCAN_TOL = 5e-4


def draw(seed, B, T, H, hd, decay="model", state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) for _ in range(3))
    n = rng.standard_normal((B, T, H, hd))
    dd = {"model": -1.0 + 0.3 * n, "strong": np.minimum(2.0 + n, 10.0), "wide": 2.0 * n}[decay]
    logw = (-np.exp(dd)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (H, hd)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) if state else np.zeros((B, H, hd, hd)))
    return r, k, v, logw, u, s0.astype(np.float32)


def torch_args(args):
    return [torch.from_numpy(a) for a in args]


def scale_of(fn, args, **kw):
    """``fn`` on the absolute values: each output's sum of absolute terms."""
    return fn(*[a.abs() if i != 3 else a for i, a in enumerate(args)], **kw)


def close(got, want, scale, tol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= tol * np.asarray(scale)), float((err / np.asarray(scale)).max())


CASES = [(0, 2, 64, 2, 64, "model"), (1, 1, 96, 2, 64, "strong"), (2, 2, 32, 1, 128, "model"),
         (3, 2, 64, 2, 8, "wide"), (4, 1, 96, 2, 64, "wide")]


@pytest.mark.parametrize("seed,B,T,H,hd,decay", CASES)
def test_scan_plain_matches_reference(seed, B, T, H, hd, decay):
    args = draw(seed, B, T, H, hd, decay)
    y, s = t_wkv.wkv_scan_plain(*torch_args(args))
    jy, js = wkv_scan(*map(jnp.asarray, args))
    sy, ss = scale_of(t_wkv.wkv_scan_plain, torch_args(args))
    assert y.dtype == s.dtype == torch.float32
    close(y, jy, sy, TOL)
    close(s, js, ss, TOL)


@pytest.mark.parametrize("seed,B,T,H,hd,decay", CASES)
@pytest.mark.parametrize("chunk", [32, 16])
def test_chunked_plain_matches_reference(seed, B, T, H, hd, decay, chunk):
    args = draw(seed, B, T, H, hd, decay)
    y, s = t_wkv.wkv_chunked_plain(*torch_args(args), chunk=chunk)
    jy, js = wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    sy, ss = scale_of(t_wkv.wkv_chunked_plain, torch_args(args), chunk=chunk)
    tol = TOL if decay == "model" else CANCEL_TOL
    close(y, jy, sy, tol)
    close(s, js, ss, tol)


@pytest.mark.parametrize("seed,B,T,H,hd,decay", [
    (5, 2, 64, 2, 64, "model"), (6, 1, 96, 2, 128, "strong"), (7, 2, 32, 2, 64, "wide"),
])
def test_dispatcher_on_cpu_matches_pallas_interpret(seed, B, T, H, hd, decay):
    args = draw(seed, B, T, H, hd, decay, state=False)
    y, s = t_wkv.wkv(*torch_args(args))
    want = wkv_pallas(*map(jnp.asarray, args[:5]), interpret=True)
    close(y, want, scale_of(t_wkv.wkv, torch_args(args))[0], PALLAS_TOL)
    assert s.shape == (B, H, hd, hd)


@pytest.mark.parametrize("seed,decay", [(8, "model"), (9, "strong"), (10, "wide"), (11, "wide")])
def test_chunked_plain_is_close_to_scan(seed, decay):
    args = torch_args(draw(seed, 2, 96, 2, 64, decay))
    for got, want, sc in zip(t_wkv.wkv_chunked_plain(*args), t_wkv.wkv_scan_plain(*args),
                             scale_of(t_wkv.wkv_chunked_plain, args)):
        close(got, want, sc, SCAN_TOL)


@pytest.mark.parametrize("fn", [t_wkv.wkv_scan_plain, t_wkv.wkv_chunked_plain])
def test_state_carries_across_calls(fn):
    """Two calls over the halves of a sequence equal one call over all of it
    (prefill feeding decode), and the given state is not written."""
    args = torch_args(draw(12, 2, 64, 2, 64))
    r, k, v, logw, u, s0 = args
    kept = s0.clone()
    y, s = fn(*args)
    sy, ss = scale_of(fn, args)
    y1, mid = fn(r[:, :32], k[:, :32], v[:, :32], logw[:, :32], u, s0)
    y2, end = fn(r[:, 32:], k[:, 32:], v[:, 32:], logw[:, 32:], u, mid)
    close(torch.cat([y1, y2], dim=1), y, sy, TOL)
    close(end, s, ss, TOL)
    assert torch.equal(s0, kept)


def test_plain_versions_take_bf16_inputs_and_return_f32():
    r, k, v, logw, u, s0 = torch_args(draw(13, 1, 32, 2, 64))
    bf = [x.bfloat16() for x in (r, k, v)] + [logw, u.bfloat16(), s0]
    for fn in (t_wkv.wkv_scan_plain, t_wkv.wkv_chunked_plain, t_wkv.wkv):
        y, s = fn(*bf)
        assert y.dtype == s.dtype == torch.float32
        want = fn(*[x.float() for x in bf])
        assert torch.equal(y, want[0]) and torch.equal(s, want[1])


@pytest.mark.parametrize("T,decay", [(1, "model"), (9, "strong"), (33, "wide")])
def test_scan_dispatcher_on_cpu_matches_reference(T, decay):
    args = draw(20 + T, 2, T, 3, 64, decay)
    y, s = t_wkv.wkv_scan(*torch_args(args))
    jy, js = wkv_scan(*map(jnp.asarray, args))
    sy, ss = scale_of(t_wkv.wkv_scan_plain, torch_args(args))
    assert y.dtype == s.dtype == torch.float32 and y.shape == (2, T, 3, 64)
    close(y, jy, sy, TOL)
    close(s, js, ss, TOL)


@pytest.mark.parametrize("T", [1, 9])
def test_scan_dispatcher_writes_out(T):
    r, k, v, logw, u, s0 = torch_args(draw(30 + T, 2, T, 2, 64))
    kept = s0.clone()
    want_y, want_s = t_wkv.wkv_scan_plain(r, k, v, logw, u, s0)
    out = torch.full_like(s0, float("nan"))
    y, s = t_wkv.wkv_scan(r, k, v, logw, u, s0, out=out)
    assert s is out and torch.equal(out, want_s) and torch.equal(y, want_y)
    assert torch.equal(s0, kept)
    y2, s2 = t_wkv.wkv_scan(r, k, v, logw, u, s0, out=s0)        # in place
    assert s2 is s0 and torch.equal(s0, want_s) and torch.equal(y2, want_y)
