"""The model-space screen's route: ``kernels/model_distance.py::outlier_scores``
(the distances and each candidate's mean distance to the others) and
``core/anomaly.py::parameter_outlier_scores`` on top of it.

On the CPU the route is the plain version, held against the reference's
``repro.core.anomaly.parameter_outlier_scores`` (its Pallas kernel in
interpret mode, as its own tests run it) and ``repro.kernels.ref.
model_distance_ref``: sums of N products in another order on each side, and
a diagonal that cancels to near 0, so each distance is held within 1e-6 of
its sum of absolute terms ``sq_i + sq_j + 2 |x_i . x_j|`` and each score
within 1e-6 of the mean of its row's off-diagonal sums (as in
``tests/test_torch_core.py``). The wrapper's argument checks raise before
any launch, and the source builds for ``sm_90a``.

On a card (marked ``cuda``, skipped without one) the kernel is one launch
that reads the candidates once and writes the distances and the scores:
held within 1e-5 of the same sums against the plain version for every k
from 1 to 32; bitwise the same for a contiguous tensor, views with row
strides of N + 1, N + 2 and N + 3 and views that start 1-3 floats into a
buffer; the same bits over two calls with other candidates in between; the
scores within 1e-5 of the plain scores; and one device kernel a call,
counted with ``torch.profiler``. The card tests import no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import anomaly as t_anomaly
from repro_torch.kernels import cuda_build
from repro_torch.kernels import model_distance as t_md

DIST_RTOL_CPU = 1e-6      # plain version against the reference (f32 on the CPU)
DIST_RTOL_CARD = 1e-5     # kernel against plain: lane, warp, chunk and chunk-sum orders
RAGGED_N = 10_007         # not a multiple of a vector, a stage or a chunk


@pytest.fixture(scope="module")
def jax_ref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import anomaly as j_anomaly
    from repro.kernels import ref

    return jnp, j_anomaly, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    return torch.device("cuda")


def cluster(seed, k, n, zero_row=False):
    """k flattened candidate models as ``tests/test_torch_core.py`` makes
    them: a normal cluster around one centre and, for k >= 3, row 0 far from
    it (a boosted, sign-flipped update)."""
    rng = np.random.default_rng(seed)
    centre = rng.standard_normal(n).astype(np.float32) * 0.05
    x = centre + rng.standard_normal((k, n)).astype(np.float32) * 0.01
    if k >= 3:
        x[0] = -4.0 * x[0] + rng.standard_normal(n).astype(np.float32) * 0.2
    if zero_row:
        x[k // 2] = 0.0
    return x


def candidates(seed, k, n, zero_row=False):
    """k flattened candidate models of mixed scales, one far from the others."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((k, n)) * rng.choice([0.01, 1.0, 30.0], (k, 1))).astype(np.float32)
    x[0] = -4.0 * x[0] + 0.2 * rng.standard_normal(n).astype(np.float32)
    if zero_row and k > 1:
        x[k // 2] = 0.0
    return x


def distance_scale(x) -> np.ndarray:
    """(k, k) sq_i + sq_j + 2 |x_i . x_j| in f64."""
    x = np.asarray(x, np.float64)
    sq = (x * x).sum(1)
    return sq[:, None] + sq[None, :] + 2.0 * np.abs(x @ x.T)


def exact_distances(x) -> np.ndarray:
    """(k, k) the distances of the f32 models computed in f64."""
    x = np.asarray(x, np.float64)
    sq = (x * x).sum(1)
    return sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)


def score_scale(scale: np.ndarray) -> np.ndarray:
    """(k,) the mean of each row's off-diagonal sums of absolute terms."""
    k = scale.shape[0]
    return (scale * ~np.eye(k, dtype=bool)).sum(1) / max(k - 1, 1)


# ---------------------------------------------------------------------------
# CPU: the plain route against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 16_385])
@pytest.mark.parametrize("k", [1, 2, 5, 16, 32])
def test_outlier_scores_plain_match_reference(jax_ref, k, n):
    """The plain route within DIST_RTOL_CPU of each entry's scale of the
    exact (f64) distances and scores, and of the reference's, up to the
    reference's own distance from the exact value: XLA's CPU product of two
    rows of 16,385 lies 1.09e-6 of the scale from it (k = 2), the port 4.5e-8."""
    jnp, j_anomaly, ref = jax_ref
    zero_row = k >= 5 and n >= 3
    x = cluster(k * 1_000 + n, k, n, zero_row)
    d, scores = t_md.outlier_scores(torch.from_numpy(x))
    assert d.dtype == scores.dtype == torch.float32
    assert d.shape == (k, k) and scores.shape == (k,)
    scale = distance_scale(x)
    tol, score_tol = DIST_RTOL_CPU * scale, DIST_RTOL_CPU * score_scale(scale) + 1e-30
    exact_d = exact_distances(x)
    exact_s = (exact_d * ~np.eye(k, dtype=bool)).sum(1) / max(k - 1, 1)
    assert (np.abs(d.numpy() - exact_d) <= tol).all()
    assert (np.abs(scores.numpy() - exact_s) <= score_tol).all()
    want_d = np.asarray(ref.model_distance_ref(jnp.asarray(x)))
    assert (np.abs(d.numpy() - want_d) <= tol + np.abs(want_d - exact_d)).all()
    want = np.asarray(j_anomaly.parameter_outlier_scores(jnp.asarray(x)))
    assert (np.abs(scores.numpy() - want) <= score_tol + np.abs(want - exact_s)).all()
    # the screen is the route's scores, and the route's distances model_distance's
    assert torch.equal(t_anomaly.parameter_outlier_scores(torch.from_numpy(x)), scores)
    assert torch.equal(t_md.model_distance(torch.from_numpy(x)), d)
    if k == 1:
        assert scores[0] == 0.0
    if zero_row:
        z = k // 2
        assert d[z, z] == 0.0


@pytest.mark.parametrize("k", [2, 7])
def test_outlier_scores_of_equal_and_zero_models_are_zero(k):
    """Models of zeros, and k copies of one model, score exactly 0."""
    zeros = torch.zeros((k, 33))
    d, scores = t_md.outlier_scores(zeros)
    assert not d.any() and not scores.any()
    same = torch.from_numpy(candidates(k, 1, 64)).expand(k, 64)
    d, scores = t_md.outlier_scores(same)
    assert d.shape == (k, k) and torch.isfinite(scores).all()


def test_scores_plain_divides_by_a_tensor():
    """Each score is the row's off-diagonal sum divided (IEEE) by k - 1."""
    d = torch.tensor([[0.0, 1.0, 2.0], [1.0, 0.0, 7.0], [2.0, 7.0, 0.0]])
    d[0, 0] = 100.0                           # the diagonal is never summed
    want = torch.tensor([3.0, 8.0, 9.0]) / torch.full((3,), 2.0)
    assert torch.equal(t_md.scores_plain(d), want)
    assert torch.equal(t_md.scores_plain(torch.tensor([[5.0]])), torch.zeros(1))


@pytest.mark.parametrize("fn", [t_md.outlier_scores, t_md.model_distance])
def test_wrappers_refuse_other_devices_before_any_launch(fn):
    x = torch.from_numpy(candidates(0, 5, 100))
    before = dict(cuda_build.LAUNCHES)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(x.to("meta"))
    assert dict(cuda_build.LAUNCHES) == before


@pytest.mark.parametrize("shape,dtype,transpose,err,match", [
    ((33, 10), torch.float32, False, ValueError, "k <= 32"),
    ((0, 10), torch.float32, False, ValueError, "k <= 32"),
    ((4, 0), torch.float32, False, ValueError, "N >= 1"),
    ((4, 10), torch.float64, False, TypeError, "float32"),
    ((4, 10), torch.bfloat16, False, TypeError, "float32"),
    ((10, 4), torch.float32, True, ValueError, "unit column stride"),
    ((40,), torch.float32, False, ValueError, "unit column stride"),
    ((2, 4, 10), torch.float32, False, ValueError, "unit column stride"),
])
def test_kernel_argument_checks(shape, dtype, transpose, err, match):
    """What the kernel does not take is refused by ``_check_cuda_args``,
    which ``_launch`` runs before it allocates or launches anything."""
    x = torch.zeros(shape, dtype=dtype)
    if transpose:
        x = x.T
    before = dict(cuda_build.LAUNCHES)
    with pytest.raises(err, match=match):
        t_md._check_cuda_args(x)
    assert dict(cuda_build.LAUNCHES) == before


def test_source_builds_for_sm_90a_and_states_its_limits():
    source = cuda_build.CSRC / "model_distance.cu"
    cmd = cuda_build.build_command("nvcc", source, "x.so")
    assert source.exists() and "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(source)
    text = source.read_text()
    assert f"constexpr int kMaxK = {t_md.MAX_K};" in text
    # one launch a call: the C entry point launches the kernel once
    body = text[text.index('extern "C" int model_distance('):]
    assert body.count("<<<") == 1 and "cudaGetLastError" in body


# ---------------------------------------------------------------------------
# the card: one launch, against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", list(range(1, 33)))
def test_kernel_matches_plain_for_every_k(cuda, k):
    x = torch.from_numpy(candidates(k, k, RAGGED_N, zero_row=k % 3 == 0)).to(cuda)
    before = cuda_build.LAUNCHES["model_distance"]
    d, scores = t_md.outlier_scores(x)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["model_distance"] == before + 1
    want_d, want_s = t_md.outlier_scores_plain(x)
    scale = distance_scale(x.cpu().numpy())
    assert (np.abs(d.cpu().numpy() - want_d.cpu().numpy()) <= DIST_RTOL_CARD * scale).all()
    assert (np.abs(scores.cpu().numpy() - want_s.cpu().numpy())
            <= DIST_RTOL_CARD * score_scale(scale) + 1e-30).all()
    assert torch.equal(d, d.T)
    assert torch.equal(t_md.model_distance(x), d)
    if k == 1:
        assert scores.item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(5, 1_663_370), (16, 100_003), (32, RAGGED_N), (9, 33),
                                 (3, 5)])
def test_kernel_bits_ignore_row_stride_and_alignment(cuda, k, n):
    x = torch.from_numpy(candidates(k + n, k, n)).to(cuda)
    want_d, want_s = t_md.outlier_scores(x)
    for extra in (1, 2, 3):
        wide = torch.zeros((k, n + extra), device=cuda)
        wide[:, :n] = x
        d, s = t_md.outlier_scores(wide[:, :n])
        assert torch.equal(d, want_d) and torch.equal(s, want_s), f"row stride N + {extra}"
    for start in (1, 2, 3):
        flat = torch.zeros(start + k * n, device=cuda)
        view = flat[start:].view(k, n)
        view.copy_(x)
        d, s = t_md.outlier_scores(view)
        assert torch.equal(d, want_d) and torch.equal(s, want_s), f"{start} floats in"


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(5, 1_663_370), (16, 1_663_370), (32, 100_003)])
def test_kernel_same_bits_across_calls(cuda, k, n):
    x = torch.from_numpy(candidates(3, k, n)).to(cuda)
    first = t_md.outlier_scores(x)
    for seed in range(3):           # other candidates in between, other shapes too
        t_md.outlier_scores(torch.from_numpy(candidates(seed, k, n)).to(cuda))
        t_md.model_distance(torch.from_numpy(candidates(seed, 7, 1_001)).to(cuda))
    again = t_md.outlier_scores(x)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
def test_screen_scores_on_the_card(cuda):
    """``parameter_outlier_scores`` on the card within 1e-5 of the CPU's, the
    far candidate above the others."""
    x = candidates(11, 5, 200_001)
    x[1:] = x[1] + 0.01 * np.random.default_rng(1).standard_normal((4, 200_001)).astype(
        np.float32)
    got = t_anomaly.parameter_outlier_scores(torch.from_numpy(x).to(cuda)).cpu()
    want = t_anomaly.parameter_outlier_scores(torch.from_numpy(x))
    tol = DIST_RTOL_CARD * score_scale(distance_scale(x))
    assert (np.abs(got.numpy() - want.numpy()) <= tol).all()
    assert got[0] > got[1:].max()


def device_ops_a_call(call, x, tries=5):
    """Names of the device operations one ``call(x)`` runs, from a profiled
    call. A spin kernel enqueued after it marks a trace that holds the
    call's device events (the profiler drops every device event of some
    windows); such a window is profiled again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call(x)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("spin_kernel" in name for name in names):
            return [name for name in names if "spin_kernel" not in name]
    pytest.fail(f"the profiler saw no device work in {tries} windows")


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["outlier_scores", "model_distance"])
@pytest.mark.parametrize("k,n", [(5, 1_663_370), (16, 1_663_370), (32, 100_003), (1, 4_097),
                                 (7, 33)])
def test_one_device_kernel_a_call(cuda, fn, k, n):
    call = getattr(t_md, fn)
    x = torch.from_numpy(candidates(k, k, n)).to(cuda)
    call(x)                                   # built, its counter made
    torch.cuda.synchronize()
    device = device_ops_a_call(call, x)
    assert len(device) == 1 and "model_distance_kernel" in device[0], device
    # the screen: one device kernel in all
    if fn == "outlier_scores" and k == 5:
        device = device_ops_a_call(t_anomaly.parameter_outlier_scores, x)
        assert len(device) == 1 and "model_distance_kernel" in device[0], device
