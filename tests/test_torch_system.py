"""A whole ``run_dagfl`` of the port against the reference's.

The reference's initial parameters and its threefry draws go into the port
(``params_from_jax`` and the ``draw`` hook); host numpy randomness (Poisson
starts, node choice, node batches) is the same by construction. Then the
latency, the curve and the ledger's integer columns must be equal, and the
final parameters within 1e-4 (twenty iterations of f32 SGD, computed by two
libraries).
"""
import jax
import numpy as np
import pytest
import torch

from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.fl import tasks as t_tasks

INT_FIELDS = ("publisher", "approvals", "approvers", "approval_count", "model_slot", "count",
              "published_per_node", "contributing_m0", "contributing_m1")


def _reference_draws(seed, cap):
    """The reference's uniforms: prepare i from split(PRNGKey(seed*100003+i))[0],
    check from PRNGKey(done)."""

    def draw(stream, index):
        if stream == "prepare":
            key = jax.random.split(jax.random.PRNGKey(seed * 100003 + index))[0]
        else:
            key = jax.random.PRNGKey(index)
        u = jax.random.uniform(key, (cap,), minval=1e-9, maxval=1.0)
        return torch.tensor(np.asarray(u))

    return draw


def _seeded_task(jtask, seed):
    """The port's task, started from the reference's initial parameters."""
    params0 = {k: np.asarray(v) for k, v in jtask.init(jax.random.PRNGKey(seed)).items()}

    class Seeded(t_tasks.CNNTask):
        def init(self, seed=0, device="cuda"):
            return t_tasks.params_from_jax(params0, device)

    return Seeded(**{f: getattr(jtask, f) for f in jtask.__dataclass_fields__})


@pytest.mark.parametrize("abnormal,weighted", [("normal", False), ("lazy", True)])
def test_run_dagfl_matches_reference(abnormal, weighted):
    n, seed = 8, 0
    kw = dict(num_nodes=n, abnormal=abnormal, num_abnormal=3, seed=seed)
    jt, jn, jg, _ = j_exp.make_cnn_setup(**kw)
    _, tn, tg, _ = t_exp.make_cnn_setup(**kw)
    jd, td = j_exp.default_dagfl_config(n), t_exp.default_dagfl_config(n)
    rj = j_sys.run_dagfl(jt, jn, jd, j_sys.SimConfig(iterations=20, eval_every=5, seed=seed), jg,
                         weighted=weighted)
    rt = t_sys.run_dagfl(_seeded_task(jt, seed), tn, td,
                         t_sys.SimConfig(iterations=20, eval_every=5, seed=seed), tg,
                         weighted=weighted, device="cpu",
                         draw=_reference_draws(seed, td.capacity))
    assert rt.avg_latency == rj.avg_latency
    np.testing.assert_array_equal(rt.iters, rj.iters)
    np.testing.assert_array_equal(rt.times, rj.times)
    np.testing.assert_array_equal(rt.accs, rj.accs)
    dj, dt = rj.extras["dag"], rt.extras["dag"]
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(dt, f).numpy(), np.asarray(getattr(dj, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(dt.publish_time.numpy(), np.asarray(dj.publish_time))
    np.testing.assert_array_equal(dt.accuracy.numpy(), np.asarray(dj.accuracy))
    for k in rj.final_params:
        np.testing.assert_allclose(rt.final_params[k].numpy(), np.asarray(rj.final_params[k]),
                                   atol=1e-4, rtol=0)
    for key in ("contribution_m0", "contribution_m1", "published", "late_contribution_m0",
                "late_contribution_m1", "late_published"):
        np.testing.assert_allclose(rt.extras[key], np.asarray(rj.extras[key]), rtol=1e-6)
    assert rt.extras["behaviors"] == rj.extras["behaviors"]
    assert rt.acc_at(12) == rj.acc_at(12)
    stages = rt.extras["stage_ms"]
    assert stages["prepare"]["count"] == 20 and stages["commit"]["count"] == 20
    assert stages["check"]["count"] == rt.extras["checks"] == len(rt.iters)


def test_zero_iteration_run_reports_genesis():
    task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=4, seed=0)
    res = t_sys.run_dagfl(task, nodes, t_exp.default_dagfl_config(4),
                          t_sys.SimConfig(iterations=0), gval, device="cpu")
    assert len(res.iters) == 0 and res.avg_latency == 0.0 and res.acc_at(5) == 0.0
    assert int(res.extras["dag"].count) == 1
    assert set(res.final_params) == {"b1", "b2", "bfc", "bout", "conv1", "conv2", "fc", "out"}


def test_default_draws_run_backdoor_population():
    """The port's own torch.Generator draws, with the backdoor joint-attack bias."""
    n = 6
    task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=n, abnormal="backdoor",
                                                num_abnormal=2, seed=1)
    res = t_sys.run_dagfl(task, nodes, t_exp.default_dagfl_config(n),
                          t_sys.SimConfig(iterations=12, eval_every=4, seed=1), gval,
                          device="cpu")
    assert int(res.extras["dag"].count) == 13
    assert np.all(np.isfinite(res.accs)) and len(res.accs) == len(res.iters)
    assert all(bool(torch.isfinite(p).all()) for p in res.final_params.values())
    draw = t_sys.torch_uniform_draw(0, 64, "cpu")
    u = torch.stack([draw("prepare", i) for i in range(50)])
    assert u.dtype == torch.float32 and float(u.min()) >= 1e-9 and float(u.max()) < 1.0


def test_run_dagfl_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=2, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        t_sys.run_dagfl(task, nodes, t_exp.default_dagfl_config(2),
                        t_sys.SimConfig(iterations=2), gval)
