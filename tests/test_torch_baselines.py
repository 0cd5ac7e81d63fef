"""The port's baseline systems (Google, async and Block FL) against the
reference's runs, on the bench CNN and the bench LSTM.

The reference's initial parameters go into the port (``params_from_jax``);
host numpy randomness (cohorts, Poisson starts, node picks, PoW times, node
batches) is the same by construction. Then latencies, times, accuracies and
Block FL's ``dropped`` must be equal, and the final parameters within 1e-4
(tens of f32 SGD steps computed by two libraries).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.fl import experiments as j_exp
from repro.fl import systems as j_sys
from repro.fl import tasks as j_tasks
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys
from repro_torch.fl import tasks as t_tasks

from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

SETUPS = {"cnn": (j_exp.make_cnn_setup, t_exp.make_cnn_setup),
          "lstm": (j_exp.make_lstm_setup, t_exp.make_lstm_setup)}



def seeded_task(jtask, seed):
    """The port's task, started from the reference's initial parameters."""
    params0 = jax.tree_util.tree_map(np.asarray, jtask.init(jax.random.PRNGKey(seed)))
    base = t_tasks.LSTMTask if isinstance(jtask, j_tasks.LSTMTask) else t_tasks.CNNTask

    class Seeded(base):
        def init(self, seed=0, device="cuda"):
            return t_tasks.params_from_jax(params0, device)

    return Seeded(**{f: getattr(jtask, f) for f in jtask.__dataclass_fields__})


def assert_same_result(rt, rj, param_atol=1e-4):
    assert rt.system == rj.system
    assert rt.avg_latency == rj.avg_latency
    np.testing.assert_array_equal(rt.iters, rj.iters)
    np.testing.assert_array_equal(rt.times, rj.times)
    np.testing.assert_array_equal(rt.accs, rj.accs)
    want = t_tasks.params_from_jax(jax.tree_util.tree_map(np.asarray, rj.final_params), "cpu")
    assert sorted(rt.final_params) == sorted(want)
    for k in want:
        assert rt.final_params[k].dtype == torch.float32
        np.testing.assert_allclose(rt.final_params[k].numpy(), want[k].numpy(),
                                   atol=param_atol, rtol=0, err_msg=k)


def _pair_runs(system, task_name, abnormal, n, sim_kw, seed=0):
    kw = dict(num_nodes=n, abnormal=abnormal, num_abnormal=3, seed=seed)
    jt, jn, jg, _ = SETUPS[task_name][0](**kw)
    _, tn, tg, _ = SETUPS[task_name][1](**kw)
    jd = j_exp.default_dagfl_config(n, task_name)
    td = t_exp.default_dagfl_config(n, task_name)
    rj = j_sys.SYSTEMS[system](jt, jn, jd, j_sys.SimConfig(seed=seed, **sim_kw), jg)
    rt = t_sys.SYSTEMS[system](seeded_task(jt, seed), tn, td,
                               t_sys.SimConfig(seed=seed, **sim_kw), tg, device="cpu")
    return rt, rj


# Google FL draws a cohort of 10 without replacement: 12 nodes leave it a choice
@pytest.mark.parametrize("task_name,abnormal,sim_kw", [
    ("cnn", "normal", dict(iterations=20, eval_every=5)),
    ("cnn", "lazy", dict(iterations=20, eval_every=5)),
    ("lstm", "normal", dict(iterations=20, eval_every=5, steps_per_iter=2, minibatch=16)),
])
@pytest.mark.parametrize("system", ["google", "async", "block"])
def test_baseline_matches_reference(system, task_name, abnormal, sim_kw):
    rt, rj = _pair_runs(system, task_name, abnormal, 12, sim_kw)
    assert_same_result(rt, rj)
    assert rt.extras == rj.extras                       # Block FL: {"dropped": n}
    if system == "block":
        assert rt.extras["dropped"] > 0
    if system == "google":
        assert list(rt.iters) == [10, 20]               # whole rounds of the cohort


def test_systems_table_and_defaults():
    assert sorted(t_sys.SYSTEMS) == sorted(j_sys.SYSTEMS)
    assert t_sys.SYSTEMS["google"] is t_sys.run_google
    jf = {f.name: f.default for f in dataclasses.fields(j_sys.SimConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(t_sys.SimConfig)}
    assert tf == jf
    if not torch.cuda.is_available():
        task, nodes, gval, _ = t_exp.make_cnn_setup(num_nodes=10, seed=0)
        for name in ("google", "async", "block"):
            with pytest.raises(RuntimeError, match="cuda"):
                t_sys.SYSTEMS[name](task, nodes, t_exp.default_dagfl_config(10),
                                    t_sys.SimConfig(iterations=2), gval)
