"""The port's experiment drivers against the reference's, at the smallest
iteration counts their signatures allow (the set-ups keep their 100 nodes;
Table II on the LSTM task is in tests/test_torch_experiments_lstm.py).

Table II's numbers are host numpy and need nothing carried in. For the
others the port's drivers build the bench task with the reference's initial
parameters (``params_from_jax``) and draw the reference's tip-selection
uniforms, so every value the drivers return must be the reference's.
"""
import numpy as np
import pytest

from repro.fl import experiments as j_exp
from repro.fl import tasks as j_tasks
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import systems as t_sys

from test_torch_baselines import assert_same_result, seeded_task
from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from test_torch_system import _reference_draws

SEED = 0


@pytest.fixture
def reference_init_and_draws(monkeypatch):
    """The port's drivers start from the reference's parameters and draws."""
    monkeypatch.setattr(t_exp, "bench_cnn_task",
                        lambda: seeded_task(j_tasks.bench_cnn_task(), SEED))
    monkeypatch.setattr(t_exp, "bench_lstm_task",
                        lambda: seeded_task(j_tasks.bench_lstm_task(), SEED))
    monkeypatch.setattr(t_sys, "torch_uniform_draw",
                        lambda seed, cap, device: _reference_draws(seed, cap))


def assert_same_table2(task_name):
    want = j_exp.iteration_delay_experiment(task_name, iterations=1, seed=SEED)
    got = t_exp.iteration_delay_experiment(task_name, iterations=1, seed=SEED, device="cpu")
    assert list(got) == list(want)
    assert len(got) == 8
    for key in want:
        assert got[key] == want[key], key


def test_iteration_delay_experiment():
    assert_same_table2("cnn")


def test_run_all_and_ideal_convergence(reference_init_and_draws):
    want = j_exp.ideal_convergence_experiment("cnn", iterations=2, seed=SEED)
    got = t_exp.ideal_convergence_experiment("cnn", iterations=2, seed=SEED, device="cpu")
    assert list(got) == list(want) == ["dagfl", "async", "block", "google"]
    for name in want:
        assert_same_result(got[name], want[name])
    assert got["block"].extras == want["block"].extras


def test_abnormal_experiment_attack_success(reference_init_and_draws):
    kw = dict(abnormal="backdoor", num_abnormal=5, iterations=2, seed=SEED)
    want = j_exp.abnormal_experiment("cnn", **kw)
    got = t_exp.abnormal_experiment("cnn", device="cpu", **kw)
    assert list(got) == list(want)
    for name in want:
        assert_same_result(got[name], want[name])
        assert got[name].extras["attack_success"] == want[name].extras["attack_success"]


def test_contribution_experiment(reference_init_and_draws):
    kw = dict(abnormal="poisoning", num_abnormal=10, iterations=2, seed=SEED)
    want = j_exp.contribution_experiment("cnn", **kw)
    got = t_exp.contribution_experiment("cnn", device="cpu", **kw)
    assert list(got) == list(want) == [0, 1]
    for m in want:
        assert list(got[m]) == list(want[m])
        for key, value in want[m].items():
            assert got[m][key] == value or (np.isnan(got[m][key]) and np.isnan(value)), (m, key)
