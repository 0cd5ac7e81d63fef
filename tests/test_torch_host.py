"""Host-side parity of the PyTorch port: configs, synthetic data, population,
latency model and Poisson starts give the reference's arrays, bit for bit.

Also holds the rule that the port imports neither JAX nor the JAX package.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from repro.configs import base as j_base
from repro.configs import dagfl_paper_tasks as j_tasks_cfg
from repro.data import synthetic as j_syn
from repro.fl import experiments as j_exp
from repro.fl import latency as j_lat
from repro.fl import nodes as j_nodes
from repro.fl import systems as j_sys
from repro_torch.configs import base as t_base
from repro_torch.configs import dagfl_paper_tasks as t_tasks_cfg
from repro_torch.data import synthetic as t_syn
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import latency as t_lat
from repro_torch.fl import nodes as t_nodes
from repro_torch.fl import systems as t_sys

REPO = Path(__file__).resolve().parent.parent


def _same_fields(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("kw", [{}, dict(num_nodes=8, k=3, alpha=6, beta=2, capacity=64)])
def test_dagfl_config_matches(kw):
    j, t = j_base.DagFLConfig(**kw), t_base.DagFLConfig(**kw)
    _same_fields(j, t)
    assert t.expected_tips() == j.expected_tips()
    assert t.iteration_delay(1.3e9) == j.iteration_delay(1.3e9)
    with pytest.raises(ValueError):
        t_base.DagFLConfig(k=5, alpha=5)


def test_paper_task_configs_match():
    _same_fields(j_tasks_cfg.CNN_TASK, t_tasks_cfg.CNN_TASK)
    _same_fields(j_tasks_cfg.LSTM_TASK, t_tasks_cfg.LSTM_TASK)


@pytest.mark.parametrize("image_size", [16, 28])
def test_mnist_like_identical(image_size):
    jg, tg = j_syn.MnistLike(image_size, seed=3), t_syn.MnistLike(image_size, seed=3)
    np.testing.assert_array_equal(jg.protos, tg.protos)
    jd = jg.balanced(np.random.default_rng(5), 40)
    td = tg.balanced(np.random.default_rng(5), 40)
    np.testing.assert_array_equal(jd.x, td.x)
    np.testing.assert_array_equal(jd.y, td.y)
    np.testing.assert_array_equal(j_syn.add_backdoor_trigger(jd.x, 4),
                                  t_syn.add_backdoor_trigger(td.x, 4))


def test_paper_partition_identical():
    jp = j_syn.paper_partition(j_syn.MnistLike(16, seed=1), 6, 20, 10, seed=4)
    tp = t_syn.paper_partition(t_syn.MnistLike(16, seed=1), 6, 20, 10, seed=4)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("abnormal", ["normal", "lazy", "poisoning", "backdoor"])
def test_population_and_node_streams_identical(abnormal):
    kw = dict(num_nodes=6, abnormal=abnormal, num_abnormal=2, seed=2)
    jn = j_nodes.build_population(j_syn.MnistLike(16, seed=2), **kw)
    tn = t_nodes.build_population(t_syn.MnistLike(16, seed=2), **kw)
    for a, b in zip(jn, tn):
        assert (a.node_id, a.behavior) == (b.node_id, b.behavior)
        for part in ("train", "test"):
            for key in ("x", "y"):
                np.testing.assert_array_equal(getattr(a, part)[key], getattr(b, part)[key])
        # the per-node rng streams: the same batches in the same order
        for draw in (lambda n: n.epoch(3, 5), lambda n: n.val_batch(7), lambda n: n.minibatch(4)):
            da, db = draw(a), draw(b)
            for key in da:
                np.testing.assert_array_equal(da[key], db[key])


def test_latency_model_identical():
    cfg_j = j_base.DagFLConfig(num_nodes=12)
    cfg_t = t_base.DagFLConfig(num_nodes=12)
    jl, tl = j_lat.LatencyModel.create(cfg_j, 9), t_lat.LatencyModel.create(cfg_t, 9)
    np.testing.assert_array_equal(jl.freqs, tl.freqs)
    np.testing.assert_array_equal(jl.h_all(), tl.h_all())
    for node in range(12):
        for lazy in (False, True):
            for name in ("dagfl_iteration", "google_iteration", "async_iteration",
                         "block_iteration"):
                assert getattr(jl, name)(node, lazy=lazy) == getattr(tl, name)(node, lazy=lazy)
        assert (jl.d0(node), jl.d1(node), jl.h(node)) == (tl.d0(node), tl.d1(node), tl.h(node))
    assert jl.tx_time() == tl.tx_time()
    assert jl.pow_time(np.random.default_rng(1)) == tl.pow_time(np.random.default_rng(1))


def test_poisson_starts_identical():
    np.testing.assert_array_equal(
        j_sys._poisson_starts(np.random.default_rng(4), 1.0, 50),
        t_sys._poisson_starts(np.random.default_rng(4), 1.0, 50),
    )


def test_experiment_setups_identical():
    _same_fields(j_exp.default_dagfl_config(20), t_exp.default_dagfl_config(20))
    _same_fields(j_exp.default_dagfl_config(20, "lstm"), t_exp.default_dagfl_config(20, "lstm"))
    jt, jn, jv, _ = j_exp.make_cnn_setup(num_nodes=5, seed=1)
    tt, tn, tv, _ = t_exp.make_cnn_setup(num_nodes=5, seed=1)
    assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
    for key in ("x", "y"):
        np.testing.assert_array_equal(jv[key], tv[key])
    for a, b in zip(jn, tn):
        np.testing.assert_array_equal(a.train["x"], b.train["x"])


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
    # the pattern does catch what it must, and spares the port's own name
    assert _FORBIDDEN.search("import jax.numpy as jnp") and _FORBIDDEN.search("from repro.core import dag")
    assert not _FORBIDDEN.search("from repro_torch.core import dag")
