"""The port's CNN task against the reference's, with the reference's
parameters carried in by ``params_from_jax``.

Logits, loss and one ``make_epoch_train`` epoch agree to atol 1e-5: the
same f32 arithmetic, done by two libraries in their own orders. Argmax
accuracies agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as j_agg
from repro.fl import tasks as j_tasks
from repro.models import layers as j_layers
from repro_torch.core import aggregation as t_agg
from repro_torch.fl import tasks as t_tasks
from repro_torch.models import layers as t_layers

TASKS = {
    "bench": j_tasks.bench_cnn_task(),
    "paper": j_tasks.CNNTask(),          # the paper's full widths: 1,663,370 parameters
}


def _pair(name, seed=0):
    jt = TASKS[name]
    tt = t_tasks.CNNTask(**{f: getattr(jt, f) for f in jt.__dataclass_fields__})
    jp = jt.init(jax.random.PRNGKey(seed))
    return jt, tt, jp, t_tasks.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _batch(image_size, n, seed=0, steps=None):
    rng = np.random.default_rng(seed)
    lead = (n,) if steps is None else (steps, n)
    x = rng.uniform(size=lead + (image_size, image_size, 1)).astype(np.float32)
    y = rng.integers(0, 10, lead).astype(np.int32)
    return {"x": x, "y": y}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("name", ["bench", "paper"])
def test_layout_flatten_and_params_from_jax(name):
    jt, tt, jp, tp = _pair(name)
    assert list(tp) == list(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    np.testing.assert_array_equal(t_agg.flatten_params(tp).numpy(),
                                  np.asarray(j_agg.flatten_params(jp)))
    shapes = t_agg.leaf_shapes(tp)
    assert [n for n, _ in shapes] == sorted(jp)          # tree_leaves order of a dict
    back = t_agg.unflatten_params(t_agg.flatten_params(tp), shapes)
    assert all(torch.equal(back[k], tp[k]) for k in tp)
    own = tt.init(1, "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape) for k, v in jp.items()}
    if name == "paper":
        assert sum(v.numel() for v in own.values()) == 1_663_370


@pytest.mark.parametrize("name", ["bench", "paper"])
def test_logits_loss_and_accuracy_match(name):
    jt, tt, jp, tp = _pair(name, seed=3)
    b = _batch(jt.image_size, 16, seed=1)
    jl = np.asarray(jt.logits(jp, jnp.asarray(b["x"])))
    tl = tt.logits(tp, torch.from_numpy(b["x"])).detach().numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tt.loss(tp, _t(b))), float(jt.loss(jp, _j(b))), atol=1e-5)
    assert float(tt.eval_fn(tp, _t(b))) == float(jt.eval_fn(jp, _j(b)))


def test_one_epoch_of_training_matches():
    jt, tt, jp, tp = _pair("bench", seed=5)
    b = _batch(jt.image_size, 32, seed=2, steps=4)
    jnew, jm = jax.jit(j_tasks.make_epoch_train(jt))(jp, _j(b), jax.random.PRNGKey(0))
    tnew, tm = t_tasks.make_epoch_train(tt)(tp, _t(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5)
    for k in jnew:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), atol=1e-5, rtol=0)
        assert not tnew[k].requires_grad
    # training returns fresh tensors: its inputs are untouched
    assert all(torch.equal(tp[k], torch.tensor(np.asarray(jp[k]))) for k in jp)


@pytest.mark.parametrize("with_mask", [False, True])
def test_softmax_xent_matches(with_mask):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (3, 5)).astype(np.int32)
    mask = (rng.uniform(size=(3, 5)) < 0.6).astype(np.float32) if with_mask else None
    want = j_layers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = t_layers.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                                None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_init_is_seeded():
    tt = t_tasks.bench_cnn_task()
    a, b, c = tt.init(7, "cpu"), tt.init(7, "cpu"), tt.init(8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc"], c["fc"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        t_tasks.bench_cnn_task().init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        t_tasks.params_from_jax({"b": np.zeros(2, np.float32)})
