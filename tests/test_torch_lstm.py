"""The port's LSTM task against the reference's, with the reference's
parameters carried in by ``params_from_jax``, at bench width and at the
paper's full width (820,522 parameters).

The flat layout (leaf order, bank rows) is bitwise the reference's. Logits,
loss, one SGD step and one epoch agree within 1e-5: the same f32 arithmetic
done by two libraries in their own orders. Argmax accuracies are equal:
the port's mean is XLA's, the f32 sum times the f32 reciprocal of the count.
The auth tag is a sum of dot products, whose order is each library's own
(the reference's jitted and eager tags differ too), so it is held within
1e-5 of the payload's sum of magnitudes, as tests/test_torch_core.py holds
it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as j_agg
from repro.core import bank as j_bank
from repro.fl import tasks as j_tasks
from repro_torch.core import aggregation as t_agg
from repro_torch.core import bank as t_bank
from repro_torch.fl import tasks as t_tasks

from test_torch_codec import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

TASKS = {
    "bench": j_tasks.bench_lstm_task(),
    "paper": j_tasks.LSTMTask(),          # the paper's full widths: 820,522 parameters
}
LEAF_ORDER = ["bout", "embed", "lstm0.b", "lstm0.w", "lstm1.b", "lstm1.w", "out"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, seed=0):
    jt = TASKS[name]
    tt = t_tasks.LSTMTask(**{f: getattr(jt, f) for f in jt.__dataclass_fields__})
    jp = jt.init(jax.random.PRNGKey(seed))
    return jt, tt, jp, t_tasks.params_from_jax(_np(jp), "cpu")


def _tokens(n, seed=0, steps=None, length=80):
    rng = np.random.default_rng(seed)
    lead = (n,) if steps is None else (steps, n)
    return rng.integers(0, 90, lead + (length,)).astype(np.int32)


def _close(tp, jp, atol):
    want = t_tasks.params_from_jax(_np(jp), "cpu")
    assert list(tp) == list(want)
    for k in want:
        np.testing.assert_allclose(tp[k].numpy(), want[k].numpy(), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["bench", "paper"])
def test_layout_flatten_bank_row_and_auth_tag(name):
    jt, tt, jp, tp = _pair(name)
    paths = ["/".join(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p.replace("/", ".") for p in paths] == LEAF_ORDER
    assert sorted(tp) == LEAF_ORDER
    for (path, leaf), key in zip(jax.tree_util.tree_flatten_with_path(jp)[0], LEAF_ORDER):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(leaf))
    want = np.asarray(j_agg.flatten_params(jp))
    flat = t_agg.flatten_params(tp)
    np.testing.assert_array_equal(flat.numpy(), want)
    assert [n for n, _ in t_agg.leaf_shapes(tp)] == LEAF_ORDER
    back = t_agg.unflatten_params(flat, t_agg.leaf_shapes(tp))
    assert all(torch.equal(back[k], tp[k]) for k in tp)
    # a bank row is the reference's flatten_params and its bank row, bitwise
    bank = t_bank.bank_write(t_bank.init_bank(tp, 3), 1, tp)
    np.testing.assert_array_equal(bank.rows[1].numpy(), want)
    jbank = jax.tree_util.tree_leaves(j_bank.bank_write(j_bank.init_bank(jp, 3),
                                                        jnp.asarray(1), jp))
    for slot in range(3):       # the reference's bank is a stacked pytree
        row = np.concatenate([np.asarray(leaf[slot]).reshape(-1) for leaf in jbank])
        np.testing.assert_array_equal(bank.rows[slot].numpy(), row)
    # the tag weights leaf i by cos(idx (0.618... + 0.001 i)) in this order
    tag_t = float(t_bank.auth_checksum(tp))
    tag_j = float(jax.jit(j_bank.auth_checksum)(jp))
    bound = 1e-5 * float(np.abs(want).sum())
    assert abs(tag_t - tag_j) <= bound
    # ... and that bound tells the order apart: the leaves weighted in reverse
    shuffled = tuple(reversed(t_agg.leaf_shapes(tp)))
    flipped = torch.cat([tp[n].reshape(-1) for n, _ in shuffled])[None]
    assert abs(float(t_bank.checksum_rows(flipped, shuffled)[0]) - tag_j) > bound
    own = tt.init(1, "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    if name == "paper":
        assert sum(v.numel() for v in own.values()) == 820_522


@pytest.mark.parametrize("name", ["bench", "paper"])
def test_logits_loss_and_accuracy_match(name):
    jt, tt, jp, tp = _pair(name, seed=3)
    toks = _tokens(12, seed=1)
    jl = np.asarray(jt.logits(jp, jnp.asarray(toks)))
    tl = tt.logits(tp, torch.from_numpy(toks)).detach().numpy()
    assert tl.shape == (12, 80, 90)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    np.testing.assert_allclose(float(tt.loss(tp, tb)), float(jt.loss(jp, jb)), atol=1e-5)
    # 12 x 79 predictions: a count that is not a power of two, so the mean's rounding shows
    assert float(tt.eval_fn(tp, tb)) == float(jax.jit(jt.eval_fn)(jp, jb))
    assert float(tt.eval_fn(tp, tb)) == float(jt.eval_fn(jp, jb))


@pytest.mark.parametrize("name", ["bench", "paper"])
def test_one_step_and_one_epoch_of_training_match(name):
    jt, tt, jp, tp = _pair(name, seed=5)
    toks = _tokens(8, seed=2)
    jnew, jm = jax.jit(jt.train_fn)(jp, {"tokens": jnp.asarray(toks)}, jax.random.PRNGKey(0))
    tnew, tm = tt.train_fn(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5)
    _close(tnew, jnew, 1e-5)
    assert not any(v.requires_grad for v in tnew.values())

    epoch = _tokens(8, seed=3, steps=3)
    jnew, jm = jax.jit(j_tasks.make_epoch_train(jt))(jp, {"tokens": jnp.asarray(epoch)},
                                                    jax.random.PRNGKey(0))
    tnew, tm = t_tasks.make_epoch_train(tt)(tp, {"tokens": torch.from_numpy(epoch)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5)
    _close(tnew, jnew, 1e-5)
    # training returns fresh tensors: its inputs are untouched
    assert all(torch.equal(tp[k], t_tasks.params_from_jax(_np(jp), "cpu")[k]) for k in tp)


@pytest.mark.parametrize("cnn", ["bench", "paper"])
def test_attack_success_rate_matches(cnn):
    jt = j_tasks.bench_cnn_task() if cnn == "bench" else j_tasks.CNNTask()
    tt = t_tasks.CNNTask(**{f: getattr(jt, f) for f in jt.__dataclass_fields__})
    jp = jt.init(jax.random.PRNGKey(4))
    tp = t_tasks.params_from_jax(_np(jp), "cpu")
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(40, jt.image_size, jt.image_size, 1)).astype(np.float32)
    y = rng.integers(0, 10, 40).astype(np.int32)
    for shift in (1, 3):
        want = float(jt.attack_success_rate(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                                            target_shift=shift))
        got = float(tt.attack_success_rate(tp, {"x": torch.from_numpy(x),
                                                "y": torch.from_numpy(y)}, target_shift=shift))
        assert got == want


def test_params_from_jax_takes_either_task():
    jp = j_tasks.bench_cnn_task().init(jax.random.PRNGKey(0))
    tp = t_tasks.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    assert list(tp) == list(jp)
    nested = {"a": np.ones(2, np.float32), "b": {"c": np.zeros((2, 3), np.float32),
                                                 "d": {"e": np.full(1, 2.0, np.float32)}}}
    out = t_tasks.params_from_jax(nested, "cpu")
    assert list(out) == ["a", "b.c", "b.d.e"]
    assert out["b.c"].shape == (2, 3) and float(out["b.d.e"]) == 2.0


def test_init_is_seeded():
    tt = t_tasks.bench_lstm_task()
    a, b, c = tt.init(7, "cpu"), tt.init(7, "cpu"), tt.init(8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lstm0.w"], c["lstm0.w"])
    assert all(float(a[k].abs().max()) == 0.0 for k in ("bout", "lstm0.b", "lstm1.b"))


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        t_tasks.bench_lstm_task().init(0)
