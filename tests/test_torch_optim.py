"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's ``repro.optim``, on the CPU.

Both sides get the same parameters and, at every step, the same gradients,
made with numpy from a seed. Updates compute in f32 on both sides, in the
same order, so f32 leaves agree within 1e-6 of their scale after three
steps (``sqrt``, ``pow`` and the divisions are each library's own, within an
ulp); bf16 leaves within one bf16 unit of the value (each side rounds its
f32 result to bf16 once, and two f32 results a hair apart may round to
neighbours). Schedules within 1e-6 relative (``cos`` is each library's own).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import optimizers as j_opt
from repro.optim import schedules as j_sched
from repro_torch.configs import TrainConfig
from repro_torch.optim import optimizers as t_opt
from repro_torch.optim import schedules as t_sched

SHAPES = {"b": ((3,), np.float32), "w": ((4, 3), np.float32), "h": {"e": ((5,), "bfloat16")}}


def tree_np(rng, shapes, scale):
    out = {}
    for name, spec in shapes.items():
        if isinstance(spec, dict):
            out[name] = tree_np(rng, spec, scale)
        else:
            out[name] = (rng.standard_normal(spec[0]) * scale).astype(np.float32)
    return out


def to_jax(tree, shapes=SHAPES):
    return {name: to_jax(sub, shapes[name]) if isinstance(sub, dict)
            else jnp.asarray(sub, dtype=jnp.bfloat16 if shapes[name][1] == "bfloat16"
                             else jnp.float32)
            for name, sub in tree.items()}


def to_torch(tree, shapes=SHAPES):
    return {name: to_torch(sub, shapes[name]) if isinstance(sub, dict)
            else torch.from_numpy(sub).to(torch.bfloat16 if shapes[name][1] == "bfloat16"
                                          else torch.float32)
            for name, sub in tree.items()}


def assert_tree_close(got, want, tol=1e-6):
    for name, sub in want.items():
        if isinstance(sub, dict):
            assert_tree_close(got[name], sub, tol)
            continue
        w = np.asarray(sub.astype(jnp.float32))
        g = got[name].float().numpy()
        if got[name].dtype == torch.bfloat16:
            bar = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        else:
            bar = tol * max(1.0, float(np.abs(w).max()))
        assert np.all(np.abs(g - w) <= bar), (name, np.abs(g - w).max())


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_optimizer_three_steps_match_the_reference(optimizer, weight_decay, grad_clip):
    rng = np.random.default_rng(3)
    params = tree_np(rng, SHAPES, 1.0)
    jcfg = JTrainConfig(optimizer=optimizer, weight_decay=weight_decay, grad_clip=grad_clip)
    tcfg = TrainConfig(optimizer=optimizer, weight_decay=weight_decay, grad_clip=grad_clip)
    j_init, j_update = j_opt.make_optimizer(jcfg)
    t_init, t_update = t_opt.make_optimizer(tcfg)
    jp, tp = to_jax(params), to_torch(params)
    js, ts = j_init(jp), t_init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for step in range(3):
        # norms above the clip (2.5 per leaf row) so that clipping acts
        grads = tree_np(rng, SHAPES, 2.5)
        lr = 0.05 * (step + 1)
        jp, js = j_update(to_jax(grads), js, jp, lr)
        tp, ts = t_update(to_torch(grads), ts, tp, lr)
        assert int(ts.step) == int(js.step) == step + 1
        assert_tree_close(tp, jp)
        if optimizer != "sgd":
            assert_tree_close(ts.mu, js.mu)
        if optimizer == "adam":
            assert_tree_close(ts.nu, js.nu)
    assert (ts.mu is None) == (optimizer == "sgd") and (ts.nu is None) == (optimizer != "adam")


def test_global_norm_and_clip_match_the_reference():
    rng = np.random.default_rng(4)
    grads = tree_np(rng, SHAPES, 3.0)
    want = float(j_opt.global_norm(to_jax(grads)))
    got = t_opt.global_norm(to_torch(grads))
    assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-6 * want
    jc, jn = j_opt.clip_by_global_norm(to_jax(grads), 1.0)
    tc, tn = t_opt.clip_by_global_norm(to_torch(grads), 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert_tree_close(tc, jc)
    # a norm under the bound leaves the gradients as they are
    small, _ = t_opt.clip_by_global_norm(to_torch(grads), 1e6)
    assert torch.equal(small["w"], to_torch(grads)["w"])


def test_init_optimizer_and_unknown_optimizer():
    tp = to_torch(tree_np(np.random.default_rng(5), SHAPES, 1.0))
    state = t_opt.init_optimizer(TrainConfig(optimizer="adam"), tp)
    assert state.mu["h"]["e"].dtype == torch.float32 and float(state.nu["w"].abs().sum()) == 0
    assert state.step.shape == () and state.step.dtype == torch.int32
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_opt.make_optimizer(TrainConfig(optimizer="lion"))


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 250])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_schedules_match_the_reference(step, as_tensor):
    ours = torch.tensor(step, dtype=torch.int32) if as_tensor else step
    theirs = jnp.asarray(step, jnp.int32) if as_tensor else step
    for make in (lambda m: m.constant_lr(0.3), lambda m: m.cosine_lr(0.3, 100),
                 lambda m: m.cosine_lr(0.3, 100, 0.0),
                 lambda m: m.warmup_cosine(0.3, 10, 100),
                 lambda m: m.warmup_cosine(0.3, 0, 100, 0.2)):
        got, want = make(t_sched)(ours), float(make(j_sched)(theirs))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-6), (step, float(got), want)
