"""Training the dense model on the CPU: ``Model.loss``, its gradient and
``Model.train_step`` against the reference, and attention's backward.

The reduced dense archs compute in f32. The same parameters (the
reference's, through ``params_from_jax``) and tokens go into both sides.
The loss agrees within 1e-6 relative (the port's mean is XLA's, the f32 sum
times the reciprocal of the count, but the sums run in other orders); every
gradient entry within 2e-5 of its leaf's largest gradient (the chain of
matmuls, norms and RoPE sums in other orders); SGD and momentum steps
within 1e-6 of the parameters' scale.

Attention's backward: ``flash_attention_bwd_plain`` (autograd through
``flash_attention_plain``, the kernel's oracle and the CPU path) against
``jax.grad`` of the reference model's ``chunked_sdpa``, within 1e-5 of each
gradient entry's sum of absolute terms (``flash_attention_bwd_scale``): GQA,
MQA, a window, and S past ``CHUNK_Q`` (1,024), where both sides walk two
query blocks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import attention as j_attn
from repro.models import build_model as j_build
from repro.optim import init_optimizer as j_init_optimizer
from repro_torch.configs import ARCHS, TrainConfig, get_arch
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model
from repro_torch.models.transformer import params_from_jax, train_unported_reason
from repro_torch.optim import init_optimizer

DENSE = ["gemma-2b", "olmo-1b", "qwen2.5-14b", "qwen3-0.6b"]
LOSS_RTOL = 1e-6
GRAD_TOL = 2e-5           # of the leaf's largest gradient
STEP_TOL = 1e-6           # of the parameters' scale
BWD_TOL = 1e-5            # of each gradient entry's sum of absolute terms


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def both(name, seed=1):
    cfg = ARCHS[name].reduced()
    jm = j_build(JConfig(**dataclasses.asdict(cfg)))
    jp = jm.init(jax.random.PRNGKey(seed))
    return cfg, jm, jp, build_model(cfg), params_from_jax(cfg, np_tree(jp), device="cpu")


def zipf_batch(cfg, seed, shape=(2, 24)):
    toks = (np.random.default_rng(seed).zipf(1.3, shape) % cfg.vocab_size).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("name", DENSE)
def test_loss_and_gradient_match_the_reference(name):
    cfg, jm, jp, model, tp = both(name)
    batch = zipf_batch(cfg, 11)
    (j_total, j_metrics), j_grads = jax.value_and_grad(jm.loss, has_aux=True)(jp, batch)
    leaves = {key: sub for key, sub in tp.items()}
    leaves = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), leaves)
    total, metrics = model.loss(leaves, batch)
    total.backward()
    total = total.detach()
    assert total.dtype == torch.float32 and total.shape == ()
    assert abs(float(total) - float(j_total)) <= LOSS_RTOL * abs(float(j_total))
    assert abs(float(metrics["xent"].detach()) - float(j_metrics["xent"])) <= \
        LOSS_RTOL * float(j_total)
    assert float(metrics["aux"]) == float(j_metrics["aux"]) == 0.0
    for path, g in jax.tree_util.tree_flatten_with_path(j_grads)[0]:
        want = np.asarray(g)
        got = leaf(leaves, path).grad.numpy()
        assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max(), path


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_train_step_matches_the_reference(name, optimizer):
    cfg, jm, jp, model, tp = both(name, seed=2)
    batch = zipf_batch(cfg, 12)
    jcfg = JTrainConfig(optimizer=optimizer, learning_rate=0.1)
    tcfg = TrainConfig(optimizer=optimizer, learning_rate=0.1)
    j_new, j_state, j_metrics = jm.train_step(jcfg, jp, j_init_optimizer(jcfg, jp), batch, 0.1)
    before = {k: v.clone() for k, v in tp["layers"]["mlp"].items()}
    t_new, t_state, t_metrics = model.train_step(tcfg, tp, init_optimizer(tcfg, tp), batch, 0.1)
    assert all(torch.equal(before[k], tp["layers"]["mlp"][k]) for k in before)  # not modified
    assert int(t_state.step) == int(j_state.step) == 1
    assert set(t_metrics) == set(j_metrics) == {"loss", "xent", "aux"}
    assert abs(float(t_metrics["loss"]) - float(j_metrics["loss"])) <= \
        LOSS_RTOL * float(j_metrics["loss"])
    for path, p in jax.tree_util.tree_flatten_with_path(j_new)[0]:
        want = np.asarray(p)
        got = leaf(t_new, path).detach().numpy()
        assert np.abs(got - want).max() <= STEP_TOL * max(1.0, np.abs(want).max()), path
        assert not leaf(t_new, path).requires_grad


def test_forward_with_gradients_gives_the_same_logits():
    """The checkpointed, unbound training route computes what the serving
    route computes, bit for bit, and reaches attention through
    ``flash_attention_train`` only while autograd records."""
    cfg, _, _, model, tp = both("qwen3-0.6b")
    tokens = zipf_batch(cfg, 13)["tokens"]
    calls = []
    real = t_attn.flash_attention_train

    def spy(*args):
        calls.append(1)
        return real(*args)

    with torch.no_grad():
        plain, _ = model.forward(tp, tokens)
    t_attn.flash_attention_train = spy
    try:
        leaves = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)
        logits, _ = model.forward(leaves, tokens)
        assert len(calls) == cfg.num_layers
        logits.sum().backward()
        # the backward recomputes every layer (torch.utils.checkpoint): again the route
        assert len(calls) == 2 * cfg.num_layers
        model.forward(tp, tokens)          # nothing requires a gradient: the serving route
        assert len(calls) == 2 * cfg.num_layers
    finally:
        t_attn.flash_attention_train = real
    assert torch.equal(plain, logits.detach())
    assert leaves["layers"]["attn"]["wq"].grad.shape == tp["layers"]["attn"]["wq"].shape


def test_node_stacked_parameters_convert():
    cfg = ARCHS["qwen3-0.6b"].reduced()
    jm = j_build(JConfig(**dataclasses.asdict(cfg)))
    stacked = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(0), 3))
    tp = params_from_jax(cfg, np_tree(stacked), device="cpu")
    assert tp["layers"]["attn"]["wq"].shape == (3,) + stacked["layers"]["attn"]["wq"].shape[1:]
    assert torch.equal(tp["embed"][2], torch.from_numpy(np.array(stacked["embed"][2])))


def test_rwkv_and_unported_families_raise_with_their_roadmap_item():
    cfg = get_arch("rwkv6-7b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = zipf_batch(cfg, 14, (1, 8))
    with pytest.raises(NotImplementedError, match="A.13, part 3"):
        model.loss(params, batch)
    with pytest.raises(NotImplementedError, match="A.13, part 3"):
        model.train_step(TrainConfig(), params, init_optimizer(TrainConfig(), params), batch, 0.1)
    for name in ("deepseek-v2-236b", "kimi-k2-1t-a32b", "zamba2-2.7b", "musicgen-large",
                 "paligemma-3b"):
        assert "A.13, part 4" in train_unported_reason(get_arch(name))
        with pytest.raises(NotImplementedError, match="A.13, part 4"):
            build_model(get_arch(name))
    assert train_unported_reason(get_arch("qwen3-0.6b")) is None


# ---------------------------------------------------------------------------
# attention's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KV,S,hd,window", [
    (2, 4, 2, 40, 64, 0),          # GQA
    (1, 4, 1, 33, 64, 0),          # MQA
    (2, 4, 2, 50, 64, 16),         # a window
    (1, 2, 2, 37, 128, 0),         # hd 128
    (1, 2, 1, 1100, 64, 0),        # two query blocks of CHUNK_Q
    (1, 2, 2, 1100, 64, 300),      # two blocks and a window
])
def test_backward_plain_matches_jax_grad_of_chunked_sdpa(B, H, KV, S, hd, window):
    rng = np.random.default_rng(S + H + hd + window)
    q = (rng.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, hd)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(j_attn.chunked_sdpa(q, k, v, window) * do),
                    argnums=(0, 1, 2))(q, k, v)
    # the kernel's layout: (B, H, S, hd) views of the model's (B, S, H, hd)
    args = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v, do)]
    got = t_fa.flash_attention_bwd(*args, window)          # CPU tensors: the plain version
    scale = t_fa.flash_attention_bwd_scale(*args, window)
    for g, w, m in zip(got, want, scale):
        w = torch.from_numpy(np.array(w)).transpose(1, 2)
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(((g - w).abs() <= BWD_TOL * m).all()), float(((g - w).abs() / m).max())


def test_train_function_is_the_forward_and_the_plain_backward():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
               for s in ((2, 4, 30, 64), (2, 2, 30, 64), (2, 2, 30, 64)))
    do = torch.from_numpy(rng.standard_normal((2, 4, 30, 64)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = t_fa.flash_attention_train(*leaves, 8)
    assert torch.equal(out.detach(), t_fa.flash_attention(q, k, v, 8))
    out.backward(do)
    for got, want in zip(leaves, t_fa.flash_attention_bwd_plain(q, k, v, do, 8)):
        assert torch.equal(got.grad, want)


def test_backward_wrapper_checks_its_arguments():
    q = torch.zeros((1, 4, 8, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_fa.flash_attention_bwd(q, q[:, :2], q[:, :2], q)
    source = t_fa.cuda_build.CSRC / "flash_attention_bwd.cu"
    cmd = t_fa.cuda_build.build_command("nvcc", source, "x.so")
    assert source.exists() and "arch=compute_90a,code=sm_90a" in cmd
