"""The port's model zoo (dense family) against the reference, on the CPU.

``models/layers.py``, ``models/attention.py`` and ``models/transformer.py``
against ``repro.models``: the same parameters (the reference's, through
``params_from_jax``) and the same tokens go into both sides. Reduced configs
compute in f32; logits agree within 1e-4 (RoPE's sin and cos, the softmax's
exp and ``rope_freqs``' pow are XLA's on one side and PyTorch's on the
other, and the sums run in other orders), layer outputs within 1e-5.

The port's cache is written in place, so a test keeps copies where it
compares a cache across steps. Unported families raise
``NotImplementedError`` naming their ROADMAP item.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import long_context_variant as j_long_context_variant
from repro.configs.base import ModelConfig as JConfig
from repro.models import attention as j_attn
from repro.models import build_model as j_build
from repro.models import layers as j_layers
from repro_torch.configs import ARCHS, get_arch, get_shape, list_archs, long_context_variant
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model
from repro_torch.models import layers as t_layers
from repro_torch.models.transformer import Model, params_from_jax

LOGIT_TOL = 1e-4
LAYER_TOL = 1e-5
DENSE = ["gemma-2b", "olmo-1b", "qwen2.5-14b", "qwen3-0.6b"]
B, S = 2, 16


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


def both(name, seed=1, cfg=None):
    """(reference model, its params, port model, the same params)."""
    cfg = cfg or ARCHS[name].reduced()
    jm = j_build(cfg_to_jax(cfg))
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(cfg), params_from_jax(cfg, np_tree(jp), device="cpu")


def cfg_to_jax(cfg):
    return JConfig(**dataclasses.asdict(cfg))


def tokens_for(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_are_the_references():
    assert list_archs() == sorted(J_ARCHS)
    for name in J_ARCHS:
        ours, theirs = dataclasses.asdict(get_arch(name)), dataclasses.asdict(J_ARCHS[name])
        assert ours == theirs
        assert dataclasses.asdict(get_arch(name).reduced()) == \
            dataclasses.asdict(J_ARCHS[name].reduced())
        assert get_arch(name).param_count() == J_ARCHS[name].param_count()
        assert get_arch(name).active_param_count() == J_ARCHS[name].active_param_count()
        assert dataclasses.asdict(long_context_variant(get_arch(name))) == \
            dataclasses.asdict(j_long_context_variant(J_ARCHS[name]))
    assert get_arch("qwen3-0.6b").param_count() == 595_984_384
    assert get_shape("decode_32k").seq_len == 32768
    with pytest.raises(KeyError):
        get_arch("nope")


@pytest.mark.parametrize("name", ["zamba2-2.7b", "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b", "musicgen-large", "paligemma-3b"])
def test_unported_families_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
        build_model(ARCHS[name].reduced())
    with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
        Model(ARCHS[name])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    params = {}
    if kind != "nonparam_layernorm":
        params["scale"] = rng.standard_normal(48).astype(np.float32)
    if kind == "layernorm":
        params["bias"] = rng.standard_normal(48).astype(np.float32)
    got = t_layers.norm_apply(kind, {k: t(v) for k, v in params.items()}, t(x))
    close(got, j_layers.norm_apply(kind, params, jnp.asarray(x)), LAYER_TOL)
    head = t_layers.rms_head_norm(t(x), t(x[0, 0]))
    close(head, j_layers.rms_head_norm(jnp.asarray(x), jnp.asarray(x[0, 0])), LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(act):
    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"].reduced(), act=act)
    jp = np_tree(j_layers.mlp_init(jax.random.PRNGKey(2), cfg_to_jax(cfg)))
    x = np.random.default_rng(4).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    got = t_layers.mlp_apply(cfg, {k: t(v) for k, v in jp.items()}, t(x))
    close(got, j_layers.mlp_apply(cfg_to_jax(cfg), jp, jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rope_matches(theta):
    close(t_layers.rope_freqs(128, theta), j_layers.rope_freqs(128, theta), 1e-7)
    x = np.random.default_rng(5).standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 100, 1000, 8191, 32767, 5]] * 2, np.int32)
    got = t_layers.apply_rope(t(x), t(pos), theta)
    close(got, j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), LAYER_TOL)


def test_init_draws_truncated_normals_from_the_generator():
    gen = torch.Generator().manual_seed(0)
    w = t_layers.dense_init(gen, 256, 64, torch.bfloat16, "cpu", layers=3)
    assert w.shape == (3, 256, 64) and w.dtype == torch.bfloat16
    assert float(w.float().abs().max()) <= 2.0 / 16
    e = t_layers.embed_init(torch.Generator().manual_seed(0), 512, 32, torch.float32, "cpu")
    assert float(e.abs().max()) <= 0.04 and 0.015 < float(e.std()) < 0.02
    again = t_layers.embed_init(torch.Generator().manual_seed(0), 512, 32, torch.float32, "cpu")
    assert torch.equal(e, again)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attn_pair(cfg, seed):
    jp = np_tree(j_attn.attn_init(jax.random.PRNGKey(seed), cfg_to_jax(cfg)))
    return jp, {k: t(v) for k, v in jp.items()}


def test_causal_mask_matches():
    for window in (0, 5):
        close(t_attn.causal_mask(12, window), j_attn.causal_mask(12, window), 0.0)


@pytest.mark.parametrize("window,S,cache_len", [(0, 24, 0), (0, 24, 30), (16, 24, 30),
                                                (16, 12, 30)])
def test_attn_forward_matches(window, S, cache_len):
    """With and without a cache; a window shorter than the sequence gives
    the reference's rolled ring buffer."""
    cfg = ARCHS["qwen2.5-14b"].reduced()
    if window:
        cfg = dataclasses.replace(cfg, attention="sliding_window", window_size=window)
    jp, tp = attn_pair(cfg, 6)
    x = np.random.default_rng(7).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want, jc = j_attn.attn_forward(cfg_to_jax(cfg), jp, jnp.asarray(x), return_cache=True,
                                   cache_len=cache_len)
    got, tc = t_attn.attn_forward(cfg, tp, t(x), return_cache=True, cache_len=cache_len)
    close(got, want, LAYER_TOL)
    close(tc.k, jc.k, LAYER_TOL)
    close(tc.v, jc.v, LAYER_TOL)
    assert tc.length == int(jc.length)
    plain, none = t_attn.attn_forward(cfg, tp, t(x))
    assert none is None and torch.equal(plain, got)


@pytest.mark.parametrize("window", [0, 8])
def test_attn_decode_step_matches(window):
    """Five steps from a prefilled cache, past the ring's end when windowed;
    the port writes its cache in place."""
    cfg = ARCHS["qwen3-0.6b"].reduced()
    if window:
        cfg = dataclasses.replace(cfg, attention="sliding_window", window_size=window)
    jp, tp = attn_pair(cfg, 8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    _, jc = j_attn.attn_forward(cfg_to_jax(cfg), jp, jnp.asarray(x), return_cache=True,
                                cache_len=10)
    _, tc = t_attn.attn_forward(cfg, tp, t(x), return_cache=True, cache_len=10)
    for step in range(5):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jc = j_attn.attn_decode_step(cfg_to_jax(cfg), jp, jnp.asarray(xs), jc)
        k_before = tc.k
        got, tc = t_attn.attn_decode_step(cfg, tp, t(xs), tc)
        assert tc.k is k_before                    # written in place
        close(got, want, LAYER_TOL)
        close(tc.k, jc.k, LAYER_TOL)
        assert tc.length == int(jc.length) == 7 + step


@pytest.mark.parametrize("window", [0, 6])
def test_decode_validity_mask_is_a_prefix(window):
    """The reference's decode mask (``attention.py:205-213``) is the first
    ``min(pos + 1, slots)`` slots for the ring buffer and the full cache:
    what the port hands ``decode_attention`` as ``lengths``."""
    for slots in (1, 4, 6, 9):
        for pos in range(0, 3 * slots + 2):
            idx = np.arange(slots)
            if window:
                slot_pos = pos - np.mod(pos - idx, slots)
                valid = (slot_pos >= 0) & (slot_pos >= pos - slots + 1)
            else:
                valid = idx <= pos
            assert valid.tolist() == (idx < min(pos + 1, slots)).tolist()


def test_empty_cache_matches():
    for attention in ("full", "sliding_window"):
        cfg = dataclasses.replace(ARCHS["olmo-1b"].reduced(), attention=attention)
        jc = j_attn.empty_cache(cfg_to_jax(cfg), 3, 100, jnp.float32, length=5)
        tc = t_attn.empty_cache(cfg, 3, 100, torch.float32, "cpu", length=5)
        assert tc.k.shape == jc.k.shape and tc.length == int(jc.length) == 5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_model_matches_reference(name):
    """forward, prefill + decode_step (the reference's own decode==forward
    check on both sides), three more decode steps, and init_cache."""
    jm, jp, tm, tp = both(name)
    cfg = tm.cfg
    tokens = tokens_for(cfg, 1, (B, S + 4))
    jl, _ = jm.forward(jp, jnp.asarray(tokens[:, :S + 1]))
    tl, aux = tm.forward(tp, tokens[:, :S + 1])
    close(tl, jl, LOGIT_TOL)
    assert float(aux) == 0.0
    jlast, jc = jm.prefill(jp, jnp.asarray(tokens[:, :S]), cache_len=S + 4)
    tlast, tc = tm.prefill(tp, tokens[:, :S], cache_len=S + 4)
    close(tlast, jlast, LOGIT_TOL)
    close(tc["stack"].k, jc["stack"].k, LAYER_TOL)
    assert tc["stack"].length == S and np.all(np.asarray(jc["stack"].length) == S)
    for step in range(4):
        tok = tokens[:, S + step:S + step + 1]
        jd, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        td, tc = tm.decode_step(tp, tok, tc)
        close(td, jd, LOGIT_TOL)
        assert tc["stack"].length == S + step + 1
    close(tm.decode_step(tp, tokens[:, S:S + 1], tm.prefill(tp, tokens[:, :S],
                                                            cache_len=S + 4)[1])[0][:, 0],
          jl[:, -1], LOGIT_TOL)
    ic = tm.init_cache(3, 40, length=7, device="cpu")
    jic = jm.init_cache(3, 40, length=7)
    assert ic["stack"].k.shape == jic["stack"].k.shape and ic["prefix"] == jic["prefix"] == []
    assert ic["stack"].length == 7 and ic["stack"].k.dtype == torch.float32


def test_long_context_variant_decodes_past_its_window():
    """The long_500k policy: a sliding-window variant with a ring cache,
    prefilled with twice its window, then decoding four steps past it."""
    name = "olmo-1b"
    cfg = long_context_variant(dataclasses.replace(ARCHS[name], attention="full")).reduced()
    assert cfg.attention == "sliding_window"
    jm, jp, tm, tp = both(name, seed=0, cfg=cfg)
    W = cfg.window_size
    T = 2 * W
    tokens = tokens_for(cfg, 2, (1, T + 4))
    jl, _ = jm.forward(jp, jnp.asarray(tokens))
    tl, _ = tm.forward(tp, tokens)
    close(tl, jl, LOGIT_TOL)
    _, jc = jm.prefill(jp, jnp.asarray(tokens[:, :T]), cache_len=T)
    _, tc = tm.prefill(tp, tokens[:, :T], cache_len=T)
    assert tc["stack"].k.shape[2] == W
    for step in range(4):
        tok = tokens[:, T + step:T + step + 1]
        jd, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        td, tc = tm.decode_step(tp, tok, tc)
        close(td, jd, LOGIT_TOL)
        close(td[:, 0], jl[:, T + step], 2e-2)    # the reference's own decode==forward bound


def test_bf16_model_states_its_tolerance():
    """One bf16 case: the reduced qwen3 in bf16 on both sides. Both round
    every matmul output to bf16, in other orders, and the port's attention
    does not round scores or probabilities (the reference's does), so its
    logits are held within the reference's own 2e-2 decode==forward bound."""
    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"].reduced(), dtype="bfloat16")
    jm, jp, tm, tp = both("qwen3-0.6b", cfg=cfg)
    tokens = tokens_for(cfg, 3, (B, S))
    jl, _ = jm.forward(jp, jnp.asarray(tokens))
    tl, _ = tm.forward(tp, tokens)
    assert tl.dtype == torch.bfloat16
    close(tl, jl.astype(jnp.float32), 2e-2)


def test_port_init_is_seeded_and_shaped_like_the_reference():
    cfg = ARCHS["qwen2.5-14b"].reduced()
    tm = build_model(cfg)
    a, b = tm.init(0, device="cpu"), tm.init(0, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda x: x.shape,
                                     j_build(cfg_to_jax(cfg)).init(jax.random.PRNGKey(0)))
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda x: tuple(x.shape), a))
    flat_j = jax.tree_util.tree_leaves_with_path(jshapes)
    assert flat_t == flat_j
    assert all(torch.equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                                  jax.tree_util.tree_leaves(b)))
    logits, _ = tm.forward(a, tokens_for(cfg, 0, (1, 8)))
    assert logits.shape == (1, 8, cfg.vocab_size) and bool(torch.isfinite(logits).all())
