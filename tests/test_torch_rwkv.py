"""The port's RWKV6 family against the reference, on the CPU.

``models/rwkv.py`` (``time_mix``, ``channel_mix``, ``rwkv_block_apply``),
``models/transformer.py`` for ``family == "rwkv"`` (``forward``,
``prefill``, ``decode_step``, ``init_cache``, ``init``) and the
``SlotServer`` against ``repro.models`` and ``repro.launch.serve`` on the
reference's parameters (``params_from_jax``) for reduced rwkv6-7b (2
layers, d 256, 4 heads of 64, f32). Block outputs agree within 1e-5 and
logits within 1e-4 (rtol and atol: sums in other orders; the model's decays
are mild, so the chunked WKV's cancellation stays far below that, see
``tests/test_torch_wkv.py``). A length that is a multiple of 32 takes the
chunked WKV (its kernel's path on a card), any other length and decode the
sequential one (``wkv_scan``, its own kernel on a card; a spy shows the
route). The SlotServer's greedy tokens are compared only where
every argmax the reference takes has a top-2 logit gap above 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs.base import ModelConfig as JConfig
from repro.launch.serve import Request as JRequest
from repro.launch.serve import SlotServer as JSlotServer
from repro.models import build_model as j_build
from repro.models import rwkv as j_rwkv
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.serve import Request, SlotServer, serve
from repro_torch.models import build_model
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.transformer import _layer, params_from_jax, unported_reason

LOGIT_TOL = 1e-4
LAYER_TOL = 1e-5
CFG = ARCHS["rwkv6-7b"].reduced()
J_CFG = JConfig(**dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, the same params)."""
    jm = j_build(J_CFG)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_jax(CFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(CFG), tp


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def close_state(got, want, tol):
    for g, w in zip(got, want):
        close(g, w, tol)


def tokens_for(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def random_state(seed, B, layers=0):
    """A nonzero RWKV state (numpy), shift rows of activation scale."""
    rng = np.random.default_rng(seed)
    H, hd, d = CFG.d_model // CFG.rwkv_head_dim, CFG.rwkv_head_dim, CFG.d_model
    lead = (layers,) if layers else ()
    return (rng.standard_normal(lead + (B, d)).astype(np.float32),
            rng.standard_normal(lead + (B, d)).astype(np.float32),
            (rng.standard_normal(lead + (B, H, hd, hd)) * 0.5).astype(np.float32))


def layer0(jp, tp):
    return jax.tree_util.tree_map(lambda a: a[0], jp["layers"]), _layer(tp["layers"], 0)


# ---------------------------------------------------------------------------
# building
# ---------------------------------------------------------------------------


def test_rwkv_builds_and_counts_the_references_parameters(pair):
    assert unported_reason(get_arch("rwkv6-7b")) is None
    full = build_model(get_arch("rwkv6-7b")).init(0, device="meta")
    ref = jax.eval_shape(j_build(J_ARCHS["rwkv6-7b"]).init, jax.random.PRNGKey(0))

    def shapes(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for name, sub in tree.items()
                    for k, v in shapes(sub, path + (name,)).items()}
        return {path: tuple(tree.shape)}

    def ref_shapes(tree):
        return {tuple(key.key for key in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    assert shapes(full) == ref_shapes(ref)
    assert sum(int(np.prod(s)) for s in shapes(full).values()) == 7_534_952_448
    small = build_model(CFG).init(3, device="cpu")
    assert shapes(small) == ref_shapes(pair[1])
    assert all(bool(torch.isfinite(t).all()) for t in
               jax.tree_util.tree_leaves(small["layers"]))
    lo, hi = float(small["layers"]["mu"].min()), float(small["layers"]["mu"].max())
    assert 0.25 <= lo and hi < 0.75
    assert torch.equal(small["layers"]["decay_w0"], torch.full_like(small["layers"]["decay_w0"],
                                                                     -1.0))


def test_init_cache_is_the_stacked_zero_state(pair):
    model = pair[2]
    cache = model.init_cache(3, 99, length=5, device="cpu")
    H, hd = CFG.d_model // CFG.rwkv_head_dim, CFG.rwkv_head_dim
    assert isinstance(cache, t_rwkv.RWKVState)
    assert cache.tm_shift.shape == cache.cm_shift.shape == (CFG.num_layers, 3, CFG.d_model)
    assert cache.wkv.shape == (CFG.num_layers, 3, H, hd, hd) and cache.wkv.dtype == torch.float32
    assert not any(bool(leaf.any()) for leaf in cache)
    want = pair[0].init_cache(3, 99, 5)
    assert all(tuple(g.shape) == w.shape for g, w in zip(cache, want))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,seed", [(64, 0), (7, 1), (1, 2), (32, 3)])
def test_time_mix_matches_reference(pair, T, seed):
    jl, tl = layer0(pair[1], pair[3])
    x = np.random.default_rng(seed).standard_normal((2, T, CFG.d_model)).astype(np.float32)
    shift, _, wkv = random_state(seed + 10, 2)
    got = t_rwkv.time_mix(CFG, tl, torch.from_numpy(x), torch.from_numpy(shift),
                          torch.from_numpy(wkv))
    want = j_rwkv.time_mix(J_CFG, jl, jnp.asarray(x), jnp.asarray(shift), jnp.asarray(wkv))
    for g, w in zip(got, want):
        close(g, w, LAYER_TOL)


@pytest.mark.parametrize("T,chunked", [(1, False), (9, False), (64, True)])
def test_time_mix_dispatches_each_length_to_its_route(pair, T, chunked, monkeypatch):
    """T a positive multiple of 32 (T > 1) goes through ``wkv``, any other
    length through ``wkv_scan`` (the sequential kernel on a card), as the
    reference dispatches; ``wkv_out`` reaches the scan as its ``out``."""
    _, tl = layer0(pair[1], pair[3])
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, kwargs.get("out")))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(t_rwkv, "wkv", spy("wkv", t_rwkv.wkv))
    monkeypatch.setattr(t_rwkv, "wkv_scan", spy("wkv_scan", t_rwkv.wkv_scan))
    x = np.random.default_rng(T).standard_normal((2, T, CFG.d_model)).astype(np.float32)
    shift, _, wkv = random_state(T + 40, 2)
    state = torch.from_numpy(wkv)
    out = torch.empty_like(state)
    _, _, new = t_rwkv.time_mix(CFG, tl, torch.from_numpy(x), torch.from_numpy(shift), state,
                                wkv_out=out)
    if chunked:
        assert calls == [("wkv", None)]
    else:
        assert calls == [("wkv_scan", out)]
    assert new is out and torch.equal(state, torch.from_numpy(wkv))


@pytest.mark.parametrize("T,seed", [(64, 4), (5, 5), (1, 6)])
def test_channel_mix_matches_reference(pair, T, seed):
    jl, tl = layer0(pair[1], pair[3])
    x = np.random.default_rng(seed).standard_normal((2, T, CFG.d_model)).astype(np.float32)
    shift = random_state(seed, 2)[1]
    got = t_rwkv.channel_mix(CFG, tl, torch.from_numpy(x), torch.from_numpy(shift))
    want = j_rwkv.channel_mix(J_CFG, jl, jnp.asarray(x), jnp.asarray(shift))
    for g, w in zip(got, want):
        close(g, w, LAYER_TOL)


@pytest.mark.parametrize("T,seed", [(96, 7), (9, 8), (1, 9)])
def test_block_apply_matches_reference(pair, T, seed):
    jl, tl = layer0(pair[1], pair[3])
    x = np.random.default_rng(seed).standard_normal((2, T, CFG.d_model)).astype(np.float32)
    state = random_state(seed + 20, 2)
    got_x, got_st = t_rwkv.rwkv_block_apply(
        CFG, tl, torch.from_numpy(x), t_rwkv.RWKVState(*map(torch.from_numpy, state)))
    want_x, want_st = j_rwkv.rwkv_block_apply(
        J_CFG, jl, jnp.asarray(x), j_rwkv.RWKVState(*map(jnp.asarray, state)))
    close(got_x, want_x, LAYER_TOL)
    close_state(got_st, want_st, LAYER_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [64, 40])
def test_forward_matches_reference(pair, S):
    jm, jp, tm, tp = pair
    tokens = tokens_for(S, (2, S))
    logits, aux = tm.forward(tp, tokens)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    assert logits.shape == (2, S, CFG.vocab_size) and float(aux) == 0.0
    close(logits, want, LOGIT_TOL)


@pytest.mark.parametrize("S", [64, 40])
def test_prefill_and_decode_match_reference(pair, S):
    jm, jp, tm, tp = pair
    tokens = tokens_for(S + 1, (2, S + 3))
    got, cache = tm.prefill(tp, tokens[:, :S], cache_len=S + 8)
    want, jcache = jm.prefill(jp, jnp.asarray(tokens[:, :S]), cache_len=S + 8)
    close(got, want, LOGIT_TOL)
    assert isinstance(cache, t_rwkv.RWKVState)
    close_state(cache, jcache, LOGIT_TOL)
    for step in range(3):
        tok = tokens[:, S + step:S + step + 1]
        got, cache = tm.decode_step(tp, tok, cache)
        want, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache)
        assert got.shape == (2, 1, CFG.vocab_size)
        close(got, want, LOGIT_TOL)
        close_state(cache, jcache, LOGIT_TOL)


def test_decode_step_writes_the_cache_in_place(pair):
    _, _, tm, tp = pair
    cache = tm.init_cache(2, 8, device="cpu")
    ptrs = [leaf.data_ptr() for leaf in cache]
    _, new = tm.decode_step(tp, tokens_for(0, (2, 1)), cache)
    assert new is cache and [leaf.data_ptr() for leaf in new] == ptrs
    assert all(bool(leaf.any()) for leaf in cache)


def test_decode_from_a_given_state_matches_reference(pair):
    jm, jp, tm, tp = pair
    state = random_state(30, 2, layers=CFG.num_layers)
    cache = t_rwkv.RWKVState(*(torch.from_numpy(a.copy()) for a in state))
    jcache = j_rwkv.RWKVState(*map(jnp.asarray, state))
    tok = tokens_for(31, (2, 1))
    got, cache = tm.decode_step(tp, tok, cache)
    want, jcache = jm.decode_step(jp, jnp.asarray(tok), jcache)
    close(got, want, LOGIT_TOL)
    close_state(cache, jcache, LOGIT_TOL)


@pytest.mark.parametrize("S", [16, 64])
def test_decode_matches_forward(pair, S):
    """prefill(S tokens) + decode(token S) == forward(S + 1 tokens) at
    position S, within the reference's 2e-2 (tests/test_models.py)."""
    _, _, tm, tp = pair
    tokens = tokens_for(S + 2, (2, S + 1))
    want = tm.forward(tp, tokens)[0][:, -1]
    _, cache = tm.prefill(tp, tokens[:, :S], cache_len=S + 4)
    got, _ = tm.decode_step(tp, tokens[:, S:], cache)
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# the slot server
# ---------------------------------------------------------------------------


def top2_gap(logits) -> float:
    top = np.sort(np.asarray(logits, np.float32).reshape(-1, logits.shape[-1]), axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def run_reference(server, reqs, gaps):
    """The reference's admit/tick loop, recording the smallest top-2 gap of
    every greedy step its jitted prefill and decode feed."""
    prefill, decode = server._prefill, server._decode

    def rec_prefill(p, t):
        logits, cache = prefill(p, t)
        gaps.append(top2_gap(logits[0, -1]))
        return logits, cache

    def rec_decode(p, t, c):
        logits, cache = decode(p, t, c)
        active = [s for s, r in enumerate(server.active) if r is not None]
        gaps.append(top2_gap(np.asarray(logits)[active, 0]))
        return logits, cache

    server._prefill, server._decode = rec_prefill, rec_decode
    pending, ticks = list(reqs), 0
    while pending or any(server.active):
        while pending and server.admit(pending[0]):
            pending.pop(0)
        server.tick()
        ticks += 1
        assert ticks < 100
    return ticks


@pytest.mark.parametrize("slots,n,prompt_len,max_new,seed", [
    (2, 3, 8, 4, 0), (3, 5, 32, 5, 1), (1, 2, 12, 3, 2),
])
def test_slot_server_serves_the_references_tokens(pair, slots, n, prompt_len, max_new, seed):
    _, jp, _, tp = pair
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, CFG.vocab_size, prompt_len).astype(np.int32) for _ in range(n)]
    max_len = prompt_len + max_new + 2
    jserver = JSlotServer(J_CFG, jp, slots=slots, max_len=max_len)
    gaps = []
    jreqs = [JRequest(i, p, max_new) for i, p in enumerate(prompts)]
    jticks = run_reference(jserver, jreqs, gaps)
    tserver = SlotServer(CFG, tp, slots=slots, max_len=max_len)
    treqs = [Request(i, p, max_new) for i, p in enumerate(prompts)]
    tticks = serve(tserver, treqs)
    assert min(gaps) > LOGIT_TOL
    assert tticks == jticks
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs) and tserver.length is None


def test_slot_server_gives_each_slot_its_own_state(pair):
    """An admitted request's prefilled state is copied into its slot alone:
    the other slot's state is untouched, and the slot holds exactly what a
    prefill of the prompt alone gives."""
    _, _, tm, tp = pair
    server = SlotServer(CFG, tp, slots=2, max_len=20)
    first = Request(0, tokens_for(40, 9), 4)
    second = Request(1, tokens_for(41, 12), 4)
    assert server.admit(first)
    kept = [leaf[:, 0].clone() for leaf in server.cache]
    assert not any(bool(leaf[:, 1].any()) for leaf in server.cache)
    assert server.admit(second)
    assert all(torch.equal(leaf[:, 0], k) for leaf, k in zip(server.cache, kept))
    _, alone = tm.prefill(tp, second.prompt[None, :], cache_len=20)
    assert all(torch.equal(leaf[:, 1], a[:, 0]) for leaf, a in zip(server.cache, alone))
    assert server.length is None
