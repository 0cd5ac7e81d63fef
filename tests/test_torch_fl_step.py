"""DAG-FL over the model zoo (``repro_torch.sharding.fl_step``) against the
reference's ``repro.sharding.fl_step``, on the CPU.

The port takes the selection's uniform draw as a tensor; the tests feed the
reference's own, ``jax.random.uniform(k_sel, (N, N), minval=1e-9,
maxval=1.0)`` with ``k_sel`` the first half of ``jax.random.split(key)``, as
its step draws it (the ring's (N, W) likewise), and the reference's
node-stacked weights (``jax.vmap(model.init)``) through ``params_from_jax``.

Selection (C, and so the chosen nodes), approvals and the frontier's
integer fields and times must be equal; so must the scores, which are
exact ratios of hit counts, and the metrics, up to the entropy's log (an
ulp). Parameters after two steps (reduced qwen3-0.6b in f32, Zipf tokens,
lr 0.3) within 1e-5 of their scale: the gradients' sums run in other orders
(tests/test_torch_train_step.py). Eq. (1) in bf16 within two bf16 units of
the value (each side rounds its bf16 product once, in its own order); after
two steps with bf16 aggregation within two bf16 units (2^-8 relative) of
each leaf's largest value, since the second step's gradients see the first
step's rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DagFLConfig as JDagFLConfig
from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import build_model as j_build
from repro.sharding import fl_step as j_fl
from repro_torch.configs import ARCHS, DagFLConfig, TrainConfig
from repro_torch.kernels import cuda_build
from repro_torch.models import build_model
from repro_torch.models.transformer import params_from_jax
from repro_torch.sharding import fl_step as t_fl

N, ALPHA, K = 4, 3, 2
LR = 0.3
PARAM_TOL = 1e-5


def frontier_pair(rng, n, stale_every=0, ties=True):
    """A later round's frontier on both sides: scores from a few levels
    (ties), publish times of which every ``stale_every``-th is stale."""
    levels = np.array([0.0, 0.25, 0.5, 0.75], np.float32) if ties else None
    scores = (rng.choice(levels, (n, n)) if ties else rng.random((n, n))).astype(np.float32)
    now = np.float32(6.0)
    publish = np.full((n,), 5.0, np.float32)
    if stale_every:
        publish[::stale_every] = 1.0
    ints = [rng.integers(0, 4, n).astype(np.int32) for _ in range(3)]
    j = j_fl.Frontier(jnp.asarray(scores), jnp.asarray(publish), *map(jnp.asarray, ints),
                      jnp.asarray(now))
    t = t_fl.Frontier(torch.from_numpy(scores), torch.from_numpy(publish),
                      *map(torch.from_numpy, ints), torch.tensor(now))
    return j, t


def check_selection(sel, C_ref):
    C_ref = np.asarray(C_ref)
    assert np.array_equal(sel.C.numpy(), C_ref)
    # slots and weights are C's nonzeros, each once (the fallback: i itself)
    dense = np.zeros_like(C_ref)
    for i in range(C_ref.shape[0]):
        for s, w in zip(sel.slots[i].tolist(), sel.weights[i].tolist()):
            dense[i, s] += w
    assert np.array_equal(dense, C_ref)
    assert sel.slots.dtype == torch.int32 and sel.weights.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [2, 4, 7])
def test_select_peers_matches_the_reference_on_its_draws(seed, n):
    rng = np.random.default_rng(seed * 10 + n)
    jf, tf = frontier_pair(rng, n, stale_every=3)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), (n, n), minval=1e-9,
                                      maxval=1.0))
    C_ref = j_fl.select_peers(jf, jax.random.PRNGKey(seed), ALPHA, K, 2.0)
    sel = t_fl.select_peers(tf, ALPHA, K, 2.0, draw=torch.from_numpy(u))
    check_selection(sel, C_ref)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_round_zero_and_the_self_fallback(n):
    rng = np.random.default_rng(n)
    # round 0: every peer fresh, all scores 0 (finite): k peers each, as the reference
    jf, tf = j_fl.init_frontier(n), t_fl.init_frontier(n, device="cpu")
    key = jax.random.PRNGKey(9)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n, n), minval=1e-9, maxval=1.0)))
    check_selection(t_fl.select_peers(tf, ALPHA, K, 1e9, draw=u),
                    j_fl.select_peers(jf, key, ALPHA, K, 1e9))
    # nobody fresh: every node falls back to itself, C = I
    jf, tf = frontier_pair(rng, n)
    sel = t_fl.select_peers(tf, ALPHA, K, -1.0, draw=u)
    check_selection(sel, j_fl.select_peers(jf, key, ALPHA, K, -1.0))
    assert np.array_equal(sel.C.numpy(), np.eye(n, dtype=np.float32))


def test_uniform_draw():
    u = t_fl.uniform_draw((3, 3), 5, torch.device("cpu"))
    assert torch.equal(u, t_fl.uniform_draw((3, 3), 5, torch.device("cpu")))
    assert float(u.min()) >= 1e-9 and float(u.max()) < 1.0 and u.dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        t_fl.uniform_draw((3, 3), torch.zeros(3, 4), torch.device("cpu"))


@pytest.mark.parametrize("leaf_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("agg_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_gather_route_against_the_einsum(leaf_dtype, agg_dtype, seed):
    """Eq. (1) through ``fedavg_gather`` (its plain version here) against the
    port's einsum and the reference's, k = 2 and k = 3 (weights 1/3)."""
    rng = np.random.default_rng(seed)
    n = 5
    jf, tf = frontier_pair(rng, n, stale_every=4, ties=False)
    key = jax.random.PRNGKey(seed)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n, n), minval=1e-9, maxval=1.0)))
    leaves = {"a": rng.standard_normal((n, 7, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal((n, 33)).astype(np.float32)}}
    j_dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    for k in (2, 3):
        sel = t_fl.select_peers(tf, 4, k, 2.0, draw=u)
        C = j_fl.select_peers(jf, key, 4, k, 2.0)
        stacked = {"a": torch.from_numpy(leaves["a"]).to(leaf_dtype),
                   "b": {"c": torch.from_numpy(leaves["b"]["c"]).to(leaf_dtype)}}
        want = j_fl.aggregate(C, jax.tree_util.tree_map(
            lambda x: jnp.asarray(x.float().numpy()).astype(j_dtype[leaf_dtype]), stacked),
            dtype=j_dtype[agg_dtype])
        before = cuda_build.LAUNCHES["fedavg_gather"]
        got = t_fl.aggregate(sel, stacked, "gather", agg_dtype)
        assert cuda_build.LAUNCHES["fedavg_gather"] == before      # CPU: the plain version
        dense = t_fl.aggregate(sel, stacked, None, agg_dtype)      # CPU default: the einsum
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            w = np.asarray(w.astype(jnp.float32))
            g = got[path[0].key] if len(path) == 1 else got["b"]["c"]
            d = dense[path[0].key] if len(path) == 1 else dense["b"]["c"]
            assert g.dtype == leaf_dtype and g.shape == w.shape
            if leaf_dtype == torch.float32 and agg_dtype == torch.float32:
                bar = 1e-6 * np.maximum(np.abs(w), 1.0)
            else:
                bar = 2 * np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            assert np.all(np.abs(g.float().numpy() - w) <= bar), (k, path)
            assert np.all(np.abs(d.float().numpy() - w) <= bar), (k, path)
    with pytest.raises(ValueError, match="impl"):
        t_fl.aggregate(sel, stacked, "ring")


def two_steps(ring_window=0, microbatches=1, agg_dtype="float32", agg_impl=None):
    """Two steps of both sides from the reference's stacked weights and
    draws; returns (reference, port) states after each step."""
    cfg = ARCHS["qwen3-0.6b"].reduced()
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jm, tm = j_build(jcfg), build_model(cfg)
    stacked = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(0), N))
    tst = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, stacked), device="cpu")
    j_step = jax.jit(j_fl.make_dagfl_train_step(
        jm, jcfg, JTrainConfig(optimizer="sgd", learning_rate=LR),
        JDagFLConfig(num_nodes=N, alpha=ALPHA, k=K, tau_max=1e9), N, microbatches=microbatches,
        agg_dtype=getattr(jnp, agg_dtype), ring_window=ring_window))
    t_step = t_fl.make_dagfl_train_step(
        tm, cfg, TrainConfig(optimizer="sgd", learning_rate=LR),
        DagFLConfig(num_nodes=N, alpha=ALPHA, k=K, tau_max=1e9), N, agg_impl=agg_impl,
        microbatches=microbatches, agg_dtype=getattr(torch, agg_dtype), ring_window=ring_window)
    rng = np.random.default_rng(1)
    val = (rng.zipf(1.3, (N, 1, 32)) % cfg.vocab_size).astype(np.int32)
    jf, tf = j_fl.init_frontier(N), t_fl.init_frontier(N, device="cpu")
    out = []
    for step in range(2):
        toks = (rng.zipf(1.3, (N, 2, 16)) % cfg.vocab_size).astype(np.int32)
        key = jax.random.PRNGKey(7 + step)
        k_sel, _ = jax.random.split(key)
        u = np.array(jax.random.uniform(k_sel, (N, ring_window or N), minval=1e-9,
                                          maxval=1.0))
        stacked, jf, jm_ = j_step(stacked, jf, {"tokens": toks, "labels": toks},
                                  {"tokens": val}, key)
        tst, tf, tm_ = t_step(tst, tf, {"tokens": toks, "labels": toks},
                              {"tokens": torch.from_numpy(val)}, torch.from_numpy(u))
        out.append(((stacked, jf, jm_), (tst, tf, tm_)))
    return out


def assert_same_step(ref, port, param_tol=PARAM_TOL, bf16=False):
    (stacked, jf, jm_), (tst, tf, tm_) = ref, port
    for name in jf._fields:
        assert np.array_equal(np.asarray(getattr(jf, name)), getattr(tf, name).numpy()), name
    assert tf.approval_count.dtype == tf.total_published.dtype == torch.int32
    assert float(tm_["mean_val_acc"]) == float(jm_["mean_val_acc"])
    assert abs(float(tm_["selection_entropy"]) - float(jm_["selection_entropy"])) <= 1e-6
    for path, w in jax.tree_util.tree_flatten_with_path(stacked)[0]:
        w = np.asarray(w)
        g = tst
        for key in path:
            g = g[key.key]
        bar = param_tol * max(1.0, np.abs(w).max())
        if bf16:          # the next step's gradients see the rounding: the leaf's scale
            bar = bar + 2 * 2.0 ** -8 * np.abs(w).max()
        assert np.all(np.abs(g.numpy() - w) <= bar), path


@pytest.mark.parametrize("agg_impl", [None, "gather"])
def test_two_steps_match_the_reference(agg_impl):
    runs = two_steps(agg_impl=agg_impl)
    for ref, port in runs:
        assert_same_step(ref, port)
    # the scores moved off zero, so round 1 chose by accuracy
    assert float(runs[0][1][1].scores.abs().sum()) > 0


def test_two_ring_steps_match_the_reference():
    for ref, port in two_steps(ring_window=2):
        assert_same_step(ref, port)
        assert float(port[2]["selection_entropy"]) == 0.0


def test_two_microbatched_steps_match_the_reference():
    for ref, port in two_steps(microbatches=2):
        assert_same_step(ref, port)


def test_two_steps_with_bf16_aggregation_match_the_reference():
    for ref, port in two_steps(agg_dtype="bfloat16"):
        assert_same_step(ref, port, bf16=True)
