"""The training entry point (``repro_torch.launch.train``) on the CPU, and against
the reference's ``repro.launch.train``.

``run`` takes the reference's node-stacked weights (``params``) and its
selection draws (``draws``: step t's ``jax.random.uniform`` of the first
half of ``split(PRNGKey(seed * 7 + t))``); the token streams are the same
numpy ``TokenSampler``s on both sides. Two steps of reduced qwen3-0.6b (f32)
then give the reference's frontier: scores, approvals, counters and times
equal, parameters within 1e-5 of their scale (the gradients' sums run in
other orders).
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.launch import train as j_train
from repro.models import build_model as j_build
from repro_torch.checkpoint import load_meta, load_pytree
from repro_torch.configs import get_arch
from repro_torch.launch import train as t_train
from repro_torch.models.transformer import params_from_jax
from repro_torch.sharding import fl_step as t_fl

PARAM_TOL = 1e-5


def test_run_trains_on_the_cpu():
    cfg = get_arch("qwen3-0.6b").reduced()
    first = t_train.init_stacked(t_train.build_model(cfg), 4, 0, torch.device("cpu"))
    out = t_train.run(cfg, steps=2, device="cpu", seq_len=32)
    assert len(out.history) == 2
    for entry in out.history:
        assert set(entry) == {"mean_val_acc", "selection_entropy", "s"}
        assert all(np.isfinite(v) for v in entry.values())
    assert out.stacked["embed"].shape == (4,) + first["embed"].shape[1:]
    assert not torch.equal(out.stacked["layers"]["mlp"]["wi"], first["layers"]["mlp"]["wi"])
    assert out.frontier.total_published.tolist() == [2, 2, 2, 2]
    assert float(out.frontier.now) == 2.0
    # the same seed: the same run
    again = t_train.run(cfg, steps=2, device="cpu", seq_len=32)
    assert torch.equal(again.stacked["embed"], out.stacked["embed"])
    assert torch.equal(again.frontier.scores, out.frontier.scores)


def test_run_with_the_references_weights_and_draws_gives_its_frontier():
    cfg = get_arch("qwen3-0.6b").reduced()
    jcfg = JConfig(**dataclasses.asdict(cfg))
    nodes, seed, steps = 4, 0, 2
    j_stacked, j_frontier = j_train.run(jcfg, steps=steps, nodes=nodes, seq_len=64, lr=0.3,
                                        seed=seed, log_every=10)
    init = jax.vmap(j_build(jcfg).init)(jax.random.split(jax.random.PRNGKey(seed), nodes))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, init), device="cpu")

    def draws(step):
        k_sel, _ = jax.random.split(jax.random.PRNGKey(seed * 7 + step))
        return torch.from_numpy(np.array(jax.random.uniform(
            k_sel, (nodes, nodes), minval=1e-9, maxval=1.0)))

    out = t_train.run(cfg, steps=steps, nodes=nodes, seq_len=64, lr=0.3, seed=seed,
                      device="cpu", params=params, draws=draws)
    for name in t_fl.Frontier._fields:
        assert np.array_equal(np.asarray(getattr(j_frontier, name)),
                              getattr(out.frontier, name).numpy()), name
    assert float(out.frontier.scores.sum()) > 0           # round 2 chose by accuracy
    for path, w in jax.tree_util.tree_flatten_with_path(j_stacked)[0]:
        w = np.asarray(w)
        g = out.stacked
        for key in path:
            g = g[key.key]
        assert np.abs(g.numpy() - w).max() <= PARAM_TOL * max(1.0, np.abs(w).max()), path


def test_small_100m_is_the_references():
    assert dataclasses.asdict(t_train.small_100m()) == dataclasses.asdict(j_train.small_100m())


@pytest.mark.parametrize("name,item", [("rwkv6-7b", "A.13, part 3"),
                                       ("deepseek-v2-236b", "A.13, part 4"),
                                       ("zamba2-2.7b", "A.13, part 4")])
def test_untrainable_archs_raise_with_their_roadmap_item(name, item):
    with pytest.raises(NotImplementedError, match=item):
        t_train.run(get_arch(name).reduced(), steps=1, device="cpu")


def test_main_writes_a_checkpoint(tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "train")
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "1",
        "--nodes", "3", "--seq-len", "16", "--batch-per-node", "2", "--checkpoint", path])
    t_train.main()
    assert "checkpoint ->" in capsys.readouterr().out
    cfg = get_arch("olmo-1b").reduced()
    template = {"params": t_train.init_stacked(t_train.build_model(cfg), 3, 0,
                                               torch.device("cpu")),
                "frontier": t_fl.init_frontier(3, device="cpu")}
    back = load_pytree(path, template)
    assert back["frontier"].total_published.tolist() == [1, 1, 1]
    assert load_meta(path) == {"arch": cfg.name, "steps": 1}
