"""The port's checkpoints (``repro_torch.checkpoint``) against the reference's
``repro.checkpoint``, on the CPU.

The file format is the reference's: the same key strings
(``jax.tree_util.keystr``), the same leaf order, the same arrays (bf16 as
the 2-byte void ``|V2`` the reference's ``np.savez`` writes). So a file
either package writes loads into the other's template, bitwise, except that
the reference's own ``load_pytree`` cannot cast a ``|V2`` leaf back (its bf16
files included), which the port can.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load
from repro.checkpoint import save_pytree as j_save
from repro.sharding import fl_step as j_fl
from repro_torch.checkpoint import load_meta, load_pytree, save_pytree
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.optim import OptState
from repro_torch.sharding import fl_step as t_fl


def trees(rng, bf16=True):
    """The same values as a reference tree and a port tree: dicts (keys out
    of order), a list, a tuple, a NamedTuple, None, 0-d and int leaves."""
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.integers(-5, 5, (6,)).astype(np.int32)
    c = rng.standard_normal((2, 2, 3)).astype(np.float32)
    d = rng.standard_normal((5,)).astype(np.float32)
    scores = rng.random((3, 3)).astype(np.float32)
    jf = j_fl.Frontier(jnp.asarray(scores), jnp.zeros(3), jnp.arange(3, dtype=jnp.int32),
                       jnp.ones(3, jnp.int32), jnp.zeros(3, jnp.int32), jnp.float32(2.0))
    tf = t_fl.Frontier(torch.from_numpy(scores), torch.zeros(3),
                       torch.arange(3, dtype=torch.int32), torch.ones(3, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32), torch.tensor(2.0))
    jt = {"params": {"zeta": jnp.asarray(a), "alpha": [jnp.asarray(b), (jnp.asarray(c),)],
                     "none": None},
          "frontier": jf, "step": jnp.int32(7)}
    tt = {"params": {"zeta": torch.from_numpy(a), "alpha": [torch.from_numpy(b),
                                                             (torch.from_numpy(c),)],
                     "none": None},
          "frontier": tf, "step": torch.tensor(7, dtype=torch.int32)}
    if bf16:
        jt["params"]["half"] = jnp.asarray(d).astype(jnp.bfloat16)
        tt["params"]["half"] = torch.from_numpy(d).to(torch.bfloat16)
    return jt, tt


def flat_equal(got, want):
    """Every leaf of the port tree ``got`` bitwise the reference's ``want``."""
    gl = [(k, v) for k, v in _port_leaves(got)]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl]
    for (_, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        if g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert np.array_equal(g.numpy(), w) and g.numpy().dtype == w.dtype


def _port_leaves(tree):
    from repro_torch.checkpoint.io import _flatten
    return _flatten(tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_round_trip_is_bitwise(tmp_path, seed):
    _, tt = trees(np.random.default_rng(seed))
    save_pytree(str(tmp_path / "ck"), tt, meta={"arch": "x", "steps": 3})
    template = jax.tree_util.tree_map(torch.zeros_like, tt)
    back = load_pytree(str(tmp_path / "ck"), template)
    assert isinstance(back["frontier"], t_fl.Frontier) and back["params"]["none"] is None
    assert isinstance(back["params"]["alpha"], list) and isinstance(back["params"]["alpha"][1],
                                                                    tuple)
    for (k1, a), (k2, b) in zip(_port_leaves(back), _port_leaves(tt)):
        assert k1 == k2 and a.dtype == b.dtype and torch.equal(a, b)
    assert load_meta(str(tmp_path / "ck")) == {"arch": "x", "steps": 3}
    assert load_meta(str(tmp_path / "nothing")) is None
    # ".npz" given or not
    assert torch.equal(load_pytree(str(tmp_path / "ck.npz"), template)["step"], tt["step"])


def test_key_strings_and_files_equal_the_references(tmp_path):
    jt, tt = trees(np.random.default_rng(2))
    j_save(str(tmp_path / "ref"), jt)
    save_pytree(str(tmp_path / "port"), tt)
    ref, port = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert json.loads(str(port["__keys__"])) == json.loads(str(ref["__keys__"]))
    assert "['params']['alpha'][1][0]" in json.loads(str(port["__keys__"]))
    assert "['frontier'].scores" in json.loads(str(port["__keys__"]))
    assert sorted(ref.files) == sorted(port.files)
    for name in ref.files:
        assert ref[name].dtype == port[name].dtype and ref[name].tobytes() == port[name].tobytes()


def test_the_references_file_loads_into_the_port(tmp_path):
    jt, tt = trees(np.random.default_rng(3))
    j_save(str(tmp_path / "ref"), jt)
    back = load_pytree(str(tmp_path / "ref"), jax.tree_util.tree_map(torch.zeros_like, tt))
    flat_equal(back, jt)
    # into another dtype: the template's (bf16 bits to f32 exactly, f32 to bf16 rounded)
    template = jax.tree_util.tree_map(torch.zeros_like, tt)
    template["params"]["half"] = torch.zeros(5)
    template["params"]["zeta"] = torch.zeros((3, 4), dtype=torch.bfloat16)
    other = load_pytree(str(tmp_path / "ref"), template)
    assert other["params"]["half"].dtype == torch.float32
    assert torch.equal(other["params"]["half"], tt["params"]["half"].float())
    assert torch.equal(other["params"]["zeta"], tt["params"]["zeta"].to(torch.bfloat16))


def test_the_ports_file_loads_into_the_reference(tmp_path):
    jt, tt = trees(np.random.default_rng(4), bf16=False)   # the reference loads no bf16
    save_pytree(str(tmp_path / "port"), tt)
    back = j_load(str(tmp_path / "port"), jax.tree_util.tree_map(jnp.zeros_like, jt))
    flat_equal(tt, back)


def test_structure_mismatch_raises_the_references_error(tmp_path):
    jt, tt = trees(np.random.default_rng(5), bf16=False)
    save_pytree(str(tmp_path / "port"), tt)
    j_save(str(tmp_path / "ref"), jt)
    wrong_t = jax.tree_util.tree_map(torch.zeros_like, tt)
    wrong_t["params"]["extra"] = torch.zeros(1)
    wrong_j = jax.tree_util.tree_map(jnp.zeros_like, jt)
    wrong_j["params"]["extra"] = jnp.zeros(1)
    with pytest.raises(ValueError) as ours:
        load_pytree(str(tmp_path / "ref"), wrong_t)
    with pytest.raises(ValueError) as theirs:
        j_load(str(tmp_path / "port"), wrong_j)
    assert "checkpoint structure mismatch" in str(ours.value)
    assert str(ours.value) == str(theirs.value)


def test_model_parameters_and_optimizer_state_round_trip(tmp_path):
    cfg = get_arch("qwen3-0.6b").reduced()
    params = build_model(cfg).init(3, device="cpu")
    state = OptState(torch.tensor(4, dtype=torch.int32), None, None)
    tree = {"params": params, "opt": state, "frontier": t_fl.init_frontier(4, device="cpu")}
    save_pytree(str(tmp_path / "m"), tree)
    back = load_pytree(str(tmp_path / "m"), jax.tree_util.tree_map(torch.zeros_like, tree))
    assert back["opt"].mu is None and int(back["opt"].step) == 4
    assert torch.equal(back["params"]["layers"]["attn"]["wq"], params["layers"]["attn"]["wq"])
    assert torch.equal(back["frontier"].scores, tree["frontier"].scores)
