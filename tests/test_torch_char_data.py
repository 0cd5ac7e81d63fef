"""The port's char corpus, samplers and char population against the reference's.

All of it is host numpy: on the same seeds the arrays, the behaviors and
every later draw of a node's stream are bitwise the reference's.
"""
import dataclasses

import numpy as np
import pytest

from repro import data as j_data
from repro.data import pipeline as j_pipe
from repro.data import synthetic as j_syn
from repro.fl import experiments as j_exp
from repro.fl import nodes as j_nodes
from repro_torch import data as t_data
from repro_torch.data import pipeline as t_pipe
from repro_torch.data import synthetic as t_syn
from repro_torch.fl import experiments as t_exp
from repro_torch.fl import nodes as t_nodes


def test_data_package_exports_the_reference_names():
    assert sorted(t_data.__all__) == sorted(j_data.__all__)
    assert t_syn.VOCAB == j_syn.VOCAB == 90
    assert all(getattr(t_data, name) is not None for name in t_data.__all__)


@pytest.mark.parametrize("num_roles,seed", [(30, 0), (7, 3)])
def test_char_corpus_matrices_and_lines(num_roles, seed):
    jc, tc = j_syn.CharCorpus(num_roles, seed), t_syn.CharCorpus(num_roles, seed)
    assert tc.num_roles == jc.num_roles == num_roles
    assert len(tc.mats) == num_roles
    for a, b in zip(jc.mats, tc.mats):
        assert b.dtype == np.float64
        np.testing.assert_array_equal(b, a)
    for role in (0, num_roles - 1, num_roles + 2):        # roles wrap around
        got = tc.lines(np.random.default_rng(seed + role), role, 5, line_len=17)
        want = jc.lines(np.random.default_rng(seed + role), role, 5, line_len=17)
        assert got.dtype == np.int32 and got.shape == (5, 17)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [2, 9])
def test_char_partition(seed):
    jc, tc = j_syn.CharCorpus(6, 1), t_syn.CharCorpus(6, 1)
    got = t_syn.char_partition(tc, 5, 12, seed=seed)
    want = j_syn.char_partition(jc, 5, 12, seed=seed)
    assert len(got) == len(want) == 5
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_samplers_draw_the_same_batches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, 37).astype(np.int32)
    js, ts = j_pipe.MinibatchSampler(x, y, 9, seed=5), t_pipe.MinibatchSampler(x, y, 9, seed=5)
    jk, tk = j_pipe.TokenSampler(90, 3, 11, seed=4), t_pipe.TokenSampler(90, 3, 11, seed=4)
    lines = rng.integers(0, 90, (23, 80)).astype(np.int32)
    jl, tl = j_pipe.lines_to_batches(lines, 6, seed=8), t_pipe.lines_to_batches(lines, 6, seed=8)
    for _ in range(4):
        for a, b in ((js.next(), ts.next()), (jk.next(), tk.next()), (next(jl), next(tl))):
            assert sorted(a) == sorted(b)
            for key in a:
                assert b[key].dtype == a[key].dtype
                np.testing.assert_array_equal(b[key], a[key])


def _same_nodes(jn, tn, steps=3, size=5, val=7):
    assert len(jn) == len(tn)
    for a, b in zip(jn, tn):
        assert (b.node_id, b.behavior) == (a.node_id, a.behavior)
        for part in ("train", "test"):
            assert sorted(getattr(a, part)) == sorted(getattr(b, part))
            for key, arr in getattr(a, part).items():
                assert getattr(b, part)[key].dtype == arr.dtype
                np.testing.assert_array_equal(getattr(b, part)[key], arr)
        # the node's own stream: the next epoch and validation batch
        for key, arr in a.epoch(steps, size).items():
            np.testing.assert_array_equal(b.epoch(steps, size)[key], arr)
        for key, arr in a.val_batch(val).items():
            np.testing.assert_array_equal(b.val_batch(val)[key], arr)


@pytest.mark.parametrize("abnormal,num_abnormal", [("normal", 0), ("lazy", 2), ("poisoning", 3)])
def test_build_char_population(abnormal, num_abnormal):
    jc, tc = j_syn.CharCorpus(8, 2), t_syn.CharCorpus(8, 2)
    kw = dict(abnormal=abnormal, num_abnormal=num_abnormal, lines_per_node=20, seed=3)
    jn = j_nodes.build_char_population(jc, 6, **kw)
    tn = t_nodes.build_char_population(tc, 6, **kw)
    assert sum(n.behavior == abnormal for n in tn) == (num_abnormal or 6)
    _same_nodes(jn, tn)


def test_build_char_population_refuses_backdoor():
    for mod, syn in ((j_nodes, j_syn), (t_nodes, t_syn)):
        with pytest.raises(AssertionError, match="CNN"):
            mod.build_char_population(syn.CharCorpus(3, 0), 4, abnormal="backdoor",
                                      num_abnormal=1)


@pytest.mark.parametrize("seed,n", [(0, 256), (5, 13)])
def test_backdoor_eval_set(seed, n):
    jg, tg = j_syn.MnistLike(image_size=16, seed=seed), t_syn.MnistLike(image_size=16, seed=seed)
    want = j_nodes.backdoor_eval_set(jg, np.random.default_rng(seed + 77), n)
    got = t_nodes.backdoor_eval_set(tg, np.random.default_rng(seed + 77), n)
    assert sorted(got) == sorted(want) == ["x", "y"]
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert np.all(got["x"][:, :3, :3, :] == 1.0)             # the trigger square


@pytest.mark.parametrize("abnormal,num_abnormal", [("normal", 0), ("poisoning", 2)])
def test_make_lstm_setup(abnormal, num_abnormal):
    kw = dict(num_nodes=5, abnormal=abnormal, num_abnormal=num_abnormal, seed=1)
    jt, jn, jv, jc = j_exp.make_lstm_setup(**kw)
    tt, tn, tv, tc = t_exp.make_lstm_setup(**kw)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert sorted(tv) == ["tokens"] and tv["tokens"].shape == (288, 80)
    np.testing.assert_array_equal(tv["tokens"], jv["tokens"])
    for a, b in zip(jc.mats, tc.mats):
        np.testing.assert_array_equal(b, a)
    _same_nodes(jn, tn)
