"""The port's consensus core against the reference, stage by stage.

The same ledger, bank and draws go into both sides. The reference's
threefry uniforms are made with JAX and fed to the port as tensors, so tip
selection must pick the same rows. Integer and boolean outputs must match
bitwise, accuracies exactly (they are multiples of 1/val_size), float ledger
columns within 1e-6 relative.

The auth tag is an f32 dot over every parameter with a cos projection;
the two sides sum it in different orders, so tags agree to 1e-5 of the sum
of the absolute terms, well inside ``authenticate``'s own 1e-3 tolerance.
Trained parameters agree to 1e-5 (four SGD steps of an f32 CNN computed by
two libraries).

The model-space screen (``parameter_outlier_scores`` on the pairwise
distances) sums N products in another order on each side, and a distance's
diagonal cancels to near 0: it is held within 1e-6 of the sum of the
absolute terms of each entry, ``sq_i + sq_j + 2 |x_i . x_j|``. The
credit-weighted tip scores take a log: within 1e-6, exact where the credit
is 1.0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DagFLConfig as JConfig
from repro.core import anomaly as j_anomaly
from repro.core import bank as j_bank
from repro.core import consensus as j_cons
from repro.core import controller as j_ctrl
from repro.core import dag as j_dag
from repro.core import validation as j_val
from repro.fl import tasks as j_tasks
from repro_torch.configs.base import DagFLConfig as TConfig
from repro_torch.core import aggregation as t_agg
from repro_torch.core import anomaly as t_anomaly
from repro_torch.core import bank as t_bank
from repro_torch.core import consensus as t_cons
from repro_torch.core import controller as t_ctrl
from repro_torch.core import dag as t_dag
from repro_torch.core import validation as t_val
from repro_torch.fl import tasks as t_tasks

INT_FIELDS = ("publisher", "approvals", "approvers", "approval_count", "model_slot", "count",
              "published_per_node", "contributing_m0", "contributing_m1")


def assert_dag_equal(jd, td, tag_rtol=1e-6):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), err_msg=f)
    np.testing.assert_array_equal(td.publish_time.numpy(), np.asarray(jd.publish_time))
    np.testing.assert_array_equal(td.accuracy.numpy(), np.asarray(jd.accuracy))
    np.testing.assert_allclose(td.auth_tag.numpy(), np.asarray(jd.auth_tag), rtol=tag_rtol,
                               atol=tag_rtol)


def jax_uniform(key, cap):
    return jax.random.uniform(key, (cap,), minval=1e-9, maxval=1.0)


def to_t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("values", [
    [.5, .75, .75, -np.inf, .75, .5],
    list(np.round(np.random.default_rng(0).uniform(0, 1, 40) * 8) / 8),
    [-np.inf] * 7,
])
def test_top_k_breaks_ties_to_the_lower_index(values):
    x = np.asarray(values, np.float32)
    for k in (1, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = t_dag.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert t_dag.top_k(torch.tensor([.5, .75, .75, -np.inf, .75, .5]), 3)[1].tolist() == [1, 2, 4]


_j_publish = jax.jit(j_dag.publish)


def _random_ledgers(steps=25, cap=16, k=2, nodes=5, seed=0):
    """Replay the same publishes on both sides; yields (jax dag, torch dag) per step."""
    rng = np.random.default_rng(seed)
    jd = j_dag.empty_dag(cap, k, nodes)
    td = t_dag.empty_dag(cap, k, nodes)
    for step in range(steps):
        count = int(jd.count)
        older = rng.integers(0, max(min(count, cap), 1), k) if count else np.full(k, -1)
        appr = np.where(rng.uniform(size=k) < 0.2, -1, older).astype(np.int32)
        if step % 7 == 3:
            appr[:] = appr[0]                                  # a duplicate approval
        pub = int(rng.integers(0, nodes))
        t = np.float32(step * 1.7 + rng.uniform())
        acc, tag = np.float32(rng.uniform()), np.float32(rng.normal() * 100)
        slot = count % cap
        jd = _j_publish(jd, jnp.int32(pub), jnp.float32(t), jnp.asarray(appr), jnp.float32(acc),
                        jnp.float32(tag), jnp.int32(slot))
        before = tuple(x.clone() for x in td)
        td_new = t_dag.publish(td, pub, torch.tensor(t), torch.from_numpy(appr), torch.tensor(acc),
                               torch.tensor(tag), slot)
        for a, b in zip(before, td):                           # functional: input untouched
            assert torch.equal(a, b)
        td = td_new
        yield jd, td


def test_publish_matches_reference_through_ring_reuse():
    for jd, td in _random_ledgers():
        assert_dag_equal(jd, td, tag_rtol=0)


@pytest.mark.parametrize("bias", [False, True])
def test_select_tips_masks_and_anomaly_match_reference(bias):
    cap, nodes = 16, 5
    *_, (jd, td) = _random_ledgers(steps=21, cap=cap, nodes=nodes, seed=1)
    rng = np.random.default_rng(2)
    nb = rng.normal(size=nodes + 1).astype(np.float32) if bias else None
    for i, now in enumerate([20.0, 33.3, 41.0, 60.0]):
        key = jax.random.PRNGKey(i)
        jrows, jn = j_dag.select_tips(jd, key, 5, jnp.float32(now), 20.0,
                                      node_bias=None if nb is None else jnp.asarray(nb))
        trows, tn = t_dag.select_tips(td, to_t(jax_uniform(key, cap)), 5,
                                      torch.tensor(now, dtype=torch.float32), 20.0,
                                      node_bias=None if nb is None else torch.from_numpy(nb))
        np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
        assert int(tn) == int(jn)
        now_t = torch.tensor(now, dtype=torch.float32)
        np.testing.assert_array_equal(t_dag.tip_mask(td, now_t, 20.0).numpy(),
                                      np.asarray(j_dag.tip_mask(jd, jnp.float32(now), 20.0)))
        assert int(t_dag.num_tips(td, now_t, 20.0)) == int(j_dag.num_tips(jd, jnp.float32(now), 20.0))
    for m in (0, 1):
        np.testing.assert_array_equal(t_dag.isolated_mask(td, m).numpy(),
                                      np.asarray(j_dag.isolated_mask(jd, m)))
        np.testing.assert_allclose(t_anomaly.contribution_rates(td, m).numpy(),
                                   np.asarray(j_anomaly.contribution_rates(jd, m)), rtol=1e-6)
        jr, tr = j_anomaly.contribution_report(jd, m), t_anomaly.contribution_report(td, m)
        np.testing.assert_allclose(tr.rates.numpy(), np.asarray(jr.rates), rtol=1e-6)
        np.testing.assert_allclose(float(tr.mean_rate), float(jr.mean_rate), rtol=1e-6)
        np.testing.assert_array_equal(tr.flagged.numpy(), np.asarray(jr.flagged))
        np.testing.assert_allclose(t_anomaly.credit_scores(td, m).numpy(),
                                   np.asarray(j_anomaly.credit_scores(jd, m)), rtol=1e-6)
    rejects = rng.integers(0, 3, (nodes, nodes)).astype(np.int32)
    np.testing.assert_allclose(t_anomaly.rejection_credit(torch.from_numpy(rejects)).numpy(),
                               np.asarray(j_anomaly.rejection_credit(jnp.asarray(rejects))),
                               rtol=1e-6)


def _cnn_params(seed, task):
    return {k: np.asarray(v) for k, v in task.init(jax.random.PRNGKey(seed)).items()}


def test_checksum_authenticate_and_bank_copies_match_reference():
    task = j_tasks.bench_cnn_task()
    params = [_cnn_params(s, task) for s in range(4)]
    cap = 6
    j_write, j_checksum = jax.jit(j_bank.bank_write), jax.jit(j_bank.auth_checksum)
    jb = j_bank.init_bank({k: jnp.asarray(v) for k, v in params[0].items()}, cap)
    tb = t_bank.init_bank(t_tasks.params_from_jax(params[0], "cpu"), cap)
    tags = np.zeros(cap, np.float32)
    for s, p in enumerate(params):
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        jb = j_write(jb, jnp.asarray(s), jp)
        tb = t_bank.bank_write(tb, s, t_tasks.params_from_jax(p, "cpu"))
        tags[s] = np.asarray(j_checksum(jp))
        tag_t = float(t_bank.auth_checksum(t_tasks.params_from_jax(p, "cpu")))
        flat = np.asarray(t_agg.flatten_params(t_tasks.params_from_jax(p, "cpu")))
        assert abs(tag_t - tags[s]) <= 1e-5 * np.abs(flat).sum()
    # slot 2 is tampered with after publication: its tag no longer matches
    bad = {k: v + 0.01 for k, v in params[2].items()}
    jb = j_write(jb, jnp.asarray(2), {k: jnp.asarray(v) for k, v in bad.items()})
    tb = t_bank.bank_write(tb, 2, t_tasks.params_from_jax(bad, "cpu"))
    slots = np.array([0, 2, -1, 3, 1], np.int32)
    ok_j = jax.jit(j_val.authenticate)(jnp.asarray(tags), jb, jnp.asarray(slots))
    ok_t = t_val.authenticate(torch.from_numpy(tags), tb, torch.from_numpy(slots))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.tolist() == [True, False, False, True, True]
    # reads are copies: writing into them leaves the stored model intact
    row0 = tb.rows[0].clone()
    t_bank.bank_read(tb, 0)["fc"].add_(1.0)
    t_bank.bank_gather(tb, torch.tensor([0, 0])).add_(1.0)
    assert torch.equal(tb.rows[0], row0)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("weighted", [False, True])
def test_prepare_commit_and_controller_match_reference(weighted):
    """Six iterations of Algorithm 2 + two Algorithm-1 checks, compared stage by stage."""
    from repro.fl.experiments import make_cnn_setup

    jt, nodes, gval, _ = make_cnn_setup(num_nodes=4, seed=0)
    tt = t_tasks.CNNTask(**{f: getattr(jt, f) for f in jt.__dataclass_fields__})
    kw = dict(num_nodes=4, capacity=16, alpha=4, k=2, tau_max=20.0)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    params0 = _cnn_params(0, jt)

    jctrl = j_ctrl.Controller(jcfg, jt.eval_fn)
    tctrl = t_ctrl.Controller(tcfg, tt.eval_fn, device="cpu")
    js = jctrl.genesis({k: jnp.asarray(v) for k, v in params0.items()}, _jb(gval))
    ts = tctrl.genesis(t_tasks.params_from_jax(params0, "cpu"), _tb(gval))
    assert_dag_equal(js.dag, ts.dag, tag_rtol=1e-5)

    jprep, jcommit = j_cons.make_dagfl_stages(jcfg, jt.eval_fn, j_tasks.make_epoch_train(jt),
                                              weighted)
    tprep, tcommit = t_cons.make_dagfl_stages(tcfg, tt.eval_fn, t_tasks.make_epoch_train(tt),
                                              weighted)
    jprep, jcommit = jax.jit(jprep), jax.jit(jcommit)
    jvalidator, tvalidator = j_val.make_validator(jt.eval_fn), t_val.make_validator(tt.eval_fn)
    jd, jb, td, tb = js.dag, js.bank, ts.dag, ts.bank
    bias = np.zeros(5, np.float32)
    rng = np.random.default_rng(0)
    for i in range(6):
        node = nodes[i % 4]
        now = np.float32(0.9 * i + 0.5)
        key = jax.random.PRNGKey(100003 + i)
        k_sel = jax.random.split(key)[0]
        u = to_t(jax_uniform(k_sel, 16))
        train, val = node.epoch(2, 16), node.val_batch(32)

        # stages 1-2 on their own: rows, slots, tags, accuracies
        jrows, _ = j_dag.select_tips(jd, k_sel, jcfg.alpha, jnp.float32(now), jcfg.tau_max)
        trows, _ = t_dag.select_tips(td, u, tcfg.alpha, torch.tensor(now), tcfg.tau_max)
        np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
        jslots = jnp.where(jrows >= 0, jd.model_slot[jnp.maximum(jrows, 0)], -1)
        tslots = torch.where(trows >= 0, td.model_slot[trows.clamp(min=0).long()], -1)
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        np.testing.assert_array_equal(
            t_val.authenticate(td.auth_tag, tb, tslots).numpy(),
            np.asarray(j_val.authenticate(jd.auth_tag, jb, jslots)))
        jaccs = jvalidator(jb, jslots, _jb(val))
        taccs = tvalidator(tb, tslots, _tb(val))
        np.testing.assert_array_equal(taccs.numpy(), np.asarray(jaccs))
        jchosen, _, _ = j_val.select_top_k(jaccs, jslots, jcfg.k)
        tchosen, _, _ = t_val.select_top_k(taccs, tslots, tcfg.k)
        np.testing.assert_array_equal(tchosen.numpy(), np.asarray(jchosen))

        # stages 1-3 as the loop runs them, then stage 4
        jp = jprep(jd, jb, jnp.float32(now), key, _jb(train), _jb(val), jnp.asarray(bias))
        tp = tprep(td, tb, torch.tensor(now), u, _tb(train), _tb(val), torch.from_numpy(bias))
        np.testing.assert_array_equal(tp.chosen_rows.numpy(), np.asarray(jp.chosen_rows))
        assert float(tp.new_accuracy) == float(jp.new_accuracy)
        assert int(tp.num_tips_seen) == int(jp.num_tips_seen)
        for name in jp.new_params:
            np.testing.assert_allclose(tp.new_params[name].numpy(), np.asarray(jp.new_params[name]),
                                       atol=1e-5, rtol=0)
        t1 = np.float32(now + rng.uniform(0.5, 2.0))
        jd, jb = jcommit(jd, jb, node.node_id, jnp.float32(t1), jp)
        td, tb = tcommit(td, tb, node.node_id, torch.tensor(t1), tp)
        assert_dag_equal(jd, td, tag_rtol=1e-5)

        if i % 3 == 2:                      # Algorithm 1 on the same ledger and draw
            js.dag, js.bank, ts.dag, ts.bank = jd, jb, td, tb
            ckey = jax.random.PRNGKey(i)
            js = jctrl.check(js, ckey, float(t1) + 1e-3, _jb(gval))
            ts = tctrl.check(ts, to_t(jax_uniform(ckey, 16)), float(t1) + 1e-3, _tb(gval))
            assert (ts.best_accuracy, ts.checks, ts.done) == (js.best_accuracy, js.checks, js.done)
            assert ts.aggregations == ts.checks
            for name in js.target_model:
                np.testing.assert_allclose(ts.target_model[name].numpy(),
                                           np.asarray(js.target_model[name]), atol=1e-5, rtol=0)


def test_iteration_is_prepare_then_commit_at_one_time():
    task = t_tasks.bench_cnn_task()
    cfg = TConfig(num_nodes=3, capacity=8, alpha=3, k=2)
    ctrl = t_ctrl.Controller(cfg, task.eval_fn, device="cpu")
    rng = np.random.default_rng(1)
    val = {"x": torch.from_numpy(rng.uniform(size=(8, 16, 16, 1)).astype(np.float32)),
           "y": torch.from_numpy(rng.integers(0, 10, 8).astype(np.int32))}
    train = {k: v[None] for k, v in val.items()}
    train_fn = t_tasks.make_epoch_train(task)
    u = torch.rand(8, generator=torch.Generator().manual_seed(0)) * (1 - 1e-9) + 1e-9

    def fresh():
        return ctrl.genesis(task.init(0, "cpu"), val)

    s = fresh()
    out = t_cons.make_dagfl_iteration(cfg, task.eval_fn, train_fn)(
        s.dag, s.bank, 1, torch.tensor(2.0), u, train, val)
    s2 = fresh()
    prep, commit = t_cons.make_dagfl_stages(cfg, task.eval_fn, train_fn)
    p = prep(s2.dag, s2.bank, torch.tensor(2.0), u, train, val)
    dag2, bank2 = commit(s2.dag, s2.bank, 1, torch.tensor(2.0), p)
    for a, b in zip(out.dag, dag2):
        assert torch.equal(a, b)
    assert torch.equal(out.bank.rows, bank2.rows)
    assert torch.equal(out.chosen_rows, p.chosen_rows) and int(out.dag.count) == 2


# ---------------------------------------------------------------------------
# the §VI model-space screen and credit-weighted selection
# ---------------------------------------------------------------------------

# model_distance sums N products in another order on each side (and the
# diagonal cancels to near 0), so it is held to a bound on the sum of the
# absolute terms of each entry, sq_i + sq_j + 2 |x_i . x_j|
DIST_RTOL = 1e-6


def distance_scale(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    sq = (x * x).sum(1)
    return sq[:, None] + sq[None, :] + 2.0 * np.abs(x @ x.T)


def candidate_models(rng, k, n, poisoned=(), zero_row=False):
    """k flattened candidate models: a normal cluster around one centre, and
    the ``poisoned`` rows far from it (a boosted, sign-flipped update)."""
    centre = rng.standard_normal(n).astype(np.float32) * 0.05
    x = centre + rng.standard_normal((k, n)).astype(np.float32) * 0.01
    for i in poisoned:
        x[i] = -4.0 * x[i] + rng.standard_normal(n).astype(np.float32) * 0.2
    if zero_row:
        x[-1] = 0.0
    return x


@pytest.mark.parametrize("k,n,poisoned,zero_row", [
    (5, 20_000, (3,), False), (5, 16_384, (), True), (1, 777, (), False),
    (16, 40_001, (0, 9, 15), True), (2, 3, (1,), False)])
def test_parameter_outlier_scores_match_reference(k, n, poisoned, zero_row):
    """The reference runs its Pallas kernel in interpret mode, as its own
    tests do on the CPU; the port its plain version. Scores within
    DIST_RTOL of the mean of each row's off-diagonal scales; a lone poisoned
    candidate scores above every normal one."""
    rng = np.random.default_rng(k * 100 + n % 97)
    x = candidate_models(rng, k, n, poisoned, zero_row)
    want = np.asarray(j_anomaly.parameter_outlier_scores(jnp.asarray(x)))
    got = t_anomaly.parameter_outlier_scores(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (k,)
    scale = distance_scale(x)
    off = ~np.eye(k, dtype=bool)
    row_scale = (scale * off).sum(1) / max(k - 1, 1)
    assert (np.abs(got.numpy() - want) <= DIST_RTOL * row_scale + 1e-30).all()
    if len(poisoned) == 1 and k >= 3:   # one outlier: it scores above every normal model
        normal = [i for i in range(k) if i not in poisoned]
        assert got[poisoned[0]] > got[normal].max()
    if k == 1:
        assert got[0] == 0.0


def test_credit_weighted_tip_scores_match_reference():
    rng = np.random.default_rng(8)
    pub = rng.integers(-1, 6, 32).astype(np.int32)
    jd = j_dag.empty_dag(32, 2, 7)._replace(publisher=jnp.asarray(pub))
    td = t_dag.empty_dag(32, 2, 7)._replace(publisher=torch.from_numpy(pub))
    scores = rng.standard_normal(32).astype(np.float32)
    credits = np.clip(rng.random(7), 0.05, 1.0).astype(np.float32)
    credits[2] = 1.0
    want = np.asarray(j_anomaly.credit_weighted_tip_scores(jd, jnp.asarray(scores),
                                                           jnp.asarray(credits)))
    got = t_anomaly.credit_weighted_tip_scores(td, torch.from_numpy(scores),
                                               torch.from_numpy(credits))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[pub == 2], scores[pub == 2])
    np.testing.assert_array_equal(got.numpy()[pub < 0], scores[pub < 0])
