"""The merge-winner kernel's algorithm, emulated on the CPU.

``csrc/gossip_merge.cu`` takes a block of ``kRows`` ledger rows (one a
lane) and a group of receivers (one a warp), the group sized by the host so
the grid is about one wave of the card's SMs. Each receiver's mask row, its
own bit forced on, says whether it hears anybody else: a self-only
receiver's result is closed-form from its own row, and it walks and stages
nothing. The others' senders go in windows of ``kWindow``, and the block
forms the union of the senders they admit. A receiver that admits at most
``kDirect`` senders within one window (an events batch) folds them, lowest
first, straight from memory and takes no part in the windows. The union is
loaded as 64-bit orderable keys (the time's bits, -0.0 made +0.0, sign-flipped, above the publisher;
0 = not held, all ones = NaN) and counters, warp w taking positions w,
w + 16, ...: a receiver that admits the whole union takes the union's
fold, computed once by the block (the 16 warps' partials meeting in two
levels of four), and every other one walks its own list of union
positions, staged, padded to 4 with a null line, into four folds that
take the entries in turn. Each window's result merges into a running one. The
kernel runs only on a card, so this file emulates that algorithm in plain
PyTorch (its constants read from the source, the launch shape by the host's
rule) and holds it bitwise against ``gossip_winner_plain``, the reference's
``ref.gossip_winner_ref`` and its Pallas kernel run in interpret mode:
every sender winning with negative counts, receivers that hear only
themselves, ties in time under other publishers, NaN times, rows nobody
holds, a ``row_offset`` block, senders past one window, and whole-union
receivers beside others in one group.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gossip_merge as j_gm
from repro.kernels import ref as j_ref
from repro_torch.kernels import cuda_build
from repro_torch.kernels import gossip_merge as t_gm


def kernel_constant(name: str) -> int:
    source = (cuda_build.CSRC / "gossip_merge.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


ROWS, WARPS, MAX_GROUP, WINDOW, DIRECT = (kernel_constant(n) for n in
                                          ("kRows", "kWarps", "kMaxGroup", "kWindow", "kDirect"))
H100_SMS = 132
INT64_MIN, INT64_MAX = -2**63, 2**63 - 1
j_winner_ref = jax.jit(j_ref.gossip_winner_ref)


def launch_shape(rr: int, cap: int, sms: int):
    """The host's grid: row tiles and receivers a block."""
    tiles = -(-cap // ROWS)
    return tiles, min(MAX_GROUP, max(1, -(-rr * tiles // sms)))


def keys(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The kernel's unsigned 64-bit key of each (time, publisher), minus
    2**63 so that int64 order is its order: not held is the least, a NaN
    time the greatest."""
    b = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(t == 0, 0, b)
    o = torch.where(b >= 2**31, ~b & 0xFFFFFFFF, b | 2**31)
    k = (o - 2**31) * 2**32 + ((p.to(torch.int64) & 0xFFFFFFFF) ^ 2**31)
    return torch.where(p < 0, INT64_MIN, torch.where(torch.isnan(t), INT64_MAX, k))


class Fold:
    """One running (key, first, counter max, winners) per row."""

    def __init__(self, cap: int):
        self.k = torch.full((cap,), INT64_MIN, dtype=torch.int64)
        self.first = torch.zeros(cap, dtype=torch.int64)
        self.ac = torch.zeros(cap, dtype=torch.int64)
        self.nw = torch.zeros(cap, dtype=torch.int64)

    def fold(self, k2, a2, j: int):
        gt, eq = k2 > self.k, k2 == self.k
        self.first = torch.where(gt, j, self.first)
        self.ac = torch.where(gt, a2, torch.where(eq, torch.maximum(self.ac, a2), self.ac))
        self.nw = torch.where(gt, 1, self.nw + eq.long())
        self.k = torch.where(gt, k2, self.k)

    def merge(self, o: "Fold"):
        gt, eq = o.k > self.k, o.k == self.k
        self.first = torch.where(gt, o.first, torch.where(eq, torch.minimum(self.first, o.first),
                                                          self.first))
        self.ac = torch.where(gt, o.ac, torch.where(eq, torch.maximum(self.ac, o.ac), self.ac))
        self.nw = torch.where(gt, o.nw, torch.where(eq, self.nw + o.nw, self.nw))
        self.k = torch.where(gt, o.k, self.k)


def emulate(t, p, ac, mask, row_offset=None, sms=H100_SMS, stats=None):
    """(src, ac) as the kernel computes them; ``stats`` counts each
    receiver's folded senders (its list, or the union's fold it takes) and
    each window's staged senders."""
    r, cap = t.shape
    rr = mask.shape[0]
    off = 0 if row_offset is None else row_offset
    _, group = launch_shape(rr, cap, sms)
    key, acl = keys(t, p), ac.to(torch.int64)
    src = torch.empty((rr, cap), dtype=torch.int32)
    aco = torch.empty((rr, cap), dtype=torch.int32)
    for i0 in range(0, rr, group):
        ng = min(group, rr - i0)
        gids = [i0 + g + off for g in range(ng)]
        adm = mask[i0:i0 + ng].bool().clone()
        adm[torch.arange(ng), gids] = True
        walks = adm.sum(1) > 1
        adm[~walks] = False
        hears = walks.clone()                                 # not self-only
        run = [Fold(cap) for _ in range(ng)]
        quick = walks & (adm.sum(1) <= DIRECT) if r <= WINDOW else torch.zeros_like(walks)
        for g in torch.nonzero(quick).flatten().tolist():
            # one window, a short list: the warp folds its admitted senders
            # straight from memory and takes no part in the windows
            if stats is not None:
                stats["modes"].append("bits")
                stats["folded"][i0 + g] += int(adm[g].sum())
            for j in torch.nonzero(adm[g]).flatten().tolist():
                run[g].fold(key[j], acl[j], j)
        walks = walks & ~quick
        adm[quick] = False
        for w0 in range(0, r if bool(walks.any()) else 0, WINDOW):
            win = adm[:, w0:w0 + WINDOW]
            union = win.any(0)
            staged = torch.nonzero(union).flatten()            # the union, ascending
            if len(staged) == 0:
                continue
            if stats is not None:
                stats["staged"].append(len(staged))
            pos = {int(j): n for n, j in enumerate(staged)}
            null = len(staged)                                # the padding's line
            skey = torch.cat([key[w0 + staged], torch.full((1, cap), INT64_MIN)])
            sac = torch.cat([acl[w0 + staged], torch.zeros((1, cap), dtype=torch.int64)])
            whole = [bool(walks[g]) and bool((win[g] == union).all()) for g in range(ng)]
            if stats is not None:
                stats["modes"].append("staged" if any(walks[g] and not whole[g] for g in range(ng))
                                      else "whole")
            if any(whole):                                    # the union's fold, 16 warps
                parts = []
                for w in range(WARPS):
                    a = Fold(cap)
                    for q in range(w, len(staged), WARPS):
                        a.fold(skey[q], sac[q], w0 + int(staged[q]))
                    parts.append(a)
                for w in range(4):                            # two levels of four
                    for o in (w + 4, w + 8, w + 12):
                        parts[w].merge(parts[o])
                for o in (1, 2, 3):
                    parts[0].merge(parts[o])
                union_fold = parts[0]
            for g in range(ng):
                if not walks[g]:
                    continue
                lst = [pos[int(j)] for j in torch.nonzero(win[g]).flatten()]
                if stats is not None:
                    stats["folded"][i0 + g] += len(lst)
                if whole[g]:
                    wf = union_fold
                else:                                         # its own list, staged
                    lst += [null] * (-len(lst) % 4)
                    folds = [Fold(cap) for _ in range(4)]
                    for n, q in enumerate(lst):
                        folds[n % 4].fold(skey[q], sac[q], q)
                    wf = folds[0]
                    for o in folds[1:]:
                        wf.merge(o)
                    wf.first = w0 + staged[wf.first.clamp(max=len(staged) - 1)]
                run[g].merge(wf)
        for g in range(ng):
            a, gid = run[g], gids[g]
            own_k, own_t, own_p, own_ac = key[gid], t[gid], p[gid], acl[gid]
            if not hears[g]:
                out_src = torch.full((cap,), gid, dtype=torch.int64)
                held = (own_p >= 0) & ~torch.isnan(own_t)
                keep = own_ac if r == 1 else own_ac.clamp(min=0)
                out_ac = torch.where(held, keep, 0)
            else:
                won = (a.k != INT64_MIN) & (a.k != INT64_MAX)
                out_src = torch.where(won & (own_k != a.k), a.first, gid)
                out_ac = torch.where(won, torch.where((a.nw < r) & (a.ac < 0), 0, a.ac), 0)
            src[i0 + g], aco[i0 + g] = out_src.int(), out_ac.int()
    return src, aco


def state(rng, r, cap, kind):
    """(t, pub, ac) as numpy: "ties" (few publishers and times, rows nobody
    holds, negative counters), "nan" (NaN, -inf, +-0 times too), "all_win"
    (every sender holds one key per row, negative counters)."""
    pub = rng.integers(-1, 3, (r, cap)).astype(np.int32)
    pub[:, ::7] = -1
    t = (rng.integers(0, 3, (r, cap)) * 0.5).astype(np.float32)
    ac = rng.integers(-3, 5, (r, cap)).astype(np.int32)
    if kind == "nan":
        t = rng.choice(np.array([np.nan, -np.inf, -0.0, 0.0, 1.0, 0.5], np.float32), (r, cap))
        t[:, ::3] = 1.0                      # rows without NaN too
    elif kind == "all_win":
        pub = np.broadcast_to(rng.integers(0, 3, (1, cap)), (r, cap)).astype(np.int32).copy()
        pub[:, 5] = -1                       # one row nobody holds
        t = np.broadcast_to(t[:1], (r, cap)).copy()
        t[:, 1] = -0.0
        t[::2, 1] = 0.0                      # -0.0 and +0.0 one key
        ac = rng.integers(-5, -1, (r, cap)).astype(np.int32)
        ac[:, 2] = rng.integers(-5, 5, r)    # a row with a positive winner
    return t, pub, ac


def k_regular_edges(rng, n, k, live):
    """``live`` directed edges drawn from a k-regular ring overlay's."""
    edges = [(i, (i + d) % n) for i in range(n) for d in range(1, k // 2 + 1)]
    edges += [(j, i) for i, j in edges]
    pick = rng.choice(len(edges), live, replace=False)
    mask = np.zeros((n, n), bool)
    for e in pick:
        mask[edges[e]] = True
    return mask


def mask_of(rng, rr, r, kind):
    if kind == "events_batch":               # a few edges fire, the path adds the diagonal
        return k_regular_edges(rng, r, 8, 3) | np.eye(r, dtype=bool)
    if kind == "self_only":
        return np.zeros((rr, r), bool)
    if kind == "full":
        return np.ones((rr, r), bool)
    return rng.random((rr, r)) < kind


# (r, rr, cap, row_offset, mask, state, sms): the SM count sets the group
CASES = [
    (24, 24, 70, None, 0.5, "ties", H100_SMS),      # one receiver a block: the union's fold
    (24, 24, 70, None, 0.5, "ties", 4),             # 16 receivers a block, lists
    (24, 24, 70, None, 0.5, "ties", 24),            # 3 a block
    (24, 24, 70, None, 0.97, "ties", 4),            # whole-union receivers beside lists
    (24, 24, 33, None, "full", "all_win", 4),       # every sender wins: negative counters
    (24, 24, 33, None, "full", "all_win", H100_SMS),
    (24, 24, 33, None, 0.7, "all_win", 8),          # not every sender: floored at 0
    (40, 40, 40, None, "events_batch", "ties", 8),  # nearly all self-only
    (9, 9, 40, None, "self_only", "ties", 8),
    (300, 40, 33, 100, 0.3, "ties", 8),             # three windows, a row_offset block
    (300, 40, 33, 100, 0.02, "nan", 8),             # sparse: windows with small unions
    (300, 4, 40, 50, 0.005, "ties", 8),             # sparse past one window
    (150, 1, 65, None, "full", "ties", H100_SMS),   # the union fold across two windows
    (12, 12, 50, None, 0.6, "nan", 16),
    (1, 1, 20, None, "full", "all_win", H100_SMS),  # R = 1: a negative counter kept
    (1, 1, 20, None, "full", "nan", H100_SMS),
]


@pytest.mark.parametrize("r,rr,cap,offset,mask_kind,kind,sms", CASES)
def test_emulated_walk_equals_plain_and_reference(r, rr, cap, offset, mask_kind, kind, sms):
    rng = np.random.default_rng(r * 1000 + rr * 10 + cap)
    t, pub, ac = state(rng, r, cap, kind)
    mask = mask_of(rng, rr, r, mask_kind)
    tt, tp, ta, tm = (torch.from_numpy(x) for x in (t, pub, ac, mask))
    row_ids = None if offset is None else offset + torch.arange(rr, dtype=torch.int32)
    stats = {"folded": [0] * rr, "staged": [], "modes": []}
    got = emulate(tt, tp, ta, tm, offset, sms, stats)
    want = t_gm.gossip_winner_plain(tt, tp, ta, tm, row_ids=row_ids)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    j_args = (jnp.asarray(t), jnp.asarray(pub), jnp.asarray(ac), jnp.asarray(mask))
    j_rows = None if offset is None else jnp.asarray(row_ids.numpy())
    ref = j_winner_ref(*j_args, row_ids=j_rows)
    pallas = j_gm.gossip_winner_pallas(*j_args, interpret=True,
                                       row_offset=0 if offset is None else offset)
    for g, w, q in zip(got, ref, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(q))

    # the walk visits only admitted senders; a self-only receiver none
    gid = np.arange(rr) + (offset or 0)
    adm = mask.copy()
    adm[np.arange(rr), gid] = True
    walks = adm.sum(1) > 1
    assert stats["folded"] == [int(n) if w else 0 for n, w in zip(adm.sum(1), walks)]
    if mask_kind in ("events_batch", "self_only"):
        assert sum(stats["staged"]) <= 2 * int(mask.sum() - np.trace(mask))
        assert set(stats["modes"]) <= {"bits"}
    if mask_kind == "events_batch":
        assert set(stats["modes"]) == {"bits"}
    if mask_kind == "full" and r > 1:
        assert set(stats["modes"]) == {"whole"}
    if mask_kind in (0.5, 0.97) and launch_shape(rr, cap, sms)[1] > 1:
        assert "staged" in stats["modes"]        # a group of one always takes the whole union
    if kind == "all_win" and mask_kind == "full":
        held = pub[0] >= 0
        assert (want[1].numpy()[:, held & (ac.max(0) < 0)] < 0).all()


def test_the_launch_fills_one_wave_at_the_main_shapes():
    assert (ROWS, WARPS, MAX_GROUP, WINDOW) == (32, 16, 16, 128)
    tiles, group = launch_shape(100, 512, H100_SMS)              # a round, 100 replicas
    assert (tiles, group) == (16, 13) and tiles * -(-100 // group) <= H100_SMS
    assert launch_shape(1, 512, H100_SMS) == (16, 1)             # the union fold
    assert launch_shape(25, 512, H100_SMS) == (16, 4)            # a receiver block
    assert launch_shape(400, 512, H100_SMS) == (16, 16)          # the scale case


def test_keys_order_as_time_then_publisher():
    t = torch.tensor([-np.inf, -1.5, -0.0, 0.0, 1e-45, 2.0, np.inf, np.inf, 2.0, np.nan, 1.0],
                     dtype=torch.float32)
    p = torch.tensor([0, 5, 1, 1, 0, 3, 0, 2, 4, 0, -1], dtype=torch.int32)
    k = keys(t, p)
    assert k[2] == k[3]                                          # -0.0 is +0.0
    assert k[-1] == INT64_MIN and k[-2] == INT64_MAX            # not held; NaN
    order = [0, 1, 3, 4, 5, 8, 6, 7]
    assert bool((k[order][1:] > k[order][:-1]).all())
