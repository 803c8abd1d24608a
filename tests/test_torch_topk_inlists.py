"""The bookkeeping behind kernel K4's carried rate sums
(cmdlmc_tpu_torch/csrc/topk_sweep.cu), on the CPU.

K4 evaluates each frame's candidate rates in full once and then, after each
event src -> dst, updates every slot's sum and count of positive candidates
from four groups of changed candidates, found through the frame's
in-neighbour lists (ops/topk_sweep.py::in_neighbour_lists). The CUDA code
cannot run here, so :class:`CarriedSums` repeats its steps line for line
over one replica (32 lanes; one butterfly per slot in the first evaluation,
and after an event one per slot in each chunk of 32 changed entries) and is
held, after every one of a run of seeded random events, to a
full re-evaluation (``slot_totals(candidate_rates(...))``): counts exactly,
sums to rtol 1e-6 (a full sum plus a few rounded deltas against a sum in
another order). No JAX kernel runs here."""

import numpy as np
import pytest
import torch

from cmdlmc_tpu_torch.core.cell import Cell
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import topk_sweep as ts
from cmdlmc_tpu_torch.rates.laws import Fermi
from cmdlmc_tpu_torch.topo.models import HydroniumRates, TopKPairRates
from cmdlmc_tpu_torch.topo.transforms import DistanceInterpolator, ReLUTransformation

torch.set_num_threads(1)

LANES = 32
F32 = torch.float32


@pytest.mark.parametrize("k", [1, 8, 16])
def test_in_neighbour_lists(k):
    """Each (k, i) appears once, under j = topi[f, k, i]; the offsets start
    at 0 and rise to K N; the entries rise within each j."""
    rng = np.random.RandomState(k)
    b, n = 3, 40
    topi = rng.randint(0, n, size=(b, k, n))
    topi[:, -1, ::3] = 0  # exhausted slots hold index 0: a long list at site 0
    off, ent = ts.in_neighbour_lists(torch.from_numpy(topi).to(torch.int32))
    assert off.dtype == ent.dtype == torch.int32
    assert off.shape == (b, n + 1) and ent.shape == (b, k * n)
    for f in range(b):
        o, e = off[f].numpy(), ent[f].numpy()
        assert o[0] == 0 and o[-1] == k * n and np.all(np.diff(o) >= 0)
        assert np.array_equal(np.sort(e), np.arange(k * n))
        for j in range(n):
            q = e[o[j]:o[j + 1]]
            assert np.all(np.diff(q) > 0)
            assert np.all(topi[f].reshape(-1)[q] == j)


def _butterfly(v):
    """warp_sum over the lane axis 0 of ``v`` [32, ...]: every lane ends with
    the same bits; returns lane 0's."""
    lanes = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v[0]


class CarriedSums:
    """One warp's (one replica's) carried slot sums and positive counts over
    one frame's tables [K, N], step for step as csrc/topk_sweep.cu keeps
    them: ``full()`` is the frame's first evaluation, ``event(src, dst,
    t_event)`` the update after a move."""

    def __init__(self, td, ti, rs, occ, tls, frame_time, params, *, kind, blend):
        self.td, self.ti, self.rs = td, ti.long(), rs
        self.occ, self.tls = occ.clone(), tls.clone()
        self.frame_time, self.params = frame_time, params
        self.kind, self.blend = kind, blend
        self.K, self.N = td.shape
        off, ent = ts.in_neighbour_lists(ti[None])
        self.off, self.ent = off[0].tolist(), ent[0].tolist()

    def omega(self):
        """omega_at over the whole table [K, N] at the current tlast_site."""
        if not self.blend:
            return self.rs
        tls = self.tls
        ratio = torch.where(tls < 0, 1.0, torch.clamp(
            (self.frame_time - tls) / self.params[6], max=1.0))
        d = self.td
        de = d + ratio[None] * (self.rs - d)
        law = ks._apply_law(self.kind, torch.clamp(de, max=50.0), self.params)
        return torch.where(d < 1.0e5, law, 0.0)

    def cand(self, k, i):
        """cand_rate at (k, i): omega occ[i] (1 - occ[nbr_k[i]])."""
        return self.omega()[k, i] * 1.0 * (1.0 - self.occ[self.ti[k, i]])

    def full(self):
        """Lane l adds the occupied sites l, l + 32, ... in order; one
        butterfly per slot for the sums and for the counts."""
        part = torch.zeros((LANES, self.K), dtype=F32)
        npos = torch.zeros((LANES, self.K), dtype=torch.int64)
        for i in range(self.N):
            if self.occ[i] == 0:
                continue
            v = self.omega()[:, i] * 1.0 * (1.0 - self.occ[self.ti[:, i]])
            part[i % LANES] = part[i % LANES] + v
            npos[i % LANES] += (v > 0).long()
        self.mine, self.cnt = _butterfly(part), npos.sum(dim=0)

    def total(self):
        total = self.mine[0]
        for k in range(1, self.K):
            total = total + self.mine[k]
        return total

    def event(self, src, dst, t_event):
        K, N = self.K, self.N
        # group 1 before the event: src's slots leave (lane k's `own`)
        own = torch.zeros(K, dtype=F32)
        own_c = torch.zeros(K, dtype=torch.int64)
        for k in range(K):
            old = self.cand(k, src)
            own[k] = -old
            own_c[k] = -int(old > 0)
        # groups 3 and 4 before the event: src's then dst's in-entries in
        # chunks of 32, entry base + l on lane l, one butterfly per slot the
        # chunk holds, into the slot's own
        s0, ns = self.off[src], self.off[src + 1] - self.off[src]
        d0, nd = self.off[dst], self.off[dst + 1] - self.off[dst]
        omega = self.omega()
        for base in range(0, ns + nd, LANES):
            ks_ = torch.full((LANES,), -1)
            v = torch.zeros(LANES, dtype=F32)
            c = torch.zeros(LANES, dtype=torch.int64)
            for lane in range(LANES):
                e = base + lane
                if e >= ns + nd:
                    continue
                of_src = e < ns
                q = self.ent[s0 + e] if of_src else self.ent[d0 + e - ns]
                i = q % N
                if i == src or i == dst or self.occ[i] == 0:
                    continue
                w = omega[q // N, i]
                ks_[lane] = q // N
                v[lane] = w if of_src else -w
                c[lane] = (1 if of_src else -1) * int(w > 0)
            for k in range(K):
                if bool((ks_ == k).any()):
                    own[k] = own[k] + _butterfly(torch.where(ks_ == k, v, 0.0))
                    own_c[k] += int(torch.where(ks_ == k, c, 0).sum())
        # the event
        self.occ[src], self.occ[dst] = 0.0, 1.0
        self.tls[dst] = t_event
        # group 2 after it: dst's slots enter at its new tlast_site
        for k in range(K):
            nw = self.cand(k, dst)
            own[k] = own[k] + nw
            own_c[k] += int(nw > 0)
        self.cnt += own_c
        self.mine = torch.where(self.cnt == 0, 0.0, self.mine + own)


def _frame(name, n, p, seed):
    """One frame's tables [K, N] of a small top-K model, a random occupancy
    and tlast_site, the frame time, the law parameters and the keywords."""
    rng = np.random.RandomState(seed)
    box = 9.0
    pos = torch.from_numpy(rng.uniform(0, box, size=(1, n, 3)).astype(np.float32))
    cell = Cell.cubic([box] * 3)
    law = Fermi(a=0.2, b=2.3, c=0.1)
    if name == "hydronium":
        model = HydroniumRates(
            cell, law, 3.0, 2.0,
            transform=ReLUTransformation(a=0.5, b=2.2, d0=2.2, left_bound=2.0,
                                         right_bound=3.3),
            interpolator=DistanceInterpolator(relaxation_time=2.0), k=4)
    elif name == "sparse":
        # few neighbours in range: most sites have exhausted slots
        model = TopKPairRates(cell, law, 1.6, 0.4, k=8)
    else:
        model = TopKPairRates(cell, law, 3.0, 2.0, k=8)
    blend = ts.has_blend(model)
    td, ti, rs = (t[0] for t in ts.topk_tables(model, pos, precompute_law=not blend))
    occ = torch.zeros(n, dtype=F32)
    occ[torch.from_numpy(rng.permutation(n)[:p])] = 1.0
    frame_time = torch.tensor(7.0, dtype=F32)
    tls = torch.from_numpy(rng.uniform(0.0, 7.0, size=n).astype(np.float32))
    tls = torch.where((occ > 0) & torch.from_numpy(rng.rand(n) < 0.7), tls, -1.0)
    kw = dict(kind=ks.law_kind(model.law), blend=blend)
    return td, ti, rs, occ, tls, frame_time, ts.law_params8(model), kw


def _run(name, n, p, events, seed):
    """Seeded random moves over one frame, the carried sums held to a full
    re-evaluation after each; returns what the run met."""
    td, ti, rs, occ, tls, frame_time, params, kw = _frame(name, n, p, seed)
    rng = np.random.RandomState(seed + 100)
    model = CarriedSums(td, ti, rs, occ, tls, frame_time, params, **kw)
    model.full()
    met = {"dst_next_to_src": 0, "emptied": 0, "events": 0}
    for ev in range(events):
        rates = ts.candidate_rates(td, ti, rs, model.occ[None], model.tls[None],
                                   frame_time, params, **kw)[0]
        sums, total = ts.slot_totals(rates[None])
        assert torch.equal(model.cnt, (rates > 0).sum(dim=1)), ev
        torch.testing.assert_close(model.mine, sums[0], rtol=1e-6, atol=0)
        torch.testing.assert_close(model.total(), total[0], rtol=1e-6, atol=0)
        assert torch.equal(model.mine[model.cnt == 0], torch.zeros_like(
            model.mine[model.cnt == 0]))  # +0 exactly, as the full sum
        pos = (rates > 0).nonzero()
        if len(pos) == 0:
            break
        k, src = pos[rng.randint(len(pos))].tolist()
        dst = int(ti[k, src])
        before = model.cnt.clone()
        model.event(src, dst, frame_time + torch.tensor(0.01 * (ev + 1), dtype=F32))
        met["events"] += 1
        met["dst_next_to_src"] += int((ti[:, dst] == src).any())
        met["emptied"] += int(((before > 0) & (model.cnt == 0)).sum())
    return met


@pytest.mark.parametrize("name", ["topk", "hydronium"])
def test_carried_sums_match_a_full_evaluation(name):
    """TopKPairRates k=8 (precomputed law) and HydroniumRates k=4 with the
    residence-time blend (dst's slots enter at its new tlast_site), over 40
    moves, many of them to a dst whose neighbour is src."""
    met = _run(name, n=48, p=18, events=40, seed=3)
    assert met["events"] == 40
    assert met["dst_next_to_src"] > 0


def test_a_slot_that_empties_sums_to_zero():
    """Few protons over sites with exhausted slots: slots lose their last
    positive candidate, and their carried sum is +0 exactly."""
    met = _run("sparse", n=48, p=3, events=40, seed=5)
    assert met["events"] > 10
    assert met["emptied"] > 0
