"""The plain reference against hand-worked cases on four sites."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import kmc, rng

BOX = (40.0, 40.0, 40.0)
LAW = {"a": 0.06, "b": 2.3, "c": 0.1}
# four sites on a line 2.3 A apart: neighbours at the Fermi midpoint (0.03),
# next neighbours at 4.6 A (inside cutoff + buffer, rate ~6e-12), the ends
# 6.9 A apart (no rate)
POS = torch.tensor([[[1.0 + 2.3 * i, 5.0, 5.0] for i in range(4)]], dtype=torch.float32)
SEED, FRAME = 12345, 7


def _entry(site: int, u: float) -> dict:
    occ = torch.zeros((1, 4))
    occ[0, site] = 1.0
    labels = torch.zeros((1, 4), dtype=torch.int64)
    labels[0, site] = 1
    return dict(occ=occ, labels=labels, sites=torch.tensor([[site]]),
                tlast=torch.full((1, 1), -1.0), disp_base=torch.zeros((1, 1, 3)),
                u=torch.tensor([u]), evc=torch.zeros(1, dtype=torch.int64),
                s=torch.zeros((4, 3)), prev=POS[0])


def _e(salt: int, counters) -> torch.Tensor:
    key = rng.mix_key(SEED, torch.tensor([0]), FRAME, 0, salt)
    return -torch.log(rng.u01(key[:, None], torch.tensor([counters])).double())[0]


def test_rates_by_hand():
    w, dist = kmc.dense_rates(POS, BOX, LAW, 5.0)
    assert float(dist[0, 0, 1]) == pytest.approx(2.3, abs=1e-6)
    assert float(w[0, 1, 0]) == pytest.approx(0.03, rel=1e-5)
    assert float(w[0, 1, 3]) == pytest.approx(0.06 / (1 + math.exp(23.0)), rel=1e-4)
    assert float(w[0, 0, 3]) == 0.0 and float(w[0, 2, 2]) == 0.0


def test_one_event_by_hand():
    w, dist = kmc.dense_rates(POS, BOX, LAW, 5.0)
    u0 = 0.01
    st, margin, _ = kmc.dense_loop(w, dist, POS, _entry(1, u0), FRAME, torch.tensor([0]),
                                   tile=1, seed=SEED, dt=0.5, max_events=1, box=BOX)
    # the proton on site 1 sees 0.03 + 0.03 + ~6e-12 per fs; its draw 0.01
    # is under the frame's 0.5 fs of it, so it fires at u / total
    total = float(w[0, 1].sum())
    eph = float(np.float32(u0)) / total  # the state holds the draw in float32
    e = _e(2, [0, 1, 2, 3])
    dst = 0 if 0.03 / e[0] > 0.03 / e[2] else 2
    assert int(st["sites"][0, 0]) == dst
    assert st["occ"][0].tolist() == [1.0 if i == dst else 0.0 for i in range(4)]
    assert int(st["labels"][0, dst]) == 1 and int(st["evc"][0]) == 1
    assert float(st["tlast"][0, 0]) == pytest.approx(FRAME * 0.5 + eph)
    jump = 2.3 * (dst - 1)
    assert st["disp_base"][0, 0].tolist() == pytest.approx([jump, 0.0, 0.0], abs=1e-6)
    fresh = float(_e(3, [0])[0])
    total_end = float(w[0, dst].sum())
    assert float(st["u"][0]) == pytest.approx(fresh - total_end * (0.5 - eph), rel=1e-12)
    # margins: the clock |u - budget| / max(budget, 1) (about 0.02), the
    # source race is certain, the destination race its relative gap
    budget = total * 0.5
    clock = abs(float(np.float32(u0)) - budget) / max(budget, 1.0)
    v = sorted([float(w[0, 1, 0]) / float(e[0]), float(w[0, 1, 2]) / float(e[2])], reverse=True)
    assert float(margin[0]) == pytest.approx(min(clock, (v[0] - v[1]) / v[0]), rel=1e-9)


def test_no_event_when_the_draw_exceeds_the_frame():
    w, dist = kmc.dense_rates(POS, BOX, LAW, 5.0)
    st, _, _ = kmc.dense_loop(w, dist, POS, _entry(1, 5.0), FRAME, torch.tensor([0]),
                              tile=1, seed=SEED, dt=0.5, max_events=4, box=BOX)
    assert int(st["sites"][0, 0]) == 1 and int(st["evc"][0]) == 0
    assert float(st["u"][0]) == pytest.approx(5.0 - float(w[0, 1].sum()) * 0.5)


def test_knn_by_hand():
    topd, topi = kmc.knn_f32(POS[0], BOX, 5.0, 2)
    # site 0: 1 (2.3), 2 (4.6); site 1: 0 and 2 tie at 2.3 -> lower index first
    assert topi[:, 0].tolist() == [1, 2]
    assert topi[:, 1].tolist() == [0, 2]
    assert topi[:, 3].tolist() == [2, 1]
    assert topd[:, 0].tolist() == pytest.approx([2.3, 4.6], abs=1e-5)


def test_topk_event_by_hand():
    topd, topi = kmc.knn_f32(POS[0], BOX, 5.0, 2)
    omega = kmc.topk_rates(topd, LAW)[None]
    st, _ = kmc.topk_loop(omega, topi[None], POS, _entry(1, 0.01), FRAME, torch.tensor([0]),
                          tile=1, seed=SEED, dt=0.5, max_events=1, box=BOX)
    # slot sums of the proton on site 1: slot 0 (-> 0) and slot 1 (-> 2) both 0.03
    key = rng.mix_key(SEED, torch.tensor([0]), FRAME, 0, 11)
    e = -torch.log(rng.u01(key[:, None], torch.tensor([[0, 1]])).double())[0]
    slot = 0 if 1 / e[0] > 1 / e[1] else 1
    assert int(st["sites"][0, 0]) == int(topi[slot, 1])


def test_row_by_hand():
    sites = torch.tensor([[0], [1]])
    disp_base = torch.tensor([[[1.0, 0.0, 0.0]], [[0.0, 2.0, 0.0]]])
    s = torch.tensor([[0.5, 0.0, 0.0], [0.0, 0.0, 1.0]])
    ref_sites = torch.tensor([[0], [0]])
    jumps = torch.tensor([3, 5])
    row = kmc.row(sites, disp_base, ref_sites, jumps, s, reset=False)
    # displacements (1.5, 0, 0) and (0, 2, 1): msd x 2.25/0, y 0/4, z 0/1
    assert row[:3] == pytest.approx([1.125, 2.0, 0.5])
    assert row[3:6] == pytest.approx([1.265625, 4.0, 0.25])
    assert row[6:9] == pytest.approx([0.5, 0.25, 4.0])
    assert row[9] == pytest.approx((2.25 ** 2 + 25.0) / 2)
    reset = kmc.row(sites, disp_base, ref_sites, jumps, s, reset=True)
    assert np.all(reset[[0, 1, 2, 3, 4, 5, 7, 8, 9]] == 0.0) and reset[6] == 1.0


def test_init_is_the_seed_s():
    a = kmc.init_state(2**31 + 17, 8, 20, 5)
    b = kmc.init_state(2**31 + 17, 8, 20, 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(len(set(r.tolist())) == 5 for r in a[0])


def test_a_draw_of_one_wins_its_race():
    # E = 0 - log(1.0) is +0, so a positive rate over it scores +inf (a
    # negative zero would score -inf and lose)
    key = rng.mix_key(SEED, torch.tensor([0]), FRAME, 0, 2)
    hit = None
    for start in range(0, 1 << 27, 1 << 22):
        c = torch.arange(start, start + (1 << 22))
        ones = (rng.u01(key, c) == 1.0).nonzero()
        if len(ones):
            hit = int(c[ones[0, 0]])
            break
    assert hit is not None
    e = kmc._draws(SEED, torch.tensor([0]), FRAME, 0, 2, torch.tensor([[hit, hit + 1]]),
                   torch.float64)
    assert float(e[0, 0]) == 0.0 and math.copysign(1.0, float(e[0, 0])) > 0
    win, gap = kmc._race(torch.tensor([[1e-9, 1.0]], dtype=torch.float64), e)
    assert int(win[0]) == 0 and float(gap[0]) == 1.0


@pytest.mark.parametrize("kind", ["jitter", "walk"])
def test_a_rotated_trajectory_is_the_same_frames_for_every_seed(kind):
    from benchmark.reference import trajectory

    traffic = {"trajectory": kind, "frames": 16, "step": 0.01, "rotate": True}
    config = {"cell_sites": 5, "box": 8.0, "structure_seed": 3}
    a = trajectory.make_frames(traffic, config, 2**31 + 1)
    b = trajectory.make_frames(traffic, config, 2**31 + 2)
    shifts = [s for s in range(16) if np.array_equal(np.roll(a, s, axis=0), b)]
    assert len(shifts) == 1
    assert np.array_equal(a, trajectory.make_frames(traffic, config, 2**31 + 1))
    plain = trajectory.make_frames(dict(traffic, rotate=False), config, 2**31 + 1)
    assert not np.array_equal(np.sort(plain, axis=0), np.sort(a, axis=0))


def test_the_clock_margin_allows_the_float32_drift():
    u = torch.tensor([1.0, 1.0, 0.2], dtype=torch.float64)
    budget = torch.tensor([1.0 + 3e-4, 4.0, 0.2 + 5e-5], dtype=torch.float64)
    assert kmc.clock_margin(u, budget, 0.0).tolist() == pytest.approx(
        [3e-4 / (1 + 3e-4), 0.75, 5e-5])
    # after a hundred frames of an integrated rate of 15 the allowance is
    # 100 * CLOCK_DRIFT_ULPS * 2^-24 * 15 (about 7e-4): the first and the
    # last are no longer far from their ties
    drift = 100 * kmc.clock_drift_step(torch.tensor([37.5]), 0.4)
    assert float(drift) == pytest.approx(100 * kmc.CLOCK_DRIFT_ULPS * 2.0**-24 * 15.0)
    m = kmc.clock_margin(u, budget, drift)
    assert float(m[0]) < 0 and float(m[2]) < 0 and float(m[1]) > 0.7
