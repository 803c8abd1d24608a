"""The yardstick's work counts against hand counts on a tiny W."""

import pytest
import torch

from benchmark import yardstick as ys

# three sites on a chain 0 - 1 - 2: W[0,1] = W[1,0] = W[1,2] = W[2,1] = 1
CHAIN = torch.tensor([[[0.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 0.0]]])


def test_sweep_work_on_a_chain():
    # 4 nonzeros; P = 1 of N = 3: pairs = 4 * 1 * 2 / (3 * 2), vacant = 4 / 3 * 2 / 2;
    # every move s -> d touches rows {0, 1, 2}: |C_s u C_d u {s, d}| = 3, times P / N
    work = ys.sweep_work(CHAIN, 1)
    assert work["pairs"] == pytest.approx(4 / 3)
    assert work["vacant"] == pytest.approx(4 / 3)
    assert work["rows"] == pytest.approx(1.0)


def test_sweep_work_averages_frames():
    empty = torch.zeros_like(CHAIN)
    work = ys.sweep_work(torch.cat([CHAIN, empty]), 1)
    assert work["pairs"] == pytest.approx(2 / 3)
    assert work["rows"] == pytest.approx(0.5)


def test_sweep_bound_by_hand():
    work = {"pairs": 2.0, "vacant": 3.0, "rows": 4.0}
    R, B, N, P, events = 10, 5, 6, 2, 7
    flops = 2.0 * R * B + (4.0 * 3.0 + N) * events + 3.0 * (P + 3.0) * events
    state = 4.0 * R * (2 * N + 5 * P + 2)
    nbytes = 4.0 * B * N * 3 + 100.0 + 2 * state + 4.0 * R + 4 * 4.0 * N * 3
    b = ys.sweep_bound(R, B, N, P, events, work, w_bytes=100.0)
    assert b["bound_ms"] == pytest.approx(1e3 * max(flops / ys.PEAK_FP32_FLOPS,
                                                    nbytes / ys.PEAK_BYTES))
    assert b["bound_by"] == "bytes"


def test_bound_picks_the_larger_side():
    assert ys.bound(67e12, 0.0) == {"bound_ms": pytest.approx(1e3), "bound_by": "operations",
                                    "flops": 67e12, "nbytes": 0.0}
    assert ys.bound(0.0, 3.35e12)["bound_by"] == "bytes"


def test_stats_bound_by_hand():
    b = ys.stats_bound(R=2, B=3, N=4, nbins=5, events=6, cands=7.0, table_bytes=8.0)
    flops = 4.0 * 2 * 3 * 7.0 + 9.0 * 6
    nbytes = 8.0 + 2 * 2 * 4.0 * 2 * 5 + 4.0 * 16
    assert b["bound_ms"] == pytest.approx(1e3 * max(flops / ys.PEAK_FP32_FLOPS,
                                                    nbytes / ys.PEAK_BYTES))
    assert (b["flops"], b["nbytes"]) == pytest.approx((flops, nbytes))


def test_topk_changed_on_a_ring():
    # K = 1: site 0 -> 1, 1 -> 2, 2 -> 0, every rate positive: in-degrees 1,
    # so 2 K + 2 * sum(deg^2) / sum(deg) = 2 + 2
    topi = torch.tensor([[[1, 2, 0]]], dtype=torch.int32)
    topd = torch.full((1, 1, 3), 2.0)
    resc = torch.full((1, 1, 3), 0.5)
    assert ys.topk_changed((topd, topi, resc), False) == pytest.approx(4.0)
    # a star: every site points at 0 (0 at 1), dead slot at site 2
    topi = torch.tensor([[[1, 0, 0]]], dtype=torch.int32)
    resc = torch.tensor([[[0.5, 0.5, 0.0]]])
    # live entries' targets 1 and 0: deg [1, 1, 0] -> 2 / 2
    assert ys.topk_changed((topd, topi, resc), False) == pytest.approx(4.0)


def test_topk_bound_by_hand():
    R, B, N, P, K, events, changed = 4, 2, 10, 3, 2, 5, 6.0
    flops = R * B * P * K * 3.0 + events * (changed * 3.0 + 3.0 * (P + K))
    state = 4.0 * R * (3 * N + 5 * P + 2)
    nbytes = 4.0 * B * N * 3 + 50.0 + 2 * state + 4.0 * R + 4 * 4.0 * N * 3
    b = ys.topk_bound(R, B, N, P, K, events, False, 50.0, changed)
    assert b["bound_ms"] == pytest.approx(1e3 * max(flops / ys.PEAK_FP32_FLOPS,
                                                    nbytes / ys.PEAK_BYTES))
