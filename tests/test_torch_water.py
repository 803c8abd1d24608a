"""The port's water event loop against the JAX package on the CPU.

* The plain version of kernel K7 (``ops/water_sweep.py::water_sweep_reference``)
  against the JAX package's water kernel B4 (``water_sweep``, interpret mode,
  rows layout): N=28 sites, R=32 replicas in RNG tiles of 16 (two tiles, so
  tile ids and the tile offset count), 16 frames of jittered positions, from
  replica states drawn with numpy (random last sites, blend counters and
  waiting counters, so every branch of the candidate rule runs at once).
  Five cases, one JAX compile each: no transform; the linear transform with
  keep_last, check_from_old, the relaxation blend and d_OH (the water
  deployment's options); the ramp with a waiting time; the interpolation
  table at n_atoms = 4 with keep_last; and the Constant law. Integer state
  (site, last, fsj, wait, jumps, event count, truncation) exact; u, corr,
  disp_base, site_disp and prev to rtol 1e-5 with atol 1e-5 (log, exp and
  XLA's approximate rsqrt round by an ulp or so differently in the two
  packages).
* The port's chunk invariance, the zero-rate pick on a draw of one, the
  wrapper's refusal of CPU tensors and the state conversion.

The tables and the transform are held in ``test_torch_water_tables.py``, the
``kmc_water`` slice, its per-frame site and its refusals in
``test_torch_water_cli.py``; both take their cases from this file.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core.cell import Cell as JCell
from cmdlmc_tpu.models import water as jwm
from cmdlmc_tpu.ops import kmc_sweep as jks
from cmdlmc_tpu.ops import water_sweep as jws
from cmdlmc_tpu.rates.laws import Constant as JConstant, Fermi as JFermi
from cmdlmc_tpu.topo import transforms as jtr
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.models import water as twm
from cmdlmc_tpu_torch.ops import kmc_sweep as ks
from cmdlmc_tpu_torch.ops import rng
from cmdlmc_tpu_torch.ops import water_sweep as ws
from cmdlmc_tpu_torch.rates.laws import Fermi

from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, R, TR, B = 28, 32, 16, 16
BOX, DT, SEED, FRAME0, TILE_OFFSET = 7.0, 0.5, 3, 5, 2
_f = jnp.float32

# an interpolation table with repeated x points (empty segments)
INTERP_X = np.array([1.5, 1.8, 2.0, 2.0, 2.2, 2.5, 2.5, 2.5, 2.8, 3.1, 3.4, 4.0],
                    np.float32)
INTERP_Y = (INTERP_X - 0.4 * np.exp(-((INTERP_X - 2.4) ** 2) / 0.1)).astype(np.float32)
INTERP_Y[3] += np.float32(0.05)  # the jump at the repeated 2.0

# name: (law, transform, n_atoms, relaxation, waiting, keep_last, check_old, d_oh)
CASES = {
    "none": ("fermi", None, 3, 0, 0, False, False, 0.0),
    "linear_check_old": ("fermi", "linear", 3, 10, 0, True, True, 0.3),
    "ramp_waiting": ("fermi", "ramp", 3, 4, 3, True, False, 0.2),
    "interp_k4": ("fermi", "interp", 4, 6, 0, True, True, 0.3),
    "constant": ("constant", "linear", 3, 0, 2, True, True, 0.0),
}


def _transform(name):
    if name == "linear":
        return jtr.LinearTransformation(a=_f(0.5), b=_f(1.2), left_bound=_f(0.0),
                                        right_bound=_f(10.0))
    if name == "ramp":
        return jtr.ReLUTransformation(a=_f(0.5), b=_f(1.6), d0=_f(2.0),
                                      left_bound=_f(1.2), right_bound=_f(3.0))
    if name == "interp":
        return jtr.InterpolatedTransformation(x=jnp.asarray(INTERP_X),
                                              y=jnp.asarray(INTERP_Y))
    return None


def _jax_model(case):
    law, tname, k, relax, waiting, keep, check, d_oh = CASES[case]
    law = (JConstant(a=_f(0.1)) if law == "constant"
           else JFermi(a=_f(0.3), b=_f(2.3), c=_f(0.1)))
    return jwm.WaterModel(
        cell=JCell.cubic([BOX] * 3), law=law, transform=_transform(tname),
        d_oh=_f(d_oh), n_atoms=k, relaxation_time=relax, waiting_time=waiting,
        keep_last_neighbor_rescaled=keep, check_from_old=check)


def _frames(n_frames=B, seed=0):
    rs = np.random.RandomState(seed)
    base = rs.uniform(0, BOX, size=(N, 3)).astype(np.float32)
    return base, (base[None] + rs.normal(scale=0.08, size=(n_frames, N, 3))
                  ).astype(np.float32)


def _state(seed=1):
    """Replica state as B4 takes it (the rebased displacement A included).
    A third of the replicas come from a site whose 3 nearest do not hold
    their last site while the last site's 3 nearest hold theirs: the
    one-way connection that check_from_old repairs."""
    rs = np.random.RandomState(seed)
    i32, f32 = np.int32, np.float32
    st = dict(
        site=rs.randint(0, N, R).astype(i32),
        last=np.where(rs.rand(R) < 0.6, rs.randint(0, N, R), -1).astype(i32),
        fsj=rs.randint(-1, 12, R).astype(i32),
        wait=np.where(rs.rand(R) < 0.3, rs.randint(1, 4, R), 0).astype(i32),
        jumps=rs.randint(0, 5, R).astype(i32),
        ev_count=rs.randint(0, 9, R).astype(i32),
        u_rem=rs.exponential(size=R).astype(f32),
        corr=rs.normal(scale=0.1, size=(R, 3)).astype(f32),
        disp_base=rs.normal(scale=1.0, size=(R, 3)).astype(f32),
    )
    _, topi, _ = ws.water_tables(torch.from_numpy(_frames()[1][:1]), (BOX,) * 3, 3,
                                 ws.T_NONE, np.zeros(5, f32))
    nbr = topi[0].T.numpy()  # [N, 3]
    one_way = [(s, o) for o in range(N) for s in nbr[o] if o not in nbr[s]]
    for r in range(0, R, 3):
        st["site"][r], st["last"][r] = one_way[rs.randint(len(one_way))]
    return st


def _statics(jm):
    """The static arguments run_water_block_fused gives B4 for this model."""
    tkind, tparams, tx, ty = jwm._transform_spec(jm)
    return (tkind, np.asarray(tparams), tx, ty, dict(
        kind=jks.law_kind(jm.law), tkind=tkind, k_atoms=jm.n_atoms, tile=TR,
        max_events=4, dt=float(DT), seed=SEED, relax=int(jm.relaxation_time),
        waiting=int(jm.waiting_time), keep_last=bool(jm.keep_last_neighbor_rescaled),
        check_old=bool(jm.check_from_old), d_oh=float(jm.d_oh), interpret=True,
        layout="rows"))


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's B4 run (interpret mode, rows layout): its inputs and outputs."""
    runs = {}
    base, pos = _frames()
    sd = np.random.RandomState(2).normal(scale=0.2, size=(N, 3)).astype(np.float32)
    for case in CASES:
        jm = _jax_model(case)
        st = _state()
        tkind, tparams, tx, ty, kw = _statics(jm)
        out = jws.water_sweep(
            jnp.asarray(pos), base, sd, *(st[k] for k in ws.STATE_KEYS),
            jks.law_params_array(jm.law), tparams, FRAME0, np.full(3, BOX, np.float32),
            TILE_OFFSET, interp_x=tx, interp_y=ty, **kw)
        names = ("site", "last", "fsj", "wait", "jumps", "ev_count", "u_rem", "corr",
                 "disp_base", "site_disp", "prev_pos", "trunc")
        runs[case] = (jm, base, pos, sd, st, dict(zip(names, (np.asarray(o) for o in out))))
    return runs


def _port_sweep(tm, pos, prev, sd, st, frame0=FRAME0, sweep=ws.water_sweep_reference):
    T = torch.from_numpy
    tkind, tparams, tx, ty = twm._transform_spec(tm)
    pos_t = T(np.ascontiguousarray(pos))
    tables = ws.water_tables(pos_t, (BOX,) * 3, tm.n_atoms, tkind, tparams, tx, ty)
    return sweep(
        pos_t, *tables, T(prev), T(sd), *(T(np.asarray(st[k])) for k in ws.STATE_KEYS),
        ks.law_params_array(tm.law), frame0, (BOX,) * 3, TILE_OFFSET,
        kind=ks.law_kind(tm.law), tile=TR, max_events=4, dt=DT, seed=SEED,
        relax=tm.relaxation_time, waiting=tm.waiting_time,
        keep_last=tm.keep_last_neighbor_rescaled, check_old=tm.check_from_old,
        d_oh=tm.host_d_oh)


INT_KEYS = ("site", "last", "fsj", "wait", "jumps", "ev_count", "trunc")
FLOAT_KEYS = ("u_rem", "corr", "disp_base", "site_disp", "prev_pos")


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax_kernel(jax_runs, case):
    jm, base, pos, sd, st, want = jax_runs[case]
    tm = convert.water_model_from_fields(jm)
    got = _port_sweep(tm, pos, base, sd, st)
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    fired = want["ev_count"] - st["ev_count"]
    assert fired.sum() > 20 and (fired > 0).sum() > R // 2, fired


def test_cases_reach_their_branches(jax_runs):
    """On the cases' data the options change the candidates: check_from_old
    swaps some replica's candidate, the 4-neighbor promotion moves one, the
    relaxation blend and the waiting gate change rates."""
    _, base, pos, _, st, _ = jax_runs["linear_check_old"]
    tm = convert.water_model_from_fields(_jax_model("linear_check_old"))
    tables = ws.water_tables(torch.from_numpy(pos), (BOX,) * 3, 3, ws.T_LINEAR,
                             twm._transform_spec(tm)[1])
    T = torch.from_numpy
    args = (tables[0][0], tables[1][0], tables[2][0], T(st["site"]), T(st["last"]),
            T(st["fsj"]), T(st["wait"]), ks.law_params_array(tm.law))
    kw = dict(kind=0, relax=10, keep_last=True)

    def differ(a, b):
        return int((a[0] != b[0]).any(dim=1).sum() + (a[1] != b[1]).any(dim=1).sum())

    base_c = ws.candidate_rates(*args, check_old=False, **kw)
    assert differ(ws.candidate_rates(*args, check_old=True, **kw), base_c) > 0
    assert differ(ws.candidate_rates(*args, check_old=False, **{**kw, "relax": 0}),
                  base_c) > 0
    assert bool((base_c[0][T(st["wait"]) > 0] == 0).all())
    tm4 = convert.water_model_from_fields(_jax_model("interp_k4"))
    t4 = ws.water_tables(torch.from_numpy(pos), (BOX,) * 3, 4, ws.T_INTERP,
                         *twm._transform_spec(tm4)[1:])
    # a last site in slot 3 of the site's row: the promotion fires
    site = T(st["site"]).long()
    last3 = t4[1][0][3, site].to(torch.int32)
    a4 = (t4[0][0], t4[1][0], t4[2][0], T(st["site"]), last3, T(st["fsj"]),
          torch.zeros(R, dtype=torch.int32), ks.law_params_array(tm4.law))
    promoted = ws.candidate_rates(*a4, kind=0, relax=6, keep_last=True, check_old=False)
    assert bool((promoted[1][:, 2] == last3.long()).all())


def test_chunk_invariance():
    """One 16-frame block equals two 8-frame blocks (draws are keyed by the
    absolute frame; the second block starts from the first's state)."""
    base, pos = _frames()
    sd = np.zeros((N, 3), np.float32)
    tm = convert.water_model_from_fields(_jax_model("linear_check_old"))
    st = _state()
    whole = _port_sweep(tm, pos, base, sd, st)
    a = _port_sweep(tm, pos[:8], base, sd, st)
    b = _port_sweep(tm, pos[8:], a["prev_pos"].numpy(), a["site_disp"].numpy(),
                    {k: a[k].numpy() for k in ws.STATE_KEYS}, frame0=FRAME0 + 8)
    for k in INT_KEYS[:-1] + FLOAT_KEYS:
        assert torch.equal(whole[k], b[k]), k
    assert torch.equal(whole["trunc"], a["trunc"] + b["trunc"])


# A pick draw (seed SEED, tile 0, event 0, salt 12) that rounds to exactly
# 1.0: (frame, replica in the tile)
PICK_ONE = (2051326, 3)


def test_pick_on_a_draw_of_one():
    """A draw of exactly 1.0 makes u2 = total; with the third candidate's
    rate underflowed to 0 (a Fermi rate past b + 88 c), B4's pick
    [u2 >= r0] + [u2 >= r0 + r1] lands on it. The port takes the last slot
    with a positive rate instead (ROADMAP queue C item 7)."""
    rates = torch.tensor([[0.05, 0.02, 0.0], [0.05, 0.0, 0.0], [0.05, 0.02, 0.01]])
    total = ws.total_rate(rates)
    assert ws.pick_slot(rates, total).tolist() == [1, 0, 2]
    frame, r = PICK_ONE
    key = rng.mix_key(SEED, 0, frame, 0, 12)
    assert float(rng.u01_counter(key, torch.tensor(r))) == 1.0
    # site 0 with its 3 nearest at 1.0, 1.5 and 20 A: the third's Fermi rate
    # (b = 2.3, c = 0.1) is 0 in float32
    n = 5
    pos = np.array([[0, 0, 0], [1.0, 0, 0], [0, 1.5, 0], [20.0, 0, 0], [0, 0, 21.0]],
                   np.float32)[None]
    box = (60.0,) * 3
    topd, topi, resc = ws.water_tables(torch.from_numpy(pos), box, 3, ws.T_NONE,
                                       np.zeros(5, np.float32))
    assert topi[0, :, 0].tolist() == [1, 2, 3]
    i32 = dict(dtype=torch.int32)
    zeros = torch.zeros(TR, **i32)
    params = ks.law_params_array(Fermi(a=0.06, b=2.3, c=0.1))
    rates, _ = ws.candidate_rates(topd[0], topi[0], resc[0], zeros, zeros - 1,
                                  zeros + 10**9, zeros, params, kind=0, relax=0,
                                  keep_last=False, check_old=False)
    assert float(rates[0, 2]) == 0.0 and float(rates[0, 0]) > 0
    out = ws.water_sweep_reference(
        torch.from_numpy(pos), topd, topi, resc, torch.from_numpy(pos[0]),
        torch.zeros((n, 3)), zeros, zeros - 1, zeros + 10**9, zeros, zeros, zeros,
        torch.zeros(TR), torch.zeros((TR, 3)), torch.zeros((TR, 3)), params, frame,
        box, 0, kind=0, tile=TR, max_events=1, dt=DT, seed=SEED, relax=0, waiting=0,
        keep_last=False, check_old=False, d_oh=0.0)
    assert int(out["ev_count"][r]) == 1
    assert int(out["site"][r]) == 2  # slot 1, not the zero-rate slot 2 (site 3)


def test_wrapper_refuses_cpu_tensors():
    base, pos = _frames(n_frames=2)
    tm = convert.water_model_from_fields(_jax_model("none"))
    with pytest.raises(ValueError, match="CUDA"):
        _port_sweep(tm, pos, base, np.zeros((N, 3), np.float32), _state(),
                    sweep=ws.water_sweep)


def test_states_carry_over():
    """convert.water_states_from_fields keeps every field, the clock too."""
    states = jwm.init_water_states(jax.random.key(1), 8, N, jnp.asarray(_frames(1)[0]))
    t = convert.water_states_from_fields(states)
    for f in dataclasses.fields(t):
        if f.name == "clock":
            for g in ("u_remaining", "event_count", "last_event_frame"):
                np.testing.assert_array_equal(getattr(t.clock, g).numpy(),
                                              np.asarray(getattr(states.clock, g)))
        else:
            np.testing.assert_array_equal(getattr(t, f.name).numpy(),
                                          np.asarray(getattr(states, f.name)))
