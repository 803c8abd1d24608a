"""The port's scan engine (``engine/lattice.py::run_block``) against the JAX
package's on the CPU: the same initial state (the JAX package's, carried over
by ``convert.ensemble_from_numpy``), the same keys
(``split(fold_in(key(seed), 1), R)``, carried over as key data) and the same
frames (numpy, from a seed), R = 8 replicas over 16-24 frames at N = 24-48.

The port reproduces JAX's threefry draws bit for bit, so it makes the same
decisions: the integer state (occupancy, labels, sites, jumps, event counts,
last event frames, histograms, jump matrix) is exact. Floats (times,
displacements, the clock's remaining draw, the rows) agree within 1e-5:
sums run in another order (torch's against XLA's reductions and matrix
product) and torch's ``log1p`` may differ from XLA's by an ulp.

Cases: dense Fermi with resets, equilibration, ``emit_every`` 2, 8
histogram bins and the jump matrix; a skewed triclinic cell (past the
kernels' skew gate); top-K k = 20 (past the kernel's 16); hydronium with a
ReLU transformation and the residence-time interpolator; AngleTopology
with FermiAngle; ``variance_mode = protons``; two blocks against one; and
``run_block_with_sites``. None of these reaches a Pallas kernel of the JAX
package (its distance kernel starts at 512 sites).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.core.cell import Cell as JCell
from cmdlmc_tpu.engine import lattice as jeng
from cmdlmc_tpu.rates import laws as jlaws
from cmdlmc_tpu.topo import models as jmodels
from cmdlmc_tpu.topo import transforms as jtr
from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.engine import fused as tfused
from cmdlmc_tpu_torch.engine import lattice as teng

torch.set_num_threads(1)

R, DT, SEED = 8, 0.5, 3
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
INT_FIELDS = ("occ", "proton_of_site", "site_of_proton", "jumps", "autocorr_ref",
              "jump_hist", "jump_matrix")
FLOAT_FIELDS = ("t_last_jump", "disp_base", "opportunity_hist")
ROW_FIELDS = ("msd_mean", "msd_var", "autocorr_mean", "autocorr_var", "jumps_mean",
              "events_mean", "truncated_mean", "msd4_mean")


def _f(x):
    return jnp.float32(x)


def _frames(n, frames, box, seed=0, scale=0.05):
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, box, (n, 3))
    return (base[None] + rng.normal(scale=scale, size=(frames, n, 3))).astype(np.float32)


def _jframes(pos, frame0=0, extras=None):
    idx = jnp.arange(frame0, frame0 + pos.shape[0], dtype=jnp.int32)
    return jmodels.Frame(donors=jnp.asarray(pos),
                         extras=None if extras is None else jnp.asarray(extras),
                         time=idx.astype(jnp.float32) * _f(DT), index=idx)


def _tframes(pos, frame0=0, extras=None):
    return teng.block_frames(torch.from_numpy(pos), frame0, DT,
                             None if extras is None else torch.from_numpy(extras))


def _start(n, protons, pos0, **kw):
    key = jax.random.key(SEED)
    ens = jeng.init_replicas(jax.random.fold_in(key, 0), R, n, protons,
                             jnp.asarray(pos0), **kw)
    keys = jax.random.split(jax.random.fold_in(key, 1), R)
    return ens, keys


def _assert_same(jens, tens, jrows=None, trows=None, label=""):
    a, b = jens.replicas, tens.replicas
    for name in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy(), err_msg=f"{label} {name}")
    for name in ("event_count", "last_event_frame"):
        np.testing.assert_array_equal(np.asarray(getattr(a.clock, name)),
                                      getattr(b.clock, name).numpy(), err_msg=f"{label} {name}")
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(a, name)), getattr(b, name).numpy(),
                                   err_msg=f"{label} {name}", **FLOAT_TOL)
    for name in ("u_remaining", "phase", "last_event_phase"):
        np.testing.assert_allclose(np.asarray(getattr(a.clock, name)),
                                   getattr(b.clock, name).numpy(),
                                   err_msg=f"{label} {name}", **FLOAT_TOL)
    for name in ("site_disp", "prev_pos"):
        np.testing.assert_allclose(np.asarray(getattr(jens, name)),
                                   getattr(tens, name).numpy(), err_msg=name, **FLOAT_TOL)
    assert int(b.clock.event_count.sum()) > 0, f"{label}: no event"
    if jrows is not None:
        trows = trows.cpu()
        np.testing.assert_array_equal(np.asarray(jrows.frame), trows.frame.numpy())
        np.testing.assert_array_equal(np.asarray(jrows.time), trows.time.numpy())
        for name in ROW_FIELDS:
            np.testing.assert_allclose(np.asarray(getattr(jrows, name)),
                                       getattr(trows, name).numpy(),
                                       err_msg=f"{label} row {name}", **FLOAT_TOL)


FERMI = dict(a=0.06, b=2.3, c=0.1)


def _dense(cell_kind="cube"):
    if cell_kind == "cube":
        box, n, protons = 9.0, 32, 12
        jcell = JCell.cubic(jnp.asarray([box] * 3, jnp.float32))
        pos = _frames(n, 24, box, seed=1)
    else:  # skewed: cutoff + buffer reaches past half the smallest height
        vectors = np.array([[9.0, 0, 0], [4.5, 8.0, 0], [2.0, 3.0, 8.0]], np.float32)
        jcell = JCell.triclinic(jnp.asarray(vectors))
        n, protons = 24, 10
        frac = np.random.RandomState(2).uniform(0, 1, (n, 3))
        base = frac @ vectors
        pos = (base[None] + np.random.RandomState(3).normal(
            scale=0.05, size=(16, n, 3))).astype(np.float32)
    law = jlaws.Fermi(**{k: _f(v) for k, v in FERMI.items()})
    model = jmodels.PairRates(cell=jcell, law=law, cutoff=_f(3.0), buffer=_f(1.5))
    return model, convert.pair_rates_from_fields(model), pos, protons


def _topk():
    box, n, protons = 9.0, 48, 16
    jcell = JCell.cubic(jnp.asarray([box] * 3, jnp.float32))
    law = jlaws.Fermi(a=_f(0.2), b=_f(2.3), c=_f(0.1))
    model = jmodels.TopKPairRates(cell=jcell, law=law, cutoff=_f(3.0), buffer=_f(2.0),
                                  k=20)
    return model, convert.topk_pair_rates_from_fields(model), _frames(n, 16, box), protons


def _hydronium():
    box, n, protons = 9.0, 32, 10
    jcell = JCell.cubic(jnp.asarray([box] * 3, jnp.float32))
    law = jlaws.Fermi(a=_f(0.2), b=_f(2.3), c=_f(0.1))
    transform = jtr.ReLUTransformation(a=_f(0.5), b=_f(2.2), d0=_f(2.2),
                                       left_bound=_f(2.0), right_bound=_f(3.3))
    model = jmodels.HydroniumRates(
        cell=jcell, law=law, cutoff=_f(3.0), buffer=_f(2.0), transform=transform,
        interpolator=jtr.DistanceInterpolator(relaxation_time=_f(2.0)), k=4)
    return model, convert.hydronium_rates_from_fields(model), _frames(n, 16, box), protons


def _angle():
    """8 P atoms, each with 4 O at 1.3 A, in a 12 A cube (the layout of
    tests/integration/test_full_pipeline.py)."""
    rng = np.random.RandomState(4)
    box, n_p = 12.0, 8
    p = rng.uniform(0, box, (n_p, 3))
    off = np.array([[1.3, 0, 0], [-1.3, 0, 0], [0, 1.3, 0], [0, -1.3, 0]])
    o = (p[:, None] + off[None]).reshape(-1, 3)
    frames = 16
    donors = (o[None] + rng.normal(scale=0.05, size=(frames,) + o.shape)).astype(np.float32)
    extras = (p[None] + rng.normal(scale=0.05, size=(frames,) + p.shape)).astype(np.float32)
    jcell = JCell.cubic(jnp.asarray([box] * 3, jnp.float32))
    law = jlaws.FermiAngle(a=_f(0.3), b=_f(2.3), c=_f(0.1), theta=_f(1.2))
    model = jmodels.AnglePairRates.from_first_frame(
        jcell, law, 3.0, 1.0, jnp.asarray(donors[0]), jnp.asarray(extras[0]), 4)
    return model, convert.angle_pair_rates_from_fields(model), donors, 12, extras


def _run_both(jmodel, tmodel, pos, protons, extras=None, init_kw=None, **kw):
    jens, keys = _start(pos.shape[1], protons, pos[0], **(init_kw or {}))
    tkeys = convert.keys_from_numpy(jax.random.key_data(keys))
    jout = jeng.run_block(jmodel, jmodel.cell, jens, keys, _jframes(pos, extras=extras),
                          dt=DT, **kw)
    tout = teng.run_block(tmodel, tmodel.cell, convert.ensemble_from_numpy(jens), tkeys,
                          _tframes(pos, extras=extras), dt=DT, **kw)
    return jout, tout


STATS = dict(init_kw=dict(hist_bins=8, track_jump_matrix=True), hist_range=(2.2, 3.0))


@pytest.mark.parametrize("case", ["dense", "triclinic", "topk20", "hydronium", "angle",
                                  "protons"])
def test_run_block_matches_jax(case):
    """Each rate model through the scan engine: the integer state exact,
    floats and rows within 1e-5."""
    if case in ("dense", "protons"):
        jmodel, tmodel, pos, protons = _dense()
        kw = dict(STATS, reset_frequency=5, equilibration=3, emit_every=2)
        if case == "protons":
            kw = dict(reset_frequency=7, variance_mode="protons")
        args = (pos, protons)
    elif case == "triclinic":
        jmodel, tmodel, pos, protons = _dense("skewed")
        assert "skewed" in tfused.fused_unsupported_reason(tmodel, tmodel.cell)
        args, kw = (pos, protons), dict(STATS)
    elif case == "topk20":
        jmodel, tmodel, pos, protons = _topk()
        assert "k=20" in tfused.fused_unsupported_reason(tmodel, tmodel.cell)
        args, kw = (pos, protons), dict(STATS, reset_frequency=6)
    elif case == "hydronium":
        jmodel, tmodel, pos, protons = _hydronium()
        args, kw = (pos, protons), dict(STATS)
    else:
        jmodel, tmodel, pos, protons, extras = _angle()
        args, kw = (pos, protons, extras), dict(reset_frequency=8)
    (jens, jrows), (tens, trows) = _run_both(jmodel, tmodel, *args, **kw)
    _assert_same(jens, tens, jrows, trows, case)
    if "init_kw" in kw:
        assert int(tens.replicas.jump_matrix.sum()) == int(
            tens.replicas.clock.event_count.sum())


def test_two_blocks_equal_one():
    """The event-ordinal keying: a block cut in two lands where one block
    does, bit for bit, and the given state is left as it was (the jump
    matrix is added into in place inside a block)."""
    _, tmodel, pos, protons = _dense()
    jens, keys = _start(pos.shape[1], protons, pos[0], hist_bins=4, track_jump_matrix=True)
    tkeys = convert.keys_from_numpy(jax.random.key_data(keys))
    start = convert.ensemble_from_numpy(jens)
    kw = dict(dt=DT, reset_frequency=5, hist_range=(2.0, 3.2))
    one, rows = teng.run_block(tmodel, tmodel.cell, start, tkeys, _tframes(pos), **kw)
    assert int(start.replicas.jump_matrix.sum()) == 0
    half, rows1 = teng.run_block(tmodel, tmodel.cell, start, tkeys, _tframes(pos[:10]), **kw)
    two, rows2 = teng.run_block(tmodel, tmodel.cell, half, tkeys,
                                _tframes(pos[10:], frame0=10), **kw)
    for a, b in ((one.replicas, two.replicas), (one.replicas.clock, two.replicas.clock)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name
    both = torch.cat([rows1.cpu().msd_mean, rows2.cpu().msd_mean])
    assert torch.equal(rows.cpu().msd_mean, both)


def test_run_block_with_sites_matches_jax():
    """Replica 0's sites after each frame, with the rows and state."""
    jmodel, tmodel, pos, protons = _dense()
    jens, keys = _start(pos.shape[1], protons, pos[0])
    tkeys = convert.keys_from_numpy(jax.random.key_data(keys))
    kw = dict(dt=DT, reset_frequency=4)
    jout, jrows, jsites = jeng.run_block_with_sites(jmodel, jmodel.cell, jens, keys,
                                                    _jframes(pos), **kw)
    tout, trows, tsites = teng.run_block_with_sites(
        tmodel, tmodel.cell, convert.ensemble_from_numpy(jens), tkeys, _tframes(pos), **kw)
    np.testing.assert_array_equal(np.asarray(jsites), tsites.numpy())
    _assert_same(jout, tout, jrows, trows, "with sites")
