"""The port's per-frame KMC clock (``engine/clock.py``) against the JAX
package's on the CPU, and the properties of ``tests/engine/test_clock.py``
(the reference's ``fastforward_to_next_jump`` tests) on the port.

``fastforward_events`` from the same key: the events per frame exact, the
in-frame phases within 1e-6 relative, with a floor of 1e-6 fs for phases
near 0 (torch's ``log1p`` may round an ulp from XLA's, and the remaining
draw carries that into the phase). The properties: a zero rate never fires and keeps its draw;
cutting the frames into two chunks gives the same events; at a constant
rate the events are the exponential draws of the same stream laid end to
end; replicas with different keys differ, around the expected count;
events land only on the frames with a nonzero rate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdlmc_tpu.engine import clock as jclock
from cmdlmc_tpu_torch.engine import clock as tclock
from cmdlmc_tpu_torch.ops import threefry as tf

torch.set_num_threads(1)


def _times(n_fired, phases, dt):
    """Absolute event times in order from per-frame counts and phases."""
    n_fired, phases = np.asarray(n_fired), np.asarray(phases, np.float64)
    return np.array([f * dt + phases[f, s] for f in range(len(n_fired))
                     for s in range(n_fired[f])])


def test_fastforward_matches_jax():
    rates = np.random.RandomState(0).uniform(0.0, 0.9, size=160).astype(np.float32)
    jn, jp = jclock.fastforward_events(jnp.asarray(rates), 0.5, jax.random.key(11),
                                       max_events=4)
    tn, tp = tclock.fastforward_events(torch.from_numpy(rates), 0.5, tf.key(11),
                                       max_events=4)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(np.nan_to_num(tp.numpy(), nan=-1),
                               np.nan_to_num(np.asarray(jp), nan=-1), rtol=1e-6, atol=1e-6)
    assert int(tn.sum()) > 30 and int(tn.max()) >= 2
    # the first clock and the timestamps
    jc = jclock.init_clock(jax.random.key(5))
    tc = tclock.init_clock(tf.key(5)[None])
    np.testing.assert_allclose(tc.u_remaining.numpy(), [float(jc.u_remaining)], rtol=1e-6)
    tc.last_event_frame[0], tc.last_event_phase[0] = 123456, 0.25
    assert float(tclock.event_time(tc, 0.5)[0]) == float(np.float32(61728.25))
    assert tclock.event_time_f64(tc, 0.1)[0] == 123456 * 0.1 + 0.25


def test_zero_rate_never_fires_and_keeps_its_draw():
    n, _ = tclock.fastforward_events(torch.zeros(100), 0.5, tf.key(0))
    assert int(n.sum()) == 0
    keys = tf.split(tf.key(0), 4)
    clock = tclock.init_clock(keys)
    u0 = clock.u_remaining.clone()
    for f in range(3):
        clock, aux, n = tclock.frame_step(
            clock, (), frame_idx=f, dt=0.5, rate_fn=lambda aux: torch.zeros(4),
            apply_fn=lambda aux, k, ph, fire: aux, key=keys)
    assert torch.equal(clock.u_remaining, u0) and int(n.sum()) == 0
    assert torch.equal(clock.event_count, torch.zeros(4, dtype=torch.int32))


def test_event_ordinal_keying_is_chunk_invariant():
    rates = torch.from_numpy(np.random.RandomState(1).uniform(0, 0.6, 120).astype(np.float32))
    key = tf.key(11)
    full_n, full_p = tclock.fastforward_events(rates, 0.5, key)
    keys = key[None]
    clock = tclock.init_clock(keys)
    got_n, got_p = [], []
    for chunk in (range(0, 60), range(60, 120)):  # a clock carried across the cut
        for f in chunk:
            def apply_fn(aux, k, ph, fire):
                slot, arr = aux
                new = arr.clone()
                new[0, slot.clamp(max=3).long()] = ph
                return slot + fire.to(torch.int32), torch.where(fire[:, None], new, arr)

            clock, (_, ph), n = tclock.frame_step(
                clock, (torch.zeros(1, dtype=torch.int32), torch.full((1, 4), float("nan"))),
                frame_idx=f, dt=0.5, rate_fn=lambda aux, r=rates[f]: r[None],
                apply_fn=apply_fn, key=keys)
            got_n.append(int(n))
            got_p.append(ph[0])
    assert got_n == full_n.tolist() and sum(got_n) > 10
    np.testing.assert_array_equal(np.nan_to_num(torch.stack(got_p).numpy(), nan=-1),
                                  np.nan_to_num(full_p.numpy(), nan=-1))


def test_constant_rate_matches_exponential_sampling():
    """At a constant rate omega the clock's event times are the stream's
    exponential draws over omega laid end to end (three omegas as three
    lanes of one key)."""
    omegas, dt, frames = (0.5, 0.8, 1.1), 1.3, 170
    key = tf.key(42)
    rates = torch.tensor(omegas, dtype=torch.float32).expand(frames, 3)
    n, ph = tclock.fastforward_events(rates, dt, key[None].expand(3, 2).contiguous(),
                                      max_events=8)
    assert int(n.max()) < 8  # no frame truncated
    draws = tf.exponential(tclock._draw_key(key, torch.arange(100))).numpy().astype(np.float64)
    for lane, omega in enumerate(omegas):
        times = _times(n[:, lane].numpy(), ph[:, lane].numpy(), dt)
        assert len(times) >= 100
        np.testing.assert_allclose(times[:100], np.cumsum(draws / np.float32(omega)),
                                   rtol=5e-4, atol=5e-3)
        frames_of = np.repeat(np.arange(frames), n[:, lane].numpy())
        in_frame = times - frames_of * dt
        assert np.all(in_frame >= 0) and np.all(in_frame <= dt * (1 + 1e-6))


def test_replicas_differ_around_the_expected_count():
    keys = tf.split(tf.key(0), 16)
    n, _ = tclock.fastforward_events(torch.full((200,), 0.2), 0.5, keys)
    counts = n.sum(dim=0).numpy()
    expected = 0.2 * 200 * 0.5
    assert len(set(counts.tolist())) > 1
    assert np.all(np.abs(counts - expected) < 6 * np.sqrt(expected))


@pytest.mark.parametrize("period,hot", [(13, 7)])
def test_events_land_on_the_frames_with_a_rate(period, hot):
    cycle = np.zeros(period, np.float32)
    cycle[hot] = 0.9
    n, _ = tclock.fastforward_events(torch.from_numpy(np.tile(cycle, 20)), 0.5, tf.key(3),
                                     max_events=3)
    fired = np.nonzero(n.numpy())[0]
    assert len(fired) > 3 and np.all(fired % period == hot)
