"""K7's prefix pre-pass on the CPU: its plain version
(``ops/water_sweep.py::water_prefix_reference``), the site prefix sum after
every frame of a block, which the kernel (``csrc/water_sweep.cu``,
``water_prefix_kernel``) writes once per block for the event loop to read at
an event. Held bit for bit against the prefix that ``water_sweep_reference``
carries frame by frame and returns, across block cuts, and against B4's
arithmetic written out in jnp. The kernel itself is held to this on the
card in ``test_torch_kernels_cuda_knn.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import torch

from cmdlmc_tpu_torch import convert
from cmdlmc_tpu_torch.ops import water_sweep as ws
from test_torch_slice import jax_kernels_run_to_end  # noqa: F401  (runs by itself)
from test_torch_water import BOX, N, _f, _frames, _jax_model, _port_sweep, _state

torch.set_num_threads(1)


def _inputs(frames=12):
    """Frames that wander across the box's faces (so the minimum image
    wraps), the positions before the block and a nonzero start prefix."""
    base, pos = _frames(n_frames=frames, seed=5)
    drift = np.cumsum(np.random.RandomState(6).normal(scale=1.5, size=pos.shape), axis=0)
    pos = (pos + drift).astype(np.float32)
    sd = np.random.RandomState(2).normal(scale=0.2, size=(N, 3)).astype(np.float32)
    return base, pos, sd


def _prefix(pos, prev, sd):
    return ws.water_prefix_reference(torch.from_numpy(pos), torch.from_numpy(prev),
                                     torch.from_numpy(sd), (BOX,) * 3)


def test_prefix_equals_the_sweeps_frame_by_frame():
    """Row b of the pre-pass equals the site_disp that water_sweep_reference
    returns after frame b, run one frame a block, bit for bit; the last row
    equals the whole block's site_disp (s_out)."""
    base, pos, sd = _inputs()
    tm = convert.water_model_from_fields(_jax_model("linear_check_old"))
    rows = _prefix(pos, base, sd)
    assert rows.shape == (pos.shape[0], N, 3)
    st, prev, s = _state(), base, sd
    for f in range(pos.shape[0]):
        out = _port_sweep(tm, pos[f:f + 1], prev, s, st, frame0=5 + f)
        assert torch.equal(rows[f].view(torch.int32), out["site_disp"].view(torch.int32)), f
        st = {k: out[k].numpy() for k in ws.STATE_KEYS}
        prev, s = out["prev_pos"].numpy(), out["site_disp"].numpy()
    whole = _port_sweep(tm, pos, base, sd, _state())
    assert torch.equal(rows[-1].view(torch.int32), whole["site_disp"].view(torch.int32))


def test_prefix_of_12_frames_is_5_then_7():
    """12 frames in one pre-pass give the rows of 5 frames, then 7 frames
    from the first pass's last row and frame."""
    base, pos, sd = _inputs()
    whole = _prefix(pos, base, sd)
    a = _prefix(pos[:5], base, sd)
    b = _prefix(pos[5:], pos[4], a[-1].numpy())
    assert torch.equal(whole.view(torch.int32), torch.cat([a, b]).view(torch.int32))
    assert _prefix(pos[:0], base, sd).shape == (0, N, 3)


def test_prefix_matches_b4_arithmetic():
    """The rows against B4's prefix step written out in jnp
    (``cmdlmc_tpu/ops/water_sweep.py``: s += d - L round(d / L) of the
    frame-to-frame move), to an ulp or two: XLA on the CPU may contract the
    minimum image's multiply and subtract."""
    base, pos, sd = _inputs()
    rows = _prefix(pos, base, sd).numpy()
    s, prev = jnp.asarray(sd), jnp.asarray(base)
    for f in range(pos.shape[0]):
        post = jnp.asarray(pos[f])
        d = post - prev
        s = s + (d - _f(BOX) * jnp.round(d / _f(BOX)))
        prev = post
        np.testing.assert_allclose(rows[f], np.asarray(s), rtol=1e-6, atol=1e-6)
