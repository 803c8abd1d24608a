"""Checkpoint / resume of simulation state.

Port of ``cmdlmc_tpu/utils/checkpoint.py`` with the JAX package's ``.npz``
layout, key for key: the state's fields flattened under ``state.``
(``state.replicas.clock.u_remaining``, ``state.nbr_carry.thresh``, ...),
``next_frame``, ``state_class`` and ``meta.*``, with ``NeighborCarry``'s
three floats as 0-d arrays that load back as Python scalars. A checkpoint
the JAX package wrote therefore loads into the port. Because the kernels
key their draws by seed, absolute frame and event ordinal, a resumed run
continues bit for bit where it left off.

``keys`` are the JAX package's scan-engine keys (threefry key data). The
port's kernels draw from the seed and never read them: a loaded ``keys``
array is carried through unchanged, and a run the port began writes none
(the JAX package cannot resume such a checkpoint).

Unlike JAX arrays, the port's tensors are mutable: the driver's block loop
updates the state in place (the jump matrix is added into where it lies).
So :meth:`CheckpointWriter.save` copies the state on the device before it
returns, and the worker thread copies that snapshot into pinned host memory
on a side stream that waits for the copy, so the write runs under the next
blocks' kernels and is never torn by them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any

import numpy as np
import torch

logger = logging.getLogger(__name__)

# NeighborCarry's fields that the JAX package registers as pytree metadata:
# saved as 0-d arrays, loaded back as Python floats
_META_FIELDS = ("thresh", "last_rebuild", "thrash_until")


def _map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor of its (nested) fields."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return obj


def _flatten(prefix: str, obj, out: dict):
    if obj is None:  # optional field (e.g. EnsembleState.nbr_carry)
        return
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flatten(f"{prefix}{f.name}.", getattr(obj, f.name), out)
    elif isinstance(obj, torch.Tensor):
        out[prefix.rstrip(".")] = obj.detach().cpu().numpy()
    else:
        out[prefix.rstrip(".")] = np.asarray(obj)


def _nested_class(field_name):
    from cmdlmc_tpu_torch.engine.clock import ClockState
    from cmdlmc_tpu_torch.engine.lattice import NeighborCarry, ReplicaState

    return {"clock": ClockState, "replicas": ReplicaState,
            "nbr_carry": NeighborCarry}[field_name]


def _rebuild(cls, prefix: str, data: dict, device):
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        if any(k.startswith(key + ".") for k in data):
            kwargs[f.name] = _rebuild(_nested_class(f.name), key + ".", data, device)
        elif key in data:
            val = data[key]
            if f.name in _META_FIELDS:
                kwargs[f.name] = val.item() if np.ndim(val) == 0 else val
            else:
                kwargs[f.name] = torch.from_numpy(np.ascontiguousarray(val)).to(device)
        elif f.default is None:
            kwargs[f.name] = None
        elif f.default is not dataclasses.MISSING:
            kwargs[f.name] = f.default
        else:
            raise KeyError(f"checkpoint is missing required field {key!r}")
    return cls(**kwargs)


def checkpoint_arrays(states, keys, next_frame: int,
                      meta: dict | None = None) -> dict[str, Any]:
    """The ``.npz`` entries of a checkpoint, as host arrays."""
    out: dict[str, Any] = {}
    _flatten("state.", states, out)
    if keys is not None:
        out["keys"] = np.asarray(keys)
    out["next_frame"] = np.int64(next_frame)
    out["state_class"] = np.bytes_(type(states).__name__.encode())
    if meta:
        for k, v in meta.items():
            out[f"meta.{k}"] = np.asarray(v)
    return out


def write_arrays(path: str, arrays: dict, compress: bool = False):
    """Write the entries to exactly ``path``: staged in ``path.tmp``, then
    renamed over it, so a crash mid-write never leaves a torn file where a
    resumable checkpoint was, and np.savez's ``.npz`` suffix is not added."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        (np.savez_compressed if compress else np.savez)(f, **arrays)
    os.replace(tmp, path)


def save_checkpoint(path: str, states, keys, next_frame: int,
                    meta: dict | None = None, compress: bool = False):
    """Persist replica states (+ the JAX package's keys, if any) and the
    stream position to ``path`` (.npz), synchronously. Uncompressed by
    default: the state is nearly incompressible floats."""
    write_arrays(path, checkpoint_arrays(states, keys, next_frame, meta), compress)


def snapshot(states):
    """A copy of every tensor of ``states`` on its own device, ordered on
    the current stream after the work that wrote them; and the device."""
    devices = set()

    def copy(t):
        devices.add(t.device)
        return t.detach().clone()

    snap = _map_tensors(states, copy)
    if len(devices) != 1:
        raise ValueError(f"a checkpoint's state must lie on one device, got {devices}")
    return snap, devices.pop()


class CheckpointWriter:
    """Overlaps checkpoint writes with device compute.

    ``save()`` copies the state on the device (:func:`snapshot`) and
    returns; a non-daemon worker thread then copies the snapshot into pinned
    host memory on a side stream that waits for the copy, and writes the
    file, while the main loop keeps launching kernels that change the state
    in place. Only one write is in flight: a new ``save()`` first joins the
    previous one.
    ``close()`` must be called before the run is declared complete; a failed
    write is logged at once and raised by the next ``save()``/``close()``.
    ``save_seconds`` holds the host time of the last ``save()`` call and
    ``write_seconds`` that of its write on the worker thread."""

    def __init__(self, path: str, compress: bool = False):
        self.path = path
        self.compress = compress
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.save_seconds = 0.0
        self.write_seconds = 0.0

    def _run(self, snap, device, ready, keys, next_frame, meta):
        t0 = time.perf_counter()
        try:
            if ready is not None:
                # into pinned memory by DMA on a side stream: a pageable
                # copy would stage through the driver and hold up the main
                # thread's launches while it runs
                side = torch.cuda.Stream(device=device)
                side.wait_event(ready)
                with torch.cuda.stream(side):
                    snap = _map_tensors(snap, lambda t: torch.empty(
                        t.shape, dtype=t.dtype, pin_memory=True).copy_(
                            t, non_blocking=True))
                side.synchronize()
            arrays = checkpoint_arrays(snap, keys, next_frame, meta)
            del snap
            write_arrays(self.path, arrays, self.compress)
        except Exception as e:  # surfaced on the next save()/close()
            logger.exception("checkpoint write to %s failed", self.path)
            self._error = e
        self.write_seconds = time.perf_counter() - t0

    def save(self, states, keys, next_frame: int, meta: dict | None = None):
        t0 = time.perf_counter()
        self.wait()
        snap, device = snapshot(states)
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        self._thread = threading.Thread(
            target=self._run, args=(snap, device, ready, keys, next_frame, meta),
            name="ckpt-writer", daemon=False,
        )
        self._thread.start()
        self.save_seconds = time.perf_counter() - t0

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()


def load_checkpoint(path: str, device="cpu", k: int | None = None):
    """Returns (states, keys, next_frame, meta), the states' tensors on
    ``device`` and ``keys`` the stored key data as a numpy array (None when
    the port began the run). A neighbor carry that the JAX package wrote
    holds its lists as float ids padded to whole tiles; it comes over with
    its first min(``k``, N - 1) rows, as ``convert.neighbor_carry_from_fields``
    takes them, so it needs the top-K model's ``k``."""
    from cmdlmc_tpu_torch.engine.lattice import EnsembleState, ReplicaState
    from cmdlmc_tpu_torch.models.water import WaterState

    with np.load(path) as f:
        data = {name: f[name] for name in f.files}
    cls_name = bytes(data.pop("state_class")).decode()
    cls = {"ReplicaState": ReplicaState, "WaterState": WaterState,
           "EnsembleState": EnsembleState}[cls_name]
    state_data = {
        name[len("state."):]: v for name, v in data.items() if name.startswith("state.")
    }
    topi = state_data.get("nbr_carry.ref_topi")
    if topi is not None and np.issubdtype(topi.dtype, np.floating):
        if k is None:
            raise ValueError(
                f"{path} holds a neighbor carry written by the JAX package "
                "(padded float lists); loading it needs the model's k")
        rows = min(int(k), state_data["nbr_carry.ref_pos"].shape[0] - 1)
        state_data["nbr_carry.ref_topi"] = np.rint(topi[:rows]).astype(np.int32)
        state_data["nbr_carry.ref_valid"] = (
            state_data["nbr_carry.ref_valid"][:rows] > 0.5)
    states = _rebuild(cls, "", state_data, torch.device(device))
    keys = data.get("keys")
    next_frame = int(data["next_frame"])
    meta = {
        name[len("meta."):]: v for name, v in data.items() if name.startswith("meta.")
    }
    return states, keys, next_frame, meta
