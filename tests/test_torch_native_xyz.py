"""The port's native xyz tokenizer (``cmdlmc_tpu_torch/native``) against the
JAX package's (``cmdlmc_tpu/native``), on the host: the same C++ source
built with the same flags, so every float must come out bit for bit the
same, on random text, on the text of chip_smoke.py's bench.py trajectory
and on malformed input. Also the port's reader through it, its numpy
fallback (``CMDLMC_NO_NATIVE``, a short native parse) and its build: named
by a hash of the source, written through a rename, safe to race. No JAX
kernel runs here."""

import logging
import os
import threading

import numpy as np
import pytest

from cmdlmc_tpu import native as jnative
from cmdlmc_tpu.io.xyz import XYZTrajectory as JXYZTrajectory
from cmdlmc_tpu_torch import native as tnative
from cmdlmc_tpu_torch.io import xyz as txyz


@pytest.fixture(scope="module", autouse=True)
def libs():
    if jnative.get_lib() is None or tnative.get_lib() is None:
        pytest.fail("g++ could not build the native tokenizer on this host")


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _same(text: bytes, n: int, first: int):
    want = jnative.parse_atom_lines(text, n, first)
    got = tnative.parse_atom_lines(text, n, first)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))
    return got


def _text(rng, n, fmt):
    pos = rng.uniform(-100, 100, size=(n, 3))
    return "".join(f"O{i % 7} {fmt(p[0])} {fmt(p[1])}\t{fmt(p[2])}\n"
                   for i, p in enumerate(pos)).encode()


def test_native_parse_equals_jax_bitwise():
    rng = np.random.RandomState(0)
    for fmt in (lambda x: f"{x:.8f}", lambda x: f"{x:.3f}",
                lambda x: f"{x:+.12f}", lambda x: f"{x:.6e}",
                lambda x: f"{x:E}", lambda x: f"{int(x)}"):
        names, pos = _same(_text(rng, 2000, fmt), 2000, 9)
        assert pos.shape == (2000, 3) and list(names[:2]) == ["O0", "O1"]


def bench_text(frames, n=144, box=14.5):
    """chip_smoke.py's bench.py trajectory body: uniform sites (seed 0),
    0.03 A of jitter a frame, six decimals."""
    rng = np.random.RandomState(0)
    base = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    block = (base[None] + np.stack([rng.normal(scale=0.03, size=base.shape)
                                    for _ in range(frames)])).astype(np.float32)
    return "".join(f"O {x:.6f} {y:.6f} {z:.6f}\n"
                   for x, y, z in block.reshape(-1, 3).tolist())


def test_bench_text_native_against_numpy():
    """On the bench.py trajectory's text the two native builds agree bit for
    bit. The hand-rolled float parser sums in double without correct
    rounding, so its float32 may differ from numpy's (a property of the
    reference, ROADMAP queue C): never by more than an ulp, here or on eight
    decimals."""
    text = bench_text(128)
    _, pos = _same(text.encode(), 128 * 144, 144)
    ref = np.array(text.split()).reshape(-1, 4)[:, 1:].astype(np.float32)
    ulps = np.abs(_bits(pos).astype(np.int64) - _bits(ref).astype(np.int64))
    assert ulps.max() <= 1
    rng = np.random.RandomState(1)
    text8 = _text(rng, 20000, lambda x: f"{x:.8f}")
    _, pos8 = _same(text8, 20000, 1)
    ref8 = np.array(text8.decode().split()).reshape(-1, 4)[:, 1:].astype(np.float32)
    ulps8 = np.abs(_bits(pos8).astype(np.int64) - _bits(ref8).astype(np.int64))
    assert ulps8.max() <= 1


def test_malformed_returns_none():
    for text in (b"O 1 2\n", b"O 1 2 x\n", b"O 1\nO 2 3 4\n", b"O 1 2 3\nH 4 5\n"):
        assert jnative.parse_atom_lines(text, 2, 2) is None, text
        assert tnative.parse_atom_lines(text, 2, 2) is None, text


def test_reader_goes_through_native_and_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "t.xyz"
    body = bench_text(40, n=12).splitlines(keepends=True)
    with open(path, "w") as f:
        for i in range(40):
            f.write(f"12\nframe {i}\n")
            f.writelines(body[12 * i:12 * (i + 1)])
    calls = []
    parse = tnative.parse_atom_lines
    monkeypatch.setattr(tnative, "parse_atom_lines",
                        lambda *a: calls.append(a[1]) or parse(*a))
    got = [b for b in txyz.XYZTrajectory(str(path), time_step=1.0,
                                         batch_frames=16).iter_batches()]
    want = list(JXYZTrajectory(str(path), time_step=1.0, batch_frames=16).iter_batches())
    assert calls == [16 * 12, 16 * 12, 8 * 12]
    assert len(got) == len(want) == 3
    for (gn, gp, gs), (wn, wp, ws) in zip(got, want):
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(_bits(gp), _bits(wp))
        assert gs == ws


def test_numpy_fallback(tmp_path, monkeypatch, caplog):
    """``CMDLMC_NO_NATIVE`` leaves the library unloaded and the reader on
    numpy; a native parse that comes back short is logged and redone."""
    body = bench_text(4, n=5).splitlines(keepends=True)
    want = np.array("".join(body).split()).reshape(-1, 4)[:, 1:].astype(
        np.float32).reshape(4, 5, 3)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setenv("CMDLMC_NO_NATIVE", "1")
    assert tnative.get_lib() is None
    names, pos = txyz._parse_batch(body, 5)
    np.testing.assert_array_equal(pos, want)
    assert list(names) == ["O"] * 5
    monkeypatch.setattr(tnative, "parse_atom_lines",
                        lambda text, n, first: (np.array(["O"] * 5), np.zeros((3, 3))))
    with caplog.at_level(logging.WARNING, logger="cmdlmc_tpu_torch.io.xyz"):
        _, pos = txyz._parse_batch(body, 5)
    np.testing.assert_array_equal(pos, want)
    assert "Native parser returned 3/20 atoms; falling back" in caplog.text


def test_build_is_keyed_atomic_and_races(tmp_path, monkeypatch):
    """The library lives in the port's _build/, named by a hash of its source
    and flags; builders that race each write through their own temporary
    file and a rename, so every one of them ends with a whole library."""
    path = tnative.so_path()
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(tnative.__file__)), "_build")
    assert os.path.basename(path).startswith("libcmdlmc_native_")
    assert os.path.exists(path)
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path))
    target = tnative.so_path()
    assert os.path.basename(target) == os.path.basename(path)
    results = []
    threads = [threading.Thread(target=lambda: results.append(tnative._build(target)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert results == [True] * 4
    assert os.listdir(tmp_path) == [os.path.basename(target)]
    import ctypes

    assert ctypes.CDLL(target).parse_atom_lines
