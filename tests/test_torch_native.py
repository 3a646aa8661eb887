"""The port's native data cores (core/native_path.py, data/native_loader.py,
data/native_imresize.py): each ctypes binding to the committed
``native/libloader.so`` / ``native/libimresize.so`` against the port's own
numpy path, bit for bit, on the cases of the JAX package's
tests/test_native.py, and the numpy path where a library is missing.
Host code only; no JAX is needed."""

import logging
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest

from mobilesuperresolution_tpu_torch.core import modes, native_path
from mobilesuperresolution_tpu_torch.data import native_imresize, native_loader, nemo
from mobilesuperresolution_tpu_torch.data.imresize import imresize_np
from mobilesuperresolution_tpu_torch.data.yuv import yuv420_to_rgb as yuv_numpy


def _yuv(rng, h, w, ch=None):
    ch = ch or (h // 2, w // 2)
    return (rng.integers(0, 256, (h, w), dtype=np.uint8), rng.integers(0, 256, ch, dtype=np.uint8),
            rng.integers(0, 256, ch, dtype=np.uint8))


def _raw_files(rng, d, shape, n):
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
    paths = []
    for i, f in enumerate(frames):
        p = d / f"{i:04d}.raw"
        f.tofile(p)
        paths.append(str(p))
    return frames, paths


def _imresize(rng, tmp_path, monkeypatch, scale):
    img = rng.integers(0, 256, (97, 113, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native_imresize.imresize_u8(img, scalar_scale=scale),
                                  imresize_np(img, scalar_scale=scale))


def _imresize_gray_shape(rng, tmp_path, monkeypatch):
    img = rng.integers(0, 256, (50, 61), dtype=np.uint8)
    np.testing.assert_array_equal(native_imresize.imresize_u8(img, output_shape=(23, 37)),
                                  imresize_np(img, output_shape=(23, 37)))


def _imresize_float(rng, tmp_path, monkeypatch):
    img = rng.random((20, 20, 3))
    np.testing.assert_array_equal(native_imresize.imresize_u8(img, scalar_scale=0.5),
                                  imresize_np(img, scalar_scale=0.5))


def _yuv_case(rng, tmp_path, monkeypatch, h, w, ch=None):
    y, u, v = _yuv(rng, h, w, ch)
    got = native_loader.yuv420_to_rgb(y, u, v)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, yuv_numpy(y, u, v))


def _raw_window(rng, tmp_path, monkeypatch, flip):
    frames, paths = _raw_files(rng, tmp_path, (6, 7, 3), 5)
    want = np.stack(frames)
    np.testing.assert_array_equal(native_loader.load_raw_window(paths, (6, 7, 3), flip_bgr=flip),
                                  want[..., ::-1] if flip else want)


def _raw_window_short_or_missing(rng, tmp_path, monkeypatch):
    frames, paths = _raw_files(rng, tmp_path, (4, 4, 3), 1)
    assert native_loader.load_raw_window(paths + [str(tmp_path / "missing.raw")], (4, 4, 3)) is None
    (tmp_path / "short.raw").write_bytes(b"\x00" * (frames[0].nbytes - 1))
    assert native_loader.load_raw_window([str(tmp_path / "short.raw")], (4, 4, 3)) is None
    with pytest.raises(ValueError, match="3-channel"):
        native_loader.load_raw_window(paths, (4, 4, 2), flip_bgr=True)


def _nemo_window(rng, tmp_path, monkeypatch):
    """A NEMO window read whole by the core equals the per-frame numpy read,
    BGR files flipped alike; a short frame falls back to numpy, which
    raises."""
    monkeypatch.setattr(nemo, "LR_SHAPE", (12, 10, 3))
    frames, paths = _raw_files(rng, tmp_path, nemo.LR_SHAPE, 3)
    window = [(f"lr/{i:04d}.raw", p) for i, p in enumerate(paths)]
    ds = nemo.NemoDataset(modes.EVAL, SimpleNamespace(num_patches=1, image_batch=3, seed=0), [window], [window],
                          raw_order="bgr")
    got = ds._load_window(window)
    want = [ds._load_frame(k, p) for k, p in window]
    assert len(got) == 3
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f[..., ::-1])
    lrs, hrs = ds._load_item(0)
    np.testing.assert_array_equal(np.stack(lrs), np.stack(got))
    with open(paths[1], "r+b") as fh:
        fh.truncate(5)
    with pytest.raises(ValueError):
        ds._load_window(window)


def _missing_library(rng, tmp_path, monkeypatch):
    """Without the libraries (an empty MSR_NATIVE_DIR and no repo copy) the
    loader logs the numpy path once and every entry point runs it."""
    monkeypatch.setattr(native_path, "find_native_lib", lambda name: None)
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append  # on the logger itself: the CLIs' LoggingTool stops propagation
    logger = logging.getLogger("msr_torch.native")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        assert native_path.load_native_lib("libloader.so") is None
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    assert any("numpy path" in r.getMessage() for r in records)
    monkeypatch.setattr(native_loader, "_lib", lambda: None)
    monkeypatch.setattr(native_imresize, "_lib", lambda: None)
    y, u, v = _yuv(rng, 8, 10)
    np.testing.assert_array_equal(native_loader.yuv420_to_rgb(y, u, v), yuv_numpy(y, u, v))
    _, paths = _raw_files(rng, tmp_path, (4, 4, 3), 2)
    assert native_loader.load_raw_window(paths, (4, 4, 3)) is None
    img = rng.integers(0, 256, (17, 19, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native_imresize.imresize_u8(img, scalar_scale=0.5),
                                  imresize_np(img, scalar_scale=0.5))


CASES = {
    "imresize_x0.5": partial(_imresize, scale=0.5),
    "imresize_x0.25": partial(_imresize, scale=0.25),
    "imresize_x1/3": partial(_imresize, scale=1.0 / 3.0),
    "imresize_x2": partial(_imresize, scale=2.0),
    "imresize_gray_output_shape": _imresize_gray_shape,
    "imresize_float_numpy": _imresize_float,
    "yuv_240x426": partial(_yuv_case, h=240, w=426),
    "yuv_odd_9x11": partial(_yuv_case, h=9, w=11, ch=(5, 6)),
    "yuv_chroma_mismatch": partial(_yuv_case, h=8, w=8, ch=(5, 5)),
    "raw_window": partial(_raw_window, flip=False),
    "raw_window_bgr": partial(_raw_window, flip=True),
    "raw_window_short_or_missing": _raw_window_short_or_missing,
    "nemo_window": _nemo_window,
    "missing_library": _missing_library,
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_cores_bit_equal_to_numpy(case, tmp_path, monkeypatch):
    """The committed libraries load here (so the core, not numpy, is what is
    compared), and each binding equals the numpy path bit for bit."""
    assert native_loader.native_available() and native_imresize.native_available()
    CASES[case](np.random.default_rng(sorted(CASES).index(case)), tmp_path, monkeypatch)
