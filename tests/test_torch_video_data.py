"""Port parity for the Vimeo-90k and NEMO video datasets and the NEMO frame
pipeline (data/vimeo.py, data/nemo.py, data/yuv.py, data/frame_utils.py)
against the JAX package's modules, on tiny files under tmp_path.

NEMO's frame shapes (240x426 LR, 1080x1920 HR, told apart by file size) are
set to tiny ones in both packages for these tests. Everything is exact:
windows, CSV dumps, batches, items and the YUV420 → RGB conversion are
bit-equal.
"""

import argparse
import os
from types import SimpleNamespace

import numpy as np
import pytest

from mobilesuperresolution_tpu.core import modes as jmodes
from mobilesuperresolution_tpu.data import frame_utils as jframe_utils
from mobilesuperresolution_tpu.data import isr as jisr
from mobilesuperresolution_tpu.data import nemo as jnemo
from mobilesuperresolution_tpu.data import vimeo as jvimeo
from mobilesuperresolution_tpu.data import yuv as jyuv
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data import frame_utils, get_dataset_module, nemo, vimeo, yuv
from mobilesuperresolution_tpu_torch.data.isr import batch_iterator

LR, HR = (20, 24, 3), (80, 96, 3)


def _params(tmp_path, **kw):
    p = dict(scale=4, lr_patch_size=8, ignored_boundary_size=2, num_patches=2, seed=0, train_sample_patch=True,
             data_dir=str(tmp_path), cache_dir="", image_batch=3, val_image_batch=2)
    p.update(kw)
    return SimpleNamespace(**p)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, str):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)


def _same_datasets(ours, theirs, modes_pair, params):
    for mode, jmode in modes_pair:
        tds, jds = ours(mode, params), theirs(jmode, params)
        assert tds.lr_windows == jds.lr_windows and tds.hr_windows == jds.hr_windows
        _assert_batches_equal(batch_iterator(tds, 2, shuffle=True, seed=1, drop_last=True),
                              jisr._batches(jds, 2, True, 1, True))
        _assert_batches_equal(batch_iterator(tds), jisr._batches(jds, 1, False, 0, False))


def test_vimeo_items_match_jax(tmp_path):
    """Vimeo's layout (split/{lr,hr}/seq/subseq, 'lr'/'hr' tags in TRAIN):
    the same windows, TRAIN batches and EVAL items as the JAX reader."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, tagged in (("train", True), ("eval", False)):
        for seq in ("00001", "00002"):
            for sub in ("0001", "0002"):
                for i in range(3):
                    hr = (rng.random(HR) * 255).astype(np.uint8)
                    for kind, img in (("lr", hr[::4, ::4]), ("hr", hr)):
                        d = tmp_path / "vimeo" / split / kind / seq / sub
                        d.mkdir(parents=True, exist_ok=True)
                        name = f"im{i}_{kind}.png" if tagged else f"im{i}.png"
                        Image.fromarray(img).save(d / name)
                        if tagged:  # an untagged file the TRAIN filter drops
                            Image.fromarray(img).save(d / f"im{i}_other.png")
    p = _params(tmp_path)
    _same_datasets(vimeo.get_dataset, jvimeo.get_dataset, ((modes.TRAIN, jmodes.TRAIN), (modes.EVAL, jmodes.EVAL)),
                   p)
    ds = vimeo.get_dataset(modes.TRAIN, p)
    assert len(ds.lr_windows) == 4 and all(len(w) == 3 for w in ds.lr_windows)


@pytest.fixture
def tiny_nemo(monkeypatch):
    for mod in (nemo, jnemo):
        monkeypatch.setattr(mod, "LR_SHAPE", LR)
        monkeypatch.setattr(mod, "HR_SHAPE", HR)


@pytest.mark.parametrize("raw_order", ["rgb", "bgr"])
def test_nemo_items_and_csvs_match_jax(tmp_path, tiny_nemo, raw_order):
    """NEMO raw frames (28 per split; names with '_' skipped): the same
    windows (TRAIN every 25 frames, EVAL back to back), the same CSV dumps,
    TRAIN batches and EVAL items as the JAX reader, in either channel
    order."""
    rng = np.random.default_rng(1)
    for split in ("train", "eval"):
        for kind, shape in (("lr", LR), ("hr", HR)):
            d = tmp_path / "nemo" / split / kind
            d.mkdir(parents=True)
            for i in range(28):
                (rng.random(shape) * 255).astype(np.uint8).tofile(d / f"{i:04d}.raw")
            (rng.random(shape) * 255).astype(np.uint8).tofile(d / "0000_skip.raw")
    jobs = {k: tmp_path / k for k in ("ours", "theirs")}
    for j in jobs.values():
        j.mkdir()
    for mode, jmode in ((modes.TRAIN, jmodes.TRAIN), (modes.EVAL, jmodes.EVAL)):
        tds = nemo.get_dataset(mode, _params(tmp_path, raw_order=raw_order, job_dir=str(jobs["ours"])))
        jds = jnemo.get_dataset(jmode, _params(tmp_path, raw_order=raw_order, job_dir=str(jobs["theirs"])))
        assert tds.lr_windows == jds.lr_windows and tds.hr_windows == jds.hr_windows
        _assert_batches_equal(batch_iterator(tds, 2, shuffle=True, seed=1, drop_last=True),
                              jisr._batches(jds, 2, True, 1, True))
        _assert_batches_equal(batch_iterator(tds), jisr._batches(jds, 1, False, 0, False))
    assert sorted(os.listdir(jobs["ours"])) == sorted(os.listdir(jobs["theirs"])) == [
        "hr_eval.csv", "hr_train.csv", "lr_eval.csv", "lr_train.csv"]
    for name in os.listdir(jobs["ours"]):
        assert (jobs["ours"] / name).read_text() == (jobs["theirs"] / name).read_text()
    p = _params(tmp_path, raw_order=raw_order)
    assert [len(nemo.get_dataset(m, p).lr_windows) for m in (modes.TRAIN, modes.EVAL)] == [2, 14]
    frame = nemo.get_dataset(modes.EVAL, p)[0][1][0]
    raw = np.fromfile(tmp_path / "nemo" / "eval" / "lr" / "0000.raw", np.uint8).reshape(LR)
    np.testing.assert_array_equal(frame, (raw[..., ::-1] if raw_order == "bgr" else raw) / np.float32(255))


def test_video_datasets_registered():
    """Both names resolve, and each module's flags parse (NEMO's
    --raw_order among them); REDS with motion vectors is registered too, and
    an unknown name is refused."""
    for name, mod in (("vimeo", vimeo), ("nemo", nemo)):
        assert get_dataset_module(name) is mod
        parser = argparse.ArgumentParser()
        mod.update_argparser(parser)
        args = parser.parse_args(["--raw_order", "bgr"] if name == "nemo" else [])
        assert args.val_image_batch == (100 if name == "nemo" else 7)
    assert get_dataset_module("reds_with_mv").__name__.endswith("data.reds_with_mv")
    with pytest.raises(KeyError):
        get_dataset_module("nope")


@pytest.mark.parametrize("hw", [(16, 24), (2, 2), (10, 6)])
def test_yuv420_to_rgb_bit_equal(tmp_path, hw):
    """The integer YUV420 → RGB conversion equals the JAX package's numpy
    path bit for bit, and convert_yuv_dir writes the same .raw files."""
    h, w = hw
    rng = np.random.default_rng(h * w)
    planes = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    got = yuv.yuv420_to_rgb(*planes)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, jyuv.yuv420_to_rgb(*planes))
    src = tmp_path / "src"
    src.mkdir()
    for f in range(2):
        for ext, pl in zip((".y", ".u", ".v"), planes):
            np.roll(pl, f).tofile(src / f"{f:04d}{ext}")
    assert yuv.convert_yuv_dir(str(src), str(tmp_path / "a"), hw) == jyuv.convert_yuv_dir(
        str(src), str(tmp_path / "b"), hw) == 2
    for f in range(2):
        assert (tmp_path / "a" / f"{f:04d}.raw").read_bytes() == (tmp_path / "b" / f"{f:04d}.raw").read_bytes()


def test_frame_utils_match_jax(tmp_path):
    """renumber_frames gives the JAX package's mapping and result (a target
    that collides with a later source is not overwritten); check_raw_layout
    returns the same patch and refuses a wrong size."""
    names = ["b.png", "0000.png", "a.png", "c.txt"]
    for side in ("ours", "theirs"):
        d = tmp_path / side
        d.mkdir()
        for n in names:
            (d / n).write_text(n)
    assert frame_utils.renumber_frames(str(tmp_path / "ours"), dry_run=True) == jframe_utils.renumber_frames(
        str(tmp_path / "theirs"), dry_run=True)
    assert frame_utils.renumber_frames(str(tmp_path / "ours")) == jframe_utils.renumber_frames(
        str(tmp_path / "theirs"))
    for side in ("ours", "theirs"):
        assert {n: (tmp_path / side / n).read_text() for n in sorted(os.listdir(tmp_path / side))} == {
            "0000.png": "0000.png", "0001.png": "a.png", "0002.png": "b.png", "c.txt": "c.txt"}
    raw = tmp_path / "f.raw"
    np.arange(10 * 12 * 3, dtype=np.uint8).tofile(raw)
    np.testing.assert_array_equal(frame_utils.check_raw_layout(str(raw), (10, 12, 3)),
                                  jframe_utils.check_raw_layout(str(raw), (10, 12, 3)))
    with pytest.raises(ValueError, match="expected"):
        frame_utils.check_raw_layout(str(raw), (10, 12, 4))
