"""Port parity for the rest of NAS: the flax-msgpack reader and writer, the
latency predictor MLP and its trainer, the packaged tables' and predictors'
lookup, the kernel timing harness and the search's latency flags.

float32 on the CPU against the JAX package (numpy converters and a flax
MLP; no JAX model forward is compiled). Tolerances: exact for the msgpack
bytes and arrays, the table grid and the converted weights; 1e-5 relative
for the MLP's outputs (six float32 matmuls summed in another order), 1e-5
for the split block (a few hundred float32 terms per output); 1e-4
relative for the trainer's report after 5 epochs (10 optimizer steps carry
the summation-order noise of each step into the next).
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from mobilesuperresolution_tpu.kernels import timing as jtiming
from mobilesuperresolution_tpu.nas import speed_estimator as jse
from mobilesuperresolution_tpu.nas import speed_model as jsm
from mobilesuperresolution_tpu_torch.cli import search
from mobilesuperresolution_tpu_torch.core import msgpack_io
from mobilesuperresolution_tpu_torch.kernels import timing
from mobilesuperresolution_tpu_torch.nas import speed_estimator as tse
from mobilesuperresolution_tpu_torch.nas import speed_model as tsm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import reference_state_dict  # noqa: E402
JAX_TABLES = os.path.join(REPO, "mobilesuperresolution_tpu", "nas", "speed_tables")
PREDICTORS = sorted(glob.glob(os.path.join(JAX_TABLES, "*_predictor.msgpack")))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _flax_params(name):
    return serialization.msgpack_restore(_read(os.path.join(JAX_TABLES, f"{name}_predictor.msgpack")))


@pytest.mark.parametrize("path", PREDICTORS, ids=lambda p: os.path.basename(p).split("_predictor")[0])
def test_msgpack_reader_matches_flax_and_round_trips(path):
    raw = _read(path)
    got, want = msgpack_io.unpackb(raw), serialization.msgpack_restore(raw)
    assert list(got) == list(want)
    for layer in want:
        assert list(got[layer]) == list(want[layer])
        for name, arr in want[layer].items():
            assert got[layer][name].dtype == arr.dtype and np.array_equal(got[layer][name], arr)
    assert msgpack_io.packb(got) == raw


def test_msgpack_writer_picks_the_smallest_encodings():
    """Every length class of the subset, against flax's own packer."""
    import msgpack

    for v in (0, 127, 128, 255, 256, 65536, 2 ** 32, -1, -32, -33, -129, -2 ** 31 - 1, "x" * 31, "x" * 32,
              "x" * 300, "x" * 70000, b"a" * 300, b"a" * 70000, list(range(16)), list(range(70000)),
              {str(i): i for i in range(20)}, np.zeros((2, 3), np.float32), np.arange(3, dtype=np.uint8),
              np.zeros((40, 40), np.float64), 1.5, None, True):
        want = msgpack.packb(v, default=serialization._msgpack_ext_pack, use_bin_type=True)
        assert msgpack_io.packb(v) == want
        back = msgpack_io.unpackb(want)
        assert np.array_equal(back, v) if isinstance(v, np.ndarray) else back == v


@pytest.mark.parametrize("name", ["tpu_v5_lite", "s10_gpu_x2"])
def test_speed_predictor_matches_flax_apply(name):
    params, jmodel = _jax_predictor(name)
    x = np.random.default_rng(0).uniform(1, 64, (50, jmodel.num_feat)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x))
    model = tsm.load_predictor(os.path.join(JAX_TABLES, f"{name}_predictor.msgpack"))
    assert (model.num_feat, model.widths) == (jmodel.num_feat, jmodel.widths)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _jax_predictor(name):
    """(params, flax SpeedPredictor) as the JAX package's load_predictor
    returns them, without its eagerly dispatched template init."""
    params = _flax_params(name)
    widths = tuple(params[f"Dense_{i}"]["kernel"].shape[1] for i in range(len(params) - 1))
    return params, jsm.SpeedPredictor(num_feat=params["Dense_0"]["kernel"].shape[0], widths=widths)


def test_densify_from_predictor_matches_jax_and_refuses_four_features():
    want = jse.densify_from_predictor(_jax_predictor("tpu_v5_lite"), max_ch=32)
    got = tse.densify_from_predictor(tsm.load_predictor(os.path.join(JAX_TABLES, "tpu_v5_lite_predictor.msgpack")),
                                     max_ch=32)
    assert got.shape == want.shape == (3, 33, 33) and got.dtype == np.float32 and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError) as jerr:
        jse.densify_from_predictor(_jax_predictor("s10_gpu_x2"), 8)
    with pytest.raises(ValueError) as terr:
        tse.densify_from_predictor(tsm.load_predictor(os.path.join(JAX_TABLES, "s10_gpu_x2_predictor.msgpack")), 8)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_speed_predictor_matches_jax(optimizer):
    """5 epochs on the v5e table from JAX's init: the same split, shuffles,
    schedule and optimizer give the same report."""
    rows = np.load(os.path.join(JAX_TABLES, "tpu_v5_lite.npy"))
    # the trainer's own init, dispatched eagerly as it dispatches it
    init = jax.tree_util.tree_map(
        np.asarray, jsm.SpeedPredictor(num_feat=3).init(jax.random.key(3), jnp.zeros((1, 3)))["params"])
    kw = dict(seed=3, epochs=5, lr=1e-3, optimizer=optimizer)
    _, want = jsm.train_speed_predictor(rows, **kw)
    model, got = tsm.train_speed_predictor(rows, init_params=init, **kw)
    for key in ("train_rel_err", "val_rel_err"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    # and a seeded start of its own: the JAX initializer's family
    fresh = tsm.init_predictor(tsm.SpeedPredictor(), seed=1)
    std = np.std(tsm.predictor_params(fresh)["Dense_2"]["kernel"])
    assert abs(std / (0.1 * np.sqrt(2 / 64)) - 1) < 0.05


def test_predictor_save_load_and_torch_conversion_match_jax(tmp_path):
    g = torch.Generator().manual_seed(0)
    dims = (3, 32, 64, 128, 64, 32, 1)
    sd = {}
    for name, (i, o) in zip(("fc1", "fc2", "fc3", "fc6", "fc7", "fc8"), zip(dims[:-1], dims[1:])):
        sd[f"{name}.weight"] = torch.randn(o, i, generator=g)
        sd[f"{name}.bias"] = torch.randn(o, generator=g)
    want, _ = jsm.convert_torch_speed_model({k: v.numpy() for k, v in sd.items()})
    model = tsm.convert_torch_speed_model(sd)
    got = tsm.predictor_params(model)
    assert list(got) == list(want)
    for layer in want:
        for name in ("kernel", "bias"):
            assert np.array_equal(got[layer][name], want[layer][name])
    path = str(tmp_path / "p.msgpack")
    tsm.save_predictor(model, path)
    assert _read(path) == serialization.to_bytes(want)
    jp = serialization.msgpack_restore(_read(path))
    assert all(np.array_equal(jp[k]["kernel"], want[k]["kernel"]) for k in want)
    est = tsm.MLPSpeedEstimator(tsm.load_predictor(path))
    np.testing.assert_allclose(est(24, 12, 5), jsm.MLPSpeedEstimator(jp)(24, 12, 5), rtol=1e-5)


def test_packaged_tables_and_predictors_resolve(monkeypatch, tmp_path):
    assert tse.packaged_table_path("tpu_v5_lite") == os.path.join(JAX_TABLES, "tpu_v5_lite.npy")
    assert tsm.packaged_predictor_path("tpu_v5_lite") == os.path.join(JAX_TABLES, "tpu_v5_lite_predictor.msgpack")
    assert tse.packaged_table_path("no_such_device") is None
    assert tsm.packaged_predictor_path("no_such_device") is None
    # the card's own table lives in the port and is found first
    h100 = tse.packaged_table_path("nvidia_h100_80gb_hbm3")
    assert h100 == os.path.join(tse.SPEED_TABLE_DIR, "nvidia_h100_80gb_hbm3.npy")
    rows = np.load(h100)
    assert rows.shape == (72, 4) and (rows[:, 3] >= 0).all() and np.isfinite(rows).all()
    assert rows[:, :3].tolist() == [list(r) for r in timing.latency_grid()]
    # 'auto' is this machine's device kind: the card's name, or 'cpu'
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert tse.packaged_table_path() == h100
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tse.device_kind() == "cpu" and tse.packaged_table_path() is None
    assert "tpu_v5_lite" in tse.packaged_names(".npy") and "nvidia_h100_80gb_hbm3" in tse.packaged_names(".npy")
    monkeypatch.setattr(tse, "JAX_SPEED_TABLE_DIR", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="missing"):
        tse.packaged_table_path("tpu_v5_lite")


# the mean relative error of the shipped H100 predictor over the 72 rows of
# its table, as scripts/torch_train_h100_predictor.py prints it (PERF.md §6)
H100_PREDICTOR_REL_ERR = 0.13239669799804688


def test_h100_predictor_ships_and_auto_resolves_it(monkeypatch):
    """The shipped H100 predictor loads, predicts its table's 72 rows within
    the reported mean relative error, and is what --speed_predictor auto
    resolves to on that card."""
    path = os.path.join(tse.SPEED_TABLE_DIR, "nvidia_h100_80gb_hbm3_predictor.msgpack")
    model = tsm.load_predictor(path)
    rows = np.load(os.path.join(tse.SPEED_TABLE_DIR, "nvidia_h100_80gb_hbm3.npy"))
    with torch.no_grad():
        pred = model(torch.from_numpy(rows[:, :3].astype(np.float32)))[:, 0].numpy()
    err = float(np.mean(np.abs(pred - rows[:, 3]) / rows[:, 3]))
    assert err <= H100_PREDICTOR_REL_ERR + 1e-6, err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert tse.device_kind() == "nvidia_h100_80gb_hbm3"
    assert search._packaged("--speed_predictor", "auto", tsm.packaged_predictor_path) == path


def test_build_latency_table_grid_on_cpu(monkeypatch):
    """The port's table at 8x8 on the CPU has the JAX harness's grid, in its
    row order (read off the JAX function with its timers stubbed), and
    every latency >= 0."""
    monkeypatch.setattr(jtiming, "benchmark_split_block", lambda *a, **k: 1.0)
    monkeypatch.setattr(jtiming, "time_fn", lambda *a, **k: 0.5)
    want = jtiming.build_latency_table()
    got = timing.build_latency_table(hw=(8, 8), runs=4, iters=2, method="loop", device="cpu")
    assert got.shape == (72, 4) and got.dtype == np.float32
    assert np.array_equal(got[:, :3], want[:, :3])
    assert (got[:, 3] >= 0).all() and np.isfinite(got).all()
    small = timing.build_latency_table(ch_in_choices=(8,), kernel_choices=(3,), hw=(4, 4), runs=3, device="cpu")
    assert small[:, :3].tolist() == [[8, 2, 3], [8, 4, 3], [8, 6, 3], [8, 8, 3]]
    calls = []
    timing.time_fn_loop(lambda c: calls.append(1) or c, torch.zeros(2), iters=3, reps=2, warmup=1)
    assert len(calls) == timing.loop_calls(iters=3, reps=2, warmup=1) == 12


def test_split_block_matches_jax_block():
    """JAX's block (timing.py:91-103) on its own weights against the port's
    (the same weights through the bridge): a partial split, k 5."""
    fwd, _ = jtiming._split_block_forward(8, 6, 5, (8, 8), jax.random.key(3))
    cells = dict(zip(fwd.__code__.co_freevars, (c.cell_contents for c in fwd.__closure__)))
    flat = {f"{m}/{n}": np.asarray(v) for m, d in cells["params"]["params"].items() for n, v in d.items()}
    x = np.random.default_rng(0).standard_normal((1, 8, 8, 8)).astype(np.float32)
    want = np.asarray(fwd(x))
    pf, zero = timing._split_block_forward(8, 6, 5, (8, 8), device="cpu", params=flat)
    assert zero.shape == (1, 8, 8, 8) and not zero.any()
    got = pf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[..., :2], x[..., :2])  # the passed-through channels


def _search_argv(job, *extra):
    return ["--job_dir", str(job), "--device", "cpu", "--dataset", "synthetic_isr", "--eval_datasets",
            "synthetic_isr", "--num_blocks", "2", "--num_residual_units", "8", "--width_epochs", "1", "--epochs",
            "0", "--kernel_epochs", "0", "--lr_patch_size", "8", "--train_batch_size", "4", "--num_patches", "1",
            *extra]


def test_search_builds_and_uses_a_speed_table_on_cpu(tmp_path, monkeypatch):
    """--build_speed_table times the units' 12 configs (the harness's grid
    shrunk to 8x8 here) into <job_dir>/speed_table.npy and searches on it;
    the supernet's baseline is num_blocks x the table's full-width k7."""
    built = []
    orig = timing.build_latency_table

    def small(**kw):
        built.append(kw)
        return orig(**{**kw, "hw": (8, 8), "runs": 4, "iters": 2})

    monkeypatch.setattr(timing, "build_latency_table", small)
    out = search.main(_search_argv(tmp_path, "--build_speed_table", "--log_steps", "1"))
    assert built[0]["ch_in_choices"] == (8,) and built[0]["method"] == "loop"
    rows = np.load(tmp_path / "speed_table.npy")
    assert rows.shape == (12, 4) and (rows[:, 3] >= 0).all()
    assert out["train_forwards"] == 2 and all(np.isfinite(s["speed"]) for s in out["steps"])
    table = tse.densify_speed_table(rows, max_ch=8)
    log = open(tmp_path / "result.log").read()
    assert f"Supernet Speed: {2 * table[2, 8, 8]:.02f} ms" in log


def test_search_predictor_packaged_table_and_pretrained_on_cpu(tmp_path):
    """--speed_predictor by packaged name, --speed_table by packaged name,
    and --pretrained from a seeded reference-layout WDSR-B .pt (9 tensors:
    head, tail, skip); the flags refuse what JAX refuses, before timing."""
    from mobilesuperresolution_tpu_torch.models import BasicModel
    from mobilesuperresolution_tpu_torch.train.checkpoint import random_jax_params

    out = search.main(_search_argv(tmp_path / "p", "--speed_predictor", "tpu_v5_lite"))
    assert np.isfinite(out["steps"][-1]["speed"])
    flat = random_jax_params(BasicModel(num_blocks=2, num_residual_units=8), 3)
    torch.save(reference_state_dict("wdsr", flat), tmp_path / "wdsr.pt")
    out = search.main(_search_argv(tmp_path / "t", "--speed_table", "tpu_v5_lite", "--pretrained",
                                   "--pretrained_path", str(tmp_path / "wdsr.pt")))
    assert out["pretrained_copied"] == 9
    for flags, match in ((["--speed_predictor", "x", "--build_speed_table"], "mutually exclusive"),
                         (["--speed_predictor", "nope"], "no packaged predictor"),
                         (["--speed_table", "auto"], "no packaged table for this backend"),
                         (["--pretrained"], "requires --pretrained_path")):
        with pytest.raises(SystemExit, match=match):
            search.main(_search_argv(tmp_path / "r", *flags))
