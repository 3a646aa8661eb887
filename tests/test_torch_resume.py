"""Port checkpoints and exact resume (train/checkpoint.py::CheckpointManager,
train/preemption.py, data/isr.py's start_batch, the trainers' --resume):
the contract tests/test_preemption.py holds for the JAX package. float32 on
the CPU, tiny models.

Tolerances: none. A resumed run does the same float32 arithmetic on the same
batches as the uninterrupted one, so its parameters and Adam state are
bit-equal (``torch.equal``); the batch streams equal the JAX package's
arrays exactly.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from mobilesuperresolution_tpu.core import modes as jmodes
from mobilesuperresolution_tpu.data import isr as jisr
from mobilesuperresolution_tpu.data.synthetic import SyntheticISRDataset as JSyntheticISRDataset
from mobilesuperresolution_tpu_torch.cli import pretrain, search
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data.isr import batch_iterator
from mobilesuperresolution_tpu_torch.data.synthetic import SyntheticISRDataset
from mobilesuperresolution_tpu_torch.models import BasicModel
from mobilesuperresolution_tpu_torch.nas.artifact import read_block_index
from mobilesuperresolution_tpu_torch.train.checkpoint import (
    CheckpointManager,
    jax_named_parameters,
    load_params_npz,
    random_jax_params,
)
from mobilesuperresolution_tpu_torch.train.preemption import PreemptionGuard
from mobilesuperresolution_tpu_torch.train.state import multistep_adam
from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

torch.set_num_threads(2)


class P:
    scale = 2
    lr_patch_size = 8
    ignored_boundary_size = 2
    num_patches = 2
    seed = 0


def _model_and_opt(seed=1):
    m = BasicModel(1, 8, 2)
    load_params_npz(m, random_jax_params(m, seed))
    m.train()
    return m, multistep_adam(jax_named_parameters(m), 1e-2, 2, 2)


def _assert_same_state(m1, o1, m2, o2):
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    s1, s2 = o1.state_dict(), o2.state_dict()
    assert (s1["applied"], s1["steps"]) == (s2["applied"], s2["steps"])
    a1, a2 = s1["adam"]["state"], s2["adam"]["state"]
    assert a1.keys() == a2.keys() and len(a1) == len(list(m1.parameters()))
    for i in a1:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a1[i][k], a2[i][k]), (i, k)


def test_checkpoint_manager_round_trip(tmp_path):
    """Params, Adam moments and counts, step, epoch and extra come back
    bit-equal; the three latest epochs are kept; a save over an existing
    epoch needs force; a run_meta written by another process count is
    refused."""
    m, opt = _model_and_opt()
    step = make_sisr_step(m, opt)
    rng = np.random.default_rng(0)
    for _ in range(2):
        step((torch.from_numpy(rng.random((2, 8, 8, 3), np.float32)),
              torch.from_numpy(rng.random((2, 16, 16, 3), np.float32))))
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_epoch() is None and ckpt.restore(m, opt) == 0 and ckpt.last_extra is None
    ckpt.save(1, m, opt, extra={"batches_done": 1})
    m2, opt2 = _model_and_opt(seed=2)
    assert CheckpointManager(str(tmp_path)).restore(m2, opt2) == 1
    _assert_same_state(m, opt, m2, opt2)
    assert opt2.steps == 2 and opt2.applied == 2
    for epoch in range(2, 6):
        ckpt.save(epoch, m, opt)
    assert ckpt.all_epochs() == [3, 4, 5] and ckpt.latest_epoch() == 5
    assert ckpt.peek_extra(5) is None and ckpt.peek_extra(1) is None
    with pytest.raises(FileExistsError):
        ckpt.save(5, m, opt)
    ckpt.save(5, m, opt, extra={"batches_done": 3}, force=True)
    assert ckpt.peek_extra(5) == {"batches_done": 3}
    assert ckpt.restore(m2, opt2, epoch=4) == 4 and ckpt.last_extra is None
    meta = os.path.join(str(tmp_path), "ckpt", "run_meta.json")
    assert json.load(open(meta)) == {"process_count": 1}
    json.dump({"process_count": 2}, open(meta, "w"))
    with pytest.raises(ValueError, match="2-process"):
        CheckpointManager(str(tmp_path)).restore(m2, opt2)


def test_guard_stops_on_budget_and_sigterm():
    """The step budget stops at its step; SIGTERM only sets a flag, read at
    the next step; the previous handler comes back."""
    g = PreemptionGuard(max_steps=3)
    try:
        assert [g.step_and_should_stop() for _ in range(4)] == [False, False, True, True]
    finally:
        g.restore_handlers()
    before = signal.getsignal(signal.SIGTERM)
    g = PreemptionGuard()
    try:
        assert g.step_and_should_stop() is False
        signal.raise_signal(signal.SIGTERM)
        assert g.step_and_should_stop() is True
    finally:
        g.restore_handlers()
    assert signal.getsignal(signal.SIGTERM) is before


def test_start_batch_replays_the_jax_stream():
    """batch_iterator(start_batch=k) yields the JAX package's _batches from
    batch k on, and the tail of the port's own full stream, bit for bit,
    prefetched or not."""
    tds = SyntheticISRDataset(modes.TRAIN, P(), num_images=3, hw=(40, 40))
    jds = JSyntheticISRDataset(jmodes.TRAIN, P(), num_images=3, hw=(40, 40))
    full = list(batch_iterator(tds, 2, shuffle=True, seed=7, drop_last=True))
    assert len(full) == 3
    for k, prefetch in ((0, 0), (2, 2)):
        got = list(batch_iterator(tds, 2, shuffle=True, seed=7, drop_last=True, prefetch=prefetch, start_batch=k))
        want = list(jisr._batches(jds, 2, True, 7, True, start_batch=k))
        assert len(got) == len(want) == 3 - k
        for g, w, f in zip(got, want, full[k:]):
            for a, b, c in zip(g, w, f):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)


def _pretrain(job, *extra):
    return pretrain.main(["--job_dir", str(job), "--device", "cpu", "--dataset", "synthetic_isr",
                          "--eval_datasets", "--num_blocks", "1", "--num_residual_units", "8", "--epochs", "2",
                          "--train_batch_size", "8", "--lr_patch_size", "8", "--num_patches", "2", *extra])


def _final_state(job):
    return torch.load(os.path.join(str(job), "ckpt", "2.pt"), weights_only=True)


def test_pretrain_preempt_resume_bit_exact(tmp_path):
    """16 items / batch 8 = 2 steps per epoch, 2 epochs. --max_steps_per_run 3
    stops in epoch 2 after its first batch; --resume replays the second. The
    final parameters, Adam moments and counts equal the uninterrupted run's
    bit for bit, and so does the weights npz. A --checkpoint_every_steps run
    writes its mid-epoch save and ends on the same weights."""
    ref = _pretrain(tmp_path / "ref")
    job = tmp_path / "job"
    first = _pretrain(job, "--max_steps_per_run", "3")
    assert first["preempted"] == {"epoch": 2, "batch": 1} and len(first["steps"]) == 3
    resumed = _pretrain(job, "--resume")
    assert resumed["resumed"] == {"epoch": 2, "batch": 1}
    assert [s["loss"] for s in first["steps"] + resumed["steps"]] == [s["loss"] for s in ref["steps"]]
    a, b = _final_state(tmp_path / "ref"), _final_state(job)
    assert (a["step"], a["epoch"], b["step"], b["epoch"]) == (4, 2, 4, 2) and "extra" not in b
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    sa, sb = a["optimizer"], b["optimizer"]
    assert (sa["applied"], sa["steps"]) == (sb["applied"], sb["steps"]) == (4, 4)
    for i, st in sa["adam"]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], sb["adam"]["state"][i][k]), (i, k)
    za, zb = (np.load(os.path.join(str(d), "weights", "models.npz")) for d in (tmp_path / "ref", job))
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    every = _pretrain(tmp_path / "every", "--checkpoint_every_steps", "1", "--epochs", "1")
    assert len(every["steps"]) == 2
    assert CheckpointManager(str(tmp_path / "every")).all_epochs() == [1]


def test_search_resume_completes_and_refuses_a_damaged_job(tmp_path):
    """A budget stop inside the width phase, then --resume re-enters that
    epoch at its batch with the phase's optimizer state and finishes every
    phase; a job dir with weights but no checkpoint is refused."""
    job = tmp_path / "search"
    common = ["--job_dir", str(job), "--device", "cpu", "--dataset", "synthetic_isr", "--eval_datasets",
              "--num_blocks", "2", "--num_residual_units", "8", "--width_search", "--speed_target", "5",
              "--width_epochs", "2", "--epochs", "0", "--kernel_epochs", "1", "--train_batch_size", "4",
              "--lr_patch_size", "8", "--num_patches", "1", "--log_steps", "1"]
    stopped = search.main(common + ["--max_steps_per_run", "3"])
    assert stopped["preempted"] == {"phase": "width", "epoch": 2, "batch": 1}
    resumed = search.main(common + ["--resume"])
    assert resumed["resumed"] == {"epoch": 2, "batch": 1}
    assert [(s["phase"], s["epoch"], s["batch"]) for s in resumed["steps"]] == [
        ("width", 2, 1), ("kernel", 3, 0), ("kernel", 3, 1)]
    assert (read_block_index(str(job))[0], read_block_index(str(job))[1]) == (
        resumed["remain_idx"], resumed["remain_width"])
    assert CheckpointManager(str(job)).all_epochs() == [1, 2, 3]
    os.remove(os.path.join(str(job), "weights", "models.npz"))
    with pytest.raises(RuntimeError, match="inconsistent"):
        search.main(common + ["--resume"])
