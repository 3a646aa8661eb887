"""Two-process CPU (gloo) jobs of the port's trainers against one process
with the global batch (the JAX package's tests/test_distributed.py, for
torch.distributed): one pair of ranks of tests/helpers/torch_parallel_worker.py
(started once for the module, on free localhost ports) runs a tcp://
group, then an env:// one; each test runs its one-process reference while
the ranks work, then waits for them with a timeout, so a hung rendezvous
fails instead of hanging.

Tolerance: the group's mean of two half-batch gradients is the global
batch's up to float summation order, so per-step losses agree within 1e-6,
each gradient within 1e-6 of its largest magnitude, and the weights after
Adam within 1e-5 (Adam's early updates are
lr-sized and sign-driven where a gradient is rounding-small)."""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from mobilesuperresolution_tpu_torch.cli import pretrain, search, train_vsr
from mobilesuperresolution_tpu_torch.train.checkpoint import CheckpointManager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
import torch_parallel_worker as worker  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks, started once for the module: (their job dir, a function
    that waits for them, 180 s at most, and returns each rank's JSON line)."""
    jobs, wait = worker.start(str(tmp_path_factory.mktemp("ranks")))
    yield pathlib.Path(jobs), wait
    try:
        wait()
    except AssertionError:
        pass  # reported by the test that waited first


def global_batch_grads(device):
    """One process's gradients of the workers' step on the global batch."""
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

    m, opt = worker.tiny_sisr_model(device)
    make_sisr_step(m, opt)(tuple(torch.from_numpy(a).to(device) for a in worker.global_batch()))
    return {k: p.grad.cpu().numpy() for k, p in m.named_parameters()}


def check_grads(jobs, want, rtol):
    """Both ranks' group-mean gradients equal ``want``, each within ``rtol``
    of that gradient's largest magnitude."""
    for r in range(2):
        got = np.load(os.path.join(jobs, f"grads{r}.npz"))
        assert set(got.files) == set(want)
        for k, g in want.items():
            assert float(np.abs(got[k] - g).max()) <= rtol * float(np.abs(g).max()), (r, k)


def test_two_process_pretrain_matches_one_process(tmp_path, ranks):
    """cli.pretrain on two ranks (tcp:// rendezvous, batch 2 each, the LR
    scaled by 2) against one process with batch 4: the same per-step losses
    and weights; the group-mean gradients of one step on half batches equal
    the global batch's (1e-6 of each gradient's largest magnitude); the
    chief alone evaluates and writes (one metrics.jsonl, result.log, npz and
    checkpoint); a rank-1 NaN batch skips the update on both ranks; a
    SIGTERM on rank 0 stops both at the same step with one checkpoint, which
    a one-process resume refuses (process count 2)."""
    jobs, wait = ranks
    one = pretrain.main(["--job_dir", str(tmp_path / "one"), "--num_patches", "2", "--learning_rate", "1e-3"]
                        + worker.sisr_args(batch=4))
    want_grads = global_batch_grads(torch.device("cpu"))
    outs = [r["sisr"] for r in wait()]
    check_grads(jobs, want_grads, 1e-6)
    assert [r["world"] for r in outs] == [2, 2] and [r["rank"] for r in outs] == [0, 1]
    # synthetic_isr: 8 images x 2 patches = 16 items, 8 a rank, 4 steps of 2
    assert len(one["steps"]) == len(outs[0]["losses"]) == len(outs[1]["losses"]) == 4
    for r in outs:
        np.testing.assert_allclose(r["losses"], [s["loss"] for s in one["steps"]], atol=1e-6)
    assert outs[0]["eval"] and not outs[1]["eval"]
    job = jobs / "train"
    a, b = np.load(tmp_path / "one" / "weights" / "models.npz"), np.load(job / "weights" / "models.npz")
    for key in a:
        np.testing.assert_allclose(b[key], a[key], atol=1e-5, err_msg=key)
    assert (job / "result.log").read_text().count("Finish Training") == 1
    tags = [json.loads(ln)["tag"] for ln in (job / "metrics.jsonl").read_text().splitlines()]
    assert tags.count("training_loss_smooth") == 1
    assert sorted(os.listdir(job / "ckpt")) == ["1.pt", "run_meta.json"]
    for r in outs:
        assert r["nan_step"] == {"skipped": 1.0, "steps": 1, "unchanged": True}
        assert r["stop"] == {"preempted": {"epoch": 1, "batch": 16}, "steps": 16,
                             "ckpt": ["1.pt", "run_meta.json"]}
    ckpt = CheckpointManager(str(jobs / "stop"))
    assert ckpt.peek_extra(1) == {"batches_done": 16}
    try:
        ckpt.restore(None, None)
    except ValueError as e:
        assert "2-process job" in str(e)
    else:
        raise AssertionError("a one-process resume of a two-process checkpoint was not refused")


def test_two_process_vsr_and_search_match_one_process(tmp_path, ranks):
    """cli.train_vsr and cli.search on two ranks (--distributed: env://,
    batch 1 / 2 each) against one process with batch 2 / 4: the same
    per-step losses; the chief alone evaluates."""
    vsr = train_vsr.main(["--job_dir", str(tmp_path / "vsr"), "--device", "cpu", "--dataset", "synthetic_vsr",
                          "--eval_datasets", "synthetic_vsr", "--epochs", "1", "--synthetic_frames", "2",
                          "--image_batch", "2", "--train_batch_size", "2", "--lr_patch_size", "12"])
    nas = search.main(["--job_dir", str(tmp_path / "search"), "--device", "cpu", "--dataset", "synthetic_isr",
                       "--eval_datasets", "synthetic_isr", "--num_blocks", "2", "--num_residual_units", "8",
                       "--width_epochs", "1", "--epochs", "0", "--kernel_epochs", "0", "--lr_patch_size", "8",
                       "--train_batch_size", "4", "--num_patches", "1"])
    outs = [r["vsr"] for r in ranks[1]()]
    for r in outs:
        assert r["world"] == 2
        np.testing.assert_allclose(r["vsr_losses"], [s["loss"] for s in vsr["steps"]], atol=1e-6)
        np.testing.assert_allclose(r["search_losses"], [s["loss"] for s in nas["steps"]], atol=1e-6)
    assert len(outs[0]["vsr_losses"]) == len(vsr["steps"]) == 2 and len(nas["steps"]) == 2
    assert outs[0]["vsr_eval"] and not outs[1]["vsr_eval"]
    assert outs[0]["search_eval"] == 1 and outs[1]["search_eval"] == 0
