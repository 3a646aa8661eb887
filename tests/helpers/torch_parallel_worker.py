"""One rank of a two-process job of the port (gloo on the CPU, NCCL on two
cards), for tests/test_torch_parallel_multiprocess.py and
tests/test_torch_cuda.py. Prints one JSON line.

    python torch_parallel_worker.py --ports P Q --rank R --job DIR [--device cuda]

First it joins through --coordinator_address localhost:P (tcp://) and runs
cli.pretrain for one epoch; then, in the same group, one make_sisr_step on
its half of a seeded global batch (its averaged gradients to
DIR/grads<R>.npz) and one whose batch is non-finite on rank 1 only; then
cli.pretrain again, rank 0 sending itself a SIGTERM after its first step.
Then it leaves that group and joins another through --distributed (env://,
torchrun's variables with MASTER_PORT Q) for one epoch of cli.train_vsr and
of cli.search. On CUDA rank R computes on card R.

``start`` launches both ranks from a test.
"""

import argparse
import functools
import json
import os
import signal
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mobilesuperresolution_tpu_torch.cli import pretrain, search, train_vsr  # noqa: E402
from mobilesuperresolution_tpu_torch.parallel import distributed  # noqa: E402


def sisr_args(device="cpu", batch=2):
    return ["--device", device, "--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--num_blocks",
            "1", "--num_residual_units", "8", "--epochs", "1", "--lr_patch_size", "8", "--train_batch_size",
            str(batch)]


def tiny_sisr_model(device):
    """The gradient and NaN steps' model: WDSR-B x2, 1 block, 8 units."""
    from mobilesuperresolution_tpu_torch.models.wdsr_basic import BasicModel
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters, load_params_npz
    from mobilesuperresolution_tpu_torch.train.checkpoint import random_jax_params
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam

    m = BasicModel(num_blocks=1, num_residual_units=8, scale=2).to(device)
    load_params_npz(m, random_jax_params(m, 0))
    return m, multistep_adam(jax_named_parameters(m), 1e-3, 10, 1)


def global_batch():
    """The gradient step's seeded global batch of 4 (LR 8x8, HR 16x16)."""
    rng = np.random.default_rng(7)
    return rng.random((4, 8, 8, 3), dtype=np.float32), rng.random((4, 16, 16, 3), dtype=np.float32)


def _losses(summary):
    return [s["loss"] for s in summary["steps"]]


def sisr(args):
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

    join = ["--coordinator_address", f"localhost:{args.ports[0]}", "--num_processes", "2", "--process_id",
            str(args.rank)]
    out = pretrain.main(["--job_dir", os.path.join(args.job, "train"), "--num_patches", "2",
                         "--learning_rate", "5e-4"] + join + sisr_args(args.device))
    res = {"losses": _losses(out), "skipped": [s["skipped"] for s in out["steps"]], "eval": out["eval"],
           "world": distributed.process_count(), "rank": distributed.process_index()}
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else torch.device("cpu")
    res["device"] = str(dev)

    # this rank's half of the global batch: the group's mean gradients
    m, opt = tiny_sisr_model(dev)
    half = slice(2 * args.rank, 2 * args.rank + 2)
    make_sisr_step(m, opt)(tuple(torch.from_numpy(a[half]).to(dev) for a in global_batch()))
    np.savez(os.path.join(args.job, f"grads{args.rank}.npz"),
             **{k: p.grad.cpu().numpy() for k, p in m.named_parameters()})

    # a batch that is non-finite on rank 1 only: every rank skips the update
    m, opt = tiny_sisr_model(dev)
    before = [p.detach().clone() for p in m.parameters()]
    lr = torch.rand(1, 8, 8, 3)
    if args.rank == 1:
        lr[0, 0, 0, 0] = float("nan")
    metrics = make_sisr_step(m, opt)((lr.to(dev), torch.rand(1, 16, 16, 3).to(dev)))
    res["nan_step"] = {"skipped": float(metrics["skipped"]), "steps": opt.steps,
                       "unchanged": all(torch.equal(a, p) for a, p in zip(before, m.parameters()))}

    # a SIGTERM on rank 0 after its first step: both stop at the first
    # exchange (step 16, PreemptionGuard's sync_every) with one checkpoint
    orig = pretrain.make_sisr_step

    def make_step(model, optimizer):
        step = orig(model, optimizer)

        def wrapped(batch):
            out = step(batch)
            if args.rank == 0 and optimizer.steps == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    pretrain.make_sisr_step = make_step
    job = os.path.join(args.job, "stop")
    out = pretrain.main(["--job_dir", job, "--num_patches", "10"] + join + sisr_args(args.device))
    res["stop"] = {"preempted": out.get("preempted"), "steps": len(out["steps"]),
                   "ckpt": sorted(os.listdir(os.path.join(job, "ckpt")))}
    return res


def vsr(args):
    os.environ.update(RANK=str(args.rank), WORLD_SIZE="2", LOCAL_RANK=str(args.rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(args.ports[1]))
    out = train_vsr.main(["--job_dir", os.path.join(args.job, "vsr"), "--distributed", "--device", args.device,
                          "--dataset", "synthetic_vsr", "--eval_datasets", "synthetic_vsr", "--epochs", "1",
                          "--synthetic_frames", "2", "--image_batch", "2", "--train_batch_size", "1",
                          "--lr_patch_size", "12"])
    res = {"vsr_losses": _losses(out), "vsr_eval": out["eval"], "world": distributed.process_count()}
    out = search.main(["--job_dir", os.path.join(args.job, "search"), "--distributed", "--device", args.device,
                       "--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--num_blocks", "2",
                       "--num_residual_units", "8", "--width_epochs", "1", "--epochs", "0", "--kernel_epochs", "0",
                       "--lr_patch_size", "8", "--train_batch_size", "2", "--num_patches", "1"])
    res["search_losses"] = _losses(out)
    res["search_eval"] = len(out["eval"])
    return res


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(tmp, device="cpu", timeout=180):
    """Start both ranks in ``tmp`` (stdout to files: an undrained pipe can
    block a rank mid-collective). Returns (their job dir, a function that
    waits for them, ``timeout`` s at most, once, kills what is left, and
    returns each rank's JSON line, raising with a rank's log if it
    failed)."""
    ports = [str(_free_port()), str(_free_port())]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, logs = [], []
    for r in range(2):
        logs.append(os.path.join(tmp, f"rank{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ports", *ports, "--rank",
                                           str(r), "--job", os.path.join(tmp, "job"), "--device", device],
                                          stdout=f, stderr=subprocess.STDOUT, env=env))

    @functools.lru_cache(maxsize=None)
    def wait():
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGKILL)
                    p.wait()
        outs = []
        for p, log in zip(procs, logs):
            with open(log) as f:
                text = f.read()
            if p.returncode != 0:
                raise AssertionError(text[-3000:])
            outs.append(json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1]))
        return outs

    return os.path.join(tmp, "job"), wait


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ports", type=int, nargs=2, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--job", required=True)
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = p.parse_args()
    os.makedirs(args.job, exist_ok=True)
    torch.set_num_threads(1)
    # full float32 on the card, as the trainers run (core/device.py::no_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    res = {"sisr": sisr(args)}
    distributed.shutdown()
    res["vsr"] = vsr(args)
    distributed.shutdown()
    print(json.dumps(res, default=float))


if __name__ == "__main__":
    main()
