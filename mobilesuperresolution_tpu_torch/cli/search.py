"""NAS search entry, the signature workload (counterpart of
mobilesuperresolution_tpu/cli/search.py).

    python -m mobilesuperresolution_tpu_torch.cli.search \\
        --job_dir runs/search --dataset div2k --eval_datasets set5 \\
        --scale 2 --num_blocks 16 --num_residual_units 32 --width_search \\
        --speed_target 500 --width_epochs 15 --epochs 15 --kernel_epochs 10 \\
        --num_patches 200 --train_batch_size 16 --lr_patch_size 48

Three phases (width → width + length → kernel), each with a fresh Adam over
its trainable parameters, train the supernet against L1 + a latency loss
whose target anneals over the first two; every ``--log_steps`` steps and
once at the end the surviving architecture is appended to
``<job_dir>/block_index.txt``, and after every epoch the eval sets are
scored and the weights written to ``<job_dir>/weights/models.npz`` (the JAX
package's flat layout) and the full state to ``<job_dir>/ckpt``.
``--resume`` continues across the phases (the latest epoch's weights and
batch position, the optimizer state of the phase it belongs to), and a
SIGTERM or ``--max_steps_per_run`` stop writes a mid-epoch checkpoint.
Runs on CUDA unless ``--device cpu`` is given; float32 convs run in full
float32 (TF32 off, the caller's flags restored). ``--pretrained``,
``--build_speed_table`` and ``--speed_predictor`` are not ported yet
(ROADMAP.md, queue A7) and are not parsed.
"""

import logging
import os
import time

import numpy as np
import torch

import mobilesuperresolution_tpu_torch.data as data_pkg
from mobilesuperresolution_tpu_torch.cli.common_cli import (
    add_train_args,
    base_parser,
    eval_modules,
    parse_with_plugins,
    resume_position,
    run_epoch,
    train_steps_per_epoch,
)
from mobilesuperresolution_tpu_torch.cli.pretrain import run_evaluation
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.core.device import no_tf32, resolve_device
from mobilesuperresolution_tpu_torch.core.utils import SpeedScheduler, attr_extractor
from mobilesuperresolution_tpu_torch.models import get_model
from mobilesuperresolution_tpu_torch.models.wdsr_nas import get_block_status, get_width_from_block_idx
from mobilesuperresolution_tpu_torch.nas.artifact import append_block_index
from mobilesuperresolution_tpu_torch.nas.search import PHASES, phase_epochs, phase_lr, phase_trainable_mask
from mobilesuperresolution_tpu_torch.nas.speed_estimator import KERNEL_CHOICES, densify_speed_table, get_ori_speed
from mobilesuperresolution_tpu_torch.nas.speed_loss import SpeedLoss
from mobilesuperresolution_tpu_torch.train.checkpoint import (
    CheckpointManager,
    jax_named_parameters,
    load_params_npz,
    save_params_npz,
)
from mobilesuperresolution_tpu_torch.train.preemption import PreemptionGuard
from mobilesuperresolution_tpu_torch.train.state import multistep_adam
from mobilesuperresolution_tpu_torch.train.steps import make_search_step

log = logging.getLogger("msr_torch.search")


def add_search_args(parser):
    parser.add_argument("--speed_target", type=float, default=40.0, help="Latency target in ms.")
    parser.add_argument("--width_epochs", type=int, default=15)
    parser.add_argument("--kernel_epochs", type=int, default=10)
    parser.add_argument("--no_speed_scheduler", action="store_true")
    parser.add_argument("--weight_sr_l1", type=float, default=1.0)
    parser.add_argument("--weight_speed", type=float, default=0.1)
    parser.add_argument("--speed_table", type=str, default=None,
                        help="Measured (N, 4) latency table [ch_in, ch_split, kernel, ms], "
                        "a .npy path; replaces the analytic latency model.")
    parser.add_argument("--speed_table_fill", type=str, default="linear", choices=("linear", "nearest"),
                        help="How off-grid channel configs get latencies from the table.")
    parser.add_argument("--log_steps", type=int, default=100)


def _arch(model):
    idx = get_block_status(model)
    return idx, get_width_from_block_idx(model, idx)


def main(argv=None):
    """Run the search; returns a summary: per-step metrics (``steps``), the
    per-epoch eval results (``eval``), the number of training forwards and
    eval images, and the final architecture."""
    parser = base_parser("NAS search (PyTorch/CUDA)")
    add_train_args(parser)
    add_search_args(parser)
    params = parse_with_plugins(parser, argv)
    params.model_type = "NAS_MODEL"
    params.width_search = True  # the canonical configuration (the reference's other one crashes)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(message)s")
    log.info(attr_extractor(params))
    device = resolve_device(params.device)
    with no_tf32(), torch.autograd.set_detect_anomaly(params.debug):
        return _search(params, device)


def _resume(params, ckpt, model, steps_per_epoch, summary):
    """``--resume`` across the phases, as the JAX search resumes: the
    weights come from the weights npz, the epoch from the latest checkpoint
    and the batch from its ``extra``; the optimizer state is restored when
    the phase it belongs to starts. Returns (start epoch, start batch),
    (0, 0) for a fresh start; a job dir with only one of the two artifacts
    is refused."""
    if not params.resume:
        return 0, 0
    latest = ckpt.latest_epoch()
    npz = os.path.join(params.job_dir, "weights", "models.npz")
    has_npz = os.path.exists(npz)
    if latest and has_npz:
        load_params_npz(model, npz)
        resume_batch = resume_position(ckpt.peek_extra(latest), steps_per_epoch)
        log.info(f"resuming search from epoch {latest}" + (f", batch {resume_batch}" if resume_batch else ""))
        summary["resumed"] = {"epoch": latest, "batch": resume_batch}
        return latest, resume_batch
    if bool(latest) != has_npz:
        # one artifact without the other is a damaged job dir: training from
        # scratch would overwrite the survivor
        raise RuntimeError(f"--resume found inconsistent state in {params.job_dir}: checkpoint epoch={latest}, "
                           f"weights npz {'present' if has_npz else 'missing'}; repair or clear the job dir")
    log.info("--resume: nothing to resume, starting fresh")
    return 0, 0


def _search(params, device):
    model = get_model(params, device=device)
    named = jax_named_parameters(model)
    train_ds = data_pkg.get_dataset_module(params.dataset).get_dataset(modes.TRAIN, params)
    steps_per_epoch = train_steps_per_epoch(len(train_ds), params.train_batch_size)

    speed_table = None
    if params.speed_table:
        if not (params.speed_table.endswith(".npy") and os.path.exists(params.speed_table)):
            raise SystemExit(f"--speed_table {params.speed_table!r}: not an existing .npy file")
        rows = np.load(params.speed_table)
        speed_table = torch.from_numpy(
            densify_speed_table(rows, max_ch=params.num_residual_units, method=params.speed_table_fill)
        ).to(device)
        u = params.num_residual_units
        ori_speed = float(params.num_blocks * speed_table[KERNEL_CHOICES.index(7), u, u])
        log.info(f"using measured latency table from {params.speed_table} (fill={params.speed_table_fill})")
    else:
        ori_speed = get_ori_speed(params.num_blocks, params.num_residual_units)
    log.info(f"Supernet Speed: {ori_speed:.02f} ms; target {params.speed_target:.02f} ms")
    if ori_speed <= params.speed_target:
        # the supernet already meets the target: a (ori - target) scale would
        # be <= 0 and the scheduler would anneal backwards, so use a
        # target-magnitude scale and a constant target
        log.warning("supernet already meets the speed target: latency pressure only penalizes regressions")
        speed_loss = SpeedLoss(scale=max(params.speed_target, 1e-6))
        total_speed = params.speed_target
    else:
        speed_loss = SpeedLoss(scale=ori_speed - params.speed_target)
        total_speed = ori_speed
    scheduler = SpeedScheduler(search_epoch=params.width_epochs + params.epochs, total_speed=total_speed,
                               target_speed=params.speed_target, gamma=0.5)

    eval_mods = eval_modules(params)
    n_eval_images = sum(len(mod.get_dataset(modes.EVAL, params)) for _, mod in eval_mods)
    summary = {"steps": [], "eval": [], "train_forwards": 0, "eval_images": 0}
    ckpt = CheckpointManager(params.job_dir)
    start_epoch, resume_batch = _resume(params, ckpt, model, steps_per_epoch, summary)
    guard = PreemptionGuard(params.max_steps_per_run)
    epoch = 0
    try:
        for phase in PHASES:
            n_epochs = phase_epochs(params, phase)
            if n_epochs == 0:
                continue
            log.info(f"=== phase {phase}: {n_epochs} epochs ===")
            opt = multistep_adam(named, phase_lr(params.learning_rate, phase), steps_per_epoch, n_epochs,
                                 trainable_mask=phase_trainable_mask(named, phase))
            if epoch < start_epoch < epoch + n_epochs or (resume_batch and epoch < start_epoch <= epoch + n_epochs):
                # resuming inside this phase: its saved optimizer state was made
                # with this phase's trainable mask
                ckpt.restore(model, opt)
            step = make_search_step(model, opt, speed_loss, params.weight_sr_l1, params.weight_speed, speed_table)
            for _ in range(n_epochs):
                epoch += 1
                if phase in ("width", "length") and not params.no_speed_scheduler:
                    target = scheduler.step()
                else:
                    target = params.speed_target
                if epoch < start_epoch or (epoch == start_epoch and not resume_batch):
                    continue  # trained before the resume point; the scheduler still advanced
                log.info(f"speed target: {target:.2f} ms")
                losses, t0 = [], time.time()

                def on_step(bidx, metrics):
                    metrics = {k: float(v) for k, v in metrics.items()}
                    summary["train_forwards"] += 1
                    summary["steps"].append(dict(metrics, phase=phase, epoch=epoch, batch=bidx, target=target))
                    losses.append(metrics["loss"])
                    if bidx % params.log_steps == 0:
                        remain_idx, remain_width = _arch(model)
                        append_block_index(params.job_dir, remain_idx, remain_width)
                        log.info(
                            f"[{phase} e{epoch} b{bidx}] loss={metrics['loss']:.4e} l1={metrics['l1']:.4e} "
                            f"speed={metrics['speed']:.2f}/{target:.2f}ms blocks={len(remain_idx)}"
                        )

                sb = resume_batch if epoch == start_epoch else 0
                stopped = run_epoch(params, train_ds, epoch, sb, lambda b: step(b, target), on_step, guard, ckpt,
                                    model, opt, device)
                if stopped is not None:
                    log.info(f"preempted in phase {phase} at epoch {epoch} batch {stopped}: mid-epoch checkpoint "
                             "written (--resume replays the rest of the epoch exactly)")
                    summary["preempted"] = {"phase": phase, "epoch": epoch, "batch": stopped}
                    return summary
                log.info(f"[{phase}] epoch {epoch}: loss={np.mean(losses):.4e} ({time.time() - t0:.1f}s)")
                res = run_evaluation(params, model, eval_mods, device)
                summary["eval"].append({"epoch": epoch, **res})
                summary["eval_images"] += n_eval_images
                # force: upgrade a mid-epoch save of this epoch
                ckpt.save(epoch, model, opt, force=True)
                save_params_npz(params.job_dir, model)
    finally:
        guard.restore_handlers()

    remain_idx, remain_width = _arch(model)
    append_block_index(params.job_dir, remain_idx, remain_width)
    log.info(f"final arch: {len(remain_idx)} blocks, widths={remain_width}")
    summary.update(remain_idx=remain_idx, remain_width=remain_width)
    return summary


if __name__ == "__main__":
    main()
