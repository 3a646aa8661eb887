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
float32 (TF32 off, the caller's flags restored).

The latency model is the reference's analytic formula unless one of these
replaces it: ``--speed_table`` (a measured ``.npy``, a packaged table's
name or ``auto`` for this card's, nas/speed_estimator.py),
``--speed_predictor`` (a trained predictor's ``.msgpack``, a packaged name
or ``auto``, nas/speed_model.py) or ``--build_speed_table`` (time the
blocks on this card first, kernels/timing.py, and use that table, written
to ``<job_dir>/speed_table.npy``). ``--pretrained --pretrained_path`` copies
a reference WDSR-B ``.pt``'s head, tail and skip into the supernet
(train/torch_convert.py). ``--xla_profile_steps N`` traces the first N
steps (core/profiling.py). The log goes to stdout and
``<job_dir>/result.log``. ``--distributed`` searches with one process per
card, each on its slice of every epoch (parallel/distributed.py); the chief
evaluates and writes every artifact.
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
from mobilesuperresolution_tpu_torch.core.logging_tool import LoggingTool
from mobilesuperresolution_tpu_torch.core.profiling import StepProfiler
from mobilesuperresolution_tpu_torch.core.utils import SpeedScheduler, attr_extractor
from mobilesuperresolution_tpu_torch.models import get_model
from mobilesuperresolution_tpu_torch.models.wdsr_nas import get_block_status, get_width_from_block_idx
from mobilesuperresolution_tpu_torch.parallel import distributed
from mobilesuperresolution_tpu_torch.nas.artifact import append_block_index
from mobilesuperresolution_tpu_torch.nas.search import PHASES, phase_epochs, phase_lr, phase_trainable_mask
from mobilesuperresolution_tpu_torch.kernels import timing
from mobilesuperresolution_tpu_torch.nas.speed_estimator import (
    KERNEL_CHOICES,
    densify_from_predictor,
    densify_speed_table,
    device_kind,
    get_ori_speed,
    packaged_names,
    packaged_table_path,
)
from mobilesuperresolution_tpu_torch.nas.speed_loss import SpeedLoss
from mobilesuperresolution_tpu_torch.nas.speed_model import load_predictor, packaged_predictor_path
from mobilesuperresolution_tpu_torch.train.checkpoint import (
    CheckpointManager,
    jax_named_parameters,
    load_params_npz,
    save_params_npz,
)
from mobilesuperresolution_tpu_torch.train.preemption import PreemptionGuard
from mobilesuperresolution_tpu_torch.train.state import multistep_adam
from mobilesuperresolution_tpu_torch.train.steps import make_search_step
from mobilesuperresolution_tpu_torch.train.torch_convert import load_pretrained_supernet, load_torch_checkpoint

log = logging.getLogger("msr_torch.search")


def add_search_args(parser):
    parser.add_argument("--speed_target", type=float, default=40.0, help="Latency target in ms.")
    parser.add_argument("--width_epochs", type=int, default=15)
    parser.add_argument("--kernel_epochs", type=int, default=10)
    parser.add_argument("--no_speed_scheduler", action="store_true")
    parser.add_argument("--weight_sr_l1", type=float, default=1.0)
    parser.add_argument("--weight_speed", type=float, default=0.1)
    parser.add_argument("--speed_table", type=str, default=None,
                        help="Measured (N, 4) latency table [ch_in, ch_split, kernel, ms]: a .npy path from "
                        "kernels/timing.py, a packaged table's name (e.g. 'nvidia_h100_80gb_hbm3', "
                        "'tpu_v5_lite', 'huawei_p30_cpu') or 'auto' for this card's; replaces the analytic "
                        "latency model. Packaged tables are measured at 240x426 (the NEMO protocol's LR "
                        "size); for another deployment shape, re-measure with --build_speed_table.")
    parser.add_argument("--speed_table_fill", type=str, default="linear", choices=("linear", "nearest"),
                        help="How off-grid channel configs get latencies from the table.")
    parser.add_argument("--speed_predictor", type=str, default=None,
                        help="Trained SpeedPredictor weights: a .msgpack path (nas/speed_model.py), a packaged "
                        "name (e.g. 'tpu_v5_lite') or 'auto'. The MLP fills the dense latency table. Mutually "
                        "exclusive with --speed_table/--build_speed_table.")
    parser.add_argument("--build_speed_table", action="store_true",
                        help="Time the blocks on this card first (kernels/timing.py) and use the table, "
                        "written to <job_dir>/speed_table.npy.")
    parser.add_argument("--log_steps", type=int, default=100)
    parser.add_argument("--eval_tile", type=int, default=0,
                        help="Accepted as the JAX search accepts it, and read nowhere: the supernet's eval runs "
                        "whole images.")


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
    LoggingTool(params.job_dir)
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


def _packaged(flag, value, resolve):
    """The path a packaged-name or 'auto' flag value resolves to, else a
    SystemExit (for a table, listing the packaged ones)."""
    path = resolve(None if value == "auto" else value)
    if path is not None:
        return path
    if flag == "--speed_predictor":
        raise SystemExit(f"--speed_predictor {value!r}: not a file and no packaged predictor of that name "
                         "(nas/speed_tables/*_predictor.msgpack); train one with "
                         "nas.speed_model.train_speed_predictor on a measured table")
    shipped = packaged_names(".npy")
    if value == "auto":
        head = f"--speed_table auto: no packaged table for this backend (device kind {device_kind()!r})."
    else:
        head = f"--speed_table {value!r}: not a file and not a packaged table name."
    raise SystemExit(f"{head} Packaged tables: {shipped}. To measure THIS backend, re-run with "
                     "--build_speed_table (on-card timing harness, writes <job_dir>/speed_table.npy), or pass "
                     "one of the packaged names to target that device.")


def _latency_table(params, device):
    """The dense (3, C+1, C+1) latency table of the speed flags (numpy), or
    None for the analytic model. The flags are checked before any timing."""
    if params.speed_predictor and (params.speed_table or params.build_speed_table):
        raise SystemExit("--speed_predictor is mutually exclusive with --speed_table/--build_speed_table")
    u = params.num_residual_units
    if params.build_speed_table:
        table_path = os.path.join(params.job_dir, "speed_table.npy")
        if distributed.is_primary():  # the chief times its card; every process reads the table
            log.info("building the measured latency table on the card ...")
            rows = timing.build_latency_table(ch_in_choices=(u,), out_path=table_path, method="loop", device=device)
            log.info(f"latency table ({rows.shape[0]} rows) → {table_path}")
        distributed.barrier()
        params.speed_table = table_path
    if params.speed_table:
        if not os.path.exists(params.speed_table):
            params.speed_table = _packaged("--speed_table", params.speed_table, packaged_table_path)
        table = densify_speed_table(np.load(params.speed_table), max_ch=u, method=params.speed_table_fill)
        log.info(f"using measured latency table from {params.speed_table} (fill={params.speed_table_fill})")
        return table
    if params.speed_predictor:
        path = params.speed_predictor
        if not os.path.exists(path):
            path = _packaged("--speed_predictor", path, packaged_predictor_path)
        table = densify_from_predictor(load_predictor(path), max_ch=u)
        log.info(f"using MLP latency predictor from {path}")
        return table
    return None


def _load_pretrained(params, model):
    """``--pretrained``: the shape-greedy transfer of a reference WDSR-B
    ``.pt`` into the supernet; returns the tensors copied."""
    if not params.pretrained_path:
        raise SystemExit("--pretrained requires --pretrained_path <wdsr .pt>")
    current = {k: p.detach().cpu().numpy() for k, p in jax_named_parameters(model).items()}
    new, copied = load_pretrained_supernet(current, load_torch_checkpoint(params.pretrained_path))
    load_params_npz(model, new)
    log.info(f"pretrained transfer from {params.pretrained_path}: {copied} tensors copied")
    return copied


def _search(params, device):
    model = get_model(params, device=device)
    named = jax_named_parameters(model)
    train_ds = data_pkg.get_dataset_module(params.dataset).get_dataset(modes.TRAIN, params)
    steps_per_epoch = train_steps_per_epoch(len(train_ds), params.train_batch_size)

    speed_table = _latency_table(params, device)
    if speed_table is not None:
        # the supernet's baseline: num_blocks x the full-width k7 block, the
        # table's analog of get_ori_speed
        u = params.num_residual_units
        speed_table = torch.from_numpy(speed_table).to(device)
        ori_speed = float(params.num_blocks * speed_table[KERNEL_CHOICES.index(7), u, u])
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

    summary = {"steps": [], "eval": [], "train_forwards": 0, "eval_images": 0}
    if params.pretrained:
        summary["pretrained_copied"] = _load_pretrained(params, model)
    eval_mods = eval_modules(params)
    n_eval_images = sum(len(mod.get_dataset(modes.EVAL, params)) for _, mod in eval_mods)
    ckpt = CheckpointManager(params.job_dir)
    start_epoch, resume_batch = _resume(params, ckpt, model, steps_per_epoch, summary)
    distributed.broadcast_parameters(model)
    guard = PreemptionGuard(params.max_steps_per_run, device=device)
    prof = StepProfiler(params.job_dir, params.xla_profile_steps)
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
                    prof.step()
                    if bidx % params.log_steps == 0:
                        remain_idx, remain_width = _arch(model)
                        if distributed.is_primary():
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
                if distributed.is_primary():
                    res = run_evaluation(params, model, eval_mods, device)
                    summary["eval"].append({"epoch": epoch, **res})
                    summary["eval_images"] += n_eval_images
                # force: upgrade a mid-epoch save of this epoch (the chief
                # writes, every process waits for it)
                ckpt.save(epoch, model, opt, force=True)
                if distributed.is_primary():
                    save_params_npz(params.job_dir, model)
    finally:
        guard.restore_handlers()
        prof.close()

    remain_idx, remain_width = _arch(model)
    if distributed.is_primary():
        append_block_index(params.job_dir, remain_idx, remain_width)
    log.info(f"final arch: {len(remain_idx)} blocks, widths={remain_width}")
    summary.update(remain_idx=remain_idx, remain_width=remain_width)
    return summary


if __name__ == "__main__":
    main()
