"""Shared CLI plumbing (counterpart of mobilesuperresolution_tpu/cli/common_cli.py).

Only flags that ported code reads are parsed; each entry point adds its own.
``--compile_cache`` concerns XLA alone and has no counterpart here.
``--distributed`` (torchrun's ``env://``) and ``--coordinator_address`` with
``--num_processes`` / ``--process_id`` (a ``tcp://`` rendezvous) join a
process group right after parsing (parallel/distributed.py): one process per
device, NCCL on CUDA and gloo on the CPU, each process training on its slice
of every epoch. ``--xla_profile_steps`` keeps its name and traces with
torch.profiler (core/profiling.py). ``--device`` picks CUDA (the default) or
the CPU.
"""

import argparse
import logging
import os
import time

import mobilesuperresolution_tpu_torch.data as data_pkg
import mobilesuperresolution_tpu_torch.models as models_pkg
from mobilesuperresolution_tpu_torch.core.meters import AverageMeter
from mobilesuperresolution_tpu_torch.core.metrics_writer import MetricsWriter
from mobilesuperresolution_tpu_torch.core.profiling import StepProfiler
from mobilesuperresolution_tpu_torch.data import isr
from mobilesuperresolution_tpu_torch.parallel import distributed
from mobilesuperresolution_tpu_torch.parallel.mesh import shard_batch
from mobilesuperresolution_tpu_torch.train import torch_convert as tc
from mobilesuperresolution_tpu_torch.train.checkpoint import CheckpointManager, load_params_npz, save_params_npz
from mobilesuperresolution_tpu_torch.train.preemption import PreemptionGuard, save_midepoch

log = logging.getLogger("msr_torch.train")


def train_steps_per_epoch(n_items, batch_size):
    """Optimizer steps each process runs per epoch: its ceil(n/P) items
    (``isr.batch_iterator``'s wrap-padded slice) in drop-last batches of
    the per-process batch size. The LR schedule's milestones count these, so
    counting the global items would fire them P times too late."""
    per_process = -(-n_items // distributed.process_count())
    return max(per_process // batch_size, 1)


def base_parser(description):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--job_dir", type=str, required=True)
    parser.add_argument("--dataset", type=str, default="div2k")
    parser.add_argument("--eval_datasets", type=str, nargs="*", default=["set5"])
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the random weights and of the training data order.")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute.")
    parser.add_argument("--save_eval_images", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="'cuda' (default) or 'cpu'.")
    parser.add_argument("--distributed", action="store_true",
                        help="Join a process group from torchrun's environment (env://: RANK, WORLD_SIZE, "
                        "MASTER_ADDR, MASTER_PORT, LOCAL_RANK): one process per card, NCCL (gloo with --device "
                        "cpu); each process trains on its slice of the data.")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0 for an explicit tcp:// rendezvous (with --num_processes and "
                        "--process_id).")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser


def add_train_args(parser):
    """Training flags, and the TRAIN data flags (``data/isr.py``); call
    before ``parse_with_plugins`` so the dataset's defaults apply."""
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the latest checkpoint in job_dir (<job_dir>/ckpt).")
    parser.add_argument("--max_steps_per_run", type=int, default=0,
                        help="Stop after N optimizer steps of this process: write a mid-epoch checkpoint "
                        "and return (SIGTERM takes the same path at the next step). --resume replays the "
                        "rest of the epoch exactly. 0 = no budget.")
    parser.add_argument("--checkpoint_every_steps", type=int, default=0,
                        help="Also checkpoint every N optimizer steps within an epoch, so a hard crash "
                        "loses at most N steps. 0 = end-of-epoch saves only.")
    parser.add_argument("--debug", action="store_true",
                        help="Clamp epochs to 1 and turn on autograd's anomaly detection.")
    parser.add_argument("--xla_profile_steps", type=int, default=0,
                        help="Trace the first N optimizer steps with torch.profiler to "
                        "<job_dir>/profile/train/trace.json (core/profiling.py; the name is the JAX "
                        "package's). 0 = off.")
    isr.add_train_args(parser)


def add_eval_args(parser, tile=True):
    """The flags of the entry points that evaluate or train one model
    (cli/pretrain.py, cli/retrain_searched.py, cli/train_vsr.py); ``tile``
    adds the SISR ones' ``--eval_tile``."""
    parser.add_argument("--eval_model", type=str, default=None,
                        help="Path to a params .npz (the JAX package's flat layout) to evaluate or "
                        "initialize from.")
    parser.add_argument("--eval_only", action="store_true")
    if tile:
        parser.add_argument("--eval_tile", type=int, default=0,
                            help="Evaluate in overlapping tiles of this size (train/eval_tiling.py): exact, "
                            "bounded memory per forward. 0 = whole images.")


def parse_with_plugins(parser, argv=None, with_models=True):
    """Parse known args, let the dataset and (``with_models``) model modules
    inject their flags, then re-parse (the reference's plugin idiom)."""
    known, _ = parser.parse_known_args(argv)
    data_pkg.get_dataset_module(known.dataset).update_argparser(parser)
    if with_models:
        models_pkg.update_argparser(parser)
    params = parser.parse_args(argv)
    if getattr(params, "debug", False):
        params.epochs = 1
    # join the group before any device is touched: the process's card
    # follows its local rank
    distributed.initialize_from_params(params)
    os.makedirs(params.job_dir, exist_ok=True)
    return params


def resume_position(extra, steps_per_epoch):
    """The batch to re-enter a restored epoch at: the ``batches_done`` of a
    mid-epoch save's ``extra``, or 0 for an end-of-epoch save or one made on
    the epoch's last batch (the epoch is complete)."""
    done = int((extra or {}).get("batches_done", 0))
    return 0 if done >= steps_per_epoch else done


def run_epoch(params, train_ds, epoch, start_batch, step, on_step, guard, ckpt, model, optimizer, device):
    """One training epoch from batch ``start_batch``: shuffled drop-last
    batches of ``train_ds`` (seed ``params.seed + epoch``, made two ahead in
    a thread) moved to ``device`` and given to ``step``, then
    ``on_step(batch index, metrics)``. At a guard stop it writes a mid-epoch
    checkpoint and returns the number of batches done; every
    ``params.checkpoint_every_steps`` batches (but the last) it writes one and
    goes on. Returns None when the epoch ran to its end."""
    steps_per_epoch = train_steps_per_epoch(len(train_ds), params.train_batch_size)
    batches = isr.batch_iterator(train_ds, params.train_batch_size, shuffle=True, seed=params.seed + epoch,
                                 drop_last=True, prefetch=2, start_batch=start_batch, shard_by_process=True)
    for bidx, arrays in enumerate(batches, start=start_batch):
        on_step(bidx, step(shard_batch(device, arrays)))
        if guard.step_and_should_stop():
            save_midepoch(ckpt, params.job_dir, epoch, model, optimizer, bidx + 1)
            return bidx + 1
        every = params.checkpoint_every_steps
        if every and (bidx + 1) % every == 0 and bidx + 1 < steps_per_epoch:
            save_midepoch(ckpt, params.job_dir, epoch, model, optimizer, bidx + 1)
    return None


def fit(params, model, optimizer, step, train_ds, device, evaluate, eval_key="eval_images"):
    """The epoch loop of the trainers of one model (cli/pretrain.py,
    cli/retrain_searched.py, cli/train_vsr.py), as the JAX package's: train
    ``params.epochs`` epochs of ``step`` on ``train_ds`` (``run_epoch``),
    then after each ``evaluate(epoch) -> ({set name: metrics}, items)`` on
    freshly prepared weights (the chief's alone in a process group), a
    forced full-state save and the weights npz;
    ``--resume`` first restores the latest checkpoint and re-enters a
    mid-epoch one at its batch. Losses and eval metrics go to
    metrics.jsonl. Returns a summary: per-step metrics (``steps``), per-epoch
    eval results (``eval``), the number of training forwards and of eval
    items (``eval_key``), and ``resumed`` / ``preempted`` ({epoch, batch})
    when those happened."""
    steps_per_epoch = train_steps_per_epoch(len(train_ds), params.train_batch_size)
    summary = {"steps": [], "eval": [], "train_forwards": 0, eval_key: 0}
    ckpt = CheckpointManager(params.job_dir)
    start_epoch = resume_batch = 0
    if params.resume:
        start_epoch = ckpt.restore(model, optimizer)
        resume_batch = resume_position(ckpt.last_extra, steps_per_epoch)
        summary["resumed"] = {"epoch": start_epoch, "batch": resume_batch}
        log.info(f"resumed from epoch {start_epoch}" + (f", batch {resume_batch}" if resume_batch else ""))
    # every process starts from rank 0's parameters
    distributed.broadcast_parameters(model)
    writer = MetricsWriter(params.job_dir)
    guard = PreemptionGuard(params.max_steps_per_run, device=device)
    prof = StepProfiler(params.job_dir, params.xla_profile_steps)
    first_epoch = start_epoch if resume_batch else start_epoch + 1
    try:
        for epoch in range(first_epoch, params.epochs + 1):
            model.train()
            meter, t0 = AverageMeter(), time.time()

            def on_step(bidx, metrics):
                metrics = {k: float(v) for k, v in metrics.items()}
                meter.update(metrics["loss"])
                summary["train_forwards"] += 1
                summary["steps"].append(dict(metrics, epoch=epoch, batch=bidx))
                prof.step()

            sb = resume_batch if epoch == first_epoch else 0
            stopped = run_epoch(params, train_ds, epoch, sb, step, on_step, guard, ckpt, model, optimizer, device)
            if stopped is not None:
                log.info(f"preempted at epoch {epoch} batch {stopped}: mid-epoch checkpoint written "
                         "(--resume replays the rest of the epoch exactly)")
                summary["preempted"] = {"epoch": epoch, "batch": stopped}
                return summary
            log.info(f"epoch {epoch}: loss={meter.avg:.4e} ({meter.count} steps, {time.time() - t0:.1f}s)")
            writer.scalar("training_loss_smooth", meter.avg, epoch)
            # the eval path runs on the weights prepare() derives: stale after
            # every optimizer step until it runs again
            model.eval()
            model.prepare()
            if distributed.is_primary():
                # the chief evaluates (the parameters are equal everywhere)
                results, items = evaluate(epoch)
                for name, vals in results.items():
                    writer.scalars(vals, epoch, prefix=f"{name}/")
                summary["eval"].append({"epoch": epoch, **results})
                summary[eval_key] += items
            # force: upgrade a mid-epoch save of this epoch; the chief
            # writes, and every process waits for it here
            ckpt.save(epoch, model, optimizer, force=True)
            if distributed.is_primary():
                save_params_npz(params.job_dir, model)
    finally:
        guard.restore_handlers()
        prof.close()
    log.info("Finish Training")
    return summary


def eval_modules(params):
    return [(name, data_pkg.get_dataset_module(name)) for name in params.eval_datasets]


def load_vsr_eval_params(path, model_type, model):
    """Load evaluation weights into the VSR ``model``: a ``.pt`` / ``.pth``
    reference or mmedit checkpoint (its ``['params']`` unless the file
    holds SpyNet keys at the top), converted per model type
    (train/torch_convert.py) with its block count and width checked against
    the model, or else a params npz. Returns the model."""
    if not path.endswith((".pt", ".pth")):
        return load_params_npz(model, path)
    sd = tc.load_torch_checkpoint(path)
    if "params" in sd and not any(k.startswith("spynet") for k in sd):
        sd = sd["params"]
    if model_type == "basic_origin":
        converted, ckpt_blocks = tc.convert_basicvsr_origin_state_dict(sd)
        if ckpt_blocks != model.num_block:
            raise ValueError(f"checkpoint has {ckpt_blocks} trunk blocks but basic_origin expects {model.num_block}")
    elif model_type == "single":
        converted, ckpt_blocks, ckpt_ch = tc.convert_single_image_state_dict(sd)
        channel = model.encoder.v.shape[-1]
        if (ckpt_blocks, ckpt_ch) != (model.num_blocks, channel):
            raise ValueError(f"checkpoint is a {ckpt_blocks}-block/{ckpt_ch}-ch 'single' model; got --num_blocks "
                             f"{model.num_blocks} channel {channel}")
    elif model_type == "multi":
        converted, ckpt_blocks = tc.convert_naive_multi_state_dict(sd)
        if ckpt_blocks != len(model.idx):
            raise ValueError(f"checkpoint has {ckpt_blocks} body blocks but the block_index artifact "
                             f"(--model_path) describes {len(model.idx)} — they come from different searches")
    elif model_type == "basic_mv":
        converted, ckpt_blocks = tc.convert_mvvsr_state_dict(sd)
        if ckpt_blocks != model.num_block:
            raise ValueError(f"checkpoint has {ckpt_blocks} trunk blocks but basic_mv expects {model.num_block}")
    else:
        raise ValueError(
            f"torch checkpoint conversion is not available for {model_type!r} (the reference's mobile 'basic' "
            "variant cannot run in the reference itself — its conv_last shape is broadcast-impossible, see "
            "models/basicvsr.py:19-23); export npz weights instead"
        )
    return load_params_npz(model, converted)
