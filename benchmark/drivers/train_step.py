"""Training driver: the port's VSR training step (``train/steps.py::
make_vsr_step`` with ``train/state.py::vsr_multistep_adam`` and SpyNet frozen
by ``spynet_frozen_mask``), steps back to back on a seeded pool of distinct
host batches, each copied to the card as the training loop copies it
(``parallel/mesh.py::shard_batch``), under ``core/device.py::no_tf32`` as
``cli.train_vsr`` runs float32.

Traffic keys: ``batch``, ``frames``, ``lr_hw``, ``dtype``; ``lr`` and
``steps_per_epoch`` / ``epochs`` (the schedule, constant over a run);
``pool_batches`` and ``motions``.

Set-up builds the model, its seeded weights, the optimizer and the step
once, and drives that step through its first three steps on the pool's
first three batches, keeping what the check reads: the losses, the first
gradient as the optimizer got it (Adam's first moment after one step over 1
- beta1) and the parameters after the third step. The same step then runs
the window, which ends on a synchronise. After it the plain reference
follows the first three steps from the same weights and batches.
"""

import time

from benchmark.harness import cell as cells
from benchmark.harness import counts
from benchmark.harness import trace as tracing
from benchmark.harness import traffic as inputs
from benchmark.harness import weights
from benchmark.reference import basicvsr as ref

FIRST_STEPS = 3
BETAS = (0.9, 0.99)  # the VSR trainer's Adam (train/state.py::vsr_multistep_adam)
QUIET_GRADIENT = 1e-3  # leaves whose reference gradient is below this share of the median leaf's


def _trainable(key):
    return not key.startswith("spynet/")


def _batches(cell):
    tr = cell.traffic
    return inputs.train_batches(cell.seed, tr["pool_batches"], tr["batch"], tr["frames"], tr["lr_hw"],
                                cell.config["scale"], tr["motions"])


def _out_hw(cell):
    s = cell.config["scale"]
    return s * cell.traffic["lr_hw"][0], s * cell.traffic["lr_hw"][1]


def _first_gradient(opt, p):
    """The gradient the optimizer's first update took, from Adam's first
    moment (m1 = (1 - beta1) g1); zeros where it has none, as after a step
    that left the state unchanged."""
    state = opt.opt.state.get(p, {})
    if "exp_avg" not in state:
        return p.detach().new_zeros(p.shape)
    return state["exp_avg"].detach() / (1 - BETAS[0])


def run(cell):
    import torch

    from mobilesuperresolution_tpu_torch.core.device import no_tf32
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.parallel.mesh import shard_batch
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters
    from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

    tr, cfg, dev = cell.traffic, cell.config, cell.device
    on_card = dev.type == "cuda"
    batches = _batches(cell)
    model = get_vsr_model(cfg["model_type"], scale=cfg["scale"], compute_dtype=getattr(torch, tr["dtype"]),
                          device=dev)
    params = weights.make(cfg, cell.seed, dev)
    weights.load_into(model, params)
    model.train()
    named = jax_named_parameters(model)
    mask = spynet_frozen_mask(named)
    opt = vsr_multistep_adam(named, tr["lr"], tr["steps_per_epoch"], tr["epochs"], trainable_mask=mask)
    step = make_vsr_step(model, opt, _out_hw(cell))
    trainable = [k for k in named if mask[k]]

    trace = tracing.Trace() if cell.trace else None
    if trace:
        trace.arm()
    with no_tf32():
        losses, skipped = [], 0
        for i in range(FIRST_STEPS):
            m = step(shard_batch(dev, batches[i]))
            losses.append(float(m["loss"]))
            skipped += int(m["skipped"])
            if i == 0:
                first = {k: _first_gradient(opt, named[k]) for k in trainable}
        after = {k: named[k].detach().clone() for k in trainable}
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_process
        if trace:
            trace.begin()
        n, j = 0, FIRST_STEPS
        while True:
            m = step(shard_batch(dev, batches[j % len(batches)]))
            skipped += int(m["skipped"])
            n, j = n + 1, j + 1
            if time.perf_counter() - t0 >= cell.seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        if trace:
            trace.end()
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    program = {"losses": losses, "first": first, "after": after}
    del step, opt, model, named
    if on_card:
        torch.cuda.empty_cache()

    want = reference_readings(cell, params, batches)
    checks, notes = compare(cell, program, want, params)
    result = {
        "end_to_end": {"step_ms": 1e3 * (t_end - t0) / n, "setup_s": setup_s},
        "attempted": n,
        "failed": skipped,
        "memory_peak_bytes": memory_peak,
        "checks": checks,
        "notes": dict(notes, steps_in_window=n, window_s=t_end - t0, losses=losses),
    }
    if trace:
        flops, b1_s, b2_s = counts.train_step(cfg, tr)
        steps = n  # every step launched in the traced window finished in it
        result["trace"] = {
            "events": trace.events, "window_s": trace.window_s, "busy_s": tracing.busy_seconds(trace.events),
            "breakdown": tracing.breakdown(trace.events), "steps": steps, "useful_flops": steps * flops,
            "b1_least_s": steps * b1_s, "b2_least_s": steps * b2_s, "dtype": tr["dtype"],
        }
    return result


def reference_readings(cell, params, batches, variant=None):
    """The plain reference's first three steps from ``params`` on the pool's
    first batches: {"losses", "first", "after"}. ``variant`` puts a changed
    reference in the program's place, for the control and fault readings:
    "tf32" (convs and matmuls in TF32), "half_batch" (the loss over the
    first half of each batch)."""
    import torch

    dev = cell.device
    half = variant == "half_batch"
    clips = []
    for lr_clip, hr_clip in batches[:FIRST_STEPS]:
        if half:
            lr_clip, hr_clip = lr_clip[: len(lr_clip) // 2], hr_clip[: len(hr_clip) // 2]
        clips.append(tuple(torch.from_numpy(a).to(dev).permute(0, 1, 4, 2, 3) for a in (lr_clip, hr_clip)))
    saved = ref.set_full_float32()
    if variant == "tf32":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        losses, first, after = ref.train_steps(params, cell.config, clips, cell.traffic["lr"], BETAS, _trainable,
                                               _out_hw(cell))
    finally:
        ref.restore_float32(saved)
    return {"losses": losses, "first": first, "after": {k: v for k, v in after.items() if _trainable(k)}}


def _norms(tensors):
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def gaps(got, want, params):
    """The three compared numbers, each the worst over its items: the
    relative gap of each step's loss; per leaf, the gap between the norms of
    the first gradients, over the larger of the reference leaf's norm and
    the median leaf's; the same of the parameters' change over the three
    steps, leaving out the leaves whose reference gradient is below
    ``QUIET_GRADIENT`` of the median leaf's (they move under Adam by
    round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    g_got, g_want = _norms(got["first"]), _norms(want["first"])
    g_med = cells.median(list(g_want.values()))
    grad = max(abs(g_got[k] - g_want[k]) / max(g_want[k], g_med) for k in g_want)
    moving = [k for k in g_want if g_want[k] >= QUIET_GRADIENT * g_med]
    d_got = _norms({k: got["after"][k].double() - params[k].double() for k in moving})
    d_want = _norms({k: want["after"][k].double() - params[k].double() for k in moving})
    d_med = cells.median(list(d_want.values()))
    change = max(abs(d_got[k] - d_want[k]) / max(d_want[k], d_med) for k in moving)
    return {"loss_gap": loss, "grad_norm_gap": grad, "change_norm_gap": change,
            "quiet_leaves": sorted(set(g_want) - set(moving))}


def compare(cell, got, want, params):
    g = gaps(got, want, params)
    lim = cell.limits
    checks = [cells.check(name, g[name], lim[name]) for name in ("loss_gap", "grad_norm_gap", "change_norm_gap")]
    return checks, {"quiet_leaves": g["quiet_leaves"], "reference_losses": want["losses"]}


def control_readings(cell):
    """The compared numbers of the reference put in the program's place with
    ``cell.variant`` ("tf32" or "half_batch"), against the plain reference;
    no window runs."""
    params = weights.make(cell.config, cell.seed, cell.device)
    batches = _batches(cell)
    want = reference_readings(cell, params, batches)
    got = reference_readings(cell, params, batches, cell.variant)
    return {k: v for k, v in gaps(got, want, params).items() if k != "quiet_leaves"}

