"""Train steps (counterpart of mobilesuperresolution_tpu/train/steps.py): the
SISR step, the NAS search step and the VSR step.

Failure guard (the JAX package's ``_guarded_update``), in all three: a batch whose
loss or any gradient (of every parameter, trainable in this phase or not) is
not finite skips the update; parameters, Adam moments and the LR count stay
put, and ``metrics["skipped"]`` is 1 (a CPU scalar: the guard has read the
flag on the host already). The other metrics are detached scalar tensors on
the device.

In a process group (parallel/distributed.py) each process runs its slice of
the global batch, and the loss, the reported metrics and every gradient are
averaged over the group by one flat all-reduce before the guard reads them,
so every process applies, or skips, the same update: a non-finite batch on
one process skips it on all. A flat all-reduce rather than DDP: the guard
needs the averaged gradients before the step, the NAS supernet's trainable
set changes between phases, and the reduction stays one call in one place.
Every process starts from the same parameters (``common_cli.fit`` and the
search broadcast rank 0's) and the same optimizer state, so their states
stay equal."""

import torch

from mobilesuperresolution_tpu_torch.parallel.distributed import all_reduce_mean_
from mobilesuperresolution_tpu_torch.train.losses import charbonnier_loss, l1_loss


def _all_finite(loss, grads):
    """One device-side flag: the loss and every gradient are finite."""
    flat = torch.cat([g.reshape(-1).float() for g in grads]) if grads else loss.new_zeros(0)
    return torch.isfinite(loss) & torch.isfinite(flat).all()


def _group_mean(metrics, params):
    """The group's mean of the metrics (a dict of scalar tensors, detached)
    and, in place, of every gradient; in one process the metrics as they
    are. Runs after the backward, so it may overwrite the detached
    metrics in place."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    all_reduce_mean_(list(metrics.values()) + [p.grad for p in params if p.grad is not None])
    return metrics


def _guarded_update(loss, params, optimizer):
    """Apply the optimizer step if the loss and every gradient are finite,
    and count the step either way (``optimizer.steps``, the JAX
    TrainState's ``step``); returns the ``skipped`` metric."""
    finite = bool(_all_finite(loss.detach(), [p.grad for p in params if p.grad is not None]))
    if finite:
        optimizer.step()
    optimizer.steps += 1
    return torch.tensor(0.0 if finite else 1.0)


def make_sisr_step(model, optimizer, forward=None):
    """SISR step (BASIC_MODEL pretraining, searched-net retraining): L1 loss
    (the reference's pretrain.py:61-82). Returns ``step(batch) -> {loss, l1,
    skipped}``, ``batch`` = (lr (B, h, w, 3), hr (B, s·h, s·w, 3)) on the
    model's device; the model runs in train mode (live weights).
    ``forward(model, lr)`` replaces ``model(lr)`` (the height-sharded step,
    parallel/spatial_train.py)."""
    params = list(model.parameters())
    forward = forward or (lambda m, x: m(x))

    def step(batch):
        lr_img, hr_img = batch
        for p in params:
            p.grad = None
        loss = l1_loss(forward(model, lr_img), hr_img)
        loss.backward()
        m = _group_mean({"loss": loss}, params)
        skipped = _guarded_update(m["loss"], params, optimizer)
        return {"loss": m["loss"], "l1": m["loss"], "skipped": skipped}

    return step


def make_search_step(model, optimizer, speed_loss, weight_sr_l1=1.0, weight_speed=0.1, speed_table=None):
    """NAS search step: L1 + SpeedLoss on the latency the supernet traces
    (the reference's search.py:71-81). Returns ``step(batch, speed_target)
    -> metrics``, ``batch`` = (lr (B, h, w, 3), hr (B, s·h, s·w, 3)) on the
    model's device and ``speed_target`` the SpeedScheduler's per-epoch value."""
    params = list(model.parameters())

    def step(batch, speed_target):
        lr_img, hr_img = batch
        for p in params:
            p.grad = None
        sr, speed_accu = model(lr_img, speed_table)
        l1 = l1_loss(sr, hr_img)
        sp = speed_loss(speed_accu, speed_target, gamma=weight_speed)
        loss = weight_sr_l1 * l1 + sp
        loss.backward()
        m = _group_mean({"loss": loss, "l1": l1, "speed_loss": sp, "speed": speed_accu}, params)
        m["skipped"] = _guarded_update(m["loss"], params, optimizer)
        return m

    return step


def make_vsr_step(model, optimizer, out_hw, forward=None):
    """VSR step: Charbonnier loss on the model's (B, T, out_h, out_w, C)
    output (the reference's train_video_superresolution.py:76-97). Returns
    ``step(batch) -> {loss, skipped}``, ``batch`` = (lr (B, T, h, w, C), hr
    (B, T, out_h, out_w, C)) on the model's device; the model runs in train
    mode (live weights, SpyNet's flows without a gradient).
    ``forward(lr, out_h, out_w)`` replaces the model's call (the
    height-sharded step, parallel/vsr_spatial.py)."""
    params = list(model.parameters())
    oh, ow = out_hw
    forward = forward or model

    def step(batch):
        lr_clip, hr_clip = batch
        for p in params:
            p.grad = None
        loss = charbonnier_loss(forward(lr_clip, oh, ow), hr_clip)
        loss.backward()
        m = _group_mean({"loss": loss}, params)
        return {"loss": m["loss"], "skipped": _guarded_update(m["loss"], params, optimizer)}

    return step
