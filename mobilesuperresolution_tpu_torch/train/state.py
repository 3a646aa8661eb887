"""Optimizer and LR schedule (counterpart of
mobilesuperresolution_tpu/train/state.py): Adam with the reference's
MultiStepLR (milestones [E/2, 9E/10] epochs, gamma 0.3; the VSR trainer's
[E/2, 8E/10] and betas (0.9, 0.99)), over the trainable parameters only, as
the JAX package's optax ``multi_transform`` mask freezes the rest: a frozen
parameter has no moments and never moves, as ``optax.set_to_zero`` leaves it.

The learning rate is a function of the number of *applied* updates, as
optax's schedule counts them: a step that the training loop skips (a
non-finite loss or gradient) leaves the parameters, the Adam moments and the
count where they were.
"""

import torch


def multistep_lr(base_lr, steps_per_epoch, epochs, gamma=0.3, milestones=None):
    """MultiStepLR as ``count -> lr``: gamma applies once per occurrence of
    a milestone (duplicates compound to gamma²) from the update whose count
    reaches ``milestone * steps_per_epoch``; milestone 0 folds into the
    initial value (torch applies it from the first step)."""
    if milestones is None:
        milestones = [epochs // 2, epochs * 9 // 10]
    boundaries = {}
    init = base_lr
    for m in milestones:
        if m > 0:
            step = int(m * steps_per_epoch)
            boundaries[step] = boundaries.get(step, 1.0) * gamma
        else:
            init = init * gamma

    def schedule(count):
        lr = init
        for step, scale in sorted(boundaries.items()):
            if count >= step:
                lr = lr * scale
        return lr

    return schedule


class MultiStepAdam:
    """``torch.optim.Adam`` (eps 1e-8; betas default to torch's (0.9, 0.999),
    the reference's pretrain / search settings) over the trainable
    parameters, with the LR set from ``schedule`` and the count of applied
    updates before every step. ``steps`` counts every training step the
    guard saw, applied or skipped (the JAX TrainState's ``step``)."""

    def __init__(self, params, schedule, betas=(0.9, 0.999)):
        self.params = list(params)
        self.schedule = schedule
        self.applied = 0
        self.steps = 0
        self.opt = torch.optim.Adam(self.params, lr=schedule(0), betas=betas)

    def state_dict(self):
        """The moments and the counts, for a checkpoint."""
        return {"adam": self.opt.state_dict(), "applied": self.applied, "steps": self.steps}

    def load_state_dict(self, state):
        self.opt.load_state_dict(state["adam"])
        self.applied, self.steps = int(state["applied"]), int(state["steps"])

    def step(self):
        """One update from the parameters' ``.grad``; a trainable parameter
        the loss does not reach gets a zero gradient, as in optax (its
        moments decay and it still moves)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.applied)
        self.opt.step()
        self.applied += 1


def multistep_adam(named_params, base_lr, steps_per_epoch, epochs, trainable_mask=None, milestones=None,
                   betas=(0.9, 0.999)):
    """Adam with the reference's LR schedule over ``named_params``
    ({key: parameter}); ``trainable_mask`` ({key: bool}, default all True)
    selects the parameters this optimizer updates (the search phases, the
    VSR trainer's frozen SpyNet)."""
    params = [p for k, p in named_params.items() if trainable_mask is None or trainable_mask[k]]
    return MultiStepAdam(params, multistep_lr(base_lr, steps_per_epoch, epochs, milestones=milestones), betas)


def vsr_multistep_adam(named_params, base_lr, steps_per_epoch, epochs, trainable_mask=None):
    """The VSR trainer's optimizer: Adam betas (0.9, 0.99) and milestones
    [E/2, 8E/10] (the JAX package's vsr_multistep_adam)."""
    return multistep_adam(named_params, base_lr, steps_per_epoch, epochs, trainable_mask,
                          milestones=[epochs // 2, epochs * 8 // 10], betas=(0.9, 0.99))


def spynet_frozen_mask(named_params):
    """{key: trainable}: False for every parameter under a spynet / flownet
    scope (the JAX package's cli/train_vsr.py::spynet_frozen_mask)."""
    return {k: not any(s in ("spynet", "flownet") for s in k.split("/")) for k in named_params}
