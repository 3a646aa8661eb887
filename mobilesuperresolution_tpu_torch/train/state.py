"""Optimizer and LR schedule (counterpart of
mobilesuperresolution_tpu/train/state.py): Adam with the reference's
MultiStepLR (milestones [E/2, 9E/10] epochs, gamma 0.3), over the trainable
parameters only, as the JAX package's optax ``multi_transform`` mask
freezes the rest.

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
    """``torch.optim.Adam`` (torch's defaults: betas (0.9, 0.999), eps 1e-8,
    the reference's pretrain / search settings) over the trainable
    parameters, with the LR set from ``schedule`` and the count of applied
    updates before every step."""

    def __init__(self, params, schedule):
        self.params = list(params)
        self.schedule = schedule
        self.applied = 0
        self.opt = torch.optim.Adam(self.params, lr=schedule(0))

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


def multistep_adam(named_params, base_lr, steps_per_epoch, epochs, trainable_mask=None):
    """Adam with the reference's LR schedule over ``named_params``
    ({key: parameter}); ``trainable_mask`` ({key: bool}, default all True)
    selects the parameters this optimizer updates (the search phases)."""
    params = [p for k, p in named_params.items() if trainable_mask is None or trainable_mask[k]]
    return MultiStepAdam(params, multistep_lr(base_lr, steps_per_epoch, epochs))
