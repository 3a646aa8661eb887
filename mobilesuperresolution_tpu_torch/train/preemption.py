"""Preemption-safe training (counterpart of
mobilesuperresolution_tpu/train/preemption.py).

``PreemptionGuard`` turns two stop sources into one decision per optimizer
step: SIGTERM (the handler only sets a flag; the loop polls it at step
boundaries, writes a mid-epoch checkpoint and returns) and a step budget
(``--max_steps_per_run``: stop after N steps of this process, the same save
and exit path, deterministic).

Mid-epoch checkpoints are exact: patch sampling is a function of (epoch
seed, item index) alone (data/isr.py ``_batches``), so a resumed process
replays the remaining batches of the interrupted epoch bit for bit.

In a process group the signal flag is OR-ed over the processes every
``sync_every`` steps (an all-reduce MAX, parallel/distributed.py), so a
SIGTERM that reaches one process stops all of them at the same step; the
step budget counts the same steps everywhere and needs no exchange.
"""

import signal as _signal

from mobilesuperresolution_tpu_torch.parallel.distributed import any_process, is_primary, process_count
from mobilesuperresolution_tpu_torch.train.checkpoint import save_params_npz


def save_midepoch(ckpt, job_dir, epoch, model, optimizer, batches_done):
    """One mid-epoch full-state save, on a stop or a periodic
    ``--checkpoint_every_steps`` save: the batch position goes into the
    checkpoint's ``extra``, so ``--resume`` replays the rest of the epoch,
    and the weights npz is refreshed (atomically); by the chief alone."""
    ckpt.save(epoch, model, optimizer, extra={"batches_done": batches_done}, force=True)
    if is_primary():
        save_params_npz(job_dir, model)


class PreemptionGuard:
    """Stops after ``max_steps`` optimizer steps (0 = no budget) or at the
    first step boundary after a SIGTERM (in a process group: at the first
    exchange, every ``sync_every`` steps, after a SIGTERM on any process;
    the exchange's tensor lives on ``device``, which NCCL needs on the
    card). Off the main thread, where Python cannot install a handler, it
    is budget-only. ``restore_handlers`` puts the previous handler back."""

    def __init__(self, max_steps=0, sync_every=16, device="cpu"):
        self.max_steps = int(max_steps or 0)
        self.sync_every = max(1, int(sync_every))
        self.device = device
        self.steps = 0
        self._signaled = False
        self._synced_stop = False
        self._prev = None
        try:
            self._prev = _signal.signal(_signal.SIGTERM, self._handler)
        except ValueError:  # not the main thread
            pass

    def _handler(self, signum, frame):
        self._signaled = True

    def restore_handlers(self):
        if self._prev is not None:
            _signal.signal(_signal.SIGTERM, self._prev)
            self._prev = None

    def step_and_should_stop(self):
        """Call once per completed optimizer step. True = checkpoint and stop."""
        self.steps += 1
        if self.max_steps and self.steps >= self.max_steps:
            return True
        if process_count() == 1:
            return self._signaled
        if self.steps % self.sync_every == 0:
            self._synced_stop = any_process(self._signaled, self.device)
        return self._synced_stop
