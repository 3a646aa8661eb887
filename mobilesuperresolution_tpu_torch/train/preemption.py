"""Preemption-safe training (counterpart of
mobilesuperresolution_tpu/train/preemption.py, one process).

``PreemptionGuard`` turns two stop sources into one decision per optimizer
step: SIGTERM (the handler only sets a flag; the loop polls it at step
boundaries, writes a mid-epoch checkpoint and returns) and a step budget
(``--max_steps_per_run``: stop after N steps of this process, the same save
and exit path, deterministic).

Mid-epoch checkpoints are exact: patch sampling is a function of (epoch
seed, item index) alone (data/isr.py ``_batches``), so a resumed process
replays the remaining batches of the interrupted epoch bit for bit.

The JAX package also OR-reduces the signal flag over the processes of a
multi-host job; the port runs one process until ``--distributed`` lands
(ROADMAP.md, queue A8), so the flag is read as it is.
"""

import signal as _signal

from mobilesuperresolution_tpu_torch.train.checkpoint import save_params_npz


def save_midepoch(ckpt, job_dir, epoch, model, optimizer, batches_done):
    """One mid-epoch full-state save, on a stop or a periodic
    ``--checkpoint_every_steps`` save: the batch position goes into the
    checkpoint's ``extra``, so ``--resume`` replays the rest of the epoch,
    and the weights npz is refreshed (atomically)."""
    ckpt.save(epoch, model, optimizer, extra={"batches_done": batches_done}, force=True)
    save_params_npz(job_dir, model)


class PreemptionGuard:
    """Stops after ``max_steps`` optimizer steps (0 = no budget) or at the
    first step boundary after a SIGTERM. Off the main thread, where Python
    cannot install a handler, it is budget-only. ``restore_handlers`` puts
    the previous handler back."""

    def __init__(self, max_steps=0):
        self.max_steps = int(max_steps or 0)
        self.steps = 0
        self._signaled = False
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
        return self._signaled
