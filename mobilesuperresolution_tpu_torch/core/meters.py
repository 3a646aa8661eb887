"""Loss meters (own copy of mobilesuperresolution_tpu/core/meters.py::AverageMeter)."""


class AverageMeter:
    """Tracks a running average of a scalar (e.g. loss)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
