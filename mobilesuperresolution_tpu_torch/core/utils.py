"""Misc utilities (own copy of mobilesuperresolution_tpu/core/utils.py)."""


def attr_extractor(obj):
    """Pretty banner of all public attributes of a params namespace."""
    attrs = [a for a in dir(obj) if not a.startswith("_")]
    info_len = 30
    string = f"\n{'INFO':{'*'}{'^'}{80}s}\n"
    for name in attrs:
        v = getattr(obj, name)
        if callable(v):
            continue
        string += f"** {f'{name}:':{''}{'<'}{info_len}s}{v}\n"
    string += f"{'':{'*'}{'^'}{80}s}\n"
    return string


class SpeedScheduler:
    """Anneals the latency target linearly from the supernet speed down to the
    final target over ``gamma * search_epoch`` epochs
    (reference: utils/__init__.py:26-41)."""

    def __init__(self, search_epoch, total_speed, target_speed, gamma=0.75):
        self.search_epoch = search_epoch
        self.total_speed = float(total_speed)
        self.target_speed = float(target_speed)
        self.gamma = gamma
        self.epoch = 0

    def step(self):
        self.epoch += 1
        horizon = self.search_epoch * self.gamma
        if self.epoch > horizon:
            return self.target_speed
        return self.target_speed + (horizon - self.epoch) * (self.total_speed - self.target_speed) / horizon
