"""Device-to-host copy time on the device timeline per delivered frame
(the serving layer's harvest of each window's output), ms/frame."""

from benchmark.harness import trace


def read(ctx):
    t = trace.seconds_of(ctx["events"], ("DtoH",), kind="memcpy")
    return 1e3 * t / ctx["frames_harvested"] if t > 0 and ctx["frames_harvested"] else None
