"""Device resolution and float32 precision for the port's entry points."""

import contextlib

import torch

from mobilesuperresolution_tpu_torch.parallel.distributed import is_initialized


def resolve_device(device=None):
    """``None`` or ``"cuda"`` → the CUDA device (in a process group, this
    process's card), raising if there is none; ``"cpu"`` only when the
    caller asks for it. The port never falls back to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None and is_initialized():
        # one process per card: parallel.distributed.initialize made this
        # process's card the current one
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def no_tf32():
    """Full float32 convs and matmuls (cuDNN would otherwise run float32
    convs in TF32); restores the caller's flags."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
