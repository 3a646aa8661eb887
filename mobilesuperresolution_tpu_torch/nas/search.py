"""Three-phase NAS search pieces (counterpart of
mobilesuperresolution_tpu/nas/search.py).

Phases, each with a fresh optimizer over its trainable parameters:

1. width  (width_epochs, lr x10): alpha1/alpha2 (block skip) frozen,
   everything else trains.
2. length (epochs): everything trains.
3. kernel (kernel_epochs): alpha1/alpha2 and the channel gates (mask_w,
   split_w) frozen; the conv weights and the kernel-mix alpha train.
"""

PHASES = ("width", "length", "kernel")


def phase_trainable_mask(keys, phase):
    """{key: True if trainable in ``phase``} over flat parameter keys
    (``block_0/alpha1``, ``mask_w``, ...; the leaf name decides)."""
    if phase not in PHASES:
        raise ValueError(f"unknown search phase {phase!r}")
    mask = {}
    for key in keys:
        leaf = key.rsplit("/", 1)[-1]
        is_length = leaf in ("alpha1", "alpha2")
        is_gate = leaf in ("mask_w", "split_w")
        if phase == "width":
            mask[key] = not is_length
        elif phase == "length":
            mask[key] = True
        else:
            mask[key] = not (is_length or is_gate)
    return mask


def phase_lr(base_lr, phase):
    """Phase 1 uses lr x10 (the reference's search.py:299)."""
    return base_lr * 10.0 if phase == "width" else base_lr


def phase_epochs(params, phase):
    return {
        "width": params.width_epochs if params.width_search else 0,
        "length": params.epochs,
        "kernel": params.kernel_epochs,
    }[phase]
