"""Operations and bytes of the published architectures, from shapes alone.

Count rules, so that the count is the work of the function and not of one
implementation of it, and no correct implementation can read above its peak:
- a conv counts its products with pixels of the image (a SAME conv's taps
  that meet the zero padding are not needed), 2 operations a multiply-add;
- SpyNet counts its five 7x7 convs per pyramid level at the level's size,
  after the input is resized to multiples of 32; each direction's trunk is
  its own nf-channel stack (not the block-diagonal form that runs both);
  the mobile reconstruction's ConvTranspose counts its K x K x Cin x Cout
  products per input pixel (its sub-pixel form computes more);
- warps, resizes, activations and additions are not counted;
- bytes count each input and output once and the weights once, in the
  dtype the cell computes in.

Published peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s in
bf16, 495 TFLOP/s in TF32 (the fastest tensor-core rate that takes float32
inputs: the peak against which float32 work is held), 3.35 TB/s of HBM.
"""

import math

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
SPYNET_CHANNELS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))


def live_taps(size, k):
    """Output-pixel and tap pairs along one axis of a k-tap SAME conv whose
    input pixel lies in the image."""
    return sum(max(0, size - abs(d)) for d in range(-(k // 2), k // 2 + 1))


def conv_flops(n, h, w, cin, cout, k):
    """A k x k SAME stride-1 conv over n maps of (h, w)."""
    return 2.0 * n * cin * cout * live_taps(h, k) * live_taps(w, k)


def conv_bytes(n, h, w, cin, cout, k, nbytes, out_hw=None):
    """Input, output and weights once each."""
    oh, ow = out_hw or (h, w)
    return nbytes * (n * h * w * cin + n * oh * ow * cout + k * k * cin * cout + cout)


def least_seconds(flops, nbytes, dtype):
    """The roofline's least time: the larger of operations at the peak rate
    and bytes at the memory's."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def spynet_levels(h, w, levels=6):
    """(h, w) of each pyramid level of a SpyNet call on (h, w) frames,
    coarsest first."""
    h32, w32 = int(math.ceil(h / 32.0) * 32), int(math.ceil(w / 32.0) * 32)
    return [(h32 >> (levels - 1 - i), w32 >> (levels - 1 - i)) for i in range(levels)]


def spynet_convs(h, w, dtype, even_only=False):
    """[(flops, bytes)] of the 7x7 convs of one SpyNet call (one pair, one
    direction) on (h, w) frames; ``even_only``: only the levels whose sizes
    are both even (the levels the port runs on kernel B1 in space-to-depth
    form)."""
    out = []
    for lh, lw in spynet_levels(h, w):
        if even_only and (lh % 2 or lw % 2):
            continue
        for cin, cout in SPYNET_CHANNELS:
            out.append((conv_flops(1, lh, lw, cin, cout, 7), conv_bytes(1, lh, lw, cin, cout, 7, DTYPE_BYTES[dtype])))
    return out


def flow_hw(h, w, flow_downscale):
    return (max(h // flow_downscale, 1), max(w // flow_downscale, 1)) if flow_downscale > 1 else (h, w)


def trunk_flops(config, h, w):
    """One direction's trunk on one (h, w) frame."""
    nf, nb, k = config["num_feat"], config["num_block"], config["trunk_kernel"]
    return conv_flops(1, h, w, 3 + nf, nf, k) + 2 * nb * conv_flops(1, h, w, nf, nf, k)


def transpose_conv(config, h, w, dtype):
    """(flops, bytes) of the mobile ConvTranspose (2nf -> 3, K, stride s,
    VALID) on one (h, w) map."""
    k, s, cin = config["transpose_kernel"], config["scale"], 2 * config["num_feat"]
    oh, ow = h * s + k - s, w * s + k - s
    flops = 2.0 * h * w * k * k * cin * 3
    return flops, DTYPE_BYTES[dtype] * (h * w * cin + oh * ow * 3 + k * k * cin * 3 + 3)


def upconvs(config, h, w, dtype):
    """[(flops, bytes)] of the original BasicVSR's two upconvs (3x3 conv +
    pixel shuffle 2) on one (h, w) frame."""
    nf = config["num_feat"]
    c1, c2 = config["upconv_channels"]
    nb = DTYPE_BYTES[dtype]
    return [(conv_flops(1, h, w, nf, c1, 3), conv_bytes(1, h, w, nf, c1, 3, nb)),
            (conv_flops(1, 2 * h, 2 * w, c1 // 4, c2, 3), conv_bytes(1, 2 * h, 2 * w, c1 // 4, c2, 3, nb))]


def tails(config, h, w, dtype):
    """[(flops, bytes)] of the conv + pixel-shuffle calls of one frame's
    reconstruction (the port's kernel B2)."""
    if config["reconstruction"] == "mobile":
        return [transpose_conv(config, h, w, dtype)]
    return upconvs(config, h, w, dtype)


def reconstruction_flops(config, h, w):
    """The reconstruction of one (h, w) frame."""
    nf = config["num_feat"]
    if config["reconstruction"] == "mobile":
        return conv_flops(1, h, w, 2 * nf, 2 * nf, 1) + transpose_conv(config, h, w, "float32")[0]
    hr = config["hr_channels"]
    c2 = config["upconv_channels"][1]
    return (conv_flops(1, h, w, 2 * nf, nf, 1) + sum(f for f, _ in upconvs(config, h, w, "float32"))
            + conv_flops(1, 4 * h, 4 * w, c2 // 4, hr, 3) + conv_flops(1, 4 * h, 4 * w, hr, 3, 3))


def frame_flops(config, h, w):
    """Both trunks and the reconstruction of one frame."""
    return 2 * trunk_flops(config, h, w) + reconstruction_flops(config, h, w)


def serve_window(config, traffic):
    """Per window of the serving scheme: (useful flops, SpyNet calls, B1
    least seconds, B2 least seconds). A window computes ``chunk + 2 *
    overlap`` frames of every stream; SpyNet runs once per distinct pair and
    direction with the flow cache (``chunk`` new pairs a window), and on
    every pair of the window without it."""
    s = traffic["streams"]
    h, w = traffic["lr_hw"]
    dtype = traffic["dtype"]
    frames = traffic["chunk"] + 2 * traffic["overlap"]
    pairs = traffic["chunk"] if traffic["flow_cache"] else frames - 1
    calls = 2 * s * pairs
    fh, fw = flow_hw(h, w, traffic["flow_downscale"])
    spy = spynet_convs(fh, fw, dtype)
    flops = s * frames * frame_flops(config, h, w) + calls * sum(f for f, _ in spy)
    b1 = calls * sum(least_seconds(f, b, dtype) for f, b in spynet_convs(fh, fw, dtype, even_only=True))
    b2 = s * frames * sum(least_seconds(f, b, dtype) for f, b in tails(config, h, w, dtype))
    return flops, calls, b1, b2


def train_step(config, traffic):
    """Per training step: (useful flops, B1 least seconds, B2 least
    seconds). The layers that take gradients (trunks, reconstruction) count
    their forward and a backward of twice its work; SpyNet, frozen, counts
    its forward on every pair and direction; B2 runs in the forward only."""
    b, t = traffic["batch"], traffic["frames"]
    h, w = traffic["lr_hw"]
    dtype = traffic["dtype"]
    calls = 2 * b * (t - 1)
    flops = 3 * b * t * frame_flops(config, h, w) + calls * sum(f for f, _ in spynet_convs(h, w, dtype))
    b1 = calls * sum(least_seconds(f, n, dtype) for f, n in spynet_convs(h, w, dtype, even_only=True))
    b2 = b * t * sum(least_seconds(f, n, dtype) for f, n in tails(config, h, w, dtype))
    return flops, b1, b2
