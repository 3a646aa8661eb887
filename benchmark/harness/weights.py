"""Seeded weights of a BasicVSR configuration, made on the device.

The benchmark makes the weights and hands the same tensors to the program
(copied into its parameters, in the layout its JAX-keyed checkpoints load)
and to the plain reference. Two generator calls draw every value (one normal,
one uniform), so making them costs a few launches whatever the depth.

Scales (He-style fan-in scaling, with mmedit's 0.1 on the residual blocks'
convs, so that 30 blocks neither vanish nor saturate):
- SpyNet: torch's default Uniform(+-1/sqrt(fan_in)) for kernels and biases,
  but the last conv of each level (16 -> 2): its kernel scaled by
  ``SPYNET_FLOW_GAIN`` so that the flows of a 426x240 frame reach a few
  pixels, as a trained SpyNet's do on moving video, and its bias zero (a
  random bias there adds a constant flow of up to 12 pixels that differs
  from seed to seed, and with it how much bf16 flows lose to rounding);
- trunks: conv0 normal with std sqrt(2 / fan_in), the blocks' convs 0.1 of
  that, biases Uniform(+-0.05);
- reconstruction: normal with std sqrt(2 / fan_in), the last conv to RGB
  scaled by ``OUTPUT_GAIN`` so that the network's residual over the bilinear
  base has a standard deviation of about 0.1 (a frame's detail), biases
  Uniform(+-0.05).
"""

import math

SPYNET_FLOW_GAIN = 5.0
BIAS_RANGE = 0.05
RESIDUAL_GAIN = 0.1
OUTPUT_GAIN = 0.3
SPYNET_CHANNELS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))


def shapes(config):
    """{JAX checkpoint key: shape} of a BasicVSR configuration, in order."""
    nf, nb = config["num_feat"], config["num_block"]
    out = {}
    for level in range(config["spynet_levels"]):
        for i, (ci, co) in enumerate(SPYNET_CHANNELS):
            out[f"spynet/level_{level}/conv{i}_kernel"] = (7, 7, ci, co)
            out[f"spynet/level_{level}/conv{i}_bias"] = (co,)
    names = ["conv0"] + [f"block{b}_conv{j}" for b in range(nb) for j in (1, 2)]
    for name in names:
        ci = 3 + nf if name == "conv0" else nf
        for d in ("backward", "forward"):
            out[f"propagation/trunks/{d}_{name}_kernel"] = (3, 3, ci, nf)
            out[f"propagation/trunks/{d}_{name}_bias"] = (nf,)
    if config["reconstruction"] == "mobile":
        k = config["transpose_kernel"]
        out["fusion/Conv_0/kernel"] = (1, 1, 2 * nf, 2 * nf)
        out["fusion/Conv_0/bias"] = (2 * nf,)
        out["conv_last/kernel"] = (k, k, 2 * nf, 3)
        out["conv_last/bias"] = (3,)
    else:
        hr = config["hr_channels"]
        up1, up2 = config["upconv_channels"]
        for name, shape in (("fusion", (1, 1, 2 * nf, nf)), ("upconv1", (3, 3, nf, up1)),
                            ("upconv2", (3, 3, up1 // 4, up2)), ("conv_hr", (3, 3, up2 // 4, hr)),
                            ("conv_last", (3, 3, hr, 3))):
            out[f"{name}/Conv_0/kernel"] = shape
            out[f"{name}/Conv_0/bias"] = (shape[-1],)
    return out


def _scale(key, shape, config):
    """(distribution, scale) of one tensor: ("normal", std) or ("uniform",
    half-width)."""
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else None
    if key.startswith("spynet/"):
        stem = key.rpartition("_")[0]
        if key.endswith("conv4_bias"):
            return "uniform", 0.0
        ci = SPYNET_CHANNELS[int(stem[-1])][0]
        bound = 1.0 / math.sqrt(49 * ci)
        gain = SPYNET_FLOW_GAIN if stem.endswith("conv4") else 1.0
        return "uniform", bound * gain
    if len(shape) == 1:
        return "uniform", BIAS_RANGE
    he = math.sqrt(2.0 / fan_in)
    if "_block" in key:
        return "normal", he * RESIDUAL_GAIN
    if key.endswith("_conv0_kernel"):
        return "normal", math.sqrt(1.0 / fan_in)
    if key == "conv_last/kernel":
        # a transpose conv of stride s sums over about (K/s)^2 * Cin inputs
        k, s = shape[0], config["scale"]
        return "normal", OUTPUT_GAIN / math.sqrt((k / s) ** 2 * shape[2])
    if key == "conv_last/Conv_0/kernel":
        return "normal", OUTPUT_GAIN / math.sqrt(fan_in)
    return "normal", he


def make(config, seed, device):
    """{key: float32 tensor on ``device``} drawn from ``seed``."""
    import torch

    shp = shapes(config)
    plan = {k: _scale(k, s, config) for k, s in shp.items()}
    sizes = {k: math.prod(s) for k, s in shp.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n_normal = sum(sizes[k] for k, (d, _) in plan.items() if d == "normal")
    n_uniform = sum(sizes[k] for k, (d, _) in plan.items() if d == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, {"normal": 0, "uniform": 0}
    for key, (dist, scale) in plan.items():
        src = normal if dist == "normal" else uniform
        out[key] = src[at[dist]: at[dist] + sizes[key]].view(shp[key]) * scale
        at[dist] += sizes[key]
    return out


def load_into(model, params):
    """Copy ``params`` into the program's parameters, keyed as its JAX
    checkpoints (every key present, none left over, shapes equal), and let
    it derive its compute weights (``prepare``), as loading a checkpoint
    does."""
    import torch

    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters

    named = jax_named_parameters(model)
    if set(named) != set(params):
        raise KeyError(f"weights do not match the model: missing {sorted(set(named) - set(params))[:5]}, "
                       f"unexpected {sorted(set(params) - set(named))[:5]}")
    with torch.no_grad():
        for key, p in named.items():
            if tuple(p.shape) != tuple(params[key].shape):
                raise ValueError(f"{key}: {tuple(params[key].shape)} != {tuple(p.shape)}")
            p.copy_(params[key])
    model.prepare()
