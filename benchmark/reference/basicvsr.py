"""Plain float32 reference of BasicVSR: SpyNet flows, bidirectional
propagation, reconstruction, the streaming window scheme, the Charbonnier
loss and the Adam step.

Written from the published descriptions, in plain PyTorch (NCHW, ``F.conv2d``,
``F.grid_sample``), with nothing of the program under test: BasicVSR (Chan et
al., CVPR 2021, arXiv 2012.02181, and its mmedit code), SpyNet (Ranjan and
Black, CVPR 2017, as BasicVSR uses it: ImageNet-normalised inputs resized to
multiples of 32, a 6-level average-pool pyramid, at each level five 7x7 convs
8-32-64-32-16-2 with ReLUs refining the 2x-upsampled flow), and the mobile
variant of arXiv 2207.12577 (fusion 1x1, ConvTranspose 5x5 stride 4, a
bilinear resize to the output size, a bilinear base).

Parameters come as a dict keyed as the JAX checkpoint keys them (HWIO
kernels; the ConvTranspose kernel un-mirrored, as flax applies it over the
stride-dilated input), made by the benchmark from the seed. Every weight the
program derives from them (SpyNet's 7x7 convs in space-to-depth 5x5 form, the
block-diagonal dual trunks, the sub-pixel form of the transpose conv) is
computed here in its published form instead.

Departures, each the program's documented choice and not a change of the
function: output frames are resized bilinearly to the served size (the
NEMO pipeline's 1920x1080); ``flow_downscale`` d runs SpyNet on frames
resized to 1/d and upsamples the flow; the coarsest SpyNet level of an
input smaller than 32 pixels starts from a 1x1 zero flow (mmedit's would
be empty).
"""

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SPYNET_LEVELS = 6
SPYNET_CONVS = 5


def set_full_float32():
    """Full float32 convs and matmuls: on this card cuDNN otherwise runs
    float32 convs in TF32. Returns the flags it replaced."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return saved


def restore_float32(saved):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def lrelu(x):
    return F.leaky_relu(x, 0.1)


def conv(x, kernel, bias):
    """SAME conv of an NCHW map with an HWIO kernel."""
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, padding=kernel.shape[0] // 2)


def resize(x, hw, align_corners=False):
    """Bilinear resize of an NCHW map."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=align_corners)


def flow_warp(x, flow, padding_mode):
    """``grid_sample`` of an NCHW map at the pixel offsets ``flow`` (N, 2, H,
    W: channel 0 dx, 1 dy), align_corners=True, as BasicVSR's flow_warp."""
    n, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=x.dtype, device=x.device),
                            torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
    vx = 2.0 * (gx + flow[:, 0]) / max(w - 1, 1) - 1.0
    vy = 2.0 * (gy + flow[:, 1]) / max(h - 1, 1) - 1.0
    grid = torch.stack([vx, vy], dim=-1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode=padding_mode, align_corners=True)


def spynet_level(params, level, x):
    stem = f"spynet/level_{level}/"
    for i in range(SPYNET_CONVS):
        x = conv(x, params[f"{stem}conv{i}_kernel"], params[f"{stem}conv{i}_bias"])
        if i < SPYNET_CONVS - 1:
            x = F.relu(x)
    return x


def spynet(params, ref, supp):
    """Flow (N, 2, H, W) that warps ``supp`` onto ``ref``; both (N, 3, H, W)
    in [0, 1]."""
    n, _, h, w = ref.shape
    h32, w32 = int(math.ceil(h / 32.0) * 32), int(math.ceil(w / 32.0) * 32)
    mean = torch.tensor(IMAGENET_MEAN, dtype=ref.dtype, device=ref.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=ref.dtype, device=ref.device).view(1, 3, 1, 1)
    refs = [resize((ref - mean) / std, (h32, w32))]
    supps = [resize((supp - mean) / std, (h32, w32))]
    for _ in range(SPYNET_LEVELS - 1):
        refs.insert(0, F.avg_pool2d(refs[0], 2, 2))
        supps.insert(0, F.avg_pool2d(supps[0], 2, 2))
    h0, w0 = refs[0].shape[-2:]
    flow = ref.new_zeros((n, 2, max(h0 // 2, 1), max(w0 // 2, 1)))
    for level in range(SPYNET_LEVELS):
        th, tw = refs[level].shape[-2:]
        up = F.interpolate(flow, size=(flow.shape[2] * 2, flow.shape[3] * 2), mode="bilinear",
                           align_corners=True) * 2.0
        if up.shape[2] < th or up.shape[3] < tw:
            up = F.pad(up, (0, max(tw - up.shape[3], 0), 0, max(th - up.shape[2], 0)), mode="replicate")
        up = up[:, :, :th, :tw]
        warped = flow_warp(supps[level], up, "border")
        flow = spynet_level(params, level, torch.cat([refs[level], warped, up], 1)) + up
    flow = resize(flow, (h, w))
    return torch.cat([flow[:, :1] * (w / w32), flow[:, 1:] * (h / h32)], 1)


def pair_flows(params, ref, supp, flow_downscale=1):
    """SpyNet's flow for frames of (N, 3, H, W), run on frames resized to
    1/flow_downscale and the flow brought back to (H, W)."""
    h, w = ref.shape[-2:]
    if flow_downscale == 1:
        return spynet(params, ref, supp)
    fh, fw = max(h // flow_downscale, 1), max(w // flow_downscale, 1)
    flow = spynet(params, resize(ref, (fh, fw)), resize(supp, (fh, fw)))
    flow = resize(flow, (h, w))
    return torch.cat([flow[:, :1] * (w / fw), flow[:, 1:] * (h / fh)], 1)


def trunk(params, direction, x, num_block):
    """conv 3x3 -> leaky ReLU -> num_block residual blocks (conv, ReLU, conv, + x)."""
    stem = f"propagation/trunks/{direction}_"
    x = lrelu(conv(x, params[stem + "conv0_kernel"], params[stem + "conv0_bias"]))
    for b in range(num_block):
        y = F.relu(conv(x, params[f"{stem}block{b}_conv1_kernel"], params[f"{stem}block{b}_conv1_bias"]))
        x = x + conv(y, params[f"{stem}block{b}_conv2_kernel"], params[f"{stem}block{b}_conv2_bias"])
    return x


def reconstruct_mobile(params, feat, lr, out_hw, scale):
    y = lrelu(conv(feat, params["fusion/Conv_0/kernel"], params["fusion/Conv_0/bias"]))
    k = params["conv_last/kernel"]  # (K, K, Cin, Cout), applied un-mirrored over the dilated input
    y = F.conv_transpose2d(y, k.flip(0, 1).permute(2, 3, 0, 1), params["conv_last/bias"], stride=scale)
    return resize(y, out_hw) + resize(lr, out_hw)


def reconstruct_origin(params, feat, lr, out_hw):
    def p(name):
        return params[f"{name}/Conv_0/kernel"], params[f"{name}/Conv_0/bias"]

    y = lrelu(conv(feat, *p("fusion")))
    y = lrelu(F.pixel_shuffle(conv(y, *p("upconv1")), 2))
    y = lrelu(F.pixel_shuffle(conv(y, *p("upconv2")), 2))
    y = conv(lrelu(conv(y, *p("conv_hr"))), *p("conv_last"))
    h, w = lr.shape[-2:]
    return resize(y + resize(lr, (4 * h, 4 * w)), out_hw)


def clip_flows(params, lrs, flow_downscale=1):
    """Both directions' flows of a clip (N, T, 3, H, W): (2·N·(T-1), 2, H, W),
    the backward flows (frame i+1 onto frame i) first."""
    n, t, c, h, w = lrs.shape
    a = lrs[:, :-1].reshape(-1, c, h, w)
    b = lrs[:, 1:].reshape(-1, c, h, w)
    return pair_flows(params, torch.cat([a, b]), torch.cat([b, a]), flow_downscale)


def propagate(params, config, lrs, flows, out_hw, keep=None):
    """The bidirectional recurrence and the reconstruction on a clip (N, T,
    3, H, W) with its ``clip_flows``. Returns the output frames (N,
    len(keep), 3, out_h, out_w) of the time steps in ``keep`` (default:
    all), reconstructing only those."""
    n, t, c, h, w = lrs.shape
    nf, nb = config["num_feat"], config["num_block"]
    keep = list(range(t)) if keep is None else list(keep)
    fb = flows[: n * (t - 1)].reshape(n, t - 1, 2, h, w)
    ff = flows[n * (t - 1):].reshape(n, t - 1, 2, h, w)
    backward = [None] * t
    feat = lrs.new_zeros((n, nf, h, w))
    for i in range(t - 1, -1, -1):
        if i < t - 1:
            feat = flow_warp(feat, fb[:, i], "zeros")
        feat = trunk(params, "backward", torch.cat([lrs[:, i], feat], 1), nb)
        backward[i] = feat
    out = {}
    feat = lrs.new_zeros((n, nf, h, w))
    for i in range(t):
        if i > 0:
            feat = flow_warp(feat, ff[:, i - 1], "zeros")
        feat = trunk(params, "forward", torch.cat([lrs[:, i], feat], 1), nb)
        if i in keep:
            both = torch.cat([backward[i], feat], 1)
            if config["reconstruction"] == "mobile":
                out[i] = reconstruct_mobile(params, both, lrs[:, i], out_hw, config["scale"])
            else:
                out[i] = reconstruct_origin(params, both, lrs[:, i], out_hw)
        backward[i] = None
    return torch.stack([out[i] for i in keep], 1)


def forward(params, config, lrs, out_hw, flow_downscale=1, keep=None):
    """BasicVSR on a clip (N, T, 3, H, W) in [0, 1]: ``propagate`` on its
    ``clip_flows``."""
    return propagate(params, config, lrs, clip_flows(params, lrs, flow_downscale), out_hw, keep)


def window_indices(start, chunk, overlap, last):
    """Frame indices of the window whose kept outputs start at ``start``:
    ``chunk + 2 * overlap`` frames from ``start - overlap``, clip edges
    replicated, ``last`` the last frame the stream had when it ran."""
    return [min(max(i, 0), last) for i in range(start - overlap, start + chunk + overlap)]


def charbonnier(sr, hr, eps=1e-12):
    """mean(sqrt((sr - hr)^2 + eps)), eps inside the square root."""
    d = sr - hr
    return torch.mean(torch.sqrt(d * d + eps))


class Adam:
    """Adam (Kingma and Ba), as PyTorch's Adam computes it: bias-corrected
    moments, eps added to the corrected square root."""

    def __init__(self, params, lr, betas, eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, (v.sqrt() / math.sqrt(c2)).add_(self.eps), value=-self.lr / c1)


def train_steps(params, config, batches, lr, betas, trainable, out_hw):
    """Charbonnier + Adam steps on ``batches`` [(lr (N, T, 3, h, w), hr (N, T,
    3, H, W))], SpyNet's flows without a gradient (a frozen SpyNet). Returns
    (losses, first gradients {key: tensor}, parameters after the steps)."""
    params = {k: v.clone() for k, v in params.items()}
    keys = [k for k in params if trainable(k)]
    for k in keys:
        params[k].requires_grad_(True)
    opt = Adam([params[k] for k in keys], lr, betas)
    losses, first = [], None
    for lr_clip, hr_clip in batches:
        with torch.no_grad():
            flows = clip_flows(params, lr_clip)
        loss = charbonnier(propagate(params, config, lr_clip, flows, out_hw), hr_clip)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(keys, grads)}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in params.items()}
