"""The VSR types' eval forwards as functions of TF ops, for TFLite export
(export/export.py::export_tflite).

Each builder takes a float port model and returns ``forward(x)`` on an NHWC
float32 ``(B, T, H, W, C)`` tensor (C = 5 for 'basic_mv') that computes the
model's eval forward at (height, width), with every weight folded into a
constant made once, outside the per-frame code, so the unrolled graph holds
one copy of each:

- resizes (``ops/resize.py``) gather the two taps of each row of the port's
  own ``linear_resize_matrix`` and blend them: torch's half-pixel centres
  (source clamped at 0) and its ``align_corners=True`` form alike, at any up
  or down size. TFLite's RESIZE_BILINEAR differs at the edges and for
  downscales, and a dense matrix product would be quantized by
  ``Optimize.DEFAULT``;
- ``flow_warp`` (``ops/warp.py``) is its gather form: the padded frame
  flattened, int32 flat indices of the four taps, both padding modes;
- SpyNet runs its 7x7 stacks as direct 7x7 convs (the space-to-depth form
  computes the same function);
- the recurrence is unrolled over the static T: each direction's trunk runs
  on its own weights (the port's block-diagonal dual conv is the same
  function), and the first step, whose carry is zeros (the port warps a
  zero carry with a zero flow), convolves the frame with conv0's frame
  channels alone. No zero tensor of a frame's size is built: the converter
  would fold it into a constant that size (19 MB at 360x540);
- sub-pixel convs take their output channels reordered for
  ``tf.nn.depth_to_space``.

tensorflow is imported when a builder is called.
"""

import math

import numpy as np

from mobilesuperresolution_tpu_torch.kernels.fused_tail import LRELU_SLOPE
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR, BasicVSROrigin
from mobilesuperresolution_tpu_torch.models.mvvsr import MotionVectorVSR
from mobilesuperresolution_tpu_torch.models.naive_multi import NaiveMultiModel
from mobilesuperresolution_tpu_torch.models.single_image import SingleImageModel
from mobilesuperresolution_tpu_torch.models.spynet import IMAGENET_MEAN, IMAGENET_STD, flow_downscale_hw
from mobilesuperresolution_tpu_torch.ops.layers import subpixel_transpose_kernel
from mobilesuperresolution_tpu_torch.ops.resize import linear_resize_matrix

def import_tf():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise RuntimeError(f"tensorflow unavailable: {e}") from e
    return tf


def depth_to_space_order(scale, channels):
    """Conv channel order that makes ``tf.nn.depth_to_space`` (channel
    (i·s + j)·C + c to offset (i, j) of channel c) give the port's
    ``depth_to_space`` (channel c·s² + i·s + j)."""
    return np.arange(scale * scale * channels).reshape(channels, scale * scale).T.reshape(-1)


def _np(t):
    return t.detach().float().cpu().numpy()


def resize_taps(in_len, out_len, align_corners):
    """(i0, i1, w0, w1): the two source taps of each output row of
    ``linear_resize_matrix`` and their weights (i1 = i0, w1 = 0 where a row
    has one tap)."""
    m = linear_resize_matrix(in_len, out_len, align_corners, np.float64)
    i0, i1, w0, w1 = (np.zeros(out_len, t) for t in (np.int32, np.int32, np.float64, np.float64))
    for r, row in enumerate(m):
        nz = np.flatnonzero(row)
        i0[r], w0[r] = nz[0], row[nz[0]]
        i1[r], w1[r] = (nz[1], row[nz[1]]) if len(nz) > 1 else (nz[0], 0.0)
    return i0, i1, w0.astype(np.float32), w1.astype(np.float32)


class TFOps:
    """The port's ops in TF, on tensors of static shape."""

    def __init__(self):
        self.tf = import_tf()

    def const(self, a):
        return self.tf.constant(np.asarray(a, np.float32))

    def conv(self, x, kb, padding="SAME"):
        return self.tf.nn.conv2d(x, kb[0], 1, padding) + kb[1]

    def lrelu(self, x):
        return self.tf.nn.leaky_relu(x, LRELU_SLOPE)

    def _resize_axis(self, x, axis, out_len, align_corners):
        tf = self.tf
        in_len = x.shape[axis]
        if in_len == out_len:
            return x
        i0, i1, w0, w1 = resize_taps(in_len, out_len, align_corners)
        shape = [out_len] + [1] * (len(x.shape) - 1 - axis)
        a = tf.gather(x, i0, axis=axis)
        if not w1.any():
            return a if (w0 == 1).all() else a * w0.reshape(shape)
        return a * w0.reshape(shape) + tf.gather(x, i1, axis=axis) * w1.reshape(shape)

    def resize(self, x, out_hw, align_corners=False):
        """``resize_bilinear`` on (N, H, W, C): along the width, then the
        height, as torch's kernel nests its two blends."""
        x = self._resize_axis(x, 2, int(out_hw[1]), align_corners)
        return self._resize_axis(x, 1, int(out_hw[0]), align_corners)

    def avg_pool_2x2(self, x):
        return self.tf.nn.avg_pool2d(x, 2, 2, "VALID")

    def flow_warp(self, x, flow, padding_mode):
        """``ops/warp.py::flow_warp``: x (N, H, W, C), flow (N, H, W, 2)."""
        tf = self.tf
        n, h, w, c = x.shape
        vx = flow[..., 0] + np.arange(w, dtype=np.float32)[None, :]
        vy = flow[..., 1] + np.arange(h, dtype=np.float32)[:, None]
        if padding_mode == "border":
            vx, vy = tf.clip_by_value(vx, 0.0, w - 1.0), tf.clip_by_value(vy, 0.0, h - 1.0)
        elif padding_mode == "zeros":
            vx, vy = tf.clip_by_value(vx, -1.0, float(w)), tf.clip_by_value(vy, -1.0, float(h))
        else:
            raise ValueError(f"unsupported padding_mode {padding_mode}")
        iy0, ix0 = tf.floor(vy), tf.floor(vx)
        fy, fx = (vy - iy0)[..., None], (vx - ix0)[..., None]
        hp, wp = h + 3, w + 3
        xp = tf.reshape(tf.pad(x, [[0, 0], [1, 2], [1, 2], [0, 0]]), [n * hp * wp, c])
        # padded coordinates of the top-left tap, in [0, size + 1]
        base = (tf.cast(iy0 + 1.0, tf.int32) * wp + tf.cast(ix0 + 1.0, tf.int32)
                + (np.arange(n, dtype=np.int32) * (hp * wp))[:, None, None])
        t00, t01 = tf.gather(xp, base), tf.gather(xp, base + 1)
        t10, t11 = tf.gather(xp, base + wp), tf.gather(xp, base + wp + 1)
        top = t00 * (1.0 - fx) + t01 * fx
        bot = t10 * (1.0 - fx) + t11 * fx
        return top * (1.0 - fy) + bot * fy

    def depth_to_space(self, y, scale):
        return self.tf.nn.depth_to_space(y, scale)

    def scale_flow(self, flow, sx, sy):
        """flow * [sx, sy], the factors rounded to float32 (``scale_flow``)."""
        return flow * np.array([sx, sy], np.float32)

    def upsample_flow(self, flow, h, w):
        fh, fw = flow.shape[1:3]
        if (fh, fw) == (h, w):
            return flow
        return self.scale_flow(self.resize(flow, (h, w)), w / fw, h / fh)

    # weights, folded into constants

    def plain(self, conv, order=None):
        """A ``PlainConv`` / ``UpConv``: (HWIO kernel, bias) constants."""
        k, b = _np(conv.kernel), _np(conv.bias)
        if order is not None:
            k, b = k[..., order], b[order]
        return self.const(k), self.const(b)

    def wn(self, conv, order=None):
        """A ``WNConv``: its effective (weight-normed) kernel and bias."""
        k, b = _np(conv.effective_kernel()), _np(conv.b)
        if order is not None:
            k, b = k[..., order], b[order]
        return self.const(k), self.const(b)

    def subpixel(self, layer):
        """A ``SubpixelConvTranspose``: its sub-pixel kernel and per-phase
        bias in depth_to_space order, and (M, stride, kernel size)."""
        s, K = layer.stride, layer.kernel.shape[0]
        cout = layer.kernel.shape[3]
        order = depth_to_space_order(s, cout)
        k = _np(subpixel_transpose_kernel(layer.kernel.detach().float(), s))[..., order]
        b = _np(layer.bias.repeat_interleave(s * s))[order]
        return (self.const(k), self.const(b)), (-(-K // s), s, K)

    def subpixel_apply(self, x, kb, geom, out_hw):
        """``SubpixelConvTranspose.forward``: the M x M conv over the padded
        map, depth_to_space, the crop to the transpose's size, and the
        bilinear resize to ``out_hw``."""
        m, s, K = geom
        h, w = x.shape[1:3]
        ex = max(K - s, 0)
        y = self.conv(self.tf.pad(x, [[0, 0], [m - 1, m], [m - 1, m], [0, 0]]), kb, "VALID")
        y = self.depth_to_space(y, s)[:, : h * s + ex, : w * s + ex]
        return self.resize(y, out_hw)


def tf_spynet(ops, spynet):
    """``SpyNet.forward`` as ``fn(ref, supp)`` on (N, H, W, 3)."""
    tf = ops.tf
    levels = [[(ops.const(_np(getattr(lv, f"conv{i}_kernel"))), ops.const(_np(getattr(lv, f"conv{i}_bias"))))
               for i in range(5)] for lv in (getattr(spynet, f"level_{j}") for j in range(spynet.levels))]
    mean, std = np.array(IMAGENET_MEAN, np.float32), np.array(IMAGENET_STD, np.float32)

    def pre(x):
        return (x - mean) / std

    def fn(ref, supp):
        n, h, w, _ = ref.shape
        h32, w32 = int(math.ceil(h / 32.0) * 32), int(math.ceil(w / 32.0) * 32)
        refs, supps = [pre(ops.resize(ref, (h32, w32)))], [pre(ops.resize(supp, (h32, w32)))]
        for _ in range(spynet.levels - 1):
            refs.insert(0, ops.avg_pool_2x2(refs[0]))
            supps.insert(0, ops.avg_pool_2x2(supps[0]))
        h0, w0 = refs[0].shape[1:3]
        flow = tf.zeros((n, max(h0 // 2, 1), max(w0 // 2, 1), 2))
        for convs, r, s in zip(levels, refs, supps):
            th, tw = r.shape[1:3]
            fh, fw = flow.shape[1:3]
            up = ops.resize(flow, (fh * 2, fw * 2), align_corners=True) * 2.0
            # odd level sizes leave the upsampled flow one short: replicate-pad
            if up.shape[1] < th:
                up = tf.concat([up] + [up[:, -1:]] * (th - up.shape[1]), 1)
            if up.shape[2] < tw:
                up = tf.concat([up] + [up[:, :, -1:]] * (tw - up.shape[2]), 2)
            up = up[:, :th, :tw]
            y = tf.concat([r, ops.flow_warp(s, up, "border"), up], -1)
            for i, kb in enumerate(convs):
                y = ops.conv(y, kb)
                if i < len(convs) - 1:
                    y = tf.nn.relu(y)
            flow = y + up
        return ops.scale_flow(ops.resize(flow, (h, w)), w / w32, h / h32)

    return fn


def _pair_flows(ops, spynet_fn, x, flow_downscale):
    """SpyNet on the (t, t+1) pairs of x (B, T, H, W, C), at 1/d resolution
    and upsampled: (refs x_t, supps x_{t+1}) flows and (refs x_{t+1}, supps
    x_t) flows, each a list over t of (B, H, W, 2), as ``compute_flows``'s
    backward and forward flows."""
    tf = ops.tf
    b, t, h, w, c = x.shape
    fh, fw = flow_downscale_hw(h, w, flow_downscale)
    frames = [x[:, i] for i in range(t)]
    if (fh, fw) != (h, w):
        frames = [ops.resize(f, (fh, fw)) for f in frames]
    x1, x2 = tf.concat(frames[:-1], 0), tf.concat(frames[1:], 0)
    flows = ops.upsample_flow(spynet_fn(tf.concat([x1, x2], 0), tf.concat([x2, x1], 0)), h, w)
    n = b * (t - 1)
    fb = [flows[i * b: (i + 1) * b] for i in range(t - 1)]
    ff = [flows[n + i * b: n + (i + 1) * b] for i in range(t - 1)]
    return ff, fb


def _tf_propagation(ops, model):
    """Both legs of ``BasicVSRBase._propagate``: fn(x, ff, fb) -> (out_b,
    out_f), lists over t of (B, H, W, nf)."""
    tf = ops.tf
    trunks = model.propagation.trunks
    names = ["conv0"] + [f"block{i}_conv{j}" for i in range(model.num_block) for j in (1, 2)]
    weights = {d: {name: (ops.const(_np(getattr(trunks, f"{d}_{name}_kernel"))),
                          ops.const(_np(getattr(trunks, f"{d}_{name}_bias")))) for name in names}
               for d in ("backward", "forward")}
    for d, wd in weights.items():
        # conv0 on the frame alone, for the first step's zero carry
        wd["conv0_first"] = (ops.const(_np(getattr(trunks, f"{d}_conv0_kernel"))[:, :, :-model.num_feat]),
                             wd["conv0"][1])

    def trunk(wd, inp, first=False):
        y = ops.lrelu(ops.conv(inp, wd["conv0_first" if first else "conv0"]))
        for i in range(model.num_block):
            y = y + ops.conv(tf.nn.relu(ops.conv(y, wd[f"block{i}_conv1"])), wd[f"block{i}_conv2"])
        return y

    def leg(wd, x, order, flow_of):
        outs, carry = {}, None
        for step, ti in enumerate(order):
            if step == 0:
                carry = trunk(wd, x[:, ti], first=True)
            else:
                carry = trunk(wd, tf.concat([x[:, ti], ops.flow_warp(carry, flow_of(ti), "zeros")], -1))
            outs[ti] = carry
        return [outs[ti] for ti in range(len(order))]

    def fn(x, ff, fb):
        t = x.shape[1]
        out_b = leg(weights["backward"], x, range(t - 1, -1, -1), lambda ti: fb[ti])
        out_f = leg(weights["forward"], x, range(t), lambda ti: ff[ti - 1])
        return out_b, out_f

    return fn


def _frames_batch(tf, frames):
    """A list over t of (B, ...) tensors as one (B·T, ...) batch, b-major."""
    return tf.reshape(tf.stack(frames, 1), [-1, *frames[0].shape[1:]])


def tf_basicvsr(model, height, width):
    """'basic', 'basic_origin' and 'basic_mv' (``BasicVSRBase`` subclasses)."""
    ops = TFOps()
    tf = ops.tf
    propagate = _tf_propagation(ops, model)
    spynet = tf_spynet(ops, model.spynet) if model.has_spynet else None
    if isinstance(model, BasicVSROrigin):
        fusion = ops.plain(model.fusion)
        nf = model.num_feat
        up1 = ops.plain(model.upconv1, depth_to_space_order(2, nf))
        up2 = ops.plain(model.upconv2, depth_to_space_order(2, 64))
        conv_hr, conv_last = ops.plain(model.conv_hr), ops.plain(model.conv_last)

        def reconstruct(feats, xf):
            h, w = xf.shape[1:3]
            y = ops.lrelu(ops.conv(feats, fusion))
            y = ops.lrelu(ops.depth_to_space(ops.conv(y, up1), 2))
            y = ops.lrelu(ops.depth_to_space(ops.conv(y, up2), 2))
            y = ops.conv(ops.lrelu(ops.conv(y, conv_hr)), conv_last)
            return ops.resize(y + ops.resize(xf, (4 * h, 4 * w)), (height, width))
    else:
        fusion = ops.plain(model.fusion)
        last, geom = ops.subpixel(model.conv_last)

        def reconstruct(feats, xf):
            y = ops.subpixel_apply(ops.lrelu(ops.conv(feats, fusion)), last, geom, (height, width))
            return y + ops.resize(xf, (height, width))

    def forward(x):
        b, t, h, w, _ = x.shape
        if isinstance(model, MotionVectorVSR):
            ff = [x[:, i + 1, ..., 3:5] for i in range(t - 1)]
            fb = [-f for f in ff]
            x = x[..., :3]
        else:
            ff, fb = _pair_flows(ops, spynet, x, model.flow_downscale)
        out_b, out_f = propagate(x, ff, fb)
        feats = _frames_batch(tf, [tf.concat([ob, of], -1) for ob, of in zip(out_b, out_f)])
        out = reconstruct(feats, tf.reshape(x, [b * t, h, w, 3]))
        return tf.reshape(out, [b, t, height, width, 3])

    return forward


def tf_single(model, height, width):
    """'single' (``SingleImageModel``)."""
    ops = TFOps()
    tf = ops.tf
    encoder, body_tail = ops.wn(model.encoder), ops.wn(model.body_tail)
    blocks = [(ops.wn(blk.WNConv_0), ops.wn(blk.WNConv_1))
              for blk in (getattr(model, f"block_{i}") for i in range(model.num_blocks))]
    shuf, geom = ops.subpixel(model.shuf)

    def forward(x):
        b, t, h, w, c = x.shape
        y = ops.conv(tf.reshape(x, [b * t, h, w, c]), encoder)
        z = y
        for k0, k1 in blocks:
            z = ops.conv(tf.nn.relu(ops.conv(z, k0)), k1) + z
        out = ops.subpixel_apply(ops.conv(z, body_tail) + y, shuf, geom, (height, width))
        return tf.reshape(out, [b, t, height, width, c])

    return forward


def tf_naive_multi(model):
    """'multi' (``NaiveMultiModel``): the output is always x scale."""
    ops = TFOps()
    tf = ops.tf
    s, ch = model.scale, model.channels
    spynet = tf_spynet(ops, model.flownet)
    encode = ops.wn(model.encode)
    blocks = [(ops.plain(blk.PlainConv_0), ops.plain(blk.PlainConv_1)) for blk in model.blocks()]
    decode = ops.wn(model.decode, depth_to_space_order(s, 3))

    def forward(x):
        b, t, h, w, c = x.shape
        # frame 0's zero flow, made by an op: tf.zeros would be folded into
        # a constant of the frame's size
        zero = x[:, 0, :, :, :2] * 0.0
        if t > 1:
            fh, fw = flow_downscale_hw(h, w, model.flow_downscale)
            frames = [x[:, i] for i in range(t)]
            if (fh, fw) != (h, w):
                frames = [ops.resize(f, (fh, fw)) for f in frames]
            ff = ops.upsample_flow(spynet(tf.concat(frames[1:], 0), tf.concat(frames[:-1], 0)), h, w)
            flows = _frames_batch(tf, [zero] + [ff[i * b: (i + 1) * b] for i in range(t - 1)])
        else:
            flows = zero
        xf = tf.reshape(x, [b * t, h, w, c])
        enc = tf.reshape(ops.conv(xf, encode), [b, t, h, w, ch])
        # previous-frame encodings; frame 0 warps its own with the zero flow
        prev = tf.reshape(tf.concat([enc[:, :1], enc[:, :-1]], 1), [b * t, h, w, ch])
        x_warp = ops.flow_warp(prev, flows, "zeros")
        y = tf.reshape(enc, [b * t, h, w, ch])
        for i, (k0, k1) in enumerate(blocks):
            inp = tf.concat([flows, x_warp, y], -1) if i == 0 else y
            y = ops.conv(tf.nn.relu(ops.conv(inp, k0)), k1) + y
        out = ops.depth_to_space(ops.conv(y, decode), s) + ops.resize(xf, (h * s, w * s))
        return tf.reshape(out, [b, t, h * s, w * s, c])

    return forward


def tf_vsr_model(model, height, width):
    """The TF forward of a float port VSR model of a type ``cli.export``
    lists ('basic', 'basic_origin', 'basic_mv', 'single', 'multi')."""
    if isinstance(model, (BasicVSR, BasicVSROrigin)):  # 'basic_mv' is a BasicVSR
        return tf_basicvsr(model, height, width)
    if isinstance(model, SingleImageModel):
        return tf_single(model, height, width)
    if isinstance(model, NaiveMultiModel):
        return tf_naive_multi(model)
    raise TypeError(f"no TFLite builder for {type(model).__name__}: the exported VSR types are 'basic', "
                    "'basic_origin', 'basic_mv', 'single' and 'multi'")
