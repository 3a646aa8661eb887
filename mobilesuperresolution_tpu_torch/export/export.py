"""Deployment export (counterpart of mobilesuperresolution_tpu/export/export.py,
the reference's export_onnx.py + onnx_tflite.py).

- ``pt2``: ``torch.export`` of a model's forward, traced on the CPU, where
  every kernel wrapper takes its plain PyTorch version, so the artifact holds
  only ATen ops and runs on any device (``torch.export.load``, then
  ``move_to_device_pass`` for the card). It plays the role the JAX package's
  StableHLO artifact plays: a portable graph with no hand kernel in it.
- ``onnx``: the searched SISR net (ResultNet) through ``torch.onnx.export``
  with NCHW input, the reference's own artifact; needs the ``onnx`` package.
- ``tflite``: the searched SISR net (ResultNet) rebuilt in TF ops from the
  port's weights (weight norm folded into plain HWIO kernels, NHWC,
  ``tf.nn.depth_to_space`` for the tail) and converted by
  ``tf.lite.TFLiteConverter`` with the JAX package's settings (TFLite
  builtins plus select TF ops; ``quantize``: dynamic-range int8,
  ``Optimize.DEFAULT``). tensorflow is imported when it is called, and it
  raises without it. The VSR types are refused (ROADMAP.md, queue A8g).

The export input is 360x540 like the reference's (NHWC here, NCHW for ONNX).
"""

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.models.result_net import ResultNet


class FixedSizeForward(torch.nn.Module):
    """``model(x, *args)`` as a one-input module: the output size of a VSR
    model (height, width) becomes part of the graph."""

    def __init__(self, model, *args):
        super().__init__()
        self.model = model
        self.args = args

    def forward(self, x):
        return self.model(x, *self.args)


def export_pt2(module, example, path):
    """Trace ``module`` (eval mode, on the CPU) on ``example`` with
    ``torch.export`` and save the program to ``path`` (.pt2)."""
    with torch.no_grad():
        program = torch.export.export(module.eval(), (example,))
    torch.export.save(program, path)
    return path


def load_pt2(path, device="cpu"):
    """The saved program's module on ``device``; the graph's device literals
    are rewritten by ``move_to_device_pass`` when it is not the CPU."""
    program = torch.export.load(path)
    if torch.device(device).type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    return program.module()


class _NCHW(torch.nn.Module):
    """An NHWC model behind the NCHW interface of the reference's ONNX
    artifact."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def export_onnx(model, input_shape, path, opset=13):
    """Export the searched SISR net (the port's ResultNet, on the CPU) to ONNX
    with input (N, C, H, W), as the reference's export_onnx.py did.
    ``input_shape`` is NHWC like the rest of this module. Needs the ``onnx``
    package, which torch serializes through."""
    n, h, w, c = input_shape
    try:
        torch.onnx.export(_NCHW(model.eval()), torch.zeros(n, c, h, w), path, opset_version=opset, dynamo=False,
                          input_names=["input"], output_names=["output"])
    except Exception as e:
        if isinstance(e, ImportError) and "onnx" in str(e).lower() or "onnx is not installed" in str(e):
            raise RuntimeError("the 'onnx' package is required for ONNX export (pip install onnx in your "
                               f"deployment environment): {e}") from e
        raise
    return path


def refuse_tflite(name):
    raise NotImplementedError(f"TFLite export of {name} is not ported: the VSR types need SpyNet, the flow warp and "
                              "the unrolled scan in TF ops (ROADMAP.md, queue A8g); export --format pt2 instead")


def _import_tf():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise RuntimeError(f"tensorflow unavailable: {e}") from e
    return tf


def _depth_to_space_order(scale, channels):
    """Conv channel order that makes ``tf.nn.depth_to_space`` (channel
    (i·s + j)·C + c to offset (i, j) of channel c) give the port's
    ``depth_to_space`` (channel c·s² + i·s + j)."""
    return np.arange(scale * scale * channels).reshape(channels, scale * scale).T.reshape(-1)


def tf_result_net(model):
    """The forward of ``model`` (a ResultNet, float) as a function of TF ops
    on an NHWC float32 tensor, its weights folded into constants: each
    WNConv's effective HWIO kernel and bias, the tail's and skip's output
    channels reordered for ``tf.nn.depth_to_space``."""
    tf = _import_tf()
    s = model.scale

    def weights(conv, order=None):
        k = conv.effective_kernel().detach().float().cpu().numpy()
        b = conv.b.detach().float().cpu().numpy()
        if order is not None:
            k, b = k[..., order], b[order]
        return tf.constant(k), tf.constant(b)

    order = _depth_to_space_order(s, 3) if s > 1 else None
    head, tail, skip = weights(model.head), weights(model.tail, order), weights(model.skip, order)
    blocks = [(cin - split, weights(blk.WNConv_0)) for (cin, split, _), blk in zip(model.idx, model.blocks())]

    def conv(x, kb):
        return tf.nn.conv2d(x, kb[0], 1, "SAME") + kb[1]

    def forward(x):
        x = x - model.image_mean
        y = conv(x, head)
        for p, kb in blocks:
            x2 = y[..., p:]
            x2 = tf.nn.relu(conv(x2, kb)) + x2
            y = tf.concat([y[..., :p], x2], -1) if p > 0 else x2
        y = conv(y, tail) + conv(x, skip)  # the reference never re-adds image_mean
        return tf.nn.depth_to_space(y, s) if s > 1 else y

    return forward


def export_tflite(module, input_shape, path, quantize=False):
    """Write the searched SISR net ``module`` (a float ResultNet) as a
    ``.tflite`` flatbuffer for an NHWC float32 input of ``input_shape``,
    converted as the JAX package converts (TFLite builtins plus select TF
    ops), dynamic-range int8 (int8 weights) with ``quantize``."""
    if not isinstance(module, ResultNet):
        refuse_tflite(type(module).__name__)
    if module.quantized:
        raise ValueError("export the float ResultNet: --quantize makes TFLite's own dynamic-range int8")
    tf = _import_tf()
    fn = tf.function(tf_result_net(module), input_signature=[tf.TensorSpec(input_shape, tf.float32)],
                     autograph=False)
    converter = tf.lite.TFLiteConverter.from_concrete_functions([fn.get_concrete_function()], fn)
    converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS, tf.lite.OpsSet.SELECT_TF_OPS]
    if quantize:
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
    with open(path, "wb") as f:
        f.write(converter.convert())
    return path


def run_tflite(path, x):
    """The ``.tflite`` at ``path`` on the numpy input ``x`` in
    ``tf.lite.Interpreter`` (the CPU); returns its output as numpy."""
    tf = _import_tf()
    interp = tf.lite.Interpreter(model_path=path)
    interp.allocate_tensors()
    interp.set_tensor(interp.get_input_details()[0]["index"], np.ascontiguousarray(x, np.float32))
    interp.invoke()
    return interp.get_tensor(interp.get_output_details()[0]["index"])
