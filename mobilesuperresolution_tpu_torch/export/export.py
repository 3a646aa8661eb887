"""Deployment export (counterpart of mobilesuperresolution_tpu/export/export.py,
the reference's export_onnx.py + onnx_tflite.py).

- ``pt2``: ``torch.export`` of a model's forward, traced on the CPU, where
  every kernel wrapper takes its plain PyTorch version, so the artifact holds
  only ATen ops and runs on any device (``torch.export.load``, then
  ``move_to_device_pass`` for the card). It plays the role the JAX package's
  StableHLO artifact plays: a portable graph with no hand kernel in it.
- ``onnx``: the searched SISR net (ResultNet) through ``torch.onnx.export``
  with NCHW input, the reference's own artifact; needs the ``onnx`` package.
- ``tflite``: needs tensorflow, and raises without it.

The export input is 360x540 like the reference's (NHWC here, NCHW for ONNX).
"""

import torch


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


def export_tflite(module, input_shape, path, quantize=False):
    """TFLite: the reference converts its ONNX artifact with tensorflow's
    converter (onnx_tflite.py), dynamic-range int8 with ``quantize``."""
    try:
        import tensorflow  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"tensorflow unavailable: {e}") from e
    raise NotImplementedError("TFLite conversion of the port's artifact (ONNX → TF → TFLite) is not implemented; "
                              "export --format onnx and convert it with the TF toolchain")
