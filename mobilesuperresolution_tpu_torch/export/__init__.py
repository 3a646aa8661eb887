from mobilesuperresolution_tpu_torch.export.export import (
    FixedSizeForward,
    export_onnx,
    export_pt2,
    export_tflite,
    load_pt2,
    run_tflite,
)

__all__ = ["FixedSizeForward", "export_onnx", "export_pt2", "export_tflite", "load_pt2", "run_tflite"]
