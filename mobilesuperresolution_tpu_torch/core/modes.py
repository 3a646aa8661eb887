"""Run-mode constants (own copy of mobilesuperresolution_tpu/core/modes.py)."""

TRAIN = "train"
EVAL = "eval"
PREDICT = "predict"
