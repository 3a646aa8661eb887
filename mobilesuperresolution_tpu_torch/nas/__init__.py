"""Neural architecture search artifacts (counterpart of
mobilesuperresolution_tpu/nas; only the artifact reader is ported so far)."""
