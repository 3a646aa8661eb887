"""Offline analyses of eval outputs (counterpart of mobilesuperresolution_tpu/analysis)."""
