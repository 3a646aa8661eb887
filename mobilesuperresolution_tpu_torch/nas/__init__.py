"""Neural architecture search (counterpart of mobilesuperresolution_tpu/nas):
the latency model, the latency loss, the search phases and the
``block_index.txt`` artifact. The MLP latency predictor is not ported yet."""
