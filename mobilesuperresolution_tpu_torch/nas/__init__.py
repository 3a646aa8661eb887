"""Neural architecture search (counterpart of mobilesuperresolution_tpu/nas):
the latency model (analytic, measured tables, and the MLP latency predictor
with its trainer), the latency loss, the search phases and the
``block_index.txt`` artifact. ``speed_tables/`` ships the H100's measured
table and the predictor trained on it (scripts/torch_train_h100_predictor.py),
which ``--speed_table auto`` / ``--speed_predictor auto`` find on that card."""
