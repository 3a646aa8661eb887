"""The search artifact ``block_index.txt`` (own copy of
mobilesuperresolution_tpu/nas/artifact.py's reader).

The search appends, at every log step, the Python tuple repr
``([remain_block_idx, ...], [[mask_ch, split_ch, kernel], ...])``; consumers
parse the LAST line with ``ast.literal_eval`` and take element [1] for the
widths. An ``idx:width`` colon form is also accepted.
"""

import ast
import os


def read_block_index(path):
    """Parse the LAST line → (remain_idx, remain_width). Accepts a job dir or
    a direct file path, tuple-repr or colon format."""
    if os.path.isdir(path):
        path = os.path.join(path, "block_index.txt")
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    last = lines[-1]
    if last.startswith("("):
        idx, width = ast.literal_eval(last)
        return list(idx), [list(w) for w in width]
    idx_str, width_str = last.split(":", 1)
    return ast.literal_eval(idx_str), ast.literal_eval(width_str)
