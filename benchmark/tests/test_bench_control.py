"""The control of every cell comes out not correct on the card, through the
same check as a benchmark run, on three seeds at the cell's own size. The
serving cells state float32; the control is the port's own path one step
below it, serving in bfloat16 (``--bf16``), and the port's ``--quantize
int8`` path below that fails as well: each runs a short window at the cell's
load. Training (float32, TF32 off) puts the reference, computed in TF32, in
the program's place."""

import pytest

from benchmark.harness import cell as cells
from benchmark.harness import control

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
SERVE = ("serve.basicvsr_mobile.s4_cached", "serve.basicvsr.s1_plain")
TRAIN = "train.basicvsr_mobile.b2t10p64"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", ["bf16", "int8"])
@pytest.mark.parametrize("name", SERVE)
def test_serving_control_is_not_correct(cuda_device, name, variant, seed):
    res = control.run(name, seed, 2.0, variant, cuda_device)
    assert not cells.is_correct(res), res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_is_not_correct(cuda_device, seed):
    limits = cells.find(TRAIN)[3]["limits"]
    values = control.readings(TRAIN, seed, 2.0, "tf32", cuda_device)
    assert any(values[k] > limit for k, limit in limits.items()), values
