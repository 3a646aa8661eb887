"""Port parity for the NAS search slice: the STE gates, the latency model and
loss, kernel B5's plain version and its autograd Function, the supernet,
one search step's gradients, a short lockstep of the search against the JAX
step, the LR schedule, the TRAIN data stream and the search entry point.
float32 on the CPU, the same numpy inputs and weights on both sides (the
bridge's seeded weights, whose keys and shapes are checked against the JAX
init's; no JAX init is compiled).

Tolerances: exact where the arithmetic is the same integer or comparison
logic (gates, counts, data items, the architecture); 1e-6 relative for
scalar float formulas; 1e-5 for B5 (a few hundred f32 terms per output
summed in another order) and for the tiny supernet's sr and latency; 1e-4
of the largest gradient for a step's gradients (a 2-block chain summed in
another order); 1e-4 relative per-step loss over the short lockstep (Adam
carries the summation-order noise of one step into the next, so final
weights after many steps are not compared).
"""

import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.core.utils import SpeedScheduler as JSpeedScheduler
from mobilesuperresolution_tpu.data import isr as jisr
from mobilesuperresolution_tpu.data import synthetic as jsyn
from mobilesuperresolution_tpu.kernels.fused_convsep import fused_convsep as j_convsep_kernel
from mobilesuperresolution_tpu.models.wdsr_nas import NASModel as JNASModel
from mobilesuperresolution_tpu.models.wdsr_nas import get_block_status as j_block_status
from mobilesuperresolution_tpu.models.wdsr_nas import get_width_from_block_idx as j_width
from mobilesuperresolution_tpu.nas import speed_estimator as jse
from mobilesuperresolution_tpu.nas.artifact import read_block_index as j_read_block_index
from mobilesuperresolution_tpu.nas.search import phase_trainable_mask as j_phase_mask
from mobilesuperresolution_tpu.nas.speed_loss import SpeedLoss as JSpeedLoss
from mobilesuperresolution_tpu.ops import ste as jste
from mobilesuperresolution_tpu.train.checkpoint import load_params_npz as j_load_params_npz
from mobilesuperresolution_tpu.train.state import TrainState
from mobilesuperresolution_tpu.train.state import multistep_adam as j_multistep_adam
from mobilesuperresolution_tpu.train.state import multistep_lr as j_multistep_lr
from mobilesuperresolution_tpu.train.steps import make_search_step as j_make_search_step
from mobilesuperresolution_tpu_torch.cli import search
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.core.utils import SpeedScheduler
from mobilesuperresolution_tpu_torch.data import isr as tisr
from mobilesuperresolution_tpu_torch.data import synthetic as tsyn
from mobilesuperresolution_tpu_torch.kernels.fused_convsep import FusedConvSepFn, fused_convsep, fused_convsep_plain
from mobilesuperresolution_tpu_torch.models import NASModel, get_model
from mobilesuperresolution_tpu_torch.models.wdsr_nas import (
    get_block_status,
    get_current_blocks,
    get_width_from_block_idx,
)
from mobilesuperresolution_tpu_torch.nas import speed_estimator as tse
from mobilesuperresolution_tpu_torch.nas.artifact import read_block_index
from mobilesuperresolution_tpu_torch.nas.search import phase_trainable_mask
from mobilesuperresolution_tpu_torch.nas.speed_loss import SpeedLoss
from mobilesuperresolution_tpu_torch.ops import ste as tste
from mobilesuperresolution_tpu_torch.train.checkpoint import (
    jax_named_parameters,
    jax_param_shapes,
    load_params_npz,
    random_jax_params,
    save_params_npz,
)
from mobilesuperresolution_tpu_torch.train.state import multistep_adam, multistep_lr
from mobilesuperresolution_tpu_torch.train.steps import make_search_step

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P30_TABLE = os.path.join(REPO, "mobilesuperresolution_tpu", "nas", "speed_tables", "huawei_p30_cpu.npy")


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(params, leaf=np.asarray):
    """The JAX package's flat-npz layout (train/checkpoint.py::save_params_npz)."""
    return {
        "/".join(str(getattr(p, "key", p)) for p in path): leaf(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        d = out
        for s in scope:
            d = d.setdefault(s, {})
        d[leaf] = jnp.asarray(v)
    return out


# ---------------------------------------------------------------------------
# STE gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("least_channel", [0, 3, 8])
def test_ste_gates_match_jax(least_channel):
    """Above the floor, the floor with ties at the k-th value (four 0.3s for
    a floor of 3), and binary_mask's identity gradient."""
    cases = [
        np.array([0.9, 0.1, 0.6, 0.55, 0.2, 0.7, 0.51, 0.8, 0.95, 0.5], np.float32),
        np.array([0.1, 0.3, 0.3, 0.2, 0.3, 0.05, 0.3, 0.45, 0.1, 0.2], np.float32),
    ]
    c = np.linspace(-1, 1, 10).astype(np.float32)
    for w in cases:
        want = np.asarray(jste.rounding(jnp.asarray(w), least_channel))
        np.testing.assert_array_equal(tste.rounding(_t(w), least_channel).numpy(), want)
        assert float(tste.mask_active_count(_t(w), least_channel)) == float(
            jste.mask_active_count(jnp.asarray(w), least_channel)
        )
        wt = _t(w).requires_grad_()
        m = tste.binary_mask(wt, least_channel)
        (m * _t(c)).sum().backward()
        jm, jg = jax.value_and_grad(lambda v: jnp.sum(jste.binary_mask(v, least_channel) * c))(jnp.asarray(w))
        np.testing.assert_array_equal(m.detach().numpy(), np.asarray(jste.binary_mask(jnp.asarray(w), least_channel)))
        np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jg))
    if least_channel:
        with pytest.raises(ValueError, match="least_channel"):
            tste.rounding(torch.ones(least_channel - 1), least_channel)


@pytest.mark.parametrize("a1,a2", [(0.1, 0.9), (0.9, 0.1), (0.5, 0.5)])
def test_condition_matches_jax(a1, a2):
    """Forward select (ties keep the skip) and identity gradients to both
    alphas."""
    t1, t2 = torch.tensor(a1, requires_grad=True), torch.tensor(a2, requires_grad=True)
    b1, b2 = tste.condition(t1, t2)
    (2.0 * b1 + 3.0 * b2).backward()
    jb = jste.condition(jnp.float32(a1), jnp.float32(a2))
    jg = jax.grad(lambda x, y: 2.0 * jste.condition(x, y)[0] + 3.0 * jste.condition(x, y)[1], argnums=(0, 1))(
        jnp.float32(a1), jnp.float32(a2)
    )
    assert (float(b1.detach()), float(b2.detach())) == (float(jb[0]), float(jb[1]))
    assert (float(t1.grad), float(t2.grad)) == (float(jg[0]), float(jg[1])) == (2.0, 3.0)


# ---------------------------------------------------------------------------
# latency model, loss, scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", [False, True], ids=["analytic", "table"])
@pytest.mark.parametrize("differentiable", [False, True])
def test_block_speed_matches_jax(rng, table, differentiable):
    """The per-block latency from the gates, its value and (differentiable)
    its gradients to mask_w, split_w and alpha; the table is indexed
    [kernel, split, mask] with the split count floored at 8."""
    r = 12
    mask_w = rng.uniform(0.3, 0.8, r).astype(np.float32)
    split_w = rng.uniform(0.2, 0.6, r).astype(np.float32)  # few survive: the floor of 8 decides
    alpha = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    dense = tse.densify_speed_table(np.load(P30_TABLE), max_ch=r) if table else None
    jt = None if dense is None else jnp.asarray(dense)

    def jfn(m, s, a):
        return jse.block_speed_from_gates(m, s, a, differentiable=differentiable, speed_table=jt)

    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2))(jnp.asarray(mask_w), jnp.asarray(split_w), jnp.asarray(alpha))
    ts = [_t(a).requires_grad_() for a in (mask_w, split_w, alpha)]
    got = tse.block_speed_from_gates(*ts, differentiable=differentiable,
                                     speed_table=None if dense is None else _t(dense))
    np.testing.assert_allclose(float(got.detach()), float(jv), rtol=1e-6)
    assert got.requires_grad == differentiable
    if differentiable:
        got.backward()
        for t, g in zip(ts, jg):
            # the table path indexes with the counts: no gradient reaches the gates
            tg = torch.zeros_like(t) if t.grad is None else t.grad
            np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=1e-6, atol=1e-7)
    else:
        assert all(float(np.abs(np.asarray(g)).max()) == 0.0 for g in jg)


@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_densify_speed_table_matches_jax(method):
    """The measured Huawei P30 CPU table (read as data) densified to 32 and
    40 channels, and the nearest-config estimator it is built on."""
    rows = np.load(P30_TABLE)
    for max_ch in (32, 40):
        np.testing.assert_array_equal(
            tse.densify_speed_table(rows, max_ch, method), jse.densify_speed_table(rows, max_ch, method)
        )
    for q in [(32, 16, 3), (20, 7, 5), (8, 8, 7), (64, 1, 3)]:
        assert tse.TableSpeedEstimator(rows)(*q) == jse.TableSpeedEstimator(rows)(*q)
    with pytest.raises(ValueError):
        tse.densify_speed_table(rows, 32, "cubic")


def test_speed_loss_scheduler_and_ori_speed_match_jax():
    for nb, r in [(16, 32), (4, 12), (2, 8)]:
        assert tse.get_ori_speed(nb, r) == jse.get_ori_speed(nb, r)
    speed = np.array([3.0, 55.0, 41.5], np.float32)
    for method in ("clamp", "mse", "abs"):
        for target in (40.0, 60.0):
            got = SpeedLoss(scale=12.5)(_t(speed), target, gamma=0.1, method=method)
            want = JSpeedLoss(scale=12.5)(jnp.asarray(speed), target, gamma=0.1, method=method)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    a, b = SpeedScheduler(5, 600.0, 500.0, gamma=0.5), JSpeedScheduler(5, 600.0, 500.0, gamma=0.5)
    assert [a.step() for _ in range(7)] == [b.step() for _ in range(7)]


# ---------------------------------------------------------------------------
# kernel B5: plain version and autograd Function
# ---------------------------------------------------------------------------


def _convsep_inputs(rng, k, c=8, c_out=12, hw=(16, 20), b=2):
    return (
        rng.standard_normal((b, *hw, c)).astype(np.float32),
        (rng.standard_normal((k, k, c)) * 0.2).astype(np.float32),
        rng.standard_normal(c).astype(np.float32),
        (rng.standard_normal((c, c_out)) * 0.2).astype(np.float32),
        rng.standard_normal(c_out).astype(np.float32),
    )


@pytest.mark.parametrize("k", [3, 5, 7])
def test_fused_convsep_plain_matches_pallas(rng, k):
    """B5's plain version (the CPU path and the card-side oracle) against the
    Pallas kernel in interpret mode (H a multiple of its row tile, 8); the
    wrapper takes the plain path on CPU tensors and counts no launch."""
    args = _convsep_inputs(rng, k)
    want = np.asarray(j_convsep_kernel(*map(jnp.asarray, args), tile=8, interpret=True))
    before = fused_convsep.launches
    got = fused_convsep(*map(_t, args))
    assert fused_convsep.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), fused_convsep_plain(*map(_t, args)).numpy())
    # a tensor on neither the CPU nor CUDA is refused, never computed by the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        fused_convsep(*(torch.empty(a.shape, device="meta") for a in args))


@pytest.mark.parametrize("k", [3, 7])
def test_fused_convsep_gradients_match_jax(rng, k):
    """FusedConvSepFn's backward (the plain version recomputed under
    autograd) against JAX autodiff of the XLA reference of the same function,
    for every input, on a ragged map."""
    x, wd, bd, wp, bp = _convsep_inputs(rng, k, hw=(9, 13))
    cot = rng.standard_normal((2, 9, 13, 12)).astype(np.float32)

    def jref(x, wd, bd, wp, bp):
        dw = jax.lax.conv_general_dilated(
            x, wd[:, :, None, :], (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=x.shape[-1],
        )
        return jnp.sum((jnp.maximum(dw + bd, 0.0) @ wp + bp) * cot)

    jg = jax.grad(jref, argnums=tuple(range(5)))(*map(jnp.asarray, (x, wd, bd, wp, bp)))
    ts = [_t(a).requires_grad_() for a in (x, wd, bd, wp, bp)]
    (FusedConvSepFn.apply(*ts) * _t(cot)).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4 * max(1.0, float(np.abs(g).max())))


# ---------------------------------------------------------------------------
# the supernet
# ---------------------------------------------------------------------------


def _jax_supernet(nb, r, width_search=True, differentiable_speed=False):
    """A JAX NASModel and params for it (cached per configuration; JAX arrays
    are immutable): the bridge's seeded weights from the JAX initializers'
    families (``random_jax_params``), after checking that their keys and
    shapes are the JAX init's (``jax.eval_shape``: traced, not compiled)."""
    return _jax_init(nb, r, width_search, differentiable_speed)


@functools.lru_cache(maxsize=None)
def _jax_init(nb, r, width_search, differentiable_speed):
    jm = JNASModel(num_blocks=nb, num_residual_units=r, scale=2, width_search=width_search,
                   differentiable_speed=differentiable_speed)
    shapes = _flat(jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 8, 8, 3)))["params"],
                   leaf=lambda a: tuple(a.shape))
    flat = random_jax_params(NASModel(num_blocks=nb, num_residual_units=r, scale=2), seed=0)
    assert {k: v.shape for k, v in flat.items()} == shapes
    return jm, _unflat(flat)


def _port_supernet(flat, nb, r, **kw):
    m = NASModel(num_blocks=nb, num_residual_units=r, scale=2, **kw)
    load_params_npz(m, flat)
    return m


@pytest.mark.parametrize(
    "r,width_search,differentiable,table",
    [(8, True, False, False), (12, False, True, True)],
    ids=["8units", "12units-table-diff"],
)
def test_nas_model_matches_jax(rng, r, width_search, differentiable, table):
    """sr and speed_accu within 1e-5 through the bridge, with one block
    skipped (alpha1 > alpha2: beta2 = 0, computed all the same); the
    bridge's key set and shapes equal the JAX init's flattened params
    (``_jax_supernet``) and the port model's; the architecture readers
    agree."""
    kw = dict(width_search=width_search, differentiable_speed=differentiable)
    jm, params = _jax_supernet(2, r, **kw)
    flat = _flat(params)
    flat["block_1/alpha1"] = np.float32(0.95)
    flat["block_0/split_w"] = rng.uniform(0.2, 0.9, r).astype(np.float32)
    flat["block_0/alpha"] = np.array([0.7, 1.4, 0.2], np.float32)
    m = _port_supernet(flat, 2, r, **kw)
    assert jax_param_shapes(m) == {k: v.shape for k, v in flat.items()}
    dense = tse.densify_speed_table(np.load(P30_TABLE), max_ch=r) if table else None
    x = rng.random((2, 12, 10, 3)).astype(np.float32)
    want_sr, want_speed = jax.jit(jm.apply)({"params": _unflat(flat)}, jnp.asarray(x),
                                            None if dense is None else jnp.asarray(dense))
    with torch.no_grad():
        sr, speed = m(_t(x), None if dense is None else _t(dense))
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), atol=1e-5)
    np.testing.assert_allclose(float(speed), float(want_speed), rtol=1e-5)
    jp = _unflat(flat)
    idx = get_block_status(m)
    assert idx == j_block_status(jp) == [0] and get_current_blocks(m) == 1
    assert get_width_from_block_idx(m, idx) == j_width(jp, idx)
    with pytest.raises(ValueError, match="speed_table"):
        m(_t(x), torch.zeros(3, r, r))


def test_random_init_and_save_follow_jax_layout(tmp_path):
    """random_jax_params draws the gates from their JAX initializers' ranges
    and g = ||v|| for the branches; save_params_npz writes the JAX flat
    layout, which loads back into both packages."""
    _, params = _jax_supernet(2, 8)
    m = NASModel(num_blocks=2, num_residual_units=8, scale=2)
    rnd = random_jax_params(m, seed=5)
    assert set(rnd) == set(_flat(params))
    for leaf, (lo, hi) in {"mask_w": (0.5, 1.0), "block_1/split_w": (0.5, 1.0), "block_0/alpha": (0.5, 1.5),
                           "block_0/alpha1": (0.0, 0.2), "block_1/alpha2": (0.8, 1.0)}.items():
        assert lo <= rnd[leaf].min() and rnd[leaf].max() <= hi, leaf
    v = rnd["block_0/branch_5/WNConv_0/v"].astype(np.float64)
    np.testing.assert_allclose(rnd["block_0/branch_5/WNConv_0/g"], np.sqrt((v * v).sum(axis=(0, 1, 2))), rtol=1e-6)
    load_params_npz(m, rnd)
    path = save_params_npz(str(tmp_path), m)
    assert path == os.path.join(str(tmp_path), "weights", "models.npz")
    back = j_load_params_npz(path, params)
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v, rnd[k])
    m2 = NASModel(num_blocks=2, num_residual_units=8, scale=2)
    load_params_npz(m2, path)
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), m2.parameters()))


def test_get_model_builds_the_supernet(monkeypatch):
    """NAS_MODEL: a training-ready supernet on the device asked for, seeded
    weights from the JAX initializers, the width / differentiable-speed
    flags carried; without a card it raises unless the CPU is asked for."""
    p = SimpleNamespace(model_type="NAS_MODEL", num_blocks=2, num_residual_units=8, scale=2, seed=3,
                        width_search=False, differentiable_speed=True)
    m = get_model(p, device="cpu")
    assert isinstance(m, NASModel) and m.training and not m.width_search
    assert m.block_1.differentiable_speed
    want = random_jax_params(NASModel(num_blocks=2, num_residual_units=8, scale=2), seed=3)
    for k, prm in jax_named_parameters(m).items():
        np.testing.assert_array_equal(prm.detach().numpy(), want[k])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(p)


# ---------------------------------------------------------------------------
# the search step, the optimizer and the LR schedule
# ---------------------------------------------------------------------------


def test_search_step_gradients_match_jax(rng):
    """One search step's loss and the gradient of every parameter against
    jax.value_and_grad of make_search_step's loss (L1 + clamp SpeedLoss on
    the traced latency), with the target below the supernet's speed so the
    latency term pushes alpha1 / alpha2."""
    nb, r = 2, 8
    jm, params = _jax_supernet(nb, r)
    flat = _flat(params)
    m = _port_supernet(flat, nb, r)
    ori = jse.get_ori_speed(nb, r)
    target = 0.5 * ori
    lr_img = rng.random((2, 10, 12, 3)).astype(np.float32)
    hr_img = rng.random((2, 20, 24, 3)).astype(np.float32)

    def jloss(p):
        sr, speed = jm.apply({"params": p}, jnp.asarray(lr_img))
        l1 = jnp.mean(jnp.abs(sr - hr_img))
        return l1 + JSpeedLoss(scale=ori - target)(speed, target, gamma=0.1)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    jg = _flat(jg)
    opt = multistep_adam(jax_named_parameters(m), 0.0, 1, 1)
    metrics = make_search_step(m, opt, SpeedLoss(scale=ori - target))((_t(lr_img), _t(hr_img)), target)
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-5)
    assert float(metrics["skipped"]) == 0.0
    for key, prm in jax_named_parameters(m).items():
        g = jg[key]
        np.testing.assert_allclose(prm.grad.numpy(), g, atol=1e-4 * max(1e-3, float(np.abs(g).max())), err_msg=key)


@pytest.mark.parametrize(
    "epochs,milestones", [(10, None), (2, None), (1, None), (4, [0, 3, 3])], ids=["default", "dup", "zero", "custom"]
)
def test_multistep_lr_matches_optax(epochs, milestones):
    """MultiStepLR boundaries: duplicate milestones compound, milestone 0
    folds into the initial value."""
    spe = 3
    got = multistep_lr(0.01, spe, epochs, milestones=milestones)
    want = j_multistep_lr(0.01, spe, epochs, milestones=milestones)
    for count in range(spe * epochs + 2):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


def test_phase_masks_match_jax():
    _, params = _jax_supernet(2, 8)
    keys = list(_flat(params))
    for phase in ("width", "length", "kernel"):
        want = {"/".join(str(p.key) for p in path): bool(v)
                for path, v in jax.tree_util.tree_flatten_with_path(j_phase_mask(params, phase))[0]}
        assert phase_trainable_mask(keys, phase) == want
    with pytest.raises(ValueError):
        phase_trainable_mask(keys, "depth")


@pytest.mark.parametrize("phase", ["width", "kernel"])
def test_search_lockstep_matches_jax(phase):
    """Six steps of the search against make_search_step + multistep_adam
    with the phase's trainable mask and an LR milestone inside the run; the
    fourth batch holds a NaN, which both sides skip (no parameter, moment or
    schedule count moves). Per-step loss, l1 and latency agree, and so does
    the surviving architecture."""
    nb, r, bs, hw = 2, 8, 2, 8
    spe, epochs, lr = 2, 3, 1e-2  # milestones [1, 2] epochs: boundaries at counts 2 and 4
    jm, params = _jax_supernet(nb, r)
    flat = _flat(params)
    flat["block_0/alpha"] = np.array([1.0, 1.01, 0.99], np.float32)  # a near tie the steps can flip
    params = _unflat(flat)
    ori = jse.get_ori_speed(nb, r)
    target = 0.6 * ori
    tx = j_multistep_adam(lr, spe, epochs, trainable_mask=j_phase_mask(params, phase))
    state = TrainState(step=0, params=params, opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
    jstep = j_make_search_step(state, JSpeedLoss(scale=ori - target))

    m = _port_supernet(flat, nb, r)
    named = jax_named_parameters(m)
    opt = multistep_adam(named, lr, spe, epochs, trainable_mask=phase_trainable_mask(named, phase))
    tstep = make_search_step(m, opt, SpeedLoss(scale=ori - target))
    frozen = {k: p.detach().clone() for k, p in named.items() if not phase_trainable_mask(named, phase)[k]}

    data = np.random.default_rng(7)
    for i in range(6):
        lr_img = data.random((bs, hw, hw, 3), np.float32)
        hr_img = data.random((bs, 2 * hw, 2 * hw, 3), np.float32)
        if i == 3:
            lr_img[0, 0, 0, 0] = np.nan
        state, jmet = jstep(state, (jnp.asarray(lr_img), jnp.asarray(hr_img)), target)
        tmet = tstep((_t(lr_img), _t(hr_img)), target)
        assert float(tmet["skipped"]) == float(jmet["skipped"]) == float(i == 3)
        if i == 3:
            continue
        for key in ("loss", "l1", "speed"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-4, err_msg=f"step {i} {key}")
    assert opt.applied == 5
    for k, p in frozen.items():
        assert torch.equal(named[k].detach(), p), k
    idx = get_block_status(m)
    assert idx == j_block_status(state.params)
    assert get_width_from_block_idx(m, idx) == j_width(state.params, idx)


# ---------------------------------------------------------------------------
# TRAIN data
# ---------------------------------------------------------------------------


def _train_params(**kw):
    return SimpleNamespace(scale=2, lr_patch_size=6, ignored_boundary_size=2, num_patches=3, seed=0,
                           synthetic_textured=True, **kw)


@pytest.mark.parametrize("textured", [True, False])
def test_train_batches_match_jax_bicubic(textured):
    """The synthetic (bicubic) TRAIN stream: shuffled order, random patches
    with the ignored boundary, flips / transpose, drop_last, bit-equal to
    JAX's _batches for the same seed."""
    p = _train_params()
    p.synthetic_textured = textured
    tds = tsyn.SyntheticISRDataset(modes.TRAIN, p, num_images=3, hw=(40, 44))
    jds = jsyn.SyntheticISRDataset(modes.TRAIN, p, num_images=3, hw=(40, 44))
    assert len(tds) == len(jds) == 9
    got = list(tisr.batch_iterator(tds, 4, shuffle=True, seed=11, drop_last=True, prefetch=2))
    want = list(jisr._batches(jds, 4, True, 11, True))
    assert len(got) == len(want) == 2
    for (gl, gh), (wl, wh) in zip(got, want):
        assert gl.shape == (4, 6, 6, 3) and gh.shape == (4, 12, 12, 3)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gh, wh)


def test_train_batches_match_jax_paired():
    """Paired LR/HR files: the LR-grid patch inside the boundary and the
    matching HR window, in order and shuffled, with the remainder batch."""
    lrs = [tsyn.synthetic_image(20 + i, (18, 22)) for i in range(2)]
    hrs = [tsyn.synthetic_image(30 + i, (36, 44)) for i in range(2)]

    def loaders(base):
        class Paired(base):
            def _load(self, files, index):
                return (lrs if files is self.lr_files else hrs)[index]
        return Paired

    files = [("a", None), ("b", None)]
    p = _train_params()
    tds = loaders(tisr.ImageSRDataset)(modes.TRAIN, p, files, list(files))
    jds = loaders(jisr.ImageSRDataset)(modes.TRAIN, p, files, list(files))
    for shuffle in (False, True):
        got = list(tisr.batch_iterator(tds, 4, shuffle=shuffle, seed=5))
        want = list(jisr._batches(jds, 4, shuffle, 5, False))
        assert [len(b[0]) for b in got] == [len(b[0]) for b in want] == [4, 2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])


def test_div2k_train_half_matches_jax(tmp_path):
    """``--dataset div2k`` trains on DIV2K_train_HR (PNG files read from
    disk), bit-equal to the JAX package's div2k dataset; the eval-only sets
    refuse TRAIN."""
    from PIL import Image

    from mobilesuperresolution_tpu.data import div2k as jdiv2k
    from mobilesuperresolution_tpu_torch.data import get_dataset_module

    d = tmp_path / "DIV2K" / "DIV2K_train_HR"
    d.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(tsyn.synthetic_image(40 + i, (30, 34))).save(d / f"{i:04d}.png")
    p = _train_params(data_dir=str(tmp_path))
    tds = get_dataset_module("div2k").get_dataset(modes.TRAIN, p)
    jds = jdiv2k.get_dataset(modes.TRAIN, p)
    assert len(tds) == len(jds) == 6
    for g, w in zip(tisr.batch_iterator(tds, 4, shuffle=True, seed=2), jisr._batches(jds, 4, True, 2, False)):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    with pytest.raises(NotImplementedError, match="eval-only"):
        get_dataset_module("set5").get_dataset(modes.TRAIN, p)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_search_cli_on_cpu(tmp_path, monkeypatch):
    """cli.search end to end on the CPU at a tiny size: three phases, finite
    metrics at every step, a block_index.txt that the JAX reader parses and a
    weights npz that loads into a JAX NASModel and gives the port's output;
    flags of parts not ported are refused, and without a card it runs only
    when the CPU is asked for."""
    argv = ["--job_dir", str(tmp_path), "--device", "cpu", "--dataset", "synthetic_isr",
            "--eval_datasets", "synthetic_isr", "--num_blocks", "2", "--num_residual_units", "8",
            "--width_epochs", "1", "--epochs", "1", "--kernel_epochs", "1", "--lr_patch_size", "8",
            "--train_batch_size", "4", "--num_patches", "1", "--log_steps", "1", "--speed_target", "10",
            "--speed_table", P30_TABLE]
    tf32 = torch.backends.cudnn.allow_tf32
    out = search.main(argv)
    assert torch.backends.cudnn.allow_tf32 == tf32
    assert [s["phase"] for s in out["steps"]] == ["width"] * 2 + ["length"] * 2 + ["kernel"] * 2
    assert all(np.isfinite([s[k] for k in ("loss", "l1", "speed", "speed_loss")]).all() for s in out["steps"])
    assert (out["train_forwards"], out["eval_images"], len(out["eval"])) == (6, 24, 3)
    assert np.isfinite(out["eval"][-1]["synthetic_isr"]["PSNR"])
    lines = open(os.path.join(tmp_path, "block_index.txt")).read().splitlines()
    assert len(lines) == 7  # every step at --log_steps 1, and the final line
    assert j_read_block_index(str(tmp_path)) == read_block_index(str(tmp_path)) == (
        out["remain_idx"], out["remain_width"]
    )
    jm, template = _jax_supernet(2, 8)
    path = os.path.join(tmp_path, "weights", "models.npz")
    jp = j_load_params_npz(path, template)
    m = _port_supernet(path, 2, 8)
    x = np.random.default_rng(0).random((1, 8, 8, 3)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(m(_t(x))[0].numpy(), np.asarray(jm.apply({"params": jp}, jnp.asarray(x))[0]),
                                   atol=1e-5)
    for flag in (["--distributed"], ["--pretrained"], ["--eval_tile", "64"], ["--speed_predictor", "auto"],
                 ["--build_speed_table"]):
        with pytest.raises(SystemExit):
            search.main(argv[:2] + ["--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="npy"):
        search.main(argv[:-1] + ["huawei_p30_cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        search.main([a for a in argv if a not in ("--device", "cpu")])
