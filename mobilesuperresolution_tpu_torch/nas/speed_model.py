"""Learned latency predictor: an MLP from a block descriptor to its latency
in ms, and its trainer (counterpart of
mobilesuperresolution_tpu/nas/speed_model.py).

The reference's ConvBlockModel (Linear in→32→64→128→64→32→1 with ReLUs,
kaiming-normal×0.1 init) trained on (ch_in, ch_split, kernel, ms) rows with
an 80/20 split and the relative squared error ((s−t)/scale)²/t. The weights
are kept in the JAX package's layout, ``{"Dense_i": {"kernel" (in, out),
"bias"}}``, and saved as flax's msgpack (core/msgpack_io.py), so the
predictors shipped beside the JAX package load here unchanged, and a
predictor trained here loads there.
"""

import numpy as np
import torch
import torch.nn as nn

from mobilesuperresolution_tpu_torch.core import msgpack_io
from mobilesuperresolution_tpu_torch.nas.speed_estimator import device_kind, find_speed_file

DEFAULT_WIDTHS = (32, 64, 128, 64, 32)


class SpeedPredictor(nn.Module):
    """MLP block descriptor → latency (ms): ``Dense_i`` Linear layers of
    ``widths`` with ReLU between, then one output. ``num_feat`` 3 is the
    search's (ch_in, ch_split, kernel); the reference's S10/S21 predictors
    take 4 features through (128, 256, 512, 256, 128)."""

    def __init__(self, num_feat=3, widths=DEFAULT_WIDTHS):
        super().__init__()
        self.num_feat = num_feat
        self.widths = tuple(widths)
        dims = (num_feat, *self.widths, 1)
        for i in range(len(dims) - 1):
            setattr(self, f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))

    def layers(self):
        return [getattr(self, f"Dense_{i}") for i in range(len(self.widths) + 1)]

    def forward(self, x):
        """x: (N, num_feat) → (N, 1)."""
        *hidden, last = self.layers()
        for layer in hidden:
            x = torch.relu(layer(x))
        return last(x)


def init_predictor(model, seed=0):
    """The JAX initializer family: kernels Normal(0, (0.1·sqrt(2/fan_in))²)
    drawn from a ``torch.Generator`` seeded with ``seed``, biases zero."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.layers():
            fan_in = layer.in_features
            std = float(np.sqrt(2.0 / fan_in)) * 0.1
            layer.weight.copy_(torch.randn(layer.in_features, layer.out_features, generator=g).t() * std)
            layer.bias.zero_()
    return model


def predictor_params(model):
    """The flax layout of ``model``: {"Dense_i": {"kernel": (in, out),
    "bias": (out,)}}, float32 numpy."""
    return {f"Dense_{i}": {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                           "bias": layer.bias.detach().cpu().numpy().copy()}
            for i, layer in enumerate(model.layers())}


def predictor_from_params(params):
    """A ``SpeedPredictor`` holding flax-layout ``params``; ``num_feat`` and
    the hidden widths come from the kernels' shapes."""
    kernels = [np.asarray(params[f"Dense_{i}"]["kernel"]) for i in range(len(params))]
    model = SpeedPredictor(num_feat=int(kernels[0].shape[0]), widths=tuple(int(k.shape[1]) for k in kernels[:-1]))
    with torch.no_grad():
        for i, layer in enumerate(model.layers()):
            layer.weight.copy_(torch.tensor(np.asarray(params[f"Dense_{i}"]["kernel"], np.float32).T))
            layer.bias.copy_(torch.tensor(np.asarray(params[f"Dense_{i}"]["bias"], np.float32)))
    return model


def relative_squared_error(pred, target, scale=1.0):
    """((s − t)/scale)² / t, averaged."""
    return torch.mean(((pred - target) / scale) ** 2 / torch.clamp(target, min=1e-8))


def train_speed_predictor(rows, seed=0, epochs=400, lr=1e-2, batch_size=32, scale=1.0, optimizer="sgd",
                          init_params=None):
    """rows: (N, 4) [ch_in, ch_split, kernel, ms]. Returns (model, report).

    The JAX package's recipe: a numpy ``default_rng(seed)`` permutation, an
    80/20 split, the training rows shuffled in place every epoch, batches
    of ``batch_size``; SGD with momentum 0.9 (the reference's) or Adam
    (optax's defaults), at ``lr`` halved every ``epochs//4 ·
    n_train//batch_size`` steps. ``init_params`` (flax layout) replaces
    ``init_predictor``'s seeded start. The report holds the mean relative
    error on the training and validation rows (None without any)."""
    rows = np.asarray(rows, dtype=np.float32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(rows))
    n_train = int(0.8 * len(rows))
    train, val = rows[order[:n_train]], rows[order[n_train:]]

    if init_params is None:
        model = init_predictor(SpeedPredictor(num_feat=3), seed)
    else:
        model = predictor_from_params(init_params)
    params = list(model.parameters())
    transition = max(1, epochs // 4) * max(1, n_train // batch_size)
    state = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    count = 0
    for _ in range(epochs):
        rng.shuffle(train)
        for i in range(0, len(train), batch_size):
            xb = torch.from_numpy(train[i: i + batch_size, :3].copy())
            yb = torch.from_numpy(train[i: i + batch_size, 3].copy())
            loss = relative_squared_error(model(xb)[:, 0], yb, scale)
            grads = torch.autograd.grad(loss, params)
            step_lr = lr * 0.5 ** (count // transition)
            count += 1
            with torch.no_grad():
                _update(optimizer, params, grads, state, step_lr, count)

    def _eval(split):
        with torch.no_grad():
            pred = model(torch.from_numpy(split[:, :3].copy()))[:, 0]
        t = torch.from_numpy(split[:, 3].copy())
        return float(torch.mean(torch.abs(pred - t) / torch.clamp(t, min=1e-8)))

    report = {"train_rel_err": _eval(train), "val_rel_err": _eval(val) if len(val) else None}
    return model, report


def _update(optimizer, params, grads, state, lr, count):
    """One optax step in place: ``sgd(lr, momentum=0.9)`` (trace = g +
    0.9·trace) or ``adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, bias-corrected
    at step ``count``)."""
    mu, nu = state
    for p, g, m, v in zip(params, grads, mu, nu):
        if optimizer == "adam":
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).add_(g * g, alpha=0.001)
            m_hat = m / (1 - 0.9 ** count)
            v_hat = v / (1 - 0.999 ** count)
            p.sub_(lr * (m_hat / (torch.sqrt(v_hat) + 1e-8)))
        else:
            m.mul_(0.9).add_(g)
            p.sub_(lr * m)


def save_predictor(model, path):
    """Write ``model``'s weights as flax's msgpack, the format of the shipped
    ``*_predictor.msgpack`` files."""
    with open(path, "wb") as f:
        f.write(msgpack_io.packb(predictor_params(model)))


def load_predictor(path):
    """A ``SpeedPredictor`` from a flax-msgpack file; its architecture
    (num_feat, hidden widths) comes from the saved kernels' shapes."""
    with open(path, "rb") as f:
        return predictor_from_params(msgpack_io.unpackb(f.read()))


def convert_torch_speed_model(sd):
    """The reference ConvBlockModel's state dict (Linear layers fc1, fc2,
    fc3, fc6, fc7, fc8; weight (out, in)) → a ``SpeedPredictor``."""
    names = ("fc1", "fc2", "fc3", "fc6", "fc7", "fc8")
    params = {}
    for i, fc in enumerate(names):
        w = np.asarray(sd[f"{fc}.weight"], np.float32)
        params[f"Dense_{i}"] = {"kernel": np.ascontiguousarray(w.T), "bias": np.asarray(sd[f"{fc}.bias"], np.float32)}
    return predictor_from_params(params)


def packaged_predictor_path(name=None):
    """The packaged predictor ``<name>_predictor.msgpack`` (None → this
    machine's ``device_kind()``), or None."""
    return find_speed_file(f"{name or device_kind()}_predictor.msgpack")


class MLPSpeedEstimator:
    """Latency of one block configuration from a ``SpeedPredictor``."""

    def __init__(self, model):
        self.model = model

    def __call__(self, ch_in, ch_split, kernel):
        with torch.no_grad():
            x = torch.tensor([[ch_in, ch_split, kernel]], dtype=torch.float32)
            return float(self.model(x)[0, 0])

