"""The check that decides ``correct`` catches a broken timed path: each fault a
cell can have is planted in the port underneath the harness, the rest of a
run is driven as on the card (on the CPU, at a tiny size, without the
harness's look for a card), and ``correct`` must come out false. The sound
run beside them must come out true."""

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cells

CPU = torch.device("cpu")
SEED = 2**31 + 1234
TINY_SERVE = {"streams": 2, "lr_hw": [32, 48], "out_hw": [136, 200], "clip_frames": 7, "check_windows": 2}
TINY_TRAIN = {"frames": 3, "lr_hw": [16, 16], "pool_batches": 4}
SERVE = "serve.basicvsr_mobile.s4_cached"
TRAIN = "train.basicvsr_mobile.b2t10p64"


def _serve(**override):
    return cells.run_driver(SERVE, SEED, 0.5, CPU, traffic_override=dict(TINY_SERVE, **override))


def _train():
    return cells.run_driver(TRAIN, SEED, 0.3, CPU, traffic_override=TINY_TRAIN)


def test_sound_runs_are_correct():
    assert cells.is_correct(_serve())
    assert cells.is_correct(_train())


def _answer_altered(monkeypatch):
    """An output tile never written: the first frame of every window comes
    back with a 64x64 block of zeros."""
    from mobilesuperresolution_tpu_torch.serve.streaming import StreamingVSR

    harvest = StreamingVSR._harvest

    def broken(self):
        frames = harvest(self)
        first = np.array(frames[0])
        first[..., :64, :64, :] = 0.0
        return [first] + frames[1:]

    monkeypatch.setattr(StreamingVSR, "_harvest", broken)


def _window_shifted(monkeypatch):
    """The window scheme's kept span off by one: each window hands back the
    frames one step before its central ``chunk``."""
    from mobilesuperresolution_tpu_torch.serve.streaming import StreamingVSR

    def broken(self):
        out, n_keep, _ = self._inflight
        self._inflight = None
        sr = out[:, self.overlap - 1: self.overlap - 1 + n_keep].cpu().numpy()
        return list(sr[0]) if self.num_streams == 1 else list(np.swapaxes(sr, 0, 1))

    monkeypatch.setattr(StreamingVSR, "_harvest", broken)


def _state_unchanged(monkeypatch):
    """The recurrence returns its carry unchanged: every step hands the
    (warped) previous features on without running the trunks."""
    from mobilesuperresolution_tpu_torch.models import basicvsr
    from mobilesuperresolution_tpu_torch.ops.warp import flow_warp

    monkeypatch.setattr(basicvsr._MergedPropagation, "forward",
                        lambda self, feat, x_i, flow: flow_warp(feat, flow, padding_mode="zeros"))


def _half_batch(monkeypatch):
    """Half of the streams left out: the first half is computed and stands
    in for the rest."""
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSRBase

    forward = BasicVSRBase.forward

    def broken(self, x, height=1080, width=1920, flows=None):
        half = max(x.shape[0] // 2, 1)
        if flows is not None:
            flows = tuple(f[:, :half] for f in flows)
        out = forward(self, x[:half], height, width, flows)
        return torch.cat([out] * (x.shape[0] // half), 0)

    monkeypatch.setattr(BasicVSRBase, "forward", broken)


def _subpixels_permuted(monkeypatch):
    """B2's sub-pixel order wrong: inside every s x s block of the shuffled
    output the sub-pixels are transposed, so each block keeps its mean."""
    from mobilesuperresolution_tpu_torch.ops import layers

    fused = layers.fused_conv_pixel_shuffle

    def broken(x, kernel, bias, scale, *args, **kwargs):
        y = fused(x, kernel, bias, scale, *args, **kwargs)
        b, h, w, c = y.shape
        hs, ws = h - h % scale, w - w % scale
        blocks = y[:, :hs, :ws].reshape(b, hs // scale, scale, ws // scale, scale, c)
        y = y.clone()
        y[:, :hs, :ws] = blocks.transpose(2, 4).reshape(b, hs, ws, c)
        return y

    monkeypatch.setattr(layers, "fused_conv_pixel_shuffle", broken)


@pytest.mark.parametrize("plant", [_answer_altered, _window_shifted, _state_unchanged, _half_batch,
                                   _subpixels_permuted],
                         ids=["answer_altered", "window_shifted", "state_unchanged", "half_batch",
                              "subpixels_permuted"])
def test_serving_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    assert not cells.is_correct(_serve())


def _step_skipped(monkeypatch):
    """The optimizer's step returns the state unchanged (it only counts)."""
    from mobilesuperresolution_tpu_torch.train.state import MultiStepAdam

    def broken(self):
        self.applied += 1

    monkeypatch.setattr(MultiStepAdam, "step", broken)


def _loss_half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from mobilesuperresolution_tpu_torch.train import steps

    loss = steps.charbonnier_loss
    monkeypatch.setattr(steps, "charbonnier_loss", lambda sr, hr: loss(sr[: len(sr) // 2], hr[: len(hr) // 2]))


def _loss_altered(monkeypatch):
    """The loss altered where it is produced (its eps outside the square
    root)."""
    from mobilesuperresolution_tpu_torch.train import steps

    monkeypatch.setattr(steps, "charbonnier_loss", lambda sr, hr: torch.mean(torch.sqrt((sr - hr) ** 2) + 1e-3))


@pytest.mark.parametrize("plant", [_step_skipped, _loss_half_batch, _loss_altered],
                         ids=["state_unchanged", "half_batch", "loss_altered"])
def test_training_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    assert not cells.is_correct(_train())
