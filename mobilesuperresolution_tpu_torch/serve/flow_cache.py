"""Flow-reuse streaming VSR: overlapping windows share SpyNet pair flows
(counterpart of mobilesuperresolution_tpu/serve/flow_cache.py).

Consecutive windows share ``window - chunk`` frames, and a pair flow depends
only on the pair's two frames and the SpyNet weights. The plain stream runs
SpyNet on every pair of every window (9 pairs, both directions, per 4
emitted frames at chunk 4 and overlap 3); this one computes each pair once,
keeps its flows on the device, and hands the window's flows to the model
(``BasicVSR.forward(..., flows=)``), which then skips SpyNet.

Pair flows are computed in groups of ``chunk`` pairs x 2 directions x S
streams, a short group padded by repeating its last pair, so every SpyNet
call has one batch shape. The batch is laid out as ``compute_flows`` lays
out its own: ``[a|b]`` against ``[b|a]``, whose first half gives backward
flows and second half forward flows. A pair's flows are the same values
whichever window computes them, but SpyNet then sees 2·chunk·S samples, not
2·(window-1)·S, so the output matches ``chunked_vsr_apply`` to float
tolerance, not bit for bit.

Every launch goes on the current CUDA stream: a group's flows queue ahead of
the window that reads them, so the window's readiness event covers both.
"""

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.models.spynet import flow_downscale_hw, upsample_flow
from mobilesuperresolution_tpu_torch.ops.resize import resize_bilinear
from mobilesuperresolution_tpu_torch.parallel.mesh import map_groups
from mobilesuperresolution_tpu_torch.parallel.vsr_spatial import spatial_basicvsr_forward
from mobilesuperresolution_tpu_torch.serve.streaming import StreamingVSR


def make_flow_sr_fns(model, height, width, mesh=None, max_disp=8):
    """Split a BasicVSR ('basic' or 'basic_origin') into (flow_fn, sr_fn) for
    flow reuse. 'basic_mv' takes its flows from the bitstream and has no
    SpyNet, so it is refused, as are the models without this split.

    flow_fn(ref, supp): (N, H, W, C) pair frames → (N, H, W, 2) flows at
        input resolution, as ``compute_flows`` computes them for those pair
        slots (the compute dtype, the ``flow_downscale`` staging).
    sr_fn(x, ff, fb): (S, T, H, W, C) window and time-major flows (T-1, S,
        H, W, 2) → (S, T, height, width, C), the model with SpyNet skipped.

    A quantized model's SpyNet is quantized too, so flow_fn runs int8
    convs (kernel Q1), as the JAX package's ``SpyNet(quantized=...)``.

    mesh: height-shard the window (``serve --flow_cache --spatial_shards``):
    sr_fn runs ``parallel.vsr_spatial.spatial_basicvsr_forward`` on the
    cached flows (its dy clip to ``max_disp`` applies), its streams split
    over the mesh's data groups when their number D divides them
    (``Mesh.map_groups``); flow_fn splits its pair batch over the groups
    when D divides it (each pair's flow is its own sample's), one SpyNet
    call on each group's card."""
    if not hasattr(model, "spynet"):
        raise ValueError(f"flow reuse needs a SpyNet-based model (BasicVSR family); got {type(model).__name__}, "
                         "which has no spynet")
    d, dtype = model.flow_downscale, model.compute_dtype

    def flows(spynet, ref, supp):
        h, w = ref.shape[1:3]
        ref, supp = ref.to(dtype), supp.to(dtype)
        fh, fw = flow_downscale_hw(h, w, d)
        if (fh, fw) != (h, w):
            ref, supp = resize_bilinear(ref, (fh, fw)), resize_bilinear(supp, (fh, fw))
        return upsample_flow(spynet(ref, supp), h, w)

    def group_flows(_, spynet, ref, supp):
        return flows(spynet, ref, supp)

    def group_sr(group, m, x, ff, fb):
        return spatial_basicvsr_forward(m, x, height, width, group, max_disp=max_disp, flows=(ff, fb))

    def flow_fn(ref, supp):
        with torch.inference_mode():
            if mesh is not None:
                return map_groups(mesh, group_flows, model.spynet, (ref, 0), (supp, 0))
            return flows(model.spynet, ref, supp)

    def sr_fn(x, ff, fb):
        with torch.inference_mode():
            if mesh is not None:
                return map_groups(mesh, group_sr, model, (x, 0), (ff, 1), (fb, 1))
            return model(x, height, width, flows=(ff, fb))

    return flow_fn, sr_fn


class FlowCachedStreamingVSR(StreamingVSR):
    """StreamingVSR that computes each pair flow once, not once per window.

    Same push()/flush() contract, order, lookahead and pipelining as
    StreamingVSR; make the two functions with ``make_flow_sr_fns``. The cache
    holds the device flows of every pair whose first frame can still appear
    in a later window, and is evicted in step with the frame buffer."""

    def __init__(self, flow_fn, sr_fn, height, width, chunk=4, overlap=4, num_streams=1, device=None):
        super().__init__(None, height, width, chunk=chunk, overlap=overlap, num_streams=num_streams, device=device)
        self._flow = flow_fn
        self._sr = sr_fn
        # (i, j) stream frame-index pair (j = i + 1, or j = i at a clamped
        # clip edge) → (ff, fb) on the device, each (S, H, W, 2)
        self._pair_flows = {}

    def warmup(self, frame_shape):
        """Run both functions once before the stream starts. frame_shape:
        (H, W, C)."""
        s, h, w = self.num_streams, frame_shape[0], frame_shape[1]
        pair = torch.zeros((2 * self.chunk * s, *frame_shape), device=self.device)
        self._flow(pair, pair)
        x = torch.zeros((s, self.window, *frame_shape), device=self.device)
        f = torch.zeros((self.window - 1, s, h, w, 2), device=self.device)
        self._sr(x, f, f).cpu()

    def _frame(self, i):
        return self._frames[i - self._base]

    def _ensure_flows(self, pairs):
        missing = list(dict.fromkeys(k for k in pairs if k not in self._pair_flows))
        s, p = self.num_streams, self.chunk
        for g in range(0, len(missing), p):
            group = missing[g : g + p]
            padded = group + [group[-1]] * (p - len(group))
            a = np.concatenate([self._frame(i) for i, _ in padded])
            b = np.concatenate([self._frame(j) for _, j in padded])
            ab = self._to_device(np.concatenate([a, b]))
            half = p * s
            # first half: ref = the earlier frame (backward flows); second
            # half: ref = the later frame (forward flows)
            out = self._flow(ab, torch.cat([ab[half:], ab[:half]]))
            for k, key in enumerate(group):
                self._pair_flows[key] = (out[half + k * s : half + (k + 1) * s], out[k * s : (k + 1) * s])

    def _dispatch(self, s, last_idx):
        idx = self._window_indices(s, last_idx)
        pairs = [(int(idx[j]), int(idx[j + 1])) for j in range(len(idx) - 1)]
        self._ensure_flows(pairs)
        with torch.inference_mode():
            ff = torch.stack([self._pair_flows[k][0] for k in pairs])
            fb = torch.stack([self._pair_flows[k][1] for k in pairs])
        window = self._to_device(np.stack([self._frame(i) for i in idx], axis=1))
        out = self._sr(window, ff, fb)
        return out, min(self.chunk, self._seen - s), self._done_event()

    def _drop_consumed(self):
        super()._drop_consumed()
        keep_from = self._next_start - self.overlap
        for key in [k for k in self._pair_flows if k[0] < keep_from]:
            del self._pair_flows[key]

    def flush(self):
        out = super().flush()
        self._pair_flows.clear()
        return out
