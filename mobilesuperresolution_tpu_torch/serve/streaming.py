"""Streaming VSR serving: bounded-latency inference over a live frame stream
(counterpart of mobilesuperresolution_tpu/serve/streaming.py).

Streams the exact window scheme of ``parallel.temporal.chunked_vsr_apply``
(chunk + 2*overlap frames per window, central ``chunk`` outputs kept, clip
edges replicated), so the bidirectional model's need for future context is a
bounded lookahead of ``chunk + overlap - 1`` frames and memory is O(window).

Pipelining comes from CUDA's asynchronous launches: each window is enqueued
before the previous window's outputs are copied to the host, and a CUDA event
recorded after the window's work tells ``push`` whether a window is finished
without blocking on it.
"""

from collections import deque

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.core.device import resolve_device


class StreamingVSR:
    """Push frames in, get super-resolved frames out, in order.

    apply_fn: ``(lr_window, out_h, out_w) -> sr_window`` over
        (S, window, H, W, C) tensors on ``device``.
    height, width: output frame size.
    chunk: output frames emitted per window.
    overlap: context frames on each side of the kept span.
    num_streams: S lockstep input streams batched into one window.
    device: where windows run (default CUDA; raises without it unless
        ``"cpu"`` is passed).

    Pushing a clip longer than one window yields the same output as
    ``chunked_vsr_apply`` on the whole clip.
    """

    def __init__(self, apply_fn, height, width, chunk=4, overlap=4, num_streams=1, device=None):
        if chunk <= 0:
            raise ValueError("chunk must be positive")
        if overlap < 0:
            raise ValueError("overlap must be >= 0")
        if num_streams <= 0:
            raise ValueError("num_streams must be positive")
        self._apply = apply_fn
        self._hw = (height, width)
        self.device = resolve_device(device)
        self.chunk = chunk
        self.overlap = overlap
        self.num_streams = num_streams
        self.window = chunk + 2 * overlap
        self._frames = deque()  # frames[i] holds stream index self._base + i
        self._base = 0
        self._seen = 0
        self._next_start = 0  # stream index of the next window's first output
        self._inflight = None  # (output tensor, n_keep, done event or None)
        self._flushed = False

    def warmup(self, frame_shape):
        """Run the window once before the stream starts (kernel builds and
        allocator warm-up are start-up cost, not first-frame latency).
        frame_shape: (H, W, C)."""
        dummy = torch.zeros((self.num_streams, self.window, *frame_shape), device=self.device)
        self._apply(dummy, *self._hw).cpu()

    def _window_indices(self, s, last_idx):
        """Stream indices of the window whose kept outputs start at ``s``,
        clip edges replicated."""
        lo = s - self.overlap
        return np.clip(np.arange(lo, lo + self.window), 0, last_idx)

    def _to_device(self, arr):
        """A host array as a tensor on the device. From a pinned source the
        copy is queued behind the work already enqueued instead of blocking
        the host until the device catches up."""
        t = torch.from_numpy(arr)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _done_event(self):
        """A CUDA event recorded after the work enqueued so far (None on the
        CPU, where the work is already done)."""
        if self.device.type == "cpu":
            return None
        done = torch.cuda.Event()
        done.record()
        return done

    def _dispatch(self, s, last_idx):
        idx = self._window_indices(s, last_idx)
        window = self._to_device(np.stack([self._frames[i - self._base] for i in idx], axis=1))
        out = self._apply(window, *self._hw)
        return out, min(self.chunk, self._seen - s), self._done_event()

    def _ready(self):
        done = self._inflight[2]
        return done is None or done.query()

    def _harvest(self):
        out, n_keep, _ = self._inflight
        self._inflight = None
        sr = out[:, self.overlap : self.overlap + n_keep].cpu().numpy()
        if self.num_streams == 1:
            return list(sr[0])
        return list(np.swapaxes(sr, 0, 1))  # time-ordered (S, OH, OW, C)

    def _drop_consumed(self):
        keep_from = self._next_start - self.overlap
        while self._base < keep_from and self._frames:
            self._frames.popleft()
            self._base += 1

    def push(self, frame):
        """Add the next frame — (H, W, C), or (S, H, W, C) with every
        stream's frame when ``num_streams > 1``. Returns the SR frames that
        became ready (possibly none), in stream order."""
        if self._flushed:
            raise RuntimeError("push() after flush()")
        frame = np.asarray(frame)
        if self.num_streams == 1 and frame.ndim == 3:
            frame = frame[None]
        if frame.shape[0] != self.num_streams:
            raise ValueError(f"expected {self.num_streams} stream frames, got {frame.shape[0]}")
        self._frames.append(frame)
        self._seen += 1
        ready = []
        # the window for outputs [s, s+chunk) needs frames through s+chunk+overlap-1
        while self._seen >= self._next_start + self.chunk + self.overlap:
            if self._inflight is not None:
                ready.extend(self._harvest())
            self._inflight = self._dispatch(self._next_start, self._seen - 1)
            self._next_start += self.chunk
            self._drop_consumed()
        # deliver a finished window now, but never block on an unfinished one
        if self._inflight is not None and self._ready():
            ready.extend(self._harvest())
        return ready

    def flush(self):
        """End of stream: emit every remaining frame (right edge replicated,
        as in ``chunked_vsr_apply``)."""
        self._flushed = True
        ready = []
        while self._next_start < self._seen:
            if self._inflight is not None:
                ready.extend(self._harvest())
            self._inflight = self._dispatch(self._next_start, self._seen - 1)
            self._next_start += self.chunk
            self._drop_consumed()
        if self._inflight is not None:
            ready.extend(self._harvest())
        self._frames.clear()
        return ready
