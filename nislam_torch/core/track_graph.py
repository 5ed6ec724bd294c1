"""A tracked frame as one captured CUDA graph.

The port's own module; the JAX engine needs none.  There the per-frame
step is compiled into one XLA program (``nislam_tpu/core/slam.py``, a
jitted ``lax.scan`` with no host round trip), so a frame costs one
dispatch.  Run eagerly, the same step costs one launch per operation:
~250 for tracking alone at 480×640, which keeps the card idle most of the
frame.  On a CUDA device :class:`TrackGraph` captures the device part of
a tracked frame once, as a ``torch.cuda.CUDAGraph``, and replays it for
every tracked frame; on the CPU it runs the same body eagerly on the same
buffers, which is the plain version.  The body itself (tracking, the
keyframe decision, the frame's output when it inserts no keyframe) is
``nislam_torch.core.slam``'s; the host keeps the one flag read per frame
and the eager keyframe branch.

The body reads and writes only buffers at fixed addresses that this
object owns:

- ``inputs``: the frame's features ``img_u`` and ``polar`` (copied in by
  :meth:`TrackGraph.run` before each replay: a chunk's length varies, its
  tail and step mode included, while these copies, two of a few MB, cost
  the card a few µs of a frame's ~380), the tracking chain (``last_fft``,
  ``last_polar``, ``last_filt``, ``last_filt_polar``, ``last_cf_pose``,
  ``last_pose``, ``distance``, ``next_frame_id``) and the bank's ``count``;
- the carry: the body returns new values for some inputs
  (``distance``, ``next_frame_id``), written back in place, as
  ``lax.scan`` carries its state from one step to the next;
- ``outputs``: what the body returns besides, written into buffers that
  are made at its first run.

The caller's state stays the single source of truth: :meth:`load` copies
it into the inputs wherever a step or a solve replaced a leaf, and the
caller copies the carry back after each run.

Capture, at the first run on a card: the body runs once on the capture
stream (that loads the ``peak_stats`` kernel, makes the cuFFT plans and
the stream's cuBLAS and kernel workspaces, and computes the frame), then
the same body is captured on that stream.  A failed capture raises;
nothing falls back to eager launches.  ``peak_stats.launches`` counts
Python calls of its wrapper, which a replay does not make, so each replay
adds the launches that the capture counted.
"""

from __future__ import annotations

import collections
from types import SimpleNamespace
from typing import Callable, Dict, Tuple

import torch

from nislam_torch.kernels.launch import workspace
from nislam_torch.ops.peak_stats import peak_stats

# The tracking chain's leaves in ``SlamState.track`` that the body reads.
CHAIN = ("last_fft", "last_polar", "last_filt", "last_filt_polar", "last_cf_pose", "last_pose",
         "distance", "next_frame_id")

Body = Callable[[SimpleNamespace], Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]


class TrackGraph:
    """The device part of a tracked frame over fixed buffers: captured and
    replayed on a card, run eagerly on the CPU.  ``body(inputs) → (carry,
    outputs)``: ``carry`` maps input names to their new values."""

    # CUDA graphs captured in this process, by every instance.
    captures = 0

    def __init__(self, config, device: torch.device, body: Body):
        cf = config.cf
        spec = (cf.height, cf.width // 2 + 1)
        pspec = (cf.polar_shape[0], cf.polar_shape[1] // 2 + 1)

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.inputs = SimpleNamespace(
            img_u=zeros((cf.height, cf.width)), polar=zeros(pspec, torch.complex64),
            last_fft=zeros(spec + (2,)), last_polar=zeros(pspec + (2,)),
            last_filt=zeros(spec + (2,)), last_filt_polar=zeros(pspec + (2,)),
            last_cf_pose=zeros(3), last_pose=zeros(3), distance=zeros(()),
            next_frame_id=zeros((), torch.int32), bank_count=zeros((), torch.int32),
        )
        self.device = self.inputs.img_u.device  # with its index: the workspace's key
        self.outputs = None
        self._body = body
        self._graph = None
        # What the graph holds on to: its capture stream and that stream's
        # peak_stats workspace (the ticket counters it was captured with).
        self._stream = None
        self._workspace = None
        self._launches = (0, collections.Counter())  # peak_stats calls in one replay

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def load(self, state) -> None:
        """Copy ``state``'s tracking chain and bank count into the inputs."""
        for name in CHAIN:
            getattr(self.inputs, name).copy_(getattr(state.track, name))
        self.inputs.bank_count.copy_(state.bank.count)

    def run(self, img_u: torch.Tensor, polar: torch.Tensor) -> SimpleNamespace:
        """One frame (features ``img_u`` (H, W) and ``polar`` (D, C//2+1))
        → ``outputs``, overwritten by the next run; the carry is in
        ``inputs``.  Makes no host read."""
        self.inputs.img_u.copy_(img_u)
        self.inputs.polar.copy_(polar)
        if self.device.type != "cuda":
            self._step()
        elif self._graph is None:
            self._capture()
        else:
            self._graph.replay()
            calls, shapes = self._launches
            peak_stats.launches += calls
            peak_stats.shapes.update(shapes)
        return self.outputs

    def _step(self) -> None:
        carry, outs = self._body(self.inputs)
        for name, value in carry.items():
            getattr(self.inputs, name).copy_(value)
        if self.outputs is None:
            self.outputs = SimpleNamespace(**{k: torch.empty_like(v) for k, v in outs.items()})
        for name, value in outs.items():
            getattr(self.outputs, name).copy_(value)

    def _capture(self) -> None:
        """The first run on the card: the body once on the capture stream,
        which computes this frame, then its capture on the same stream.
        Other threads may go on calling CUDA meanwhile (a reader pinning
        the next chunk): only this thread's calls are checked."""
        with torch.cuda.device(self.device):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                self._step()
            ws = workspace.get(self.device, stream.cuda_stream, 0)
            graph = torch.cuda.CUDAGraph()
            calls, shapes = peak_stats.launches, collections.Counter(peak_stats.shapes)
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                self._step()
            counted = (peak_stats.launches - calls, peak_stats.shapes - shapes)
            # The capture launched nothing: put the counts back.
            peak_stats.launches = calls
            peak_stats.shapes.clear()
            peak_stats.shapes.update(shapes)
            torch.cuda.current_stream().wait_stream(stream)
        self._graph, self._stream, self._workspace, self._launches = graph, stream, ws, counted
        TrackGraph.captures += 1
