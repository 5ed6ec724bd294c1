"""A tracked frame as one captured CUDA graph.

The port's own module; the JAX engine needs none.  There the per-frame
step is compiled into one XLA program (``nislam_tpu/core/slam.py``, a
jitted ``lax.scan`` with no host round trip), so a frame costs one
dispatch.  Run eagerly, the same step costs one launch per operation:
~250 for tracking alone at 480×640, which keeps the card idle most of the
frame.

:class:`CapturedStep` is the mechanism: a function over buffers at fixed
addresses that makes no host read is, on a CUDA device, captured once as
a ``torch.cuda.CUDAGraph`` and replayed for every later call; on the CPU
it runs eagerly on the same buffers, which is the plain version.

:class:`TrackGraph` is the first use of it: the device part of a tracked
frame (tracking, the keyframe decision, the frame's output when it
inserts no keyframe; the body is ``nislam_torch.core.slam``'s), with the
host keeping the one flag read per frame and the eager keyframe branch.
Its buffers:

- ``inputs``: the frame's features ``img_u`` and ``polar`` (copied in by
  :meth:`TrackGraph.run` before each replay: a chunk's length varies, its
  tail and step mode included, while these copies, two of a few MB, cost
  the card a few µs of a frame's ~500), the tracking chain (``last_fft``,
  ``last_polar``, ``last_filt``, ``last_filt_polar``, ``last_cf_pose``,
  ``last_pose``, ``distance``, ``next_frame_id``) and the bank's
  ``count``.  They are its own, or, given as ``chain``, leaves of a state
  that the caller keeps at fixed addresses
  (:class:`~nislam_torch.core.frame_graph.FrameGraph`);
- the carry: the body returns new values for some inputs
  (``distance``, ``next_frame_id``), written back in place, as
  ``lax.scan`` carries its state from one step to the next;
- ``outputs``: what the body returns besides, written into buffers that
  are made at its first run.

With its own buffers, the caller's state stays the single source of
truth: :meth:`TrackGraph.load` copies it into the inputs wherever a step
or a solve replaced a leaf, and the caller copies the carry back after
each run.

Capture, at the first run on a card: the step runs once on the capture
stream (that loads the kernels, makes the cuFFT plans and the stream's
cuBLAS and ``peak_stats`` workspaces, and computes this call), then the
same step is captured on that stream.  A failed capture raises; nothing
falls back to eager launches.  The counted kernel wrappers
(``peak_stats``, ``stitch_raster``, ``index_add_ordered``) count Python
calls, which a replay does not make, so each replay adds the calls that
its capture counted; so do the counters registered here
(:func:`register_counts`: the ``all_reduce`` kernel's launches and the
rank groups' collectives by payload, ``RankGroup.counts``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import weakref
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from nislam_torch.kernels.launch import workspace
from nislam_torch.ops.all_reduce import all_reduce
from nislam_torch.ops.peak_stats import peak_stats
from nislam_torch.ops.scatter_add import index_add_ordered
from nislam_torch.ops.stitch_raster import stitch_raster

# The tracking chain's leaves in ``SlamState.track`` that the body reads.
CHAIN = ("last_fft", "last_polar", "last_filt", "last_filt_polar", "last_cf_pose", "last_pose",
         "distance", "next_frame_id")

# The kernel wrappers whose ``launches`` count Python calls.
COUNTED = (peak_stats, stitch_raster, index_add_ordered)

# Counters alive that captured graphs count per replay, by id: the
# ``all_reduce`` kernel's launches and the rank groups' collectives by
# payload (parallel/mesh.py).
_registered: "weakref.WeakValueDictionary[int, collections.Counter]" = weakref.WeakValueDictionary()


def register_counts(counts: collections.Counter) -> None:
    """Count ``counts`` through captured graphs: what a capture adds is
    put back, and each replay adds it."""
    _registered[id(counts)] = counts


register_counts(all_reduce.counts)

Body = Callable[[SimpleNamespace], Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]


@contextlib.contextmanager
def no_collection() -> Iterator[None]:
    """No cyclic garbage collection in the block: a stream capture's.  A
    collection there may free an earlier CUDA graph held in a reference
    cycle, and destroying a graph is a call that a capturing thread may not
    make: the capture fails."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _counts() -> tuple:
    """The counted wrappers' launches, ``peak_stats``'s by shape, and a
    copy of every registered counter, by id."""
    registered = {key: collections.Counter(c) for key, c in list(_registered.items())}
    return tuple(w.launches for w in COUNTED), collections.Counter(peak_stats.shapes), registered


def _set_counts(counts: tuple, k: int = 0, delta: Optional[dict] = None) -> None:
    """Put ``counts`` back, the registered counters still alive with
    ``k`` times ``delta`` (by the same ids) added."""
    launches, shapes, registered = counts
    for w, n in zip(COUNTED, launches):
        w.launches = n
    peak_stats.shapes.clear()
    peak_stats.shapes.update(shapes)
    for key, value in registered.items():
        c = _registered.get(key)
        if c is None:
            continue
        c.clear()
        c.update(value)
        if delta is not None:
            c.update({op: k * n for op, n in delta.get(key, {}).items()})


class CapturedStep:
    """``step()``, a function over fixed buffers that reads nothing back to
    the host: run eagerly on the CPU; on a card run once on ``stream`` (a
    new stream when None) and captured there at its first call, replayed
    at every later one.  ``pool`` (``torch.cuda.graph_pool_handle()``)
    shares one memory pool between steps that run one at a time and keep
    no tensor of their own past a run.  The captured graph is kept
    (:meth:`raw_graph`) for a graph that nests it; this object keeps its
    memory pool and workspace alive."""

    # CUDA graphs captured in this process, by every instance.
    captures = 0

    def __init__(self, device: torch.device, step: Callable[[], None],
                 stream: Optional[torch.cuda.Stream] = None, pool=None):
        self.device = device
        self._step = step
        self._stream = stream
        self._pool = pool  # a graph memory pool shared with other steps (None: its own)
        self._graph = None
        # What the graph holds on to: the capture stream's peak_stats
        # workspace (the ticket counters it was captured with).
        self._workspace = None
        self._launches = ((0,) * len(COUNTED), collections.Counter())  # calls in one replay
        self._collectives = {}  # what one replay adds to the registered counters, by id
        self.replays = 0  # replays through run()

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def run(self) -> None:
        """One call: eager on the CPU, the capture at the first call on a
        card, a replay after it."""
        if self.device.type != "cuda":
            self._step()
        elif self._graph is None:
            self._capture()
        else:
            self._graph.replay()
            self.count_replays(1)
            self.replays += 1

    def count_replays(self, k: int) -> None:
        """Add the counted wrappers' calls of ``k`` replays: those of
        :meth:`run`'s, and of a graph that nests this one
        (:class:`~nislam_torch.core.chunk_graph.ChunkGraph`)."""
        (launches, shapes, registered), (calls, more) = _counts(), self._launches
        _set_counts((tuple(a + k * b for a, b in zip(launches, calls)),
                     shapes + collections.Counter({s: k * c for s, c in more.items()}), registered), k,
                    self._collectives)

    def raw_graph(self) -> int:
        """The captured ``cudaGraph_t``, for a graph that nests it; valid
        while this step lives."""
        if self._graph is None:
            raise RuntimeError("the step has not been captured")
        return self._graph.raw_cuda_graph()

    def _capture(self) -> None:
        """The first call on the card: the step once on the capture stream,
        which computes this call, then its capture on the same stream.
        Other threads may go on calling CUDA meanwhile (a reader pinning
        the next chunk): only this thread's calls are checked."""
        with torch.cuda.device(self.device):
            stream = self._stream if self._stream is not None else torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                self._step()
            ws = workspace.get(self.device, stream.cuda_stream, 0)
            # Kept after its instantiation: a chunk graph nests it.
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = _counts()
            with no_collection(), torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                                   capture_error_mode="thread_local"):
                self._step()
            after = _counts()
            graph.instantiate()
            # The capture launched nothing: put the counts back.
            _set_counts(before)
            torch.cuda.current_stream().wait_stream(stream)
        self._launches = (tuple(b - a for a, b in zip(before[0], after[0])), after[1] - before[1])
        self._collectives = {key: after[2][key] - c for key, c in before[2].items() if key in after[2]}
        self._graph, self._stream, self._workspace = graph, stream, ws
        CapturedStep.captures += 1


class TrackGraph:
    """The device part of a tracked frame over fixed buffers: captured and
    replayed on a card, run eagerly on the CPU.  ``body(inputs) → (carry,
    outputs)``: ``carry`` maps input names to their new values.
    ``chain``, when given, supplies the tracking chain and ``bank_count``
    inputs (a namespace of the caller's fixed tensors, shaped as the own
    ones would be, or with leading lane axes, those of ``bank_count``,
    which the feature inputs then get too); ``stream`` is the capture
    stream (None: a new one)."""

    def __init__(self, config, device: torch.device, body: Body, chain: Optional[SimpleNamespace] = None,
                 stream: Optional[torch.cuda.Stream] = None):
        cf = config.cf
        spec = (cf.height, cf.width // 2 + 1)
        pspec = (cf.polar_shape[0], cf.polar_shape[1] // 2 + 1)

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        # A batched chain (the batch engine's) gives the inputs its lane axes.
        lanes = () if chain is None else tuple(chain.bank_count.shape)
        self.inputs = SimpleNamespace(img_u=zeros(lanes + (cf.height, cf.width)),
                                      polar=zeros(lanes + pspec, torch.complex64))
        if chain is None:
            chain = SimpleNamespace(
                last_fft=zeros(spec + (2,)), last_polar=zeros(pspec + (2,)),
                last_filt=zeros(spec + (2,)), last_filt_polar=zeros(pspec + (2,)),
                last_cf_pose=zeros(3), last_pose=zeros(3), distance=zeros(()),
                next_frame_id=zeros((), torch.int32), bank_count=zeros((), torch.int32),
            )
        for name in CHAIN + ("bank_count",):
            setattr(self.inputs, name, getattr(chain, name))
        self.device = self.inputs.img_u.device  # with its index: the workspace's key
        # The step holds no reference to this object: an engine that is
        # dropped frees its graphs and buffers at once, with no cycle left
        # for the garbage collector.
        self._io = SimpleNamespace(outputs=None)
        self._step = CapturedStep(self.device, functools.partial(_run_body, body, self.inputs, self._io), stream)

    @property
    def captured(self) -> bool:
        return self._step.captured

    @property
    def step(self) -> CapturedStep:
        """The captured step: the body over the inputs, without the
        feature copies of :meth:`run`."""
        return self._step

    @property
    def outputs(self) -> Optional[SimpleNamespace]:
        """What the body returns besides the carry, made at the first run."""
        return self._io.outputs

    def load(self, state) -> None:
        """Copy ``state``'s tracking chain and bank count into the inputs."""
        for name in CHAIN:
            getattr(self.inputs, name).copy_(getattr(state.track, name))
        self.inputs.bank_count.copy_(state.bank.count)

    def run(self, img_u: torch.Tensor, polar: torch.Tensor) -> SimpleNamespace:
        """One frame (features ``img_u`` (..., H, W) and ``polar`` (...,
        D, C//2+1), the chain's lane axes first) → ``outputs``, overwritten
        by the next run; the carry is in ``inputs``.  Makes no host read."""
        self.inputs.img_u.copy_(img_u)
        self.inputs.polar.copy_(polar)
        self._step.run()
        return self.outputs


def _run_body(body: Body, inputs: SimpleNamespace, io: SimpleNamespace) -> None:
    """:class:`TrackGraph`'s step: the body, its carry written back into
    ``inputs``, its outputs into ``io.outputs`` (made at the first run)."""
    carry, outs = body(inputs)
    for name, value in carry.items():
        getattr(inputs, name).copy_(value)
    if io.outputs is None:
        io.outputs = SimpleNamespace(**{k: torch.empty_like(v) for k, v in outs.items()})
    for name, value in outs.items():
        getattr(io.outputs, name).copy_(value)
