"""The one traffic generator: a mix's parameters → the sequences a run drives.

A mix (``benchmarks/traffic/<name>.json``) fixes the work: frames per
sequence, the chunk, the world's side, the texture's blur, the step per
frame in world pixels, the sensor noise and drift, and ``world_seeds``,
one per distinct sequence, from which its world, start point and noise
are drawn on the device with a ``torch.Generator`` in a few large calls.
The engine's work follows the content (keyframes, loops found, solves
and their iterations), so the content is the mix's and not the run's:
``--seed`` sets the order in which the run cycles the sequences, and so
which of them the output check samples.  Every seed runs the same work.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from benchmarks.harness import synth


@dataclasses.dataclass
class Sequences:
    frames: torch.Tensor  # (S, N, H, W) float32 in [0, 1], on the device
    order: list  # the distinct sequences in the order the run cycles them
    chunk: int

    @property
    def distinct(self) -> int:
        return self.frames.shape[0]

    @property
    def length(self) -> int:
        return self.frames.shape[1]

    @property
    def chunks(self) -> int:
        return self.length // self.chunk


def sequence_seed(seed: int, index: int) -> int:
    """A 63-bit seed for distinct sequence ``index`` of run seed ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def check_mix(mix: dict) -> None:
    if mix["frames_per_sequence"] % mix["chunk"]:
        raise ValueError(f"traffic {mix['name']}: {mix['frames_per_sequence']} frames are not whole chunks "
                         f"of {mix['chunk']}")


def make_sequences(mix: dict, height: int, width: int, seed: int, device, world_seeds=None) -> Sequences:
    """The mix's distinct sequences at an (height, width) camera, cycled in
    the order that ``seed`` draws; ``world_seeds`` (None: the mix's) sets
    other content, as the output check's calibration does."""
    check_mix(mix)
    device = torch.device(device)
    world_seeds = mix["world_seeds"] if world_seeds is None else world_seeds
    n, world_n = mix["frames_per_sequence"], mix["world"]
    frames = torch.empty((len(world_seeds), n, height, width), dtype=torch.float32, device=device)
    for j, world_seed in enumerate(world_seeds):
        g = torch.Generator(device=device)
        g.manual_seed(int(world_seed))
        noise = torch.randn((world_n, world_n), generator=g, device=device)
        world = synth.blur_world(noise, mix["texture_sigma"])
        del noise
        start = (torch.rand(2, generator=g, device=device, dtype=torch.float64) * world_n).tolist()
        path = torch.tensor(synth.heading_loop_path(n, mix["step_px"], tuple(start)), dtype=torch.float64)
        views = synth.render(world, height, width, path)
        del world
        grain = torch.randn(views.shape, generator=g, device=device)
        frames[j] = synth.sensor_noise(views, grain, mix["noise_sigma"], mix["illum_drift"])
        del views, grain
    order = np.random.default_rng(int(seed)).permutation(len(world_seeds)).tolist()
    return Sequences(frames=frames, order=order, chunk=mix["chunk"])
