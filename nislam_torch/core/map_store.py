"""Fixed-capacity keyframe bank and edge store on the device.

Counterpart of ``nislam_tpu.core.map_store``: dense preallocated tensors
with an integer cursor; the grid cell is captured at insertion (C
truncation toward zero); slot 0 is the optimizer's pinned base; ring
eviction spares slot 0 and the current tracking target.

Change of idiom: JAX arrays are immutable, so the JAX package returns new
stores.  Here :func:`add_keyframe`, :func:`add_edge` and
:func:`invalidate_edges` update the stores IN PLACE (one slot written with
a device-side index, no host sync) and return them.  A disabled write
rewrites the slot with its own old value.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from nislam_torch.ops.fft import c2r

EDGE_NONE = 0
EDGE_KCC = 1
EDGE_LOOP = 2


@dataclasses.dataclass
class KeyframeBank:
    fft: torch.Tensor  # (K, H, W//2+1, 2) image spectra (f32 or bf16 pairs)
    polar_fft: torch.Tensor  # (K, D, C//2+1, 2) polar spectra
    filt: torch.Tensor  # (K, H, W//2+1, 2) cached filters, or (K, 0, 0, 2)
    filt_polar: torch.Tensor  # (K, D, C//2+1, 2) or (K, 0, 0, 2)
    images: torch.Tensor  # (K, H, W) f32, or (K, 0, 0)
    poses: torch.Tensor  # (K, 3) f32 robot frame
    grid_xy: torch.Tensor  # (K, 2) i32 cell at insertion
    frame_ids: torch.Tensor  # (K,) i32
    distances: torch.Tensor  # (K,) f32 travel distance
    count: torch.Tensor  # () i32 live slots
    overflow: torch.Tensor  # () i32 evictions (ring) / drops (drop)
    evict_cursor: torch.Tensor  # () i32 ring position over slots 1..K-1

    @property
    def capacity(self) -> int:
        return self.fft.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.count.device) < self.count


@dataclasses.dataclass
class EdgeStore:
    from_slot: torch.Tensor  # (E,) i32
    to_slot: torch.Tensor  # (E,) i32
    T: torch.Tensor  # (E, 3) f32 camera-frame relative pose
    info: torch.Tensor  # (E, 3, 3) f32 information matrix
    types: torch.Tensor  # (E,) i32 EDGE_KCC / EDGE_LOOP
    alive: torch.Tensor  # (E,) bool
    count: torch.Tensor  # () i32 high-water mark of used slots
    overflow: torch.Tensor  # () i32 forced replacements / drops

    @property
    def capacity(self) -> int:
        return self.from_slot.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return self.alive


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def make_keyframe_bank(cf, map_cfg, device: torch.device) -> KeyframeBank:
    k = map_cfg.keyframe_capacity
    h, w = cf.height, cf.width
    d, c = cf.polar_shape
    if map_cfg.bank_dtype not in ("f32", "bf16"):
        raise ValueError(f"invalid bank_dtype {map_cfg.bank_dtype!r}")
    sdt = torch.bfloat16 if map_cfg.bank_dtype == "bf16" else torch.float32
    img_shape = (k, h, w) if map_cfg.store_images else (k, 0, 0)
    fshape = (k, h, w // 2 + 1, 2) if map_cfg.cache_filters else (k, 0, 0, 2)
    fpshape = (k, d, c // 2 + 1, 2) if map_cfg.cache_filters else (k, 0, 0, 2)
    i32, f32 = torch.int32, torch.float32
    return KeyframeBank(
        fft=_zeros((k, h, w // 2 + 1, 2), sdt, device),
        polar_fft=_zeros((k, d, c // 2 + 1, 2), sdt, device),
        filt=_zeros(fshape, sdt, device),
        filt_polar=_zeros(fpshape, sdt, device),
        images=_zeros(img_shape, f32, device),
        poses=_zeros((k, 3), f32, device),
        grid_xy=_zeros((k, 2), i32, device),
        frame_ids=torch.full((k,), -1, dtype=i32, device=device),
        distances=_zeros((k,), f32, device),
        count=_zeros((), i32, device),
        overflow=_zeros((), i32, device),
        evict_cursor=_zeros((), i32, device),
    )


def make_edge_store(map_cfg, device: torch.device) -> EdgeStore:
    e = map_cfg.edge_capacity
    i32 = torch.int32
    return EdgeStore(
        from_slot=_zeros((e,), i32, device),
        to_slot=_zeros((e,), i32, device),
        T=_zeros((e, 3), torch.float32, device),
        info=_zeros((e, 3, 3), torch.float32, device),
        types=_zeros((e,), i32, device),
        alive=_zeros((e,), torch.bool, device),
        count=_zeros((), i32, device),
        overflow=_zeros((), i32, device),
    )


def grid_location(xy: torch.Tensor, grid_scale: float) -> torch.Tensor:
    """Spatial-hash cell of a robot-frame position (truncation toward zero)."""
    return torch.trunc(xy / grid_scale).to(torch.int32)


def write_slot(buf: torch.Tensor, slot: torch.Tensor, val, do: torch.Tensor) -> None:
    """In place: ``buf[slot] = val`` if ``do`` else unchanged (device-side
    index and predicate, no host sync)."""
    val = torch.as_tensor(val, device=buf.device).to(buf.dtype)
    i = slot.reshape(1).long()
    buf.index_copy_(0, i, torch.where(do, val, buf.index_select(0, i)))


class InsertResult(NamedTuple):
    bank: KeyframeBank
    slot: torch.Tensor  # () i32 slot written (or would-be slot if not stored)
    stored: torch.Tensor  # () bool
    evicted: torch.Tensor  # () i32 slot whose old record was evicted, else -1


def add_keyframe(
    bank: KeyframeBank, *, fft, polar_fft, filt=None, filt_polar=None, image,
    pose, frame_id, distance, grid_scale: float, enabled, evict: bool = True,
    protect_slot=None,
) -> InsertResult:
    """Masked insert of one keyframe, in place.  Full bank: with ``evict``
    the oldest non-base ring slot (skipping ``protect_slot``) is reused and
    reported in ``evicted``; without it the record is dropped.  Spectra may
    be complex or float pairs; omitted filters leave the slot's filters
    untouched."""

    def as_pair(x):
        return c2r(x) if x is not None and torch.is_complex(x) else x

    dev = bank.count.device
    enabled = torch.as_tensor(enabled, dtype=torch.bool, device=dev)
    k = bank.capacity
    fits = bank.count < k
    cursor = bank.evict_cursor
    if evict and k > 2:
        victim = 1 + torch.remainder(cursor, k - 1)
        if protect_slot is not None:
            skip = victim == protect_slot
            victim = torch.where(skip, 1 + torch.remainder(cursor + 1, k - 1), victim)
        else:
            skip = torch.zeros((), dtype=torch.bool, device=dev)
        slot = torch.where(fits, bank.count, victim)
        do = enabled
        evicting = enabled & ~fits
        new_cursor = cursor + torch.where(evicting, 1 + skip.to(torch.int32), 0)
        evicted = torch.where(evicting, slot, -1)
    else:
        slot = torch.clamp(bank.count, max=k - 1)
        do = enabled & fits
        new_cursor = cursor
        evicted = torch.full((), -1, dtype=torch.int32, device=dev)
    slot = slot.to(torch.int32)
    evicted = evicted.to(torch.int32)
    idx = slot.long()

    write_slot(bank.fft, idx, as_pair(fft), do)
    write_slot(bank.polar_fft, idx, as_pair(polar_fft), do)
    if filt is not None and bank.filt.shape[1]:
        write_slot(bank.filt, idx, as_pair(filt), do)
    if filt_polar is not None and bank.filt_polar.shape[1]:
        write_slot(bank.filt_polar, idx, as_pair(filt_polar), do)
    if bank.images.shape[1]:
        write_slot(bank.images, idx, image, do)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    write_slot(bank.poses, idx, pose, do)
    write_slot(bank.grid_xy, idx, grid_location(pose[:2], grid_scale), do)
    write_slot(bank.frame_ids, idx, frame_id, do)
    write_slot(bank.distances, idx, distance, do)
    bank.overflow += (enabled & ~fits).to(torch.int32)
    bank.count += (do & fits).to(torch.int32)
    bank.evict_cursor.copy_(new_cursor)
    return InsertResult(bank=bank, slot=slot, stored=do, evicted=evicted)


def add_edge(
    edges: EdgeStore, *, from_slot, to_slot, T, edge_type, enabled, info=None
) -> EdgeStore:
    """Masked insert of one constraint, in place: reclaim the first dead
    slot, else append, else overwrite the first alive KCC edge (loop edges
    are never replaced), else drop.  Forced paths bump ``overflow``."""
    dev = edges.count.device
    if info is None:
        info = torch.eye(3, dtype=torch.float32, device=dev)
    enabled = torch.as_tensor(enabled, dtype=torch.bool, device=dev)
    cap = edges.capacity
    used = torch.arange(cap, device=dev) < edges.count
    dead = ~edges.alive & used
    has_dead = dead.any()
    # torch.argmax takes no bool: cast first ("first True" in slot order).
    first_dead = torch.argmax(dead.to(torch.int32))
    fits = edges.count < cap
    kcc = edges.alive & (edges.types == EDGE_KCC)
    has_kcc = kcc.any()
    kcc_victim = torch.argmax(kcc.to(torch.int32))
    slot = torch.where(has_dead, first_dead, torch.where(fits, edges.count.long(), kcc_victim))
    do = enabled & (has_dead | fits | has_kcc)
    appended = do & ~has_dead & fits
    forced = enabled & ~has_dead & ~fits
    write_slot(edges.from_slot, slot, from_slot, do)
    write_slot(edges.to_slot, slot, to_slot, do)
    write_slot(edges.T, slot, T, do)
    write_slot(edges.info, slot, info, do)
    write_slot(edges.types, slot, edge_type, do)
    write_slot(edges.alive, slot, True, do)
    edges.count += appended.to(torch.int32)
    edges.overflow += forced.to(torch.int32)
    return edges


def invalidate_edges(edges: EdgeStore, evicted_slot) -> EdgeStore:
    """In place: disable every edge referencing an evicted slot (no-op for -1)."""
    ref = (edges.from_slot == evicted_slot) | (edges.to_slot == evicted_slot)
    kill = ref & (torch.as_tensor(evicted_slot, device=edges.alive.device) >= 0)
    edges.alive &= ~kill
    return edges


def frames_in_neighborhood(bank: KeyframeBank, prior_pose, grid_scale: float) -> torch.Tensor:
    """Live keyframes whose insertion cell is in the 3×3 neighborhood of
    ``prior_pose``'s cell."""
    cur = grid_location(prior_pose[:2], grid_scale)
    near = torch.all(torch.abs(bank.grid_xy - cur[None, :]) <= 1, dim=-1)
    return near & bank.valid_mask()
