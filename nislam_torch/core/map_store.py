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

A bank may be sharded over ranks (``nislam_torch.parallel.engine``): the
spectra, filters and images then hold only this rank's block of slots,
starting at ``shard_base``, while the per-slot tables (poses, cells, ids,
distances) and the cursors hold every slot on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

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
    # First slot of the spectra, filters and images held here: 0 unless the
    # bank is sharded, where each rank's bank sets its own.
    shard_base: ClassVar[int] = 0

    @property
    def capacity(self) -> int:
        """K, the global slot count: the per-slot pose table holds every
        slot on every rank, sharded or not."""
        return self.poses.shape[0]

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


def device_value(val, device: torch.device, dtype=None) -> torch.Tensor:
    """``val`` as a tensor on ``device`` (``dtype``: None keeps a tensor's,
    or infers one as ``torch.as_tensor`` does): a tensor is moved (no copy
    where it lies already), a Python bool, int or float is filled on the
    device, with no copy from the host (what a captured CUDA graph can
    hold), other host data is copied."""
    if isinstance(val, torch.Tensor):
        return val.to(device=device, dtype=dtype)
    if type(val) in (bool, int, float):
        return torch.full((), val, dtype=dtype, device=device)
    return torch.as_tensor(val, dtype=dtype, device=device)


def write_slot(buf: torch.Tensor, slot: torch.Tensor, val, do: torch.Tensor) -> None:
    """In place: ``buf[slot] = val`` if ``do`` else unchanged (device-side
    index and predicate, no host sync)."""
    val = device_value(val, buf.device).to(buf.dtype)
    i = slot.reshape(1).long()
    buf.index_copy_(0, i, torch.where(do, val, buf.index_select(0, i)))


class InsertResult(NamedTuple):
    bank: KeyframeBank
    slot: torch.Tensor  # () i32 slot written (or would-be slot if not stored)
    stored: torch.Tensor  # () bool
    evicted: torch.Tensor  # () i32 slot whose old record was evicted, else -1


def plan_insert(bank: KeyframeBank, enabled, evict: bool, protect_slot=None):
    """Where :func:`add_keyframe` would write, without writing →
    ``(slot i32, stored, evicted i32 or -1, next evict cursor)``.  Lets a
    caller read the record that an insert is about to evict."""
    enabled = device_value(enabled, bank.count.device, torch.bool)
    return _plan(bank.count, bank.evict_cursor, bank.capacity, enabled, evict, protect_slot)


def _plan(count, cursor, k: int, enabled, evict: bool, protect_slot):
    """:func:`plan_insert` from a bank's ``count`` and ``evict_cursor`` and
    its capacity ``k``; elementwise, so over any lanes of them."""
    fits = count < k
    if evict and k > 2:
        victim = 1 + torch.remainder(cursor, k - 1)
        if protect_slot is not None:
            skip = victim == protect_slot
            victim = torch.where(skip, 1 + torch.remainder(cursor + 1, k - 1), victim)
        else:
            skip = torch.zeros_like(count, dtype=torch.bool)
        slot = torch.where(fits, count, victim)
        do = enabled
        evicting = enabled & ~fits
        new_cursor = cursor + torch.where(evicting, 1 + skip.to(torch.int32), 0)
        evicted = torch.where(evicting, slot, -1)
    else:
        slot = torch.clamp(count, max=k - 1)
        do = enabled & fits
        new_cursor = cursor
        evicted = torch.full_like(count, -1)
    return slot.to(torch.int32), do, evicted.to(torch.int32), new_cursor


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
    enabled = device_value(enabled, dev, torch.bool)
    fits = bank.count < bank.capacity
    slot, do, evicted, new_cursor = plan_insert(bank, enabled, evict, protect_slot)
    idx = slot.long()
    rows = bank.fft.shape[0]
    if rows == bank.capacity:
        bidx, bdo = idx, do
    else:  # sharded: the rank that owns the slot writes its block, on the device
        local = idx - bank.shard_base
        bidx, bdo = torch.clamp(local, 0, rows - 1), do & (local >= 0) & (local < rows)

    write_slot(bank.fft, bidx, as_pair(fft), bdo)
    write_slot(bank.polar_fft, bidx, as_pair(polar_fft), bdo)
    if filt is not None and bank.filt.shape[1]:
        write_slot(bank.filt, bidx, as_pair(filt), bdo)
    if filt_polar is not None and bank.filt_polar.shape[1]:
        write_slot(bank.filt_polar, bidx, as_pair(filt_polar), bdo)
    if bank.images.shape[1]:
        write_slot(bank.images, bidx, image, bdo)
    pose = device_value(pose, dev, torch.float32)
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
    enabled = device_value(enabled, dev, torch.bool)
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


def _write_lanes(buf: torch.Tensor, slot: torch.Tensor, val, do: torch.Tensor) -> None:
    """In place, in each lane b of ``buf`` (B, S, ...): ``buf[b, slot[b]] =
    val[b]`` where ``do[b]``, else unchanged."""
    b = buf.shape[0]
    tail = tuple(buf.shape[2:])
    val = device_value(val, buf.device).to(buf.dtype).expand((b,) + tail).reshape((b, 1) + tail)
    idx = slot.long().reshape((b, 1) + (1,) * len(tail)).expand((b, 1) + tail)
    keep = do.reshape((b, 1) + (1,) * len(tail))
    buf.scatter_(1, idx, torch.where(keep, val, buf.gather(1, idx)))


def add_edge_lanes(edges: EdgeStore, *, from_slot, to_slot, T, edge_type, enabled) -> EdgeStore:
    """:func:`add_edge` (identity information) in every lane of a
    lane-stacked store (leaves (B, E, ...), counts (B,)) at once, each
    lane's own constraint (``from_slot``, ``to_slot``, ``enabled`` (B,),
    ``T`` (B, 3)): the slot each lane's :func:`add_edge` would pick and the
    same writes, bit for bit, in place."""
    dev = edges.count.device
    b, cap = edges.alive.shape
    enabled = device_value(enabled, dev, torch.bool)
    used = torch.arange(cap, device=dev) < edges.count[:, None]
    dead = ~edges.alive & used
    has_dead = dead.any(-1)
    first_dead = torch.argmax(dead.to(torch.int32), dim=-1)
    fits = edges.count < cap
    kcc = edges.alive & (edges.types == EDGE_KCC)
    has_kcc = kcc.any(-1)
    kcc_victim = torch.argmax(kcc.to(torch.int32), dim=-1)
    slot = torch.where(has_dead, first_dead, torch.where(fits, edges.count.long(), kcc_victim))
    do = enabled & (has_dead | fits | has_kcc)
    appended = do & ~has_dead & fits
    forced = enabled & ~has_dead & ~fits
    _write_lanes(edges.from_slot, slot, from_slot, do)
    _write_lanes(edges.to_slot, slot, to_slot, do)
    _write_lanes(edges.T, slot, T, do)
    _write_lanes(edges.info, slot, torch.eye(3, dtype=torch.float32, device=dev), do)
    _write_lanes(edges.types, slot, edge_type, do)
    _write_lanes(edges.alive, slot, True, do)
    edges.count += appended.to(torch.int32)
    edges.overflow += forced.to(torch.int32)
    return edges


def gather_lanes(part, lanes: torch.Tensor):
    """The lanes ``lanes`` ((k,) i64) of a lanes-first store (any of the
    state's dataclasses, every tensor leaf (B, ...)): the same dataclass
    with each leaf's rows gathered, (k, ...) copies.  Advanced indexing,
    not ``index_select``, whose kernel for a few indices copies a large
    row with few threads."""
    return dataclasses.replace(part, **{f.name: getattr(part, f.name)[lanes] for f in dataclasses.fields(part)})


def scatter_lanes(part, lanes: torch.Tensor, gathered) -> None:
    """In place: each tensor leaf of the lanes-first ``part`` takes
    ``gathered``'s (:func:`gather_lanes`' result, updated) rows at
    ``lanes``."""
    for f in dataclasses.fields(part):
        getattr(part, f.name).index_copy_(0, lanes, getattr(gathered, f.name))


def _write_rows(buf: torch.Tensor, rows: torch.Tensor, val, do: torch.Tensor) -> None:
    """In place, in the flattened (B·K, ...) view of a lanes-first leaf
    (B, K, ...): row ``rows[j]`` = ``val[j]`` where ``do[j]``, else
    unchanged (:func:`write_slot`'s operations on distinct rows)."""
    flat = buf.view((-1,) + tuple(buf.shape[2:]))  # a view, never a copy: raises otherwise
    val = device_value(val, buf.device).to(buf.dtype)
    keep = do.reshape(do.shape + (1,) * (flat.dim() - 1))
    flat.index_copy_(0, rows, torch.where(keep, val, flat[rows]))


def add_keyframe_lanes(
    bank: KeyframeBank, lanes: torch.Tensor, *, fft, polar_fft, filt, filt_polar, image, pose, frame_id,
    distance, grid_scale: float, evict: bool, protect_slot,
) -> InsertResult:
    """:func:`add_keyframe` (enabled) in the gathered lanes ``lanes`` ((k,)
    i64, distinct) of a lanes-first bank (leaves (B, K, ...), counters
    (B,)), in place, each lane its own record (values (k, ...)) and so its
    own slot, stored flag, evicted slot and cursor: the spectra, filters,
    image and per-slot tables written at row ``lane·K + slot`` of their
    flattened views, the counters gathered, updated and scattered back.
    Returns the (k,) slot, stored and evicted; the bits are those of k
    :func:`add_keyframe` calls on the lanes' views."""

    def as_pair(x):
        return c2r(x) if torch.is_complex(x) else x

    k = bank.poses.shape[1]
    if bank.fft.shape[1] != k:
        raise ValueError("add_keyframe_lanes writes an unsharded bank")
    count, cursor = bank.count[lanes], bank.evict_cursor[lanes]
    enabled = torch.ones_like(count, dtype=torch.bool)
    fits = count < k
    slot, do, evicted, new_cursor = _plan(count, cursor, k, enabled, evict, protect_slot)
    rows = lanes * k + slot.long()
    _write_rows(bank.fft, rows, as_pair(fft), do)
    _write_rows(bank.polar_fft, rows, as_pair(polar_fft), do)
    if bank.filt.shape[2]:
        _write_rows(bank.filt, rows, as_pair(filt), do)
    if bank.filt_polar.shape[2]:
        _write_rows(bank.filt_polar, rows, as_pair(filt_polar), do)
    if bank.images.shape[2]:
        _write_rows(bank.images, rows, image, do)
    _write_rows(bank.poses, rows, pose, do)
    _write_rows(bank.grid_xy, rows, grid_location(pose[..., :2], grid_scale), do)
    _write_rows(bank.frame_ids, rows, frame_id, do)
    _write_rows(bank.distances, rows, distance, do)
    bank.overflow.index_copy_(0, lanes, bank.overflow[lanes] + (enabled & ~fits).to(torch.int32))
    bank.count.index_copy_(0, lanes, count + (do & fits).to(torch.int32))
    bank.evict_cursor.index_copy_(0, lanes, new_cursor)
    return InsertResult(bank=bank, slot=slot, stored=do, evicted=evicted)


def plan_insert_lanes(bank: KeyframeBank, lanes: torch.Tensor, evict: bool, protect_slot):
    """:func:`plan_insert` (enabled) in the gathered lanes ``lanes`` of a
    lanes-first bank: what :func:`add_keyframe_lanes` would write there."""
    count, cursor = bank.count[lanes], bank.evict_cursor[lanes]
    return _plan(count, cursor, bank.poses.shape[1], torch.ones_like(count, dtype=torch.bool), evict, protect_slot)


def invalidate_edges_lanes(edges: EdgeStore, evicted: torch.Tensor) -> EdgeStore:
    """:func:`invalidate_edges` in every lane of a lane-stacked store (leaves
    (k, E, ...)), lane j's evicted slot ``evicted[j]`` (-1: none), in place."""
    ev = evicted[:, None]
    kill = ((edges.from_slot == ev) | (edges.to_slot == ev)) & (ev >= 0)
    edges.alive &= ~kill
    return edges


def invalidate_edges(edges: EdgeStore, evicted_slot) -> EdgeStore:
    """In place: disable every edge referencing an evicted slot (no-op for -1)."""
    ref = (edges.from_slot == evicted_slot) | (edges.to_slot == evicted_slot)
    kill = ref & (device_value(evicted_slot, edges.alive.device) >= 0)
    edges.alive &= ~kill
    return edges


def frames_in_neighborhood(bank: KeyframeBank, prior_pose, grid_scale: float) -> torch.Tensor:
    """Live keyframes whose insertion cell is in the 3×3 neighborhood of
    ``prior_pose``'s cell."""
    cur = grid_location(prior_pose[:2], grid_scale)
    near = torch.all(torch.abs(bank.grid_xy - cur[None, :]) <= 1, dim=-1)
    return near & bank.valid_mask()
