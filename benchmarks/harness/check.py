"""Whether what the timed path produced is right: the program's outputs in
the window against the plain reference (``benchmarks/reference``) on the
same frames.

The window keeps, on the device, every instance of two distinct sequences
(the first two of the seed-drawn order): each chunk's per-frame outputs
and, for an instance that finished, its keyframe poses after
``finalize``.  Once the window has closed, the reference runs each of the
two sequences once, and each instance is held against it:

- ``mismatched_decisions``: frames whose tracked flag, keyframe decision
  and slot, loop decision or loop slot differ (tracking, the keyframe
  branch and the loop search);
- ``pose_gap_px``: the widest gap, in the camera's pixels, of a frame's
  pose (tracking, and every solve through the chain it re-derives) or of
  a keyframe's pose after the sequence's last solve (the pose-graph
  solve), keyframes matched by the frame that stored them;
- ``heading_gap_deg``: the widest gap of a frame's or a keyframe's
  heading.

The number of each that an instance reads at worst is held against its
limit in ``benchmarks/checks/<cell>.json``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from benchmarks.harness.window import keyframe_table
from benchmarks.reference.slam import ReferenceSlam

NUMBERS = ("mismatched_decisions", "pose_gap_px", "heading_gap_deg")
# Columns of the program's packed per-frame output (StepOutput.pack).
TRACKED, INSERTED, LOOP_FOUND, POSE, KEYFRAME_SLOT, LOOP_SLOT = 0, 1, 2, slice(10, 13), 14, 15


def sampled(seqs) -> set:
    """The distinct sequences whose instances are checked: the first two
    that the run's seed-drawn order cycles, which every window reaches."""
    return set(seqs.order[:2])


def _wrap_deg(rad: np.ndarray) -> np.ndarray:
    return np.degrees(np.abs((rad + math.pi) % (2.0 * math.pi) - math.pi))


def compare(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], first: int, px_per_m: float,
            keyframes=None) -> Dict[str, float]:
    """One instance's numbers: ``got`` its per-frame outputs from frame
    ``first`` on, ``ref`` the reference's whole sequence; ``keyframes`` the
    instance's after ``finalize`` (None: it did not finish), rows of x, y,
    heading and the frame that stored it.  Keyframes are matched by that
    frame: one stored by one side only is a mismatched decision, and the
    poses of the others are compared."""
    n = got["tracked"].shape[0]
    sl = slice(first, first + n)
    keys = ("tracked", "inserted", "loop_found", "keyframe_slot", "loop_slot")
    differ = np.zeros(n, dtype=bool)
    for k in keys:
        differ |= np.asarray(got[k]).astype(np.int64) != np.asarray(ref[k][sl]).astype(np.int64)
    d = np.asarray(got["pose"], np.float64) - np.asarray(ref["pose"][sl], np.float64)
    out = {
        "mismatched_decisions": float(differ.sum()),
        "pose_gap_px": float(np.max(np.hypot(d[:, 0], d[:, 1]))) * px_per_m,
        "heading_gap_deg": float(np.max(_wrap_deg(d[:, 2]))),
    }
    if keyframes is not None:
        kp = np.asarray(keyframes, np.float64)
        rp = np.asarray(ref["keyframes"], np.float64)
        common, ik, ir = np.intersect1d(np.rint(kp[:, 3]), np.rint(rp[:, 3]), return_indices=True)
        out["mismatched_decisions"] += len(kp) + len(rp) - 2 * len(common)
        if len(common):
            dk = kp[ik, :3] - rp[ir, :3]
            out["pose_gap_px"] = max(out["pose_gap_px"], float(np.max(np.hypot(dk[:, 0], dk[:, 1]))) * px_per_m)
            out["heading_gap_deg"] = max(out["heading_gap_deg"], float(np.max(_wrap_deg(dk[:, 2]))))
    return out


def unpack(packed: np.ndarray) -> Dict[str, np.ndarray]:
    """The program's packed (n, 17) outputs as the fields compared."""
    return {"tracked": packed[:, TRACKED] > 0.5, "inserted": packed[:, INSERTED] > 0.5,
            "loop_found": packed[:, LOOP_FOUND] > 0.5, "keyframe_slot": np.rint(packed[:, KEYFRAME_SLOT]),
            "loop_slot": np.rint(packed[:, LOOP_SLOT]), "pose": packed[:, POSE]}


def px_per_metre(slam: dict) -> float:
    cam = slam["camera"]
    return cam["intrinsics"][0] / cam["height"]


def worst(rows: Iterable[Dict[str, float]]) -> Dict[str, float]:
    rows = list(rows)
    return {k: max(r[k] for r in rows) for k in NUMBERS}


def reference(cell, device, precision: str = "f32") -> ReferenceSlam:
    """The plain reference of the default loop (a mix's module may give
    its own: :mod:`benchmarks.harness.driver`)."""
    slam = cell.config["slam"]
    loops = cell.traffic["model"] == "slam" and slam["loop_closure"]["to_find_loop"]
    return ReferenceSlam(slam, device, precision, find_loops=loops)


def check_window(window, seqs, cell, device) -> Tuple[Dict[str, float], List[str]]:
    """The window's kept instances against the reference → (the worst
    numbers, one line per instance)."""
    ref_slam = cell.driver.reference(cell, device)
    px = px_per_metre(cell.config["slam"])
    rows, lines = [], []
    for j in sorted(set(window.kept_sequence.values())):
        ref = ref_slam.run(seqs.frames[j], seqs.chunk)
        for inst, parts in sorted(window.kept.items()):
            if window.kept_sequence[inst] != j or not parts:
                continue
            packed = torch.cat([p for _, p in parts]).cpu().numpy()
            kf = window.kept_keyframes.get(inst)
            keyframes = None if kf is None else keyframe_table(*kf).cpu().numpy()
            row = compare(unpack(packed), ref, parts[0][0], px, keyframes)
            rows.append(row)
            lines.append(f"instance {inst} (sequence {j}, {packed.shape[0]} frames, "
                         f"{'finished' if kf is not None else 'cut by the window'}): "
                         + ", ".join(f"{k} {row[k]:.6g}" for k in NUMBERS))
    if not rows:
        raise RuntimeError("the window kept no instance to check")
    return worst(rows), lines


def check_control(seqs, cell, device, indices) -> Dict[str, float]:
    """The control: the reference in bfloat16 put in the program's place,
    over the distinct sequences ``indices``, held against the float32
    reference → the worst numbers."""
    ref_slam, ctl_slam = cell.driver.reference(cell, device), cell.driver.reference(cell, device, "bf16")
    px = px_per_metre(cell.config["slam"])
    rows = []
    for j in indices:
        ref = ref_slam.run(seqs.frames[j], seqs.chunk)
        ctl = ctl_slam.run(seqs.frames[j], seqs.chunk)
        rows.append(compare(ctl, ref, 0, px, ctl["keyframes"]))
    return worst(rows)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)
