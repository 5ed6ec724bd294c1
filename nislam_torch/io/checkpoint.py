"""Save and resume the whole SLAM state as one ``.npz``.

The layout is ``nislam_tpu.io.checkpoint``'s, so a checkpoint written by
either engine resumes in the other: leaves ``leaf_000 … leaf_NNN`` in the
JAX flatten order of ``SlamState`` (bank, edges, track, pending, canvas;
the dataclass fields in declaration order), a ``paths`` array of the JAX
key strings (``.bank.fft``, …, ``.canvas.weight``) checked on load, and a
``dtypes`` array.  npz has no bfloat16: a bf16 leaf is stored as its
uint16 bit pattern and read back as ``torch.bfloat16`` without
``ml_dtypes``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from nislam_torch.core.slam import SlamState

_PARTS = ("bank", "edges", "track", "pending", "canvas")
_CANVAS_LEAVES = ("data", "weight")  # center_x / center_y are static in JAX


def _leaves(state: SlamState) -> List[Tuple[str, torch.Tensor]]:
    out = []
    for part in _PARTS:
        node = getattr(state, part)
        names = _CANVAS_LEAVES if part == "canvas" else [f.name for f in dataclasses.fields(node)]
        out.extend((f".{part}.{name}", getattr(node, name)) for name in names)
    return out


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def save_state(path: str, state: SlamState) -> str:
    leaves = _leaves(state)
    arrays, dtypes = {}, []
    for i, (_, t) in enumerate(leaves):
        arrays[f"leaf_{i:03d}"], name = _to_numpy(t)
        dtypes.append(name)
    np.savez_compressed(
        path, paths=np.asarray([p for p, _ in leaves]), dtypes=np.asarray(dtypes), **arrays
    )
    return path


def load_state(path: str, template: SlamState) -> SlamState:
    """Load into ``template`` (e.g. ``engine.init_state()``), whose leaves
    are overwritten in place and whose devices are kept.  Shapes and dtypes
    must match: a checkpoint is tied to its config's sizes and capacities."""
    leaves = _leaves(template)
    with np.load(path, allow_pickle=False) as data:
        saved = [str(p) for p in data["paths"]]
        want = [p for p, _ in leaves]
        if saved != want:
            raise ValueError(
                f"checkpoint structure mismatch: saved {len(saved)} leaves {saved[:3]}…, "
                f"template {len(want)} leaves {want[:3]}…"
            )
        dtypes = [str(d) for d in data["dtypes"]]
        for i, (name, t) in enumerate(leaves):
            a = data[f"leaf_{i:03d}"]
            if dtypes[i] == "bfloat16":
                got = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                got = torch.from_numpy(np.array(a))  # ascontiguousarray would make 0-d arrays 1-d
            if tuple(got.shape) != tuple(t.shape):
                raise ValueError(
                    f"leaf {name}: shape {tuple(got.shape)} != template {tuple(t.shape)} — "
                    "the checkpoint was saved under a different config: check map "
                    "capacities, image/polar sizes and cf.half_polar"
                )
            if got.dtype != t.dtype:
                raise ValueError(
                    f"leaf {name}: dtype {got.dtype} != template {t.dtype} (saved under "
                    "a different bank_dtype/config — resume with the matching config)"
                )
            t.copy_(got)
    return template
