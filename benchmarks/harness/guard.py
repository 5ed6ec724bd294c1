"""The benchmark runs the PyTorch port alone: no module of JAX or of the JAX
package may be loaded in its process.  Names are compared by their top
level, the part before the first dot, whole: ``nislam_torch`` is not
``nislam_tpu``."""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "nislam_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str]) -> List[str]:
    """The names whose top level is one of :data:`FORBIDDEN`."""
    return sorted({n for n in names if top_level(n) in FORBIDDEN})


def loaded_forbidden() -> List[str]:
    """The forbidden modules in this process's ``sys.modules``."""
    return forbidden(list(sys.modules))


def imported_names(path: str) -> List[str]:
    """Every module name that the Python source at ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    return names


def scan(folder: str) -> List[str]:
    """``path: module`` for each forbidden import in the ``.py`` files under
    ``folder``."""
    found = []
    for base, _, files in os.walk(folder):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(base, f)
                found.extend(f"{path}: {n}" for n in forbidden(imported_names(path)))
    return found
