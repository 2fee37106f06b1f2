"""The benchmark runs the port alone: neither JAX nor the JAX package
`repro` may be loaded. Names are compared whole by their top-level part,
so `repro_torch` is not taken for `repro`."""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def loaded(modules: Iterable[str] = None) -> List[str]:
    """Forbidden modules in `sys.modules` (or in `modules`)."""
    return sorted(m for m in (sys.modules if modules is None else modules)
                  if forbidden(m))


def imports(path: Path) -> List[str]:
    """Every absolute module an import statement of `path` names."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.append(node.module)
    return out
