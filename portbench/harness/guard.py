"""The check that neither JAX nor the JAX package was loaded."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "afcm_tpu")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names whose top-level name (the part before the first
    dot) is one of ``FORBIDDEN``, compared whole: ``afcm_tpu_torch`` passes."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check_no_jax() -> None:
    """Exit with code 3, naming what was found on standard error, if this
    process holds a forbidden module."""
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
