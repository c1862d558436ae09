"""The import guard: nothing that the benchmark runs may load JAX or the JAX
package. Module names are compared by their top-level part (before the
first dot) as whole words, because the port's name begins with the JAX
package's name."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_embeddings_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    names = sys.modules.keys() if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
