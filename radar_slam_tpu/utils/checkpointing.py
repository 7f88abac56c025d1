"""Pipeline-state checkpointing (beyond the reference's file-per-stage
artifacts, SURVEY.md section 5: "no step/state resume within a stage").

Checkpoints any pytree of arrays (e.g. the streaming ``FrameState``, the
pose-graph, smoother tables) to a single ``.npz`` plus a JSON treedef, and
restores it with the original structure.  Orbax is available in the image
for heavyweight use; this lightweight path has no extra dependencies.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Tuple

import jax
import numpy as np



def save_pytree(path: str | Path, tree: Any, step: int = 0) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = jax.tree.flatten(tree)
    arrays = {f"leaf_{i}": jax.device_get(x) for i, x in enumerate(leaves)}
    np.savez(path.with_suffix(".npz"), **arrays)
    meta = {"step": step, "num_leaves": len(leaves),
            "treedef": str(treedef)}
    path.with_suffix(".json").write_text(json.dumps(meta))
    return path.with_suffix(".npz")


def load_pytree(path: str | Path, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (shapes/dtypes validated)."""
    path = Path(path)
    with np.load(path.with_suffix(".npz")) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    meta = json.loads(path.with_suffix(".json").read_text())
    like_leaves, treedef = jax.tree.flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(like_leaves)}")
    import jax.numpy as jnp
    restored = []
    for a, b in zip(leaves, like_leaves):
        if tuple(a.shape) != tuple(np.shape(b)):
            raise ValueError(f"shape mismatch {a.shape} vs {np.shape(b)}")
        restored.append(jnp.asarray(a, dtype=b.dtype if hasattr(b, "dtype")
                                    else None))
    return jax.tree.unflatten(treedef, restored), int(meta["step"])


def latest_checkpoint(directory: str | Path,
                      prefix: str = "state") -> Path | None:
    d = Path(directory)
    if not d.exists():
        return None
    cands = sorted(d.glob(f"{prefix}_*.npz"))
    return cands[-1] if cands else None
