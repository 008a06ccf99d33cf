"""Persistence: checkpoint and resume (`io/checkpoint.py`), in the JAX
package's file format. Trace record and replay (`io/trace.py`) are not
ported yet (ROADMAP A.9c)."""

from jax_mapping_torch.io.checkpoint import (  # noqa: F401
    CheckpointCorrupt, load_checkpoint, load_checkpoint_with_fallback,
    previous_checkpoint_path, save_checkpoint,
)
