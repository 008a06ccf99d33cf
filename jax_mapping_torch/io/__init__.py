"""Persistence: checkpoint and resume (`io/checkpoint.py`), trace record
and replay (`io/trace.py`) and the ROS map_server format (`io/rosmap.py`),
each in the JAX package's file format."""

from jax_mapping_torch.io.checkpoint import (  # noqa: F401
    CheckpointCorrupt, load_checkpoint, load_checkpoint_with_fallback,
    previous_checkpoint_path, save_checkpoint,
)
from jax_mapping_torch.io.trace import (  # noqa: F401
    TraceRecorder, TraceReplayer,
)
