from jax_mapping_torch.utils.profiling import (  # noqa: F401
    Counters, StageTimer, device_trace, global_metrics, span,
)
