"""Observability. The flight recorder (`obs/recorder.py`: the mapper, the
fleet health registry and the supervisor record into it), the `/metrics`
registry (`obs/registry.py`, which `bridge/http_api.py` renders) and the
pipeline ledger's module (`obs/pipeline.py`, whose `FixedHistogram` the
serving load generator uses; the ledger itself is not wired) are ported.
Tracing, the SLO engine and the dispatch profiler are not (ROADMAP A.9f),
so `ObsConfig.enabled` and `ObsConfig.devprof.enabled` are refused at
launch."""

from jax_mapping_torch.obs.recorder import (  # noqa: F401
    FlightRecorder, flight_recorder,
)
