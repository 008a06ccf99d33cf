"""Observability: causal tracing, flight recorder, metrics registry,
freshness SLOs, postmortem trace-diff.

Port of the JAX package's `obs` package, host half (stdlib only):

* `trace`    — `TraceContext`/`Tracer`: deterministic trace ids derived
               from `(seed, topic, seq)`, carried across Bus
               publish/delivery, mapper ticks and HTTP handlers; the same
               publish sequence gives the same ids as the JAX package's.
               Gated by `ObsConfig.enabled` (False = no Tracer exists).
* `recorder` — `flight_recorder`: always-on bounded ring of structured
               load-bearing transitions, auto-dumped to the checkpoint
               dir on supervisor restarts and watchdog divergence.
* `registry` — `MetricsRegistry`: the Prometheus exposition of
               `bridge/http_api.py`'s `/metrics`.
* `export`   — Chrome-trace/Perfetto JSON (also `GET /trace?since=`).
* `diff`     — same-seed trace-diff: the first divergence point of two
               event/span streams.
* `pipeline` — `PipelineLedger`: per-revision freshness waypoints (scan
               enqueued → installed → notified → tile re-encoded → first
               client delivery), the Server-Timing revision-age source.
               Rides the `ObsConfig.enabled` gate.
* `slo`      — `SloEngine`: the declared freshness objectives in
               `ObsConfig.slo`, evaluated once a mapper tick with
               fast/slow burn-rate alerting; alerts flight-recorded, on
               `/status.slo` and `jax_mapping_slo_*`.

* `devprof`  — `DispatchProfiler`: the device half's dispatch
               attribution over the port's marked entry points (host
               time a call, recompiles as new signature keys, captured
               signatures, the card's memory watermarks; each call a
               `utils.profiling.span` named by its entry point). Gated by
               `ObsConfig.devprof.enabled`.
* `ledger`   — `CostLedger`: FLOPs and bytes per captured signature, from
               an aten-op count on zeros and the kernels' own arithmetic;
               `cross_check` against the port's compile budget.

`python -m jax_mapping_torch.obs` is the CLI (diff two dumps, export a
dump to a Perfetto-loadable trace, the critical path of a dump's
pipeline records, the cost ledger of the canonical scenario). Importing
this package imports no torch.
"""

from jax_mapping_torch.obs.devprof import DispatchProfiler  # noqa: F401
from jax_mapping_torch.obs.diff import (  # noqa: F401
    Divergence, diff_dumps, diff_streams, normalize_events,
)
from jax_mapping_torch.obs.export import (  # noqa: F401
    chrome_events, dump_to_chrome, write_chrome_trace,
)
from jax_mapping_torch.obs.ledger import CostLedger  # noqa: F401
from jax_mapping_torch.obs.pipeline import (  # noqa: F401
    FixedHistogram, PipelineLedger,
)
from jax_mapping_torch.obs.recorder import (  # noqa: F401
    FlightRecorder, flight_recorder,
)
from jax_mapping_torch.obs.registry import (  # noqa: F401
    Family, MetricsRegistry, histogram_samples, summary_samples,
)
from jax_mapping_torch.obs.slo import SloEngine  # noqa: F401
from jax_mapping_torch.obs.trace import (  # noqa: F401
    TraceContext, Tracer, h64,
)
