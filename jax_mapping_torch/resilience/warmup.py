"""Availability-aware staged warm-up: restore -> pre-warm -> re-admit.

Port of the JAX package's `resilience/warmup.py`. A supervisor restart of
the mapper is a staged path, not restore-and-go:

1. **restoring** — the checkpoint loads (the generation fallback
   ladder);
2. **warming** — the entry points are pre-warmed in priority order —
   fusion first (the mapper's time to its first fused scan is the
   availability metric), then matching, then exploration: each
   signature is called once on zeros (`devprof.materialize_zeros`) on
   the stack's device, which loads (or builds, through the build cache
   of `io/compile_cache.py`) its kernel libraries and takes its route
   before a live scan needs it. Meanwhile serving answers from the LAST
   epoch with `state=warming` instead of blocking (`bridge/http_api.py`);
3. **ready** — a readiness gate compares the per-entry-point variant
   counts (`devprof.variant_counts`) with the port's compile budget
   (`analysis/compile_budget.json`), relative to the pre-warm baseline, and
   reports (never raises) what this warm-up grew past its maximum; the
   dispatch profiler then re-baselines so that warmed variants never
   count as live recompiles.

"Already warm" (JAX: `_cache_size() > 0`) means that this process has
dispatched the signature and that the libraries of the kernels it
launched are loaded: an in-process restart reports every name as
`in_process`. A signature from the manifest warms as `aot`, any other
as `prewarmed`; a call that fails records `error` (it never falls back to
a plain version). The warm-up's own kernel launches are counted apart
(`report["launches"]`). Pre-warm calls are pure functions of fresh zeros
(K5 applies in place on its own zeros patch), so two same-seed missions
stay bit-equal.

Thread contract: the state machine's fields mutate only under `_lock`;
the pre-warm's device work runs outside it. HTTP workers read
`state()`/`snapshot()` concurrently with the restarting step thread.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from jax_mapping_torch.obs.recorder import flight_recorder

#: Warm-up priority classes, in order: the fusion tier gates the time to
#: the first fused scan (slam_step is the mapper's fuse entry), matching
#: the first key scan, exploration the first publish; everything else
#: (sim, serving hashes, planner) follows. Classification is by
#: qualified-name substring.
_PRIORITY_CLASSES = (
    ("fusion", ("fuse", "slam_step", "sensor_kernel")),
    ("match", ("match", "pyramid", "scan_agreement", "posegraph")),
    ("frontier", ("frontier", "costfield", "planner")),
)

IDLE = "idle"
RESTORING = "restoring"
WARMING = "warming"
READY = "ready"


def warmup_class(name: str) -> int:
    """Priority class index for a qualified entry-point name (lower
    warms earlier; unclassified names warm last)."""
    for i, (_label, needles) in enumerate(_PRIORITY_CLASSES):
        if any(n in name for n in needles):
            return i
    return len(_PRIORITY_CLASSES)


def warmup_order(names) -> List[str]:
    """Names sorted fusion -> match -> frontier -> rest, alphabetical
    within a class."""
    return sorted(names, key=lambda n: (warmup_class(n), n))


def _launch_delta(before: dict, after: dict) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v > before.get(k, 0)}


class StagedWarmup:
    """The restart state machine + pre-warm driver."""

    def __init__(self, cache=None, devprof=None,
                 budget_path: Optional[str] = None, device=None):
        #: io/compile_cache.CompileCacheManager, or None (a restart with
        #: no cold-start tier: the stages still run, and the pre-warm
        #: finds what this process already dispatched).
        self.cache = cache
        self.devprof = devprof
        self.budget_path = budget_path
        #: Device the zeros go to (None: each signature's own).
        self.device = device
        self._lock = threading.Lock()
        self._state = IDLE
        #: [(fn_name, how)] per warmed signature, in warm order —
        #: how in {aot, prewarmed, in_process, error}.
        self._warmed: List[tuple] = []
        self._report: Dict[str, object] = {}

    # -- state machine -------------------------------------------------------

    def _move(self, new: str) -> None:
        with self._lock:
            old = self._state
            self._state = new
        flight_recorder.record("warmup_stage", old=old, new=new)

    def begin_restore(self) -> None:
        self._move(RESTORING)

    def begin_warming(self) -> None:
        self._move(WARMING)

    def mark_ready(self) -> None:
        self._move(READY)

    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        """The /status export + test assertion surface."""
        with self._lock:
            return {"state": self._state,
                    "n_warmed": len(self._warmed),
                    "warmed": list(self._warmed),
                    "report": dict(self._report)}

    # -- pre-warm ------------------------------------------------------------

    def prewarm(self, signatures: Optional[Dict[str, list]] = None,
                force: bool = False, manifest: bool = True) -> dict:
        """Warm the captured entry points in priority order and run the
        readiness gate. `signatures` maps qualified names to captured
        abstract signatures (the dispatch profiler's live capture); the
        cache manager's manifest adds its entries on top. `force` warms
        the explicitly passed names even where this process already
        dispatched them (the tenant control plane's admission, whose new
        bucket must run before the tenant joins); names that came only
        from the manifest keep the in-process short-circuit.
        `manifest=False` skips the manifest merge and warms only the
        passed signatures (an admission must not drag the whole
        persisted sweep behind it). Returns the report (also kept for
        `snapshot()`). Never raises: a failing signature is an `error`
        entry."""
        from jax_mapping_torch.io.compile_cache import resolve_entry_point
        from jax_mapping_torch.obs import devprof as DP
        from jax_mapping_torch.ops import _cuda
        t0 = time.perf_counter()
        baseline_sizes = DP.variant_counts()
        launches_at_start = dict(_cuda.LAUNCHES)
        sigs: Dict[str, list] = {}
        pooled_names = set()
        if self.cache is not None and manifest:
            loaded = self.cache.load_aot()
            for name, ss in loaded["signatures"].items():
                sigs.setdefault(name, []).extend(ss)
            pooled_names = set(loaded["pool_names"])
        for name, ss in (signatures or {}).items():
            have = {DP.signature_key(x) for x in sigs.get(name, [])}
            for s in ss:
                if DP.signature_key(s) not in have:
                    sigs.setdefault(name, []).append(s)
        warmed: List[tuple] = []
        by_fn: Dict[str, Dict[str, int]] = {}
        errors: Dict[str, str] = {}
        n_errors = 0
        for name in warmup_order(sigs):
            fn = resolve_entry_point(name)
            if fn is None:
                warmed.append((name, "error"))
                errors[name] = "no such entry point"
                n_errors += 1
                continue
            forced = force and name in (signatures or {})
            todo = [s for s in sigs[name]
                    if forced or not self._warm(fn, DP.signature_key(s))]
            if not todo:
                # In-process restart: this process dispatched every
                # signature and holds its kernels; nothing to pay.
                warmed.append((name, "in_process"))
                continue
            pooled = (self.cache.pool.keys_for(name)
                      if self.cache is not None and name in pooled_names
                      else set())
            for sig in todo:
                key = DP.signature_key(sig)
                before = dict(_cuda.LAUNCHES)
                try:
                    zargs, zkwargs = DP.materialize_zeros(sig, self.device)
                    with DP.unprofiled():
                        fn(*zargs, **zkwargs)
                except Exception as e:              # noqa: BLE001
                    if key in pooled:
                        self.cache.pool.drop(name, key)
                    warmed.append((name, "error"))
                    errors[name] = f"{type(e).__name__}: {e}"[:300]
                    n_errors += 1
                    continue
                ran = _launch_delta(before, dict(_cuda.LAUNCHES))
                for k, v in ran.items():
                    by_fn.setdefault(name, {})[k] = \
                        by_fn.get(name, {}).get(k, 0) + v
                DP.note_dispatch(fn, name, key, _cuda.libraries_of(ran))
                warmed.append((name, "aot" if key in pooled
                               else "prewarmed"))
        report = {
            "n_warmed": len([w for w in warmed if w[1] != "error"]),
            "n_errors": n_errors,
            "n_aot": len([w for w in warmed if w[1] == "aot"]),
            "n_prewarmed": len([w for w in warmed
                                if w[1] == "prewarmed"]),
            "n_in_process": len([w for w in warmed
                                 if w[1] == "in_process"]),
            "warm_s": round(time.perf_counter() - t0, 3),
            "launches": _launch_delta(launches_at_start,
                                      dict(_cuda.LAUNCHES)),
            "launches_by_fn": by_fn,
            "errors": errors,
        }
        report["readiness_violations"] = self._readiness(baseline_sizes)
        if self.devprof is not None:
            # Warmed variants are not live recompiles: the profiler's
            # baseline moves to them before service resumes.
            report["n_rebaselined"] = self.devprof.rebaseline()
        with self._lock:
            self._warmed = warmed
            self._report = report
        flight_recorder.record(
            "warmup_ready", n_warmed=report["n_warmed"],
            n_aot=report["n_aot"], n_errors=report["n_errors"],
            n_readiness_violations=len(report["readiness_violations"]))
        return report

    @staticmethod
    def _warm(fn, key: str) -> bool:
        """This process dispatched `fn` at `key`, and the libraries of
        the kernels it launched are loaded."""
        from jax_mapping_torch.obs import devprof as DP
        from jax_mapping_torch.ops import _cuda
        libs = DP.dispatched(fn, key)
        return libs is not None and all(_cuda.loaded(lib) for lib in libs)

    def _readiness(self, baseline: Dict[str, int]) -> List[str]:
        """The readiness gate: an entry point THIS warm-up grew past its
        budget maximum is a recompile regression on the restart path —
        report it. Relative to the pre-warm baseline: in a fresh resume
        process the baseline is zero and the check is absolute, while in
        a long-lived process the variants it already held are not this
        warm-up's doing."""
        from jax_mapping_torch.obs import devprof as DP
        from jax_mapping_torch.analysis.compilebudget import (
            Budget, default_budget_path)
        try:
            budget = Budget.load(self.budget_path or default_budget_path())
        except Exception:                           # noqa: BLE001
            return ["compile budget unreadable — readiness unchecked"]
        sizes = DP.variant_counts()
        out = []
        for e in budget.entries:
            n = sizes.get(e["name"], 0)
            if n > e["max"] and n > baseline.get(e["name"], 0):
                out.append(f"{e['name']}: {n} compiled variant(s) after "
                           f"warm-up exceeds budget {e['max']}")
        return out
