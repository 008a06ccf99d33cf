"""Warm-restart storage tier: the kernel build cache and the signature
manifest.

Port of the JAX package's `io/compile_cache.py`. The port has no jit
and no executable to serialize: a kernel's executable is the shared
library nvcc builds (`ops/_cuda.py`), and a launch is the same call
whether the process is cold or warm. So the tiers become:

* **The persistent compile cache is the kernel build cache.**
  `CompileCacheManager.enable()` points `_cuda`'s build directory at
  `<root>/cuda` (JAX: `jax_compilation_cache_dir`) and copies into it
  the libraries this process loaded before the cache was enabled, as XLA
  writes a compile to its persistent cache when it happens. A library already loaded in the process stays loaded — the
  counterpart of a jit cache that survives the node. `_cuda.BUILDS` counts the libraries nvcc built
  against those it found; `status()` reports them as `counts["builds"]`
  and `counts["builds_found"]`. The cache is bounded by `evict_lru`
  under `max_cache_bytes`; zero-byte files and `*.tmp` files (a crashed
  nvcc) are scrubbed before it is enabled.
* **The AOT snapshot is a signature manifest.** `save_aot(signatures)`
  writes each entry point's captured signatures (the dispatch
  profiler's, `obs/devprof.py`) under `<root>/aot/<fingerprint>/`, and
  copies the libraries this process has loaded into the build cache, so
  that the next process finds every kernel the signatures launch.
  `load_aot()` reads them back; the staged warm-up
  (`resilience/warmup.py`) pre-warms them on zeros as `aot`. A corrupt
  file or another fingerprint's directory is counted and degrades to
  the next tier; it never raises.
* **`WarmPool` serves no call.** In JAX it rebinds the entry points to
  serve matching calls from deserialized programs; a warm-served call
  in the port would be the same launch as the normal call. The pool
  only holds the loaded (name, key) entries and their `stats()`, and
  installs no wrapper.

The fingerprint is blake2b over the torch version, the CUDA version,
the device's name and capability (`cpu` on the CPU), the hash of the
kernel sources, headers and NVCC_FLAGS (`_cuda.source_hash`) and the
config JSON with `obs` and `cold_start` normalised out.

Thread contract: counters and the wipe refcount mutate only under
`_lock`; file I/O runs outside it. The `cache_wipe` FaultPlan kind
drives `wipe_hold`/`wipe_release`: windows compose by refcount, and
while any holds, builds go to the package's default `_build/` and
nothing is written under the root.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import threading
from typing import Dict, List, Optional, Tuple

from jax_mapping_torch.config import ColdStartConfig
from jax_mapping_torch.obs.devprof import (  # noqa: F401
    materialize_zeros, signature_key,
)
from jax_mapping_torch.obs.recorder import flight_recorder

#: Manifest file format version; bump on layout change (old files then
#: count as corrupt and degrade, never crash).
_SNAPSHOT_VERSION = 1


def cache_fingerprint(config_json: Optional[str] = None,
                      device=None) -> str:
    """Compatibility fingerprint of a manifest and its libraries: torch
    and CUDA versions, the device (name and capability; `cpu` on the
    CPU), the kernel sources' hashes and the config JSON with the
    bit-inert `obs` and `cold_start` sections normalised out, so that
    arming telemetry does not orphan a manifest."""
    import torch

    from jax_mapping_torch.ops import _cuda
    cfg_part = ""
    if config_json is not None:
        from jax_mapping_torch.config import (ColdStartConfig as _CS,
                                              ObsConfig, SlamConfig)
        try:
            cfg = SlamConfig.from_json(config_json)
            cfg_part = cfg.replace(obs=ObsConfig(),
                                   cold_start=_CS()).to_json()
        except (TypeError, ValueError, KeyError):
            cfg_part = config_json
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        idx = dev.index if dev.index is not None else 0
        major, minor = torch.cuda.get_device_capability(idx)
        dev_part = f"{torch.cuda.get_device_name(idx)} sm_{major}{minor}"
    else:
        dev_part = "cpu"
    h = hashlib.blake2b(digest_size=8)
    for part in (torch.__version__, str(torch.version.cuda), dev_part,
                 *(f"{n}:{_cuda.source_hash(n)}" for n in
                   sorted(_cuda.SOURCES)), cfg_part):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()


def qualified_name(fn, mod_name: str, attr: str, prefix: str) -> str:
    """The registry's naming contract: defining module + qualified name
    (a method as `Class.method`), stable across from-import aliases; a
    function defined elsewhere (a closure, a test's) takes the module
    that holds it."""
    owner = getattr(fn, "__module__", mod_name) or mod_name
    name = getattr(fn, "__qualname__", None) or ""
    if not owner.startswith(prefix) or not name or "<locals>" in name:
        owner = mod_name
        name = getattr(fn, "__name__", attr) or attr
    return f"{owner}.{name}"


def resolve_entry_point(name: str, prefix: str = "jax_mapping_torch"):
    """The raw entry point for a qualified name, unwrapped from any
    profiler wrapper — pre-warm calls must not count as dispatches. Its
    module is imported if no one has yet (a resume process pre-warms
    before the mapper imports its lazily loaded modules). A method comes
    back unbound (its receiver is the first argument). None when the
    name leads to no marked function."""
    import importlib
    import sys
    if not name.startswith(prefix):
        return None
    parts = name.split(".")
    for i in range(len(parts) - 1, 0, -1):
        mod_name = ".".join(parts[:i])
        mod = sys.modules.get(mod_name)
        if mod is None:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:
                continue
        obj = mod
        for attr in parts[i:]:
            obj = vars(obj).get(attr) if hasattr(obj, "__dict__") \
                else None
            if obj is None:
                break
        while hasattr(obj, "_prof") and hasattr(obj, "_fn"):
            obj = obj._fn                   # a profiler's wrapper
        if obj is not None and callable(obj) and \
                getattr(obj, "__entry_point__", None) is not None:
            return obj
        return None
    return None


class WarmPool:
    """The loaded manifest entries, keyed (function name, signature
    key). It serves no call and installs no wrapper: the warm-up
    pre-warms its entries once on zeros."""

    def __init__(self):
        self._lock = threading.Lock()
        #: {fn_name: {sig_key: signature}}
        self._entries: Dict[str, Dict[str, tuple]] = {}
        self.n_dropped = 0
        #: Always False: kept for JAX's `stats()` shape.
        self.installed = False

    def add(self, fn_name: str, sig_key: str, sig: tuple) -> None:
        with self._lock:
            self._entries.setdefault(fn_name, {})[sig_key] = sig

    def keys_for(self, fn_name: str) -> set:
        with self._lock:
            return set(self._entries.get(fn_name, ()))

    def n_entries(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._entries.values())

    def drop(self, fn_name: str, sig_key: str) -> None:
        with self._lock:
            self._entries.get(fn_name, {}).pop(sig_key, None)
            self.n_dropped += 1

    def clear(self) -> None:
        """Drop every entry (cache_wipe)."""
        with self._lock:
            self._entries = {}

    def stats(self) -> dict:
        with self._lock:
            return {"n_entries": sum(len(v)
                                     for v in self._entries.values()),
                    "n_dropped": self.n_dropped,
                    "installed": self.installed}


class CompileCacheManager:
    """One stack's handle on the warm-restart storage tier."""

    def __init__(self, cfg: ColdStartConfig, root: str,
                 config_json: Optional[str] = None, device=None):
        from jax_mapping_torch.ops import _cuda
        self.cfg = cfg
        self.root = root
        self.config_json = config_json
        self.device = device
        self._lock = threading.Lock()
        self._wipe_refs = 0
        self._counts: Dict[str, int] = {}
        self.enabled = False
        self.fingerprint: Optional[str] = None
        self.pool = WarmPool()
        #: `_cuda.BUILDS` when this manager was made: `status()` reports
        #: the builds since.
        self._builds_at_start = dict(_cuda.BUILDS)

    # -- paths ----------------------------------------------------------------

    @property
    def cuda_dir(self) -> str:
        return os.path.join(self.root, "cuda")

    def aot_dir(self, fingerprint: Optional[str] = None) -> str:
        fp = fingerprint or self.fingerprint or "unknown"
        return os.path.join(self.root, "aot", fp)

    def _count(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + by

    def _wiped(self) -> bool:
        with self._lock:
            return self._wipe_refs > 0

    def _ensure_fingerprint(self) -> str:
        if self.fingerprint is None:
            self.fingerprint = cache_fingerprint(self.config_json,
                                                 self.device)
        return self.fingerprint

    # -- the persistent build cache ------------------------------------------

    def enable(self) -> bool:
        """Point the kernel builds at `<root>/cuda` and copy the loaded
        libraries the cache lacks into it. Failures (an unwritable
        volume) degrade to the default build directory with a
        flight-recorder event; never raise."""
        if self._wiped():
            return False
        from jax_mapping_torch.ops import _cuda
        try:
            self._ensure_fingerprint()
            os.makedirs(self.cuda_dir, exist_ok=True)
            self._scrub_husks(self.root)
            _cuda.set_build_dir(self.cuda_dir)
            self._save_libraries()
        except Exception as e:                      # noqa: BLE001
            self._count("enable_failed")
            flight_recorder.record("compile_cache_degraded",
                                   stage="enable", error=type(e).__name__)
            self.enabled = False
            return False
        self.enabled = True
        flight_recorder.record("compile_cache_enabled",
                               fingerprint=self.fingerprint)
        return True

    def disable(self) -> None:
        """Point the builds back at the package's `_build/` (shutdown, a
        wipe window)."""
        from jax_mapping_torch.ops import _cuda
        _cuda.set_build_dir(None)
        self.enabled = False

    def _scrub_husks(self, d: str) -> int:
        """Delete zero-byte files and nvcc's `*.tmp` outputs (a crash
        mid-build leaves them)."""
        n = 0
        for base, _dirs, files in os.walk(d):
            for f in files:
                p = os.path.join(base, f)
                try:
                    if f.endswith(".tmp") or os.path.getsize(p) == 0:
                        os.unlink(p)
                        n += 1
                except OSError:
                    continue
        if n:
            self._count("husks_scrubbed", n)
            flight_recorder.record("compile_cache_scrub", n=n)
        return n

    def evict_lru(self) -> Tuple[int, int]:
        """Enforce `max_cache_bytes` over the cache root: files beyond
        the budget go oldest-mtime-first. Returns (n_evicted,
        bytes_freed); errors skip the file."""
        budget = self.cfg.max_cache_bytes
        entries = []
        total = 0
        for base, _dirs, files in os.walk(self.root):
            for f in files:
                p = os.path.join(base, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
                total += st.st_size
        if total <= budget:
            return 0, 0
        entries.sort()
        n = freed = 0
        for _mt, size, p in entries:
            if total - freed <= budget:
                break
            try:
                os.unlink(p)
            except OSError:
                continue
            n += 1
            freed += size
        if n:
            self._count("lru_evicted", n)
            flight_recorder.record("compile_cache_evict", n=n,
                                   bytes=freed)
        return n, freed

    # -- the signature manifest ------------------------------------------------

    def save_aot(self, signatures: Dict[str, List[tuple]]) -> dict:
        """Write one manifest file per (entry point, captured signature)
        under the fingerprint directory, and copy the loaded kernel
        libraries into the build cache. A signature with an argument
        that cannot be rebuilt in another process (an `OpaqueSpec`)
        counts as uncallable and is skipped; a failed write counts and
        is skipped. Suppressed while a wipe window holds."""
        report = {"n_saved": 0, "n_failed": 0, "n_uncallable": 0,
                  "n_libraries": 0, "names": []}
        if not self.cfg.aot_snapshots or self._wiped():
            return report
        d = self.aot_dir(self._ensure_fingerprint())
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            report["n_failed"] += 1
            return report
        for fn_name in sorted(signatures):
            for i, sig in enumerate(signatures[fn_name]):
                try:
                    blob = pickle.dumps({
                        "version": _SNAPSHOT_VERSION, "fn": fn_name,
                        "sig_key": signature_key(sig), "sig": sig})
                except (TypeError, pickle.PicklingError, AttributeError):
                    report["n_uncallable"] += 1
                    continue
                safe = fn_name.replace("/", "_")
                path = os.path.join(d, f"{safe}__{i:02d}.aot")
                tmp = path + ".tmp"
                try:
                    with open(tmp, "wb") as f:
                        f.write(blob)
                    os.replace(tmp, path)
                except OSError:
                    report["n_failed"] += 1
                    self._count("aot_save_failed")
                    continue
                report["n_saved"] += 1
                if fn_name not in report["names"]:
                    report["names"].append(fn_name)
        if self.enabled:
            report["n_libraries"] = self._save_libraries()
        self._count("aot_saved", report["n_saved"])
        flight_recorder.record("aot_snapshot_save", n=report["n_saved"],
                               n_failed=report["n_failed"])
        self.evict_lru()
        return report

    def _save_libraries(self) -> int:
        """Copy into the build cache each kernel library this process has
        loaded that the cache lacks (one built before the cache was
        enabled). Only what this process loaded: a library merely lying
        in the package's default build directory may come from another
        process, and would make a cold cache look warm."""
        from jax_mapping_torch.ops import _cuda
        n = 0
        for _name, src in sorted(_cuda.loaded_paths().items()):
            dst = os.path.join(self.cuda_dir, src.name)
            if os.path.exists(dst):
                continue
            tmp = f"{dst}.{os.getpid()}.tmp"
            try:
                shutil.copyfile(src, tmp)
                os.replace(tmp, dst)
                n += 1
            except OSError:
                continue
        if n:
            self._count("libraries_saved", n)
        return n

    def load_aot(self) -> dict:
        """Read every intact manifest file of this fingerprint into the
        pool and return the pre-warm manifest: {"pool_names": [...],
        "signatures": {fn: [sig, ...]}, counters...}. An unreadable or
        wrong-version file counts as corrupt; other fingerprints'
        directories are counted as mismatches and never read."""
        report = {"n_loaded": 0, "n_corrupt": 0, "n_degraded": 0,
                  "n_fingerprint_mismatch": 0,
                  "signatures": {}, "pool_names": []}
        if not self.cfg.aot_snapshots:
            return report
        fp = self._ensure_fingerprint()
        aot_root = os.path.join(self.root, "aot")
        try:
            siblings = sorted(os.listdir(aot_root))
        except OSError:
            siblings = []
        for other in siblings:
            if other != fp and os.path.isdir(os.path.join(aot_root, other)):
                report["n_fingerprint_mismatch"] += 1
        d = self.aot_dir(fp)
        try:
            files = sorted(f for f in os.listdir(d) if f.endswith(".aot"))
        except OSError:
            files = []
        for f in files:
            path = os.path.join(d, f)
            try:
                with open(path, "rb") as fh:
                    entry = pickle.loads(fh.read())
                if not isinstance(entry, dict) or \
                        entry.get("version") != _SNAPSHOT_VERSION:
                    raise ValueError("bad manifest layout")
                fn_name, sig = entry["fn"], entry["sig"]
                key = signature_key(sig)
                if key != entry["sig_key"]:
                    raise ValueError("signature key drifted")
            except Exception:                       # noqa: BLE001
                report["n_corrupt"] += 1
                continue
            try:
                # LRU recency: a manifest is written once and read on
                # every warm restart.
                os.utime(path)
            except OSError:
                pass
            report["signatures"].setdefault(fn_name, []).append(sig)
            self.pool.add(fn_name, key, sig)
            report["n_loaded"] += 1
            if fn_name not in report["pool_names"]:
                report["pool_names"].append(fn_name)
        with self._lock:
            for k in ("n_loaded", "n_corrupt", "n_degraded",
                      "n_fingerprint_mismatch"):
                self._counts["aot_" + k] = \
                    self._counts.get("aot_" + k, 0) + report[k]
        flight_recorder.record(
            "aot_snapshot_load", n=report["n_loaded"],
            n_corrupt=report["n_corrupt"],
            n_degraded=report["n_degraded"],
            n_fingerprint_mismatch=report["n_fingerprint_mismatch"])
        return report

    # -- cache_wipe fault boundary -------------------------------------------

    def wipe_hold(self) -> None:
        """One `cache_wipe` window opens: delete everything under the
        cache root, and build in the package's default `_build/` while
        ANY window holds (refcounted). Loaded libraries stay loaded."""
        with self._lock:
            self._wipe_refs += 1
            self._counts["wipes"] = self._counts.get("wipes", 0) + 1
        self.disable()
        n = 0
        for base, _dirs, files in os.walk(self.root, topdown=False):
            for f in files:
                try:
                    os.unlink(os.path.join(base, f))
                    n += 1
                except OSError:
                    continue
        self._count("files_wiped", n)
        self.pool.clear()
        flight_recorder.record("cache_wipe", n_files=n)

    def wipe_release(self) -> None:
        """One window clears; the LAST one out re-enables the (now
        empty) cache."""
        with self._lock:
            self._wipe_refs = max(0, self._wipe_refs - 1)
            refs = self._wipe_refs
        if refs == 0:
            self.enable()

    # -- export ---------------------------------------------------------------

    def disk_usage_bytes(self) -> int:
        total = 0
        for base, _dirs, files in os.walk(self.root):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(base, f))
                except OSError:
                    continue
        return total

    def status(self) -> dict:
        """The /status `cold_start` export (+ test assertion surface)."""
        from jax_mapping_torch.ops import _cuda
        builds = {"builds": _cuda.BUILDS["built"]
                  - self._builds_at_start["built"],
                  "builds_found": _cuda.BUILDS["found"]
                  - self._builds_at_start["found"]}
        with self._lock:
            counts = dict(self._counts, **builds)
            refs = self._wipe_refs
        return {"enabled": self.enabled,
                "fingerprint": self.fingerprint,
                "root": self.root,
                "wipe_refs": refs,
                "counts": counts,
                "pool": self.pool.stats()}
