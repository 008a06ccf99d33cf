"""Dispatch profiler: device-side performance attribution.

Port of the JAX package's `obs/devprof.py`. The port has no jit, so its
entry points are the functions the package marks with
`_util.entry_point` (the counterparts of the JAX package's jitted ones,
with JAX's static argument names kept beside each mark):

* `DispatchProfiler.install()` walks every module under the package
  prefix (module attributes and the methods of the classes a module
  defines) and rebinds EVERY alias of each marked function to one
  pass-through `_ProfiledFn` wrapper; `uninstall()` restores the sites
  that still hold it.
* Each call records host wall time around the call into a fixed
  log-bucket histogram (`HIST_EDGES_S`) and a call counter. That is the
  host's time a call: the enqueue of its device work plus any host sync
  inside it, not the device's time (no CUDA event and no
  synchronisation on the call's path), as JAX's blocked-on-dispatch
  time is. Each profiled call also runs inside `span(<its name>)`, so a
  `utils.profiling.device_trace` around the stack attributes the
  device's own time to each entry point by launch correlation.
* A "compiled variant" is a new signature key of the function: each
  tensor leaf as (shape, dtype, device), NamedTuples walked by field,
  static arguments by value, a traced Python scalar by its type only
  (`abstract_signature`), as JAX's jit keys its cache. A new key counts
  as a compile (`n_compiles`, `recompiles()`, the
  `jax_mapping_jit_recompiles_total` family) and captures one abstract
  signature, bounded per function — the input of the cost ledger
  (`obs/ledger.py`) and of the staged warm-up (`resilience/warmup.py`).
* A call made while another profiled call is active on the same thread
  is not recorded: in JAX it is traced into its caller (`slam_step`'s
  inner `fuse_scans_masked`, for one), so it counts the way JAX counts
  it.

The signatures this process dispatched are kept process-wide
(`note_dispatch`, `dispatched`, `variant_counts`): the warm-up reads
them to tell an entry point that is already warm, and registers what it
pre-warms, so that `rebaseline()` adopts warmed variants without
counting them as live recompiles — JAX's jit cache, which outlives a
profiler, plays that part there.

`DevProfConfig.enabled=False` builds nothing: no wrapper exists on any
call path. Importing this module imports no torch.

Thread contract: stats mutate only under `_lock`; dispatches arrive from
the mapper tick thread, HTTP workers and test drivers. One profiler may
be installed at a time (`_INSTALL_LOCK`): wrappers are process-global.
"""

from __future__ import annotations

import bisect
import contextlib
import hashlib
import inspect
import sys
import threading
import time
import types
from typing import Dict, List, Optional, Tuple

from jax_mapping_torch.utils.profiling import HIST_EDGES_S, span

#: Process-global install guard: module-attribute rebinding is
#: process-wide, so at most one profiler may be installed at a time.
_INSTALL_LOCK = threading.Lock()
_installed: Optional["DispatchProfiler"] = None

#: Per-thread depth of active profiled calls (the JAX tracing analogue).
_tls = threading.local()

#: {id(fn): (fn, name, {signature key: frozenset of kernel libraries it
#: launched})} — every signature this process dispatched under a profiler
#: or warmed, per function object (as a jit cache is per jitted function).
_SEEN_LOCK = threading.Lock()
_SEEN: Dict[int, tuple] = {}

torch = None                     # bound on first use; see _torch()


def _torch():
    global torch
    if torch is None:
        import torch as _t
        torch = _t
    return torch


# -- signatures ------------------------------------------------------------

class TensorSpec:
    """An abstract tensor leaf: shape, dtype name, device."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype: str, device: str):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.device = device

    def __eq__(self, other):
        return isinstance(other, TensorSpec) and \
            (self.shape, self.dtype, self.device) == \
            (other.shape, other.dtype, other.device)

    def __hash__(self):
        return hash((self.shape, self.dtype, self.device))

    def __repr__(self):
        return f"TensorSpec({self.shape}, {self.dtype!r}, {self.device!r})"

    def __getstate__(self):
        return (self.shape, self.dtype, self.device)

    def __setstate__(self, st):
        self.shape, self.dtype, self.device = st


class ArraySpec(TensorSpec):
    """An abstract numpy array leaf (device "host")."""

    def __init__(self, shape, dtype: str):
        super().__init__(shape, dtype, "host")

    def __repr__(self):
        return f"ArraySpec({self.shape}, {self.dtype!r})"


class ScalarSpec:
    """A traced Python or numpy scalar: keyed by its type only."""

    __slots__ = ("kind",)

    def __init__(self, kind: str):
        self.kind = kind

    def __eq__(self, other):
        return isinstance(other, ScalarSpec) and self.kind == other.kind

    def __hash__(self):
        return hash(("scalar", self.kind))

    def __repr__(self):
        return f"ScalarSpec({self.kind!r})"

    def __getstate__(self):
        return self.kind

    def __setstate__(self, st):
        self.kind = st


class GeneratorSpec(ScalarSpec):
    """A torch.Generator argument: keyed by its device; pre-warms with a
    fresh generator seeded 0."""

    def __repr__(self):
        return f"GeneratorSpec({self.kind!r})"


class OpaqueSpec:
    """Any other object (a method's receiver, say): keyed by its type.
    Holds the live object, so an in-process pre-warm or cost collection
    can call the entry point again (a captured signature keeps it alive;
    captures are bounded per function); it is never written to disk
    (`io/compile_cache.save_aot` skips it)."""

    __slots__ = ("kind", "obj")

    def __init__(self, obj):
        t = type(obj)
        self.kind = f"{t.__module__}.{t.__qualname__}"
        self.obj = obj

    def get(self):
        return self.obj

    def __eq__(self, other):
        return isinstance(other, OpaqueSpec) and self.kind == other.kind

    def __hash__(self):
        return hash(("opaque", self.kind))

    def __repr__(self):
        return f"OpaqueSpec({self.kind!r})"

    def __reduce__(self):
        raise TypeError(f"{self.kind}: an opaque argument is not saved")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _is_config(x) -> bool:
    """A frozen dataclass: the package's configs, static in JAX."""
    params = getattr(type(x), "__dataclass_params__", None)
    return params is not None and params.frozen


def _abs(x, static: bool):
    t = _torch()
    if static or x is None or isinstance(x, (str, t.device, t.dtype)) \
            or _is_config(x):
        return x
    if isinstance(x, t.Tensor):
        return TensorSpec(x.shape, str(x.dtype).replace("torch.", ""),
                          str(x.device))
    if type(x).__module__ == "numpy":
        import numpy as np
        if isinstance(x, np.ndarray):
            return ArraySpec(x.shape, x.dtype.name)
        if isinstance(x, np.generic):
            return ScalarSpec(x.dtype.name)
    if isinstance(x, (bool, int, float)):
        return ScalarSpec(type(x).__name__)
    if isinstance(x, t.Generator):
        return GeneratorSpec(str(x.device))
    if _is_namedtuple(x):
        return type(x)(*[_abs(v, False) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(_abs(v, False) for v in x)
    if isinstance(x, dict):
        return {k: _abs(v, False) for k, v in x.items()}
    return OpaqueSpec(x)


#: id(config) -> (config, hash): configs hash every field, so the fast
#: key reuses one hash per live config object.
_HASHES: Dict[int, tuple] = {}


def _value_key(x):
    try:
        ent = _HASHES.get(id(x))
        if ent is not None and ent[0] is x:
            return ("v", ent[1])
        h = hash(x)
    except TypeError:
        return ("r", repr(x))
    if _is_config(x):
        if len(_HASHES) > 4096:
            _HASHES.clear()
        _HASHES[id(x)] = (x, h)
    return ("v", h)


def _key(x, static: bool):
    """The in-process signature key of one argument: hashable, built
    without a device read."""
    t = torch
    if isinstance(x, t.Tensor):
        return (x.shape, x.dtype, x.device)
    if static or x is None or isinstance(x, str) or _is_config(x):
        return _value_key(x)
    if isinstance(x, (bool, int, float)):
        return type(x)
    if _is_namedtuple(x):
        return (type(x),) + tuple(_key(v, False) for v in x)
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_key(v, False) for v in x)
    if isinstance(x, dict):
        return ("d",) + tuple((k, _key(v, False))
                              for k, v in sorted(x.items()))
    if type(x).__module__ == "numpy":
        return ("a", getattr(x, "shape", ()), x.dtype.str)
    if isinstance(x, t.Generator):
        return ("g", x.device)
    return ("o", type(x))


def _static_flags(params: List[str], static, n_args: int, kwargs) -> tuple:
    pos = tuple(i < len(params) and params[i] in static
                for i in range(n_args))
    kw = {k: k in static for k in kwargs}
    return pos, kw


def abstract_signature(args: tuple, kwargs: dict, params=(),
                       static=()) -> tuple:
    """(args, kwargs) with every tensor leaf replaced by a `TensorSpec`,
    a numpy array by an `ArraySpec`, a traced Python or numpy scalar by a
    `ScalarSpec` and any other object by an `OpaqueSpec`; configs, strings
    and the arguments named in `static` (positional names from `params`)
    pass through by value — the arguments JAX's jit would hold static."""
    pos, kw = _static_flags(list(params), set(static), len(args), kwargs)
    return (tuple(_abs(a, s) for a, s in zip(args, pos)),
            {k: _abs(v, kw[k]) for k, v in sorted(kwargs.items())})


def signature_key(sig: tuple) -> str:
    """The persistent key of an abstract signature: a digest of its
    repr, equal across processes (configs and specs repr the same)."""
    return hashlib.blake2b(repr(sig).encode(), digest_size=8).hexdigest()


def materialize_zeros(sig: tuple, device=None) -> Tuple[tuple, dict]:
    """(args, kwargs) with every abstract leaf made concrete: zeros
    tensors (on the captured device, or on `device` where that is of the
    captured device's type), zeros numpy arrays, zero scalars, a
    generator seeded 0, the live object of an `OpaqueSpec` — the
    pre-warm input: calling an entry point with these takes the route
    the captured live call took, on fresh tensors."""
    t = _torch()
    dev = t.device(device) if device is not None else None

    def place(captured: str):
        return dev if dev is not None and \
            t.device(captured).type == dev.type else captured

    def concrete(x):
        if isinstance(x, ArraySpec):
            import numpy as np
            return np.zeros(x.shape, np.dtype(x.dtype))
        if isinstance(x, TensorSpec):
            return t.zeros(x.shape, dtype=getattr(t, x.dtype),
                           device=place(x.device))
        if isinstance(x, GeneratorSpec):
            g = t.Generator(device=place(x.kind))
            g.manual_seed(0)
            return g
        if isinstance(x, ScalarSpec):
            if x.kind in ("bool", "int", "float"):
                return {"bool": False, "int": 0, "float": 0.0}[x.kind]
            import numpy as np
            return np.dtype(x.kind).type(0)
        if isinstance(x, OpaqueSpec):
            return x.get()
        if _is_namedtuple(x):
            return type(x)(*[concrete(v) for v in x])
        if isinstance(x, (list, tuple)):
            return type(x)(concrete(v) for v in x)
        if isinstance(x, dict):
            return {k: concrete(v) for k, v in x.items()}
        return x

    args, kwargs = sig
    return tuple(concrete(a) for a in args), \
        {k: concrete(v) for k, v in kwargs.items()}


@contextlib.contextmanager
def unprofiled():
    """Calls made inside this block on this thread are not recorded: the
    warm-up's and the cost ledger's own calls of a raw entry point, whose
    inner entry points JAX would trace into them, not dispatch."""
    depth = getattr(_tls, "depth", 0)
    _tls.depth = depth + 1
    try:
        yield
    finally:
        _tls.depth = depth


# -- the process-wide record of dispatched signatures ----------------------

def note_dispatch(fn, name: str, key: str,
                  libraries=frozenset()) -> None:
    """Record that this process dispatched the raw entry point `fn`
    (qualified name `name`) at signature `key`, launching kernels of
    `libraries`."""
    with _SEEN_LOCK:
        ent = _SEEN.get(id(fn))
        if ent is None or ent[0] is not fn:
            ent = _SEEN[id(fn)] = (fn, name, {})
        ent[2][key] = frozenset(libraries)


def dispatched(fn, key: str) -> Optional[frozenset]:
    """The libraries `fn` launched at `key`, or None when this process
    never dispatched that signature."""
    with _SEEN_LOCK:
        ent = _SEEN.get(id(fn))
        return ent[2].get(key) if ent is not None and ent[0] is fn \
            else None


def _seen_keys(fn) -> set:
    with _SEEN_LOCK:
        ent = _SEEN.get(id(fn))
        return set(ent[2]) if ent is not None and ent[0] is fn else set()


def variant_counts() -> Dict[str, int]:
    """Signatures dispatched (or warmed) per entry point in this
    process: the port's counterpart of JAX's per-function compiled-
    variant count."""
    with _SEEN_LOCK:
        out: Dict[str, int] = {}
        for _fn, name, keys in _SEEN.values():
            if keys:
                out[name] = max(out.get(name, 0), len(keys))
        return out


# -- the registry walk -----------------------------------------------------

def entry_sites(prefix: str = "jax_mapping_torch"):
    """{id(fn): (fn, [(owner, attr, qualified name)])} for every marked
    entry point reachable from a module under `prefix`: module
    attributes (from-import aliases included) and the methods of the
    classes each module defines. Wrappers are looked through."""
    from jax_mapping_torch.io.compile_cache import qualified_name
    targets: Dict[int, tuple] = {}

    def visit(owner, attr, fn, mod_name):
        raw = fn
        while hasattr(raw, "_fn") and isinstance(raw, _ProfiledFn):
            raw = raw._fn
        if not callable(raw) or \
                getattr(raw, "__entry_point__", None) is None:
            return
        ent = targets.setdefault(id(raw), (raw, []))
        ent[1].append((owner, attr,
                       qualified_name(raw, mod_name, attr, prefix)))

    for mod_name in sorted(sys.modules):
        mod = sys.modules[mod_name]
        if mod is None or not mod_name.startswith(prefix):
            continue
        for attr, obj in sorted(vars(mod).items()):
            if isinstance(obj, type) and obj.__module__ == mod_name:
                for cattr, cobj in sorted(vars(obj).items()):
                    visit(obj, cattr, cobj, mod_name)
            else:
                visit(mod, attr, obj, mod_name)
    return targets


class _FnProfile:
    """Per-function dispatch accounting; mutated only under the
    profiler's `_lock`."""

    __slots__ = ("name", "count", "total_s", "max_s", "buckets", "fast",
                 "keys", "n_compiles", "signatures")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        #: Per-bucket (non-cumulative) counts over HIST_EDGES_S; [-1] is
        #: overflow — the StageTimer layout.
        self.buckets = [0] * (len(HIST_EDGES_S) + 1)
        #: In-process keys seen (the per-call lookup).
        self.fast: set = set()
        #: Persistent keys of the variants this profile knows: its
        #: compiled-variant count, baseline included.
        self.keys: set = set()
        #: Compile events observed while profiled (a new variant; the
        #: first one counts).
        self.n_compiles = 0
        #: [(key, (abstract_args, abstract_kwargs))] — one per observed
        #: variant, bounded by DevProfConfig.
        self.signatures: List[Tuple[str, tuple]] = []


class _ProfiledFn:
    """Pass-through wrapper for one entry point. Everything but
    `__call__` forwards to the wrapped function (`__name__`,
    `__module__`, `__qualname__`, the entry-point mark), so registry
    walks see the function itself; `__get__` binds it as a method where
    it replaced one."""

    __slots__ = ("_fn", "_prof", "_name", "_params", "_static",
                 "__weakref__")

    def __init__(self, fn, prof: "DispatchProfiler", name: str):
        self._fn = fn
        self._prof = prof
        self._name = name
        try:
            self._params = list(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            self._params = []
        self._static = frozenset(fn.__entry_point__ or ())

    def __call__(self, *args, **kwargs):
        if getattr(_tls, "depth", 0):
            # Inside another profiled call: in JAX this call is traced
            # into its caller, not dispatched.
            return self._fn(*args, **kwargs)
        prof = self._prof
        try:
            params, static = self._params, self._static
            key = (tuple(_key(a, i < len(params) and params[i] in static)
                         for i, a in enumerate(args)),
                   tuple((k, _key(v, k in static))
                         for k, v in sorted(kwargs.items())))
        except Exception:                           # noqa: BLE001
            key = None
        before = prof._launches() if prof._fresh(self._name, key) \
            else None
        _tls.depth = 1
        t0 = time.perf_counter()
        try:
            with span(self._name):
                return self._fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            _tls.depth = 0
            prof._record(self, dt, key, args, kwargs, before)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return types.MethodType(self, obj)

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "_fn"), item)

    # `__module__` and `__doc__` live in every class dict, so instance
    # lookup finds them before __getattr__: forward them explicitly, or
    # a wrapper would report this module as the wrapped function's.
    @property
    def __module__(self):
        return getattr(self._fn, "__module__", None)

    @property
    def __doc__(self):
        return getattr(self._fn, "__doc__", None)

    def __repr__(self) -> str:
        return f"<profiled {self._name}>"


class DispatchProfiler:
    """Wrap the package's entry points; attribute dispatch wall time,
    recompiles and cost-ledger signatures per function."""

    def __init__(self, cfg=None, tracer=None):
        if cfg is None:
            from jax_mapping_torch.config import DevProfConfig
            cfg = DevProfConfig(enabled=True)
        self.cfg = cfg
        self.tracer = tracer
        self._lock = threading.Lock()
        self._profiles: Dict[str, _FnProfile] = {}
        #: [(wrapper, [(owner, attr)])] — the rebind log uninstall
        #: replays. Mutated only during install/uninstall under
        #: `_INSTALL_LOCK`.
        self._bindings: List[Tuple[_ProfiledFn, list]] = []
        self.installed = False
        self._cuda = None

    # -- install / uninstall -------------------------------------------------

    def install(self, prefix: str = "jax_mapping_torch") -> int:
        """Wrap every currently importable entry point under `prefix`;
        returns how many NEW functions were wrapped. May be called again
        after further imports (already-wrapped functions are skipped); a
        second live profiler is refused (wrappers are process-global)."""
        global _installed
        _torch()
        from jax_mapping_torch.ops import _cuda
        self._cuda = _cuda
        with _INSTALL_LOCK:
            if _installed is not None and _installed is not self:
                raise RuntimeError(
                    "another DispatchProfiler is installed — uninstall "
                    "it first (wrappers are process-global)")
            wrapped = {id(w._fn) for w, _ in self._bindings}
            targets = {k: v for k, v in entry_sites(prefix).items()
                       if k not in wrapped}
            for fn, sites in targets.values():
                name = sites[0][2]
                wrapper = _ProfiledFn(fn, self, name)
                for owner, attr, _ in sites:
                    setattr(owner, attr, wrapper)
                self._bindings.append(
                    (wrapper, [(o, a) for o, a, _ in sites]))
                baseline = _seen_keys(fn)
                with self._lock:
                    prof = self._profiles.setdefault(name,
                                                     _FnProfile(name))
                    # Compiles count SINCE install: what this process
                    # dispatched before is its warm state, as JAX's jit
                    # cache sizes are at install.
                    prof.keys |= baseline
            _installed = self
            self.installed = True
            return len(targets)

    def rebaseline(self, names=None) -> int:
        """Adopt every variant this process has dispatched or warmed as
        the recompile baseline, without counting it — the warm-restart
        contract: variants the staged warm-up brought in are cold-start
        repayment, not live recompiles. Returns how many functions moved
        their baseline. `names` limits the sweep."""
        with _INSTALL_LOCK:
            bound = [(w._name, w._fn) for w, _ in self._bindings]
        seen = {n: _seen_keys(fn) for n, fn in bound}
        moved = 0
        with self._lock:
            for name, _fn in bound:
                if names is not None and name not in names:
                    continue
                st = self._profiles.setdefault(name, _FnProfile(name))
                if not seen[name] <= st.keys:
                    st.keys |= seen[name]
                    moved += 1
        return moved

    def uninstall(self) -> None:
        """Restore the original function at every site that still holds
        our wrapper (a site reassigned since install is left alone).
        Idempotent."""
        global _installed
        with _INSTALL_LOCK:
            for wrapper, sites in self._bindings:
                for owner, attr in sites:
                    if vars(owner).get(attr) is wrapper:
                        setattr(owner, attr, wrapper._fn)
            self._bindings = []
            if _installed is self:
                _installed = None
            self.installed = False

    # -- recording (any thread) ----------------------------------------------

    def _fresh(self, name: str, key) -> bool:
        """Whether `key` is a variant this profile has not seen."""
        if key is None:
            return True
        with self._lock:
            st = self._profiles.get(name)
            return st is None or key not in st.fast

    def _launches(self) -> dict:
        return dict(self._cuda.LAUNCHES)

    def _record(self, wrapper: _ProfiledFn, dt_s: float, key,
                args: tuple, kwargs: dict, before) -> None:
        with self._lock:
            st = self._profiles.setdefault(wrapper._name,
                                           _FnProfile(wrapper._name))
            st.count += 1
            st.total_s += dt_s
            st.max_s = max(st.max_s, dt_s)
            st.buckets[bisect.bisect_left(HIST_EDGES_S, dt_s)] += 1
            known = key is not None and key in st.fast
        if not known:
            self._new_variant(wrapper, key, args, kwargs, before)
        if self.cfg.trace_spans and self.tracer is not None:
            self.tracer.emit(f"device:{wrapper._name}")

    def _new_variant(self, wrapper, key, args, kwargs, before) -> None:
        """A key this profile had not seen: abstract the arguments (off
        the lock), then count a compile unless the persistent key is in
        the baseline."""
        try:
            sig = abstract_signature(args, kwargs, wrapper._params,
                                     wrapper._static)
            pkey = signature_key(sig)
        except Exception:                           # noqa: BLE001
            return                                  # unabstractable
        libs = frozenset()
        if before is not None:
            after = self._launches()
            libs = self._cuda.libraries_of(
                [k for k, v in after.items() if v > before.get(k, 0)])
        note_dispatch(wrapper._fn, wrapper._name, pkey, libs)
        with self._lock:
            st = self._profiles[wrapper._name]
            if key is not None:
                st.fast.add(key)
            if pkey in st.keys:
                return
            st.keys.add(pkey)
            st.n_compiles += 1
            if self.cfg.capture_signatures and \
                    len(st.signatures) < self.cfg.max_signatures_per_fn:
                st.signatures.append((pkey, sig))

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """Per-function dispatch accounting for `/status` `perf` (only
        functions actually dispatched)."""
        with self._lock:
            return {
                name: {
                    "count": st.count,
                    "total_ms": round(st.total_s * 1e3, 3),
                    "mean_ms": round(st.total_s * 1e3
                                     / max(st.count, 1), 3),
                    "max_ms": round(st.max_s * 1e3, 3),
                    "compiled_variants": len(st.keys),
                    "n_compiles": st.n_compiles,
                    "n_signatures": len(st.signatures),
                } for name, st in sorted(self._profiles.items())
                if st.count > 0
            }

    def histograms(self) -> Dict[str, dict]:
        """Per-function fixed log-bucket dispatch histograms — the
        `jax_mapping_device_dispatch_seconds` family source: host time a
        call (the enqueue plus any sync inside), not device time."""
        with self._lock:
            return {
                name: {
                    "edges_s": HIST_EDGES_S,
                    "buckets": list(st.buckets),
                    "sum_s": st.total_s,
                    "count": st.count,
                } for name, st in sorted(self._profiles.items())
                if st.count > 0
            }

    def recompiles(self) -> Dict[str, int]:
        """Compile events per function while profiled — the
        `jax_mapping_jit_recompiles_total{fn=...}` source (every
        profiled function reports, 0 included)."""
        with self._lock:
            return {name: st.n_compiles
                    for name, st in sorted(self._profiles.items())}

    def signatures(self) -> Dict[str, List[tuple]]:
        """Captured abstract signatures per function (ledger and warm-up
        input)."""
        with self._lock:
            return {name: [sig for _, sig in st.signatures]
                    for name, st in self._profiles.items()
                    if st.signatures}

    def raw_fn(self, name: str):
        """The unwrapped function for `name`, or None — the ledger and
        the warm-up call through it, so their calls are not dispatches."""
        with _INSTALL_LOCK:
            for wrapper, _ in self._bindings:
                if wrapper._name == name:
                    return wrapper._fn
        return None

    def memory_stats(self) -> Optional[Dict[str, dict]]:
        """The card's allocator watermarks per CUDA device, or None when
        no CUDA device is initialised (the CPU) or the knob is off.
        `bytes_in_use` and `peak_bytes_in_use` are the caching
        allocator's allocated bytes (current and peak), `bytes_limit` the
        device's total memory; JAX's `largest_alloc_size` has no torch
        counterpart and is left out. Host-side reads: no sync."""
        if not self.cfg.memory_stats:
            return None
        t = _torch()
        if not t.cuda.is_available() or not t.cuda.is_initialized():
            return None
        out: Dict[str, dict] = {}
        for i in range(t.cuda.device_count()):
            ms = t.cuda.memory_stats(i)
            if not ms:
                continue
            out[f"cuda:{i}"] = {
                "bytes_in_use": int(ms.get("allocated_bytes.all.current",
                                           0)),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak",
                                                0)),
                "bytes_limit": int(t.cuda.get_device_properties(i)
                                   .total_memory)}
        return out or None
