"""Build and load the port's CUDA kernels; count their launches.

Each source in `jax_mapping_torch/csrc/` is compiled by `nvcc` into its
own shared library with a plain C interface and loaded with `ctypes`.
Libraries land in `jax_mapping_torch/_build/`, named by a hash of their
source, the shared headers (`csrc/*.cuh`) and the flags, so a checkout
builds each kernel once. Nothing is
built or loaded when this module is imported: the first call that needs
a kernel builds it (or `build_all()` builds every kernel in parallel).
`set_build_dir` points the builds at another directory (the warm-restart
tier's persistent cache, `io/compile_cache.py`); a library already
loaded in the process stays loaded. `BUILDS` counts the libraries nvcc
built and those found already built.

Every wrapper adds to its entry in `LAUNCHES` the number of kernel grids
it launched, and nowhere else, so a caller can reset the counts, drive a
path and read which kernels ran and how often. A kernel with more than
one route (K2 and K3: a cluster launch, or one launch a sweep on large
grids) also adds them to `ROUTES`, by route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR

#: Kernel library name -> source file in csrc/.
SOURCES = {
    "sensor_model": "sensor_model.cu",
    "label_prop": "label_prop.cu",
    "costfield_relax": "costfield_relax.cu",
    "window_fuse": "window_fuse.cu",
    "voxel_model": "voxel_model.cu",
    "match_correlate": "match_correlate.cu",
}

#: nvcc flags. --fmad=false: no multiply-add contraction, so every float
#: operation rounds once, as in PyTorch's eager kernels and the plain
#: versions; never --use_fast_math.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: Kernel name -> launches since the last reset_launches().
LAUNCHES: Dict[str, int] = {
    "sensor_model_delta": 0,
    "sensor_model_raster": 0,
    "label_prop": 0,
    "costfield_relax": 0,
    "window_delta": 0,
    "window_apply": 0,
    "voxel_image": 0,
    "voxel_summed": 0,
    "match_correlate": 0,
}

#: Kernel name -> route ("cluster<C>" or "global") -> launches since the
#: last reset_launches().
ROUTES: Dict[str, Dict[str, int]] = {"label_prop": {},
                                     "costfield_relax": {}}

#: Errors the port's launchers return beside cudaError_t codes
#: (csrc/cluster_sweep.cuh).
OWN_ERRORS = {-2: "no cluster of this size fits on the card "
                  "(cudaOccupancyMaxActiveClusters is 0)"}

#: Library -> kernels of `LAUNCHES` it launches.
KERNELS = {
    "sensor_model": ("sensor_model_delta", "sensor_model_raster"),
    "label_prop": ("label_prop",),
    "costfield_relax": ("costfield_relax",),
    "window_fuse": ("window_delta", "window_apply"),
    "voxel_model": ("voxel_image", "voxel_summed"),
    "match_correlate": ("match_correlate",),
}

#: Libraries nvcc built in this process, and libraries found built.
BUILDS: Dict[str, int] = {"built": 0, "found": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: The cost ledger's per-thread sink (`obs/ledger.py`): kernels launched
#: on this thread while it is set report their bytes and operations.
_cost = threading.local()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

_SENSOR_ARGS = [_I, _F, _F, _F, _F, _F, _I, _I,
                _F, _F, _F, _F, _F, _F, _F]      # sensor_cell::Params
_WINDOW_ARGS = [_P, _P, _I, _P, _P, _I, _I, _I, *_SENSOR_ARGS]
_VOXEL_ARGS = [_P, _P, _P, _P, _I, _I, _I,           # buffers, B, ny, nx
               _I, _I, _I, *[_F] * 17]               # voxel_model Params

#: C signatures: library -> {entry point: argtypes}.
_SIGNATURES = {
    "sensor_model": {"sensor_model_launch":
                     [_I, _P, _P, _P, _P, _I, _I, _I, *_SENSOR_ARGS, _P]},
    "label_prop": {"label_prop_launch":
                   [_P, _P, _P, _P, _I, _I, _I, _IP, _P]},
    "costfield_relax": {"costfield_relax_launch":
                        [_P, _P, _P, _P, _I, _I, _I, _I, _IP, _P]},
    "window_fuse": {"window_delta_launch": [*_WINDOW_ARGS, _P],
                    "window_apply_launch": [*_WINDOW_ARGS, _F, _F, _P]},
    "voxel_model": {"voxel_image_launch": [*_VOXEL_ARGS, _P],
                    "voxel_summed_launch": [*_VOXEL_ARGS, _P]},
    "match_correlate": {
        "match_correlate_dense_launch": [_P] * 5 + [_I] * 8 + [_P],
        "match_correlate_list_launch": [_P] * 8 + [_I] * 6 + [_P]},
}


def count_launch(name: str, n: int = 1, route: Optional[str] = None
                 ) -> None:
    LAUNCHES[name] += n
    if route is not None:
        ROUTES[name][route] = ROUTES[name].get(route, 0) + n


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for r in ROUTES.values():
        r.clear()


def note_cost(name: str, cost) -> None:
    """Report a kernel's work to the cost ledger when one collects on this
    thread: `cost()` gives (bytes, operations), and the sink calls it. A
    launch computes nothing otherwise."""
    sink = getattr(_cost, "sink", None)
    if sink is not None:
        sink(name, cost)


def set_cost_sink(sink) -> None:
    """Install (or with None remove) this thread's cost sink."""
    _cost.sink = sink


def libraries_of(kernels) -> frozenset:
    """The libraries that launch these kernel names."""
    return frozenset(lib for lib, ks in KERNELS.items()
                     if any(k in kernels for k in ks))


def loaded(name: str) -> bool:
    """Whether library `name` is loaded in this process."""
    with _lock:
        return name in _libs


def loaded_paths() -> Dict[str, Path]:
    """Each loaded library's file."""
    with _lock:
        return {n: Path(lib._name) for n, lib in _libs.items()}


def set_build_dir(path=None) -> None:
    """Build and look for libraries under `path` from now on (None: the
    package's `_build/`). Loaded libraries stay loaded."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = Path(path) if path is not None else DEFAULT_BUILD_DIR


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def source_hash(name: str) -> str:
    """Hash of a library's source, the shared headers and NVCC_FLAGS: its
    file name under the build directory."""
    src = (CSRC / SOURCES[name]).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_hash(name)}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (target, Popen or None, temp path)."""
    out = _target(name)
    if out.exists() and out.stat().st_size > 0:
        BUILDS["found"] += 1
        return out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    with open(out.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / SOURCES[name])],
            stdout=log, stderr=subprocess.STDOUT)
    return out, proc, tmp


def _finish_build(name: str, out: Path, proc, tmp) -> None:
    if proc is None:
        return
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name]} (exit {rc}):\n"
            + out.with_suffix(".log").read_text()[-4000:])
    os.replace(tmp, out)
    BUILDS["built"] += 1


def build_all() -> Dict[str, float]:
    """Compile every kernel library, one nvcc per source, all started
    together. Returns seconds per library (0.0 where already built)."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start_build(n) for n in SOURCES}
        secs = {}
        for n, (out, proc, tmp) in started.items():
            _finish_build(n, out, proc, tmp)
            secs[n] = 0.0 if proc is None else time.perf_counter() - t0
        return secs


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for a
    library built in this checkout, or '' when there is none."""
    p = _target(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out, proc, tmp = _start_build(name)
        _finish_build(name, out, proc, tmp)
        lib = ctypes.CDLL(str(out))
        for entry, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def call(name: str, *args, entry: Optional[str] = None) -> None:
    """Call library `name`'s launch entry (`entry`, which a library with
    one entry may leave out) on the current stream; raise if the launch
    reported a CUDA error (the entry returns cudaGetLastError())."""
    if entry is None:
        (entry,) = _SIGNATURES[name]
    fn = getattr(library(name), entry)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, ctypes.c_void_p(stream))
    if rc in OWN_ERRORS:
        raise RuntimeError(f"{entry} failed: {OWN_ERRORS[rc]}")
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")


def check_cuda(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and shape)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def mask_bytes(m: torch.Tensor) -> torch.Tensor:
    """A bool mask as contiguous uint8: a view where it can be (bool and
    uint8 share their bytes), a conversion otherwise."""
    m = m.view(torch.uint8) if m.dtype == torch.bool else m.to(torch.uint8)
    return m.contiguous()


def sweep_call(name: str, *args) -> dict:
    """Launch a cluster-sweep kernel (K2 or K3) with `args` before its
    info array; count its launches by route and return how it ran:
    launches, route ("cluster<C>" or "global"), threads a CTA and the
    clusters the card holds at once."""
    info = (ctypes.c_int * 4)()
    call(name, *args, info)
    route = f"cluster{info[1]}" if info[1] else "global"
    count_launch(name, info[0], route)
    return {"launches": info[0], "route": route, "threads": info[2],
            "clusters_at_once": info[3]}
