"""Cost ledger: FLOPs and bytes per entry point per compiled variant.

Port of the JAX package's `obs/ledger.py`. JAX reads XLA's static cost
model (`lowered.compile().cost_analysis()`); the port has no compiler to
ask, so `collect()` runs each captured signature's entry point once, on
zeros (`devprof.materialize_zeros`), and counts what it does:

* every aten op through a `TorchDispatchMode`: the bytes of its tensor
  inputs and outputs, and its FLOPs from `torch.utils.flop_counter` for
  products and convolutions, one per output element otherwise (views
  and allocations move nothing);
* the port's own kernels, which are ctypes calls that the mode cannot
  see, by their shape arithmetic: each wrapper reports its kernel's
  bytes (each input read once, each output written once) and operations
  (`sensor_model_cost` ... `match_correlate_cost` below) to this thread's
  sink (`ops/_cuda.note_cost`). `chip_smoke.py` computes its `bound`
  column from the same functions. On the CPU a wrapper runs its plain
  version, whose aten ops the mode counts instead.

The numbers are eager op-by-op counts, not XLA's fused counts: a
temporary that XLA keeps in registers is written and read here. They
are comparable between variants and runs of the port, not with JAX's.

Collection is explicit (the CLI `python -m jax_mapping_torch.obs
cost-ledger`, tests, the smoke): an HTTP handler never collects.
`cross_check()` holds the result to the port's copy of the JAX compile
budget (`analysis/compile_budget.json`: JAX's names mapped to the port's,
JAX's maxima and notes), read through `analysis/compilebudget.py`, which
also holds the canonical scenario `run_cost_ledger` drives (as the JAX
package's `obs/ledger.py` reads `analysis/`).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from jax_mapping_torch.analysis.compilebudget import (
    Budget, default_budget_path, measure_scenario)

#: Float operations of the sensor model on one cell within max range of a
#: scan (the function's work there, whatever a kernel culls; the cells are
#: counted by `sensor_kernel.model_cells`): cell centre (6), offsets and
#: range with its square root (5), the atan2 polynomial with its octant
#: reduction (30), the [0, 2pi) wrap and beam rounding (7), classification
#: (7).
K1_OPS_PER_CELL = 55

#: Float operations (arithmetic and comparisons) the voxel model needs,
#: per image. Per voxel column of the region: the cell centre (6),
#: offsets (2), camera x and z (6), the in-front test and select (2), u
#: and its rounding (4), the u range test (2), the squared distance in the
#: plane (3) and its horizon test (1); a column that is behind the camera,
#: outside the image or beyond the horizon is then all zeros. Per z layer:
#: the layer centre (3), camera y (1), fy * y (1) and its square (1). Per
#: voxel the model may make non-zero (in front, inside the image in u and
#: v, within the horizon: `voxel_kernel.model_voxel_mask`; every other
#: voxel is 0 by the model's mask): v's division, offset and rounding (3),
#: the v range test (2), the squared distance (1) and horizon test (1),
#: the depth tests (2), the carve limit (2), free (2), occupied (4), the
#: selects (2).
VOXEL_COLUMN_OPS = 26
VOXEL_LAYER_OPS = 6
VOXEL_OPS = 19


# -- the kernels' arithmetic -------------------------------------------------

def sensor_model_cost(grid_cfg, scan_cfg, ranges, poses, origins
                      ) -> Tuple[int, int]:
    """K1 (deltas or rasters) on B scans: (bytes, operations). Reads the
    ranges, poses and origins, writes B (P, P) f32 patches; 55 operations
    per cell within max range."""
    from jax_mapping_torch.ops import sensor_kernel as SK
    B, nb = ranges.shape
    P = grid_cfg.patch_cells
    cells = SK.model_cells(grid_cfg, poses, origins)
    return B * (nb * 4 + 12 + 8 + P * P * 4), cells * K1_OPS_PER_CELL


def _window_cells(grid_cfg, ranges, poses, origin):
    from jax_mapping_torch.ops import sensor_kernel as SK
    B, nb = ranges.shape
    origins = origin.reshape(1, 2).expand(B, 2)
    return SK.model_cells(grid_cfg, poses, origins), B * (nb * 4 + 12) + 8


def window_delta_cost(grid_cfg, scan_cfg, ranges, poses, origin
                      ) -> Tuple[int, int]:
    """K4: B scans' deltas summed on one shared patch. Writes one (P, P)
    patch; the model and the add per scan and cell within range."""
    P = grid_cfg.patch_cells
    cells, tables = _window_cells(grid_cfg, ranges, poses, origin)
    return tables + P * P * 4, cells * (K1_OPS_PER_CELL + 1)


def window_apply_cost(grid_cfg, scan_cfg, ranges, poses, origin
                      ) -> Tuple[int, int]:
    """K5: K4's sum added into the grid's patch and clipped, in place:
    the patch read and written, 3 operations a patch cell on top."""
    P = grid_cfg.patch_cells
    cells, tables = _window_cells(grid_cfg, ranges, poses, origin)
    return (tables + 2 * P * P * 4,
            cells * (K1_OPS_PER_CELL + 1) + 3 * P * P)


def label_prop_cost(mask, sweeps: int) -> Tuple[int, int]:
    """K2 on (n, n) or (T, n, n) grids: the mask (1 byte), the seeds and
    the labels (4 each) a cell; 9 operations a cell a sweep."""
    n = mask.shape[-1]
    T = mask.numel() // (n * n)
    return T * n * n * (1 + 4 + 4), T * sweeps * n * n * 9


def relax_cost(mask, init, sweeps: int) -> Tuple[int, int]:
    """K3: F fields under M masks of (n, n); each mask read once, each
    field read and written once; 8 adds, 8 mins and a select a cell of
    every field a sweep."""
    n = init.shape[-1]
    fields = init.numel() // (n * n)
    masks = mask.numel() // (n * n)
    return n * n * (masks + 2 * 4 * fields), 17 * fields * sweeps * n * n


def voxel_ops(vox, cam, poses, origins, ny: int, nx: int,
              group: int) -> Tuple[int, dict]:
    """The operations the voxel model needs on B images over a (ny, nx)
    region (its live voxels', not a kernel's), and the cull's counts
    from the kernels' plain mirrors (`voxel_kernel.cull_counts`)."""
    from jax_mapping_torch.ops import voxel_kernel as VK
    c = VK.cull_counts(vox, cam, VK.pose_table(poses), origins, ny, nx,
                       group=group)
    B, Z = int(poses.shape[0]), vox.size_z_cells
    per_voxel = VOXEL_OPS + (group > 1)      # K7 adds each into its sum
    return (B * ny * nx * VOXEL_COLUMN_OPS + B * Z * VOXEL_LAYER_OPS
            + c["model_voxels"] * per_voxel), c


def _image_bytes(cam) -> int:
    """One depth image (f32), its pose row (4 f32) and origin (2 i32)."""
    return cam.height_px * cam.width_px * 4 + 16 + 8


def voxel_image_bytes(vox, cam, B: int) -> int:
    """K6's bytes: B images read, B (Z, P, P) f32 patches written."""
    Z, P = vox.size_z_cells, vox.patch_cells
    return B * (Z * P * P * 4 + _image_bytes(cam))


def voxel_summed_bytes(vox, cam, B: int, ny: int, nx: int) -> int:
    """K7's bytes: B images read, one (Z, ny, nx) f32 sum written."""
    return vox.size_z_cells * ny * nx * 4 + B * _image_bytes(cam)


def voxel_image_cost(vox, cam, poses, origins) -> Tuple[int, int]:
    """K6: B images' (Z, P, P) deltas, one patch each."""
    P = vox.patch_cells
    ops, _ = voxel_ops(vox, cam, poses, origins, P, P, group=1)
    return voxel_image_bytes(vox, cam, int(poses.shape[0])), ops


def voxel_summed_cost(vox, cam, poses, origins, ny: int, nx: int
                      ) -> Tuple[int, int]:
    """K7: B images summed over a (Z, ny, nx) region."""
    from jax_mapping_torch.ops import voxel_kernel as VK
    ops, _ = voxel_ops(vox, cam, poses, origins, ny, nx,
                       group=VK.Z_CHUNK)
    return voxel_summed_bytes(vox, cam, int(poses.shape[0]), ny, nx), ops


def match_correlate_cost(rasters, field, n_scores: int,
                         index_bytes: int = 0) -> Tuple[int, int]:
    """K8: n_scores dot products of a (P, P) raster with a P x P window
    of its row's field. Reads the (R, A, P, P) rasters, the (R, H, W)
    fields, the row masses and any candidate indices once, writes the
    scores; a multiply and an add a cell a score (the function's work,
    whatever zero products the kernel leaves out)."""
    R, A, P, _ = rasters.shape
    H, W = field.shape[-2], field.shape[-1]
    return (4 * (R * A * P * P + R * H * W + R + n_scores) + index_bytes,
            2 * P * P * n_scores)


# -- counting aten ops ---------------------------------------------------------

def _counting_mode():
    """A TorchDispatchMode that sums each op's bytes and FLOPs (built on
    first use: importing this module imports no torch)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    class Counting(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.n_ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            if func.is_view or name.startswith("empty") or \
                    name in ("detach", "alias", "lift_fresh",
                             "_local_scalar_dense"):
                return out
            self.n_ops += 1
            self.bytes += nbytes((args, kwargs)) + nbytes(out)
            count = flop_registry.get(func.overloadpacket)
            if count is not None:
                try:
                    self.flops += float(count(*args, **kwargs,
                                              out_val=out))
                    return out
                except Exception:                   # noqa: BLE001
                    pass
            self.flops += float(sum(t.numel() for t in tree_leaves(out)
                                    if isinstance(t, torch.Tensor)))
            return out

    return Counting()


def _measure_call(fn, args, kwargs) -> dict:
    """Run fn(*args, **kwargs) once under the counting mode with this
    thread's kernel sink: FLOPs, bytes, aten ops, kernels."""
    from torch.utils._python_dispatch import _disable_current_modes

    from jax_mapping_torch.ops import _cuda
    kernels: Dict[str, dict] = {}

    def sink(name, cost):
        # The arithmetic's own reads (model_cells, the cull's mirror) are
        # the ledger's, not the function's: outside the mode.
        with _disable_current_modes():
            n_bytes, n_ops = cost()
        k = kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                      "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += float(n_ops)
        k["bytes"] += float(n_bytes)

    from jax_mapping_torch.obs.devprof import unprofiled
    mode = _counting_mode()
    _cuda.set_cost_sink(sink)
    try:
        with unprofiled(), mode:
            fn(*args, **kwargs)
    finally:
        _cuda.set_cost_sink(None)
    return {"flops": mode.flops + sum(k["flops"] for k in kernels.values()),
            "bytes_accessed": mode.bytes + sum(k["bytes"]
                                               for k in kernels.values()),
            "aten_ops": mode.n_ops, "kernels": kernels}


class CostLedger:
    """FLOPs and bytes per (entry point, compiled variant), fed by a
    DispatchProfiler's captured signatures."""

    def __init__(self, profiler):
        self.profiler = profiler
        self._lock = threading.Lock()
        #: ONE keyed structure, {fn_name: {signature key: entry}} — an
        #: entry of None marks a reservation whose (slow, unlocked) run is
        #: in flight. One field on purpose: a separate done-set beside an
        #: entry list would be a correlated pair readable across two lock
        #: sections (the C2 tear class).
        self._collected: Dict[str, Dict[str, Optional[dict]]] = {}

    # -- collection (explicit, expensive) -------------------------------------

    def collect(self) -> Dict[str, List[dict]]:
        """Run every captured-but-uncollected signature once on zeros and
        record its cost. Returns the full ledger. Failures record an
        `error` entry instead of raising."""
        from jax_mapping_torch.obs.devprof import signature_key
        sigs = self.profiler.signatures()
        for name, variants in sorted(sigs.items()):
            fn = self.profiler.raw_fn(name)
            if fn is None:
                continue
            for sig in variants:
                key = signature_key(sig)
                with self._lock:
                    slot = self._collected.setdefault(name, {})
                    if key in slot:
                        continue
                    # Reserve (None) before the unlocked run so a
                    # concurrent collect never runs the same variant
                    # twice.
                    slot[key] = None
                entry = self._collect_one(fn, sig)
                with self._lock:
                    self._collected[name][key] = entry
        return self.snapshot()

    @staticmethod
    def _collect_one(fn, sig) -> dict:
        from jax_mapping_torch.obs.devprof import materialize_zeros
        entry = {"signature": _sig_label(sig)}
        try:
            args, kwargs = materialize_zeros(sig)
            entry.update(_measure_call(fn, args, kwargs))
        except Exception as e:                      # noqa: BLE001
            entry["error"] = f"{type(e).__name__}: {e}"
        return entry

    # -- export ----------------------------------------------------------------

    def snapshot(self) -> Dict[str, List[dict]]:
        with self._lock:
            return {
                name: [dict(e) for e in slots.values()
                       if e is not None]
                for name, slots in sorted(self._collected.items())
                if any(e is not None for e in slots.values())}

    def n_uncollected(self) -> int:
        """Captured signatures with no FINISHED ledger entry yet
        (in-flight reservations count)."""
        from jax_mapping_torch.obs.devprof import signature_key
        sigs = self.profiler.signatures()
        with self._lock:
            return sum(
                1 for name, variants in sigs.items()
                for sig in variants
                if self._collected.get(name, {}).get(signature_key(sig))
                is None)

    # -- the budget cross-check -------------------------------------------------

    def cross_check(self, budget_path: Optional[str] = None
                    ) -> List[str]:
        """Violations against the compile budget: a budgeted function
        with no ledger coverage, a costed variant count EXCEEDING the
        budget, or coverage without FLOPs/bytes. Empty list = clean."""
        budget = Budget.load(budget_path or default_budget_path())
        entries = self.snapshot()
        recompiles = self.profiler.recompiles()
        out: List[str] = []
        for e in budget.entries:
            name = e["name"]
            got = entries.get(name)
            if not got:
                out.append(f"{name}: budgeted but no cost-ledger "
                           "coverage (never dispatched under the "
                           "profiler, or signature capture missed it)")
                continue
            if len(got) > e["max"]:
                out.append(f"{name}: {len(got)} costed variant(s) "
                           f"exceeds budget {e['max']}")
            bad = [v for v in got if "flops" not in v
                   or "bytes_accessed" not in v]
            for v in bad:
                out.append(f"{name}: variant {v['signature']} has no "
                           f"FLOPs/bytes ({v.get('error', 'missing')})")
            observed = recompiles.get(name, 0)
            if observed > e["max"]:
                out.append(f"{name}: profiler observed {observed} "
                           f"compile(s), budget allows {e['max']}")
        return out


def _sig_label(sig) -> str:
    """Compact human-readable variant label: tensor leaves as
    shape:dtype, everything else by type name."""
    from jax_mapping_torch.obs.devprof import ScalarSpec, TensorSpec
    args, kwargs = sig

    def leaf(x):
        if isinstance(x, TensorSpec):
            dims = "x".join(map(str, x.shape)) or "scalar"
            return f"{dims}:{x.dtype}"
        if isinstance(x, ScalarSpec):
            return x.kind
        return type(x).__name__

    def walk(x):
        if isinstance(x, tuple) and hasattr(type(x), "_fields"):
            return type(x).__name__ + "(" + ",".join(
                walk(v) for v in x) + ")"
        if isinstance(x, (list, tuple)):
            return "(" + ",".join(walk(v) for v in x) + ")"
        if isinstance(x, dict):
            return "{" + ",".join(f"{k}={walk(v)}"
                                  for k, v in sorted(x.items())) + "}"
        return leaf(x)

    label = walk(args)
    if kwargs:
        label += walk(kwargs)
    return label


def import_all() -> None:
    """Import every submodule of the port, so that lazily imported entry
    points exist before a profiler installs."""
    import importlib
    import pkgutil

    import jax_mapping_torch
    for m in pkgutil.walk_packages(jax_mapping_torch.__path__,
                                   prefix="jax_mapping_torch."):
        if m.name.endswith("__main__"):
            continue
        try:
            importlib.import_module(m.name)
        except Exception:                           # noqa: BLE001
            continue


def run_cost_ledger(analysis_cfg=None, device="cuda"):
    """Drive the canonical scenario with a DispatchProfiler installed and
    return `(measured, profiler, ledger)` with the ledger collected — the
    machinery behind `python -m jax_mapping_torch.obs cost-ledger`."""
    import_all()
    from jax_mapping_torch.config import DevProfConfig
    from jax_mapping_torch.obs.devprof import DispatchProfiler

    profiler = DispatchProfiler(DevProfConfig(
        enabled=True, max_signatures_per_fn=16))
    profiler.install()
    try:
        measured = measure_scenario(profiler, analysis_cfg, device)
        ledger = CostLedger(profiler)
        ledger.collect()
    finally:
        profiler.uninstall()
    return measured, profiler, ledger
