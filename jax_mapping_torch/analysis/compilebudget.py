"""Entry-point variant budget — the dynamic half of C4.

The counterpart of the JAX package's `analysis/compilebudget.py`. The
static C4 checker catches *syntactic* churn (unbucketed slices and static
arguments at entry-point call sites); whatever it cannot see — batches
stacked from lists, shapes that depend on thread timing, config drift —
shows up at runtime as dispatch variants. The port's dispatch profiler
(`obs/devprof.py`) keys a variant of an entry point by its static values
and its tensors' shapes, as XLA keys a compiled program; a variant is
where the card builds new kernel configurations, workspaces and cuDNN
plans. This module pins them: every entry point reports its variant count
after a canonical deterministic scenario (`measure_scenario`, on
`config.AnalysisConfig`), and the committed `analysis/compile_budget.json`
is the ratchet (JAX's budget on the port's names, JAX's maxima and notes):

* `--check` runs the scenario and fails if any entry point minted MORE
  variants than budgeted — a recompile regression;
* a budget entry whose entry point no longer exists or no longer
  dispatches in the scenario is *stale* and fails the check;
* entries above 1 variant carry a `note` explaining which shapes are
  expected (pow2 buckets, window-vs-single paths).

    python -m jax_mapping_torch.analysis.compilebudget --measure
    python -m jax_mapping_torch.analysis.compilebudget --check
    python -m jax_mapping_torch.analysis.compilebudget --write-budget

Exit 0 clean / 1 violations / 2 error (an unreadable budget, a failed
scenario, or `--device cuda` — the default — without a card: the port
never falls back to the CPU on its own; pass `--device cpu`). `-o FILE`
writes the measured counts and the violations as JSON. The cost ledger's
coverage of the budget is checked by `python -m jax_mapping_torch.obs
cost-ledger --budget`. The scenario is meant for a fresh process: the
variants a process already holds count too.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Tuple


def default_budget_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "compile_budget.json")


# -- measurement -------------------------------------------------------------

def measure_scenario(profiler, analysis_cfg=None, device="cuda"
                     ) -> Dict[str, int]:
    """Run the canonical deterministic scenario with `profiler` installed
    and return the variants each entry point compiled while profiled
    (JAX's `measure_scenario`, on `AnalysisConfig`'s budget defaults): a
    2-robot tiny stack on plank_course(96) for 16
    steps, a map publish and two serving refreshes, bucketed fuses at
    B = 3, 5, 6, megabatch steps at the tenant counts (3, 5, 6) on
    micro_config, and the windowed world's fuse, shift and shift back.
    Meant for a fresh process, as JAX's is for cold jit caches."""
    import dataclasses

    import numpy as np
    import torch

    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import (AnalysisConfig, micro_config,
                                          tiny_config)
    from jax_mapping_torch.models import fleet as FM
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.sim import world as W
    from jax_mapping_torch.tenancy import megabatch as MBT
    from jax_mapping_torch.world.store import WorldStore

    a = analysis_cfg or AnalysisConfig()
    dev = torch.device(device)
    cfg = tiny_config(n_robots=a.budget_n_robots)
    world = W.plank_course(a.budget_world_cells, cfg.grid.resolution_m,
                           n_planks=4, seed=a.budget_seed)
    st = launch_sim_stack(cfg, world, n_robots=a.budget_n_robots,
                          http_port=0, realtime=False,
                          seed=a.budget_seed, device=dev)
    try:
        st.brain.start_exploring()
        st.run_steps(a.budget_steps)
        st.mapper.publish_map()
        # Serving-side work (gray, pyramid, tile hashes) runs on refresh:
        # two refreshes take the first-install and the diff paths.
        if st.api is not None and st.api.serving is not None \
                and st.api.serving.map_store is not None:
            st.api.serving.map_store.refresh()
            st.api.serving.map_store.refresh()
        # Bucketed fuses: B = 5 and 6 share the 6-bucket, 3 has its own —
        # two variants of `fuse_scans_masked`; a third is a bucketing
        # regression.
        gcfg, scfg = cfg.grid, cfg.scan
        gr = G.empty_grid(gcfg, dev)
        for nb in (3, 5, 6):
            G.fuse_scans_bucketed(
                gcfg, scfg, gr,
                torch.ones((nb, scfg.padded_beams), dtype=torch.float32,
                           device=dev),
                torch.zeros((nb, 3), dtype=torch.float32, device=dev))
        # Tenant buckets: one variant of `megabatch_step` per bucket.
        mcfg = micro_config()
        mworld = torch.as_tensor(W.empty_arena(
            mcfg.grid.size_cells, mcfg.grid.resolution_m), device=dev)
        mstate = FM.init_fleet_state(mcfg, device=dev,
                                     generator=torch.Generator(
                                         ).manual_seed(0))
        for nt in a.budget_tenant_counts:
            b = MBT.make_tenant_batch([mstate] * nt, [mworld] * nt,
                                      [0] * nt)
            # The wheel noise is drawn on the host (a CPU generator).
            MBT.megabatch_step(mcfg, b, mcfg.grid.resolution_m,
                               generator=torch.Generator().manual_seed(0))
        # The windowed world: one fuse at global coordinates, a shift
        # with a content-bearing leaving band (extract), a shift back
        # (host-hit rehydrate = scatter), a prefetch poll.
        wcfg = cfg.replace(
            grid=dataclasses.replace(cfg.grid, size_cells=768),
            world=dataclasses.replace(cfg.world, windowed=True,
                                      window_tiles=4, margin_tiles=1))
        wstore = WorldStore(wcfg)
        win = G.empty_grid(wstore.cfg.grid, dev)
        win = wstore.fuse_scan_global(
            win, np.full((cfg.scan.padded_beams,), 1.0, np.float32),
            np.zeros((3,), np.float32))
        win = wstore.shift(win, 2, 2)
        win = wstore.shift(win, -2, -2)
        win, _ = wstore.poll_prefetch(win)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wstore.close()
    finally:
        st.shutdown()
    return {k: v for k, v in profiler.recompiles().items() if v > 0}


# -- the budget --------------------------------------------------------------

class Budget:
    def __init__(self, entries: List[dict]):
        self.entries = list(entries)
        self.by_name = {e["name"]: e for e in self.entries}

    @classmethod
    def load(cls, path: str) -> "Budget":
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != 1:
            raise ValueError(f"{path}: unsupported budget version "
                             f"{data.get('version')!r}")
        return cls(data.get("budgets", []))

    def check(self, measured: Dict[str, int]
              ) -> Tuple[List[str], List[str], List[str]]:
        """(over_budget, unknown, stale) violation descriptions."""
        over, unknown = [], []
        for name, count in sorted(measured.items()):
            e = self.by_name.get(name)
            if e is None:
                unknown.append(
                    f"{name}: compiled {count} variant(s) but has no "
                    "budget entry — run --write-budget and justify any "
                    "entry above 1 with a note")
            elif count > e["max"]:
                over.append(
                    f"{name}: {count} compiled variant(s) exceeds "
                    f"budget {e['max']} — recompile regression (bucket "
                    "the offending shape, or raise the budget WITH a "
                    "note in compile_budget.json)")
        stale = [
            f"{e['name']}: budgeted {e['max']} but never compiled in "
            "the canonical scenario — stale entry, ratchet it out"
            for e in self.entries if e["name"] not in measured]
        return over, unknown, stale

    @staticmethod
    def dump(measured: Dict[str, int], path: str,
             notes: Optional[Dict[str, str]] = None) -> None:
        entries = []
        for name in sorted(measured):
            e = {"name": name, "max": measured[name]}
            note = (notes or {}).get(name)
            if note:
                e["note"] = note
            entries.append(e)
        with open(path, "w") as f:
            json.dump({"version": 1, "budgets": entries}, f, indent=1)
            f.write("\n")


# -- CLI ---------------------------------------------------------------------

def _measure(device: str) -> Dict[str, int]:
    """The scenario under a fresh dispatch profiler."""
    from jax_mapping_torch.config import DevProfConfig
    from jax_mapping_torch.obs import ledger as L
    from jax_mapping_torch.obs.devprof import DispatchProfiler
    L.import_all()
    profiler = DispatchProfiler(DevProfConfig(enabled=True))
    profiler.install()
    try:
        return measure_scenario(profiler, device=device)
    finally:
        profiler.uninstall()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m jax_mapping_torch.analysis.compilebudget",
        description="entry-point variant budget (ratcheted like "
                    "analysis/baseline.json)")
    p.add_argument("--budget", default=None, metavar="JSON")
    p.add_argument("--device", default="cuda",
                   help="where the scenario runs (default: cuda)")
    p.add_argument("-o", "--out", default=None, metavar="JSON",
                   help="write the measured counts and violations here")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--measure", action="store_true",
                   help="run the canonical scenario, print counts")
    g.add_argument("--write-budget", action="store_true",
                   help="regenerate the budget file (notes preserved)")
    g.add_argument("--check", action="store_true",
                   help="gate: exit 0 clean / 1 violations / 2 error")
    args = p.parse_args(argv)
    path = args.budget or default_budget_path()

    # Budget-file preflight BEFORE the scenario: a missing or corrupt
    # budget refuses at once, not after a stack drive it would discard.
    budget = None
    notes: Dict[str, str] = {}
    if args.check:
        try:
            budget = Budget.load(path)
        except (OSError, ValueError) as e:
            print(f"compilebudget: {e}", file=sys.stderr)
            return 2
    elif args.write_budget and os.path.exists(path):
        try:
            notes = {e["name"]: e["note"]
                     for e in Budget.load(path).entries if e.get("note")}
        except (OSError, ValueError) as e:
            print(f"compilebudget: {path}: {e} — refusing to "
                  "overwrite what cannot be merged", file=sys.stderr)
            return 2

    try:
        from jax_mapping_torch._util import resolve_device
        device = str(resolve_device(args.device))
        # The stack logs bring-up lines to stdout; push them to stderr so
        # --measure's stdout is exactly one JSON document.
        import contextlib
        with contextlib.redirect_stdout(sys.stderr):
            measured = _measure(device)
    except Exception as e:              # noqa: BLE001
        print(f"compilebudget: scenario failed: {e}", file=sys.stderr)
        return 2

    if args.measure:
        print(json.dumps(measured, indent=1, sort_keys=True))
        violations: List[str] = []
    elif args.write_budget:
        Budget.dump(measured, path, notes=notes)
        print(f"wrote {len(measured)} budget(s) to {path}")
        violations = []
    else:
        over, unknown, stale = budget.check(measured)
        violations = over + unknown + stale
        for line in violations:
            print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device, "measured": measured,
                       "violations": violations}, f, indent=1,
                      sort_keys=True)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
