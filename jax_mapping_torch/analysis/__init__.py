"""The port's static and dynamic correctness tier.

The counterpart of the JAX package's `analysis/`, on the port's code and
with each hazard in its torch meaning:

* the **card boundary** — host syncs (`.item()`, `.cpu()`, `float()` of
  a tensor, `if` on a tensor, data-dependent shapes, blocking copies onto
  the card) must stay out of entry points and be deliberate (baselined,
  each with a note that says why it syncs) everywhere else; entry points
  must stay pure, since the staged warm-up and the cost ledger call them
  on zeros (`torch_hazards`, the A family);
* the **lock discipline** of the threaded bridge layer — copies of the
  JAX package's B-family checkers (`lock_discipline`) and C1/C2
  (`revision_order`, `snapshot_tear`), driven by the port's lock
  protection map (`protection`);
* `device_views` (C3: writes through a numpy view of a tensor, which
  change the tensor on the CPU and only a copy on the card) and
  `shape_churn` (C4: unbucketed runtime sizes in an entry point's static
  arguments or operand shapes, one dispatch variant per value).

`core` holds the checker framework (Finding, baseline, driver). The
dynamic tier: `lockwatch` records runtime lock ORDER, `racewatch` applies
Eraser's lockset refinement to the protection-map fields on a live
stack, and `compilebudget` pins per-entry-point variant counts against
the committed `compile_budget.json`. `cli` is the `jax-mapping-torch-lint`
console entry point (also `python -m jax_mapping_torch.analysis`). The
repo gates the port in `tests/test_torch_analysis_selfcheck.py`: the full
analyzer over `jax_mapping_torch/` must report zero non-baselined
findings. Only `compilebudget` imports torch (inside its scenario); the
static checkers are pure `ast`.
"""

from jax_mapping_torch.analysis.core import (  # noqa: F401
    Baseline, Finding, SourceModule, all_checkers, analyze_paths,
    analyze_modules, default_baseline_path, load_package_modules,
)
