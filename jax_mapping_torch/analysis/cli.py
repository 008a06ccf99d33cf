"""`jax-mapping-torch-lint` — run the port's static-analysis pass.

    jax-mapping-torch-lint jax_mapping_torch/        # full pass, committed
                                                     # baseline applied
    jax-mapping-torch-lint --no-baseline jax_mapping_torch/  # everything
    jax-mapping-torch-lint --write-baseline jax_mapping_torch/  # accept
                                                     # current findings
    jax-mapping-torch-lint --format json jax_mapping_torch/
    jax-mapping-torch-lint --format github jax_mapping_torch/  # CI

A copy of the JAX package's `analysis/cli.py` on the port's package.
Also invocable as `python -m jax_mapping_torch.analysis` (the module
entry point mirrors the console script for environments without
installed scripts).

Exit-code contract (stable; CI consumers branch on it):

    0  clean — every finding baselined (or none at all)
    1  findings — at least one NON-baselined finding was reported
    2  internal/usage error — bad flags, unreadable paths, syntax
       errors in analyzed sources, corrupt baseline; NEVER used for
       findings, so a pipeline can distinguish "the code is dirty"
       from "the linter could not run"

`--format github` emits one `::error file=...,line=...::message`
workflow-command annotation per non-baselined finding (GitHub renders
them inline on the PR diff), followed by the usual summary on stderr.

The tier-1 gate (`tests/test_torch_analysis_selfcheck.py`) is exactly
"exit code 0 over `jax_mapping_torch/` with the committed baseline".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from jax_mapping_torch.analysis.core import (
    Baseline, all_checkers, analyze_modules, default_baseline_path,
    load_package_modules, load_paths,
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jax-mapping-torch-lint",
        description="Card hazard + lock-discipline static analysis for "
                    "jax_mapping_torch.")
    p.add_argument("paths", nargs="*",
                   help="files/directories to analyze (default: the "
                        "jax_mapping_torch package)")
    p.add_argument("--baseline", default=None, metavar="JSON",
                   help="baseline file (default: the committed "
                        "analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, baselined or not")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept all current findings into the baseline "
                        "file and exit 0")
    p.add_argument("--format", choices=("text", "json", "github"),
                   default="text")
    p.add_argument("--checker", action="append", default=None,
                   metavar="ID", help="run only these checker ids "
                   "(repeatable), e.g. --checker B1-lock-order")
    p.add_argument("--list-checkers", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    checkers = all_checkers()
    if args.list_checkers:
        for c in checkers:
            print(c.id)
        return 0
    if args.checker:
        known = {c.id for c in checkers}
        unknown = set(args.checker) - known
        if unknown:
            print(f"unknown checker id(s): {sorted(unknown)}; "
                  f"known: {sorted(known)}", file=sys.stderr)
            return 2
        checkers = [c for c in checkers if c.id in args.checker]

    try:
        modules = (load_paths(args.paths) if args.paths
                   else load_package_modules())
    except (OSError, SyntaxError) as e:
        print(f"jax-mapping-torch-lint: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or default_baseline_path()
    baseline = None
    try:
        if not args.no_baseline and not args.write_baseline \
                and os.path.exists(baseline_path):
            baseline = Baseline.load(baseline_path)
    except (OSError, ValueError) as e:       # ValueError covers bad JSON
        print(f"jax-mapping-torch-lint: baseline {baseline_path}: {e}",
              file=sys.stderr)
        return 2

    # --write-baseline merge preflight BEFORE the (expensive) analysis:
    # a corrupt existing baseline must refuse immediately, not after
    # seconds of checker work it will then throw away.
    existing = None
    if args.write_baseline and os.path.exists(baseline_path):
        try:
            existing = Baseline.load(baseline_path).suppressions
        except (OSError, ValueError) as e:
            print(f"jax-mapping-torch-lint: baseline {baseline_path}: {e} "
                  "— refusing to overwrite what cannot be merged",
                  file=sys.stderr)
            return 2

    res = analyze_modules(modules, baseline, checkers)

    if args.write_baseline:
        # Merge, never clobber: keep the notes of entries that are
        # still live, and keep entries this scoped run could not have
        # re-observed (filtered-out checkers / unanalyzed files) —
        # otherwise `--write-baseline --checker B1-lock-order` would
        # silently delete every A-family suppression.
        notes, keep = {}, []
        if existing is not None:
            ids = {c.id for c in checkers}
            analyzed = {m.path for m in modules}
            # An entry may be dropped (trusted to re-appear as a
            # finding if still valid) only when this run could have
            # re-observed it: its checker ran, its file was analyzed,
            # and the run had full cross-module context — a subset run
            # finds strictly less (the A checkers need the package-wide
            # entry-point registry) and must not destroy entries it
            # cannot see.
            full_context = {s["path"] for s in existing} <= analyzed
            for s in existing:
                key = (s["checker"], s["path"], s.get("symbol", ""),
                       s.get("code", ""))
                if full_context and s["checker"] in ids \
                        and s["path"] in analyzed:
                    if s.get("note"):
                        notes[key] = s["note"]
                else:
                    keep.append(s)
        Baseline.dump(res.all_findings, baseline_path, notes=notes,
                      keep=keep)
        print(f"wrote {len(res.all_findings) + len(keep)} "
              f"suppression(s) to {baseline_path}")
        return 0

    if args.format == "github":
        # GitHub workflow commands: one annotation per finding, pinned
        # to file+line so the PR diff shows it inline. Newlines and
        # the %/CR/LF command metacharacters are escaped per the
        # workflow-command spec; the summary goes to stderr so stdout
        # stays machine-consumable.
        def esc(s: str) -> str:
            return (s.replace("%", "%25").replace("\r", "%0D")
                    .replace("\n", "%0A"))

        for f in res.findings:
            level = "error" if f.severity == "error" else "warning"
            print(f"::{level} file={esc(f.path)},line={f.line},"
                  f"title={esc(f.checker)}::{esc(f.message)}")
        print(f"{res.n_files} files: {len(res.findings)} new "
              f"finding(s), {len(res.baselined)} baselined",
              file=sys.stderr)
        return 1 if res.findings else 0

    if args.format == "json":
        print(json.dumps({
            "files": res.n_files,
            "findings": [vars(f) for f in res.findings],
            "baselined": [vars(f) for f in res.baselined],
            "unused_suppressions": res.unused_suppressions,
        }, indent=1))
        return 1 if res.findings else 0

    for f in res.findings:
        print(f.format())
    for s in res.unused_suppressions:
        print(f"note: unused baseline suppression: {s['checker']} "
              f"{s['path']} [{s.get('symbol', '')}] — ratchet it out")
    print(f"{res.n_files} files: {len(res.findings)} new finding(s), "
          f"{len(res.baselined)} baselined"
          + (f", {len(res.unused_suppressions)} unused suppression(s)"
             if res.unused_suppressions else ""))
    return 1 if res.findings else 0


if __name__ == "__main__":
    sys.exit(main())
