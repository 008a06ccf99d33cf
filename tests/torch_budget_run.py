"""The canonical compile-budget scenario's cost ledger, run once a session.

`python -m jax_mapping_torch.obs cost-ledger --device cpu --budget <the
port's budget>` in a fresh process (cold, as the budget is defined) takes
seconds; two test files read its result (`test_torch_devprof.py` for the
ledger's numbers, `test_torch_analysis_selfcheck.py` for the budget's
coverage). Under xdist each file may run on another worker, so the first
caller runs the command under a file lock in the session's shared
temporary directory and every later caller reads its saved result. No
pytest, no JAX.
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
from types import SimpleNamespace

from tests.torch_jaxref import REPO, clean_cpu_env


def cost_ledger_run(tmp_path_factory):
    """(r, doc): the command's `returncode`/`stdout`/`stderr` and its JSON
    output (None when it wrote none)."""
    from jax_mapping_torch.analysis.compilebudget import default_budget_path
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent                   # shared by the session's workers
    out = root / "torch_cost_ledger.json"
    done = root / "torch_cost_ledger.run.json"
    with open(root / "torch_cost_ledger.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            env = clean_cpu_env()
            env["PYTHONPATH"] = str(REPO)
            r = subprocess.run(
                [sys.executable, "-m", "jax_mapping_torch.obs",
                 "cost-ledger", "--device", "cpu", "--budget",
                 default_budget_path(), "-o", str(out)],
                capture_output=True, text=True, cwd=str(REPO), env=env,
                timeout=600)
            done.write_text(json.dumps({
                "returncode": r.returncode, "stdout": r.stdout[-20000:],
                "stderr": r.stderr[-20000:]}))
    r = SimpleNamespace(**json.loads(done.read_text()))
    doc = json.loads(out.read_text()) if out.exists() else None
    return r, doc
