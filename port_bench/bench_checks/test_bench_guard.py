"""The import guard: a run loads neither JAX nor the JAX package, and the
reference loads nothing of the port. Each side runs in a fresh process,
so that only what it loads is in `sys.modules`."""

import json
import subprocess
import sys

from port_bench.harness import guard
from port_bench.harness.registry import REPO


def test_names_are_compared_whole():
    assert guard.forbidden_loaded(["jax_mapping_torch.ops.grid", "numpy",
                                   "jax_mappingx"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "torch"]) == ["jax"]
    assert guard.forbidden_loaded(["jax_mapping.ops"]) == ["jax_mapping"]
    assert guard.forbidden_loaded(["jax_mapping_torch"],
                                  forbidden=[guard.PORT]) == \
        ["jax_mapping_torch"]


def _fresh(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


REFERENCE_TICK = """
import json, sys, torch
from port_bench.reference import config as C, fleet as F
cfg = C.tiny_config(2)
st = F.init_fleet_state(cfg, device="cpu", radius_uniforms=torch.rand(2))
world = torch.zeros((256, 256), dtype=torch.bool)
world[:2] = True
st, _ = F.fleet_step(cfg, st, 0.05, world, wheel_normals=torch.zeros(2, 2))
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def test_reference_loads_nothing_of_the_port_nor_jax():
    tops = _fresh(REFERENCE_TICK)
    assert "torch" in tops
    assert not tops & {guard.PORT, *guard.FORBIDDEN}


HARNESS_RUN = """
import json, sys, tempfile
from pathlib import Path
from port_bench.bench_checks import tinybench
reg = tinybench.write(Path(tempfile.mkdtemp()))
out = tinybench.run(reg, "tiny2.rooms", seconds=0.5)
assert out["correct"], out
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    tops = _fresh(HARNESS_RUN)
    assert guard.PORT in tops
    assert not tops & set(guard.FORBIDDEN)
