"""JAX-package reference outputs for the PyTorch port's parity tests.

The reference runs in a fresh `JAX_PLATFORMS=cpu` subprocess, never in the
test worker: once any test in a worker installs the JAX package's
dispatch profiler, later jitted calls in that worker fail under the
installed jax, and the port's tests must not depend on which tests shared
their worker. The subprocess also drops the suite's virtual 8-device
XLA flag, which changes how XLA:CPU vectorises.

A test module hands `run_reference` a script that fills the dict `OUT`
with arrays; the arrays come back as a dict of numpy arrays. A reference
on a device mesh (the JAX package's `parallel/`) passes `n_devices`: the
subprocess then gets that many virtual CPU devices.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parent.parent

#: Helpers available to every reference script.
PRELUDE = '''
import sys
import numpy as np
OUT = {}

_SIM = ("poses", "wheel_speeds")
_GRAPH = ("poses", "pose_valid", "n_poses", "edge_ij", "edge_meas",
          "edge_weight", "edge_valid", "n_edges")
_TOP = ("est_poses", "grid", "exploring", "last_key_poses", "scan_rings",
        "n_loops", "t")


def put_state(prefix, s):
    """Store a jax_mapping FleetState's leaves under `prefix`."""
    for f in _SIM:
        OUT[prefix + "sim." + f] = np.asarray(getattr(s.sim, f))
    for f in _GRAPH:
        OUT[prefix + "graphs." + f] = np.asarray(getattr(s.graphs, f))
    for f in _TOP:
        OUT[prefix + f] = np.asarray(getattr(s, f))


def wheel_normals(s):
    """The (R, 2) standard normals step_fleet draws from this state."""
    import jax
    _key, k1 = jax.random.split(s.sim.key)
    return np.asarray(jax.random.normal(k1, s.sim.wheel_speeds.shape))
'''

#: A script prefix that gives the reference one XLA thread (before JAX is
#: imported): the suite's parallel workers share the cores.
ONE_XLA_THREAD = '''
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_multi_thread_eigen=false")
'''

_EPILOGUE = '''
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in OUT.items()})
'''


def clean_cpu_env(n_devices: int | None = None) -> dict:
    """CPU-pinned env without the suite's virtual-mesh XLA flag, or with
    `n_devices` virtual CPU devices when given."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    flags = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f)
    if n_devices is not None:
        flags = (flags + " --xla_force_host_platform_device_count="
                 f"{n_devices}").strip()
    if flags:
        env["XLA_FLAGS"] = flags
    else:
        env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def run_reference(script: str, out_path, timeout: float = 600,
                  n_devices: int | None = None) -> dict:
    """Run `script` in a fresh JAX process (on `n_devices` virtual CPU
    devices when given); return its OUT arrays."""
    src = PRELUDE + textwrap.dedent(script) + _EPILOGUE
    r = subprocess.run([sys.executable, "-c", src, str(out_path)],
                       capture_output=True, text=True, timeout=timeout,
                       env=clean_cpu_env(n_devices), cwd=str(REPO))
    if r.returncode != 0:
        raise RuntimeError(f"JAX reference failed (rc {r.returncode}):\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-6000:]}")
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


def state_tree(ref: dict, prefix: str) -> SimpleNamespace:
    """The attribute tree `fleet_state_from_numpy` reads, rebuilt from
    the leaves `put_state(prefix, ...)` stored."""
    def pick(sub):
        p = prefix + sub
        return SimpleNamespace(**{k[len(p):]: v for k, v in ref.items()
                                  if k.startswith(p) and "." not in
                                  k[len(p):]})
    top = pick("")
    top.sim = pick("sim.")
    top.graphs = pick("graphs.")
    return top
