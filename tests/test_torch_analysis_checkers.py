"""Fixture tests for the port's checkers (`jax_mapping_torch.analysis`).

Each torch-form checker (A1-A4, C3, C4) gets known-bad snippets it must
flag and known-clean snippets it must stay silent on, analyzed in memory
through `SourceModule.from_source` (the package itself is
`test_torch_analysis_selfcheck.py`'s job). Where a case of the JAX
package's `tests/test_analysis.py` has a torch form it keeps that test's
name. The last cases drive the CLI on a bad snippet per checker, A1-A4,
B1-B3, C3 and C4: exit 1 with a `path:line: severity: <id>:` finding.
No JAX is imported.
"""

import textwrap

import pytest

from jax_mapping_torch.analysis import (device_views, shape_churn,
                                        torch_hazards)
from jax_mapping_torch.analysis.core import SourceModule

HEAD = """
import functools
import random

import numpy as np
import torch

from jax_mapping_torch._util import entry_point
"""


def run_checker(checker, src, path="jax_mapping_torch/ops/snippet.py"):
    mod = SourceModule.from_source(HEAD + textwrap.dedent(src), path=path)
    return list(checker.run([mod]))


def ids(findings):
    return [f.checker for f in findings]


# Each case: (name, snippet, expected (severity, symbol) pairs or
# severities or symbols in line order; [] for silence).
A1_CASES = [
    ("a1_flags_np_asarray_on_traced_value_inside_jit", """
        @entry_point(static=("n",))
        def step(x, n):
            host = np.asarray(x)
            return host * n
        """, [("error", "step")]),
    ("a1_flags_item_and_float_on_traced_values", """
        @entry_point
        def step(x):
            a = x.sum().item()
            b = float(x.max())
            return a + b
        """, [("error", "step"), ("error", "step")]),
    ("a1_flags_sync_chained_on_call_result", """
        @entry_point
        def step(x):
            return torch.sum(x).tolist()
        """, [("error", "step")]),
    ("a1_silent_on_pure_jit_and_host_side_numpy", """
        @entry_point(static=("n",))
        def step(x, n):
            return torch.where(x > 0, x * n, x)

        def host_helper(rows):
            return np.asarray(rows).sum()
        """, []),
    ("a1_flags_sync_on_jit_result_in_timer_hot_path", """
        @entry_point(static=("n",))
        def step(state, n):
            return state + n

        class MapperNode:
            def __init__(self, cfg):
                self.state = None
                self.create_timer(0.1, self.tick)

            def tick(self):
                out = step(self.state, 3)
                return float(out)
        """, [("warning", "MapperNode.tick")]),
    ("a1_silent_in_hot_path_without_device_values", """
        class StatusNode:
            def __init__(self, cfg):
                self.rows = []
                self.create_timer(1.0, self.tick)

            def tick(self):
                return np.asarray(self.rows)
        """, []),
    ("a1_flags_cpu_numpy_as_one_site", """
        @entry_point
        def step(x):
            return x.detach().cpu().numpy()
        """, [("error", "step")]),
    ("a1_flags_to_cpu_and_tolist", """
        @entry_point
        def step(x):
            a = x.to("cpu")
            b = x.tolist()
            return a, b
        """, [("error", "step"), ("error", "step")]),
    ("a1_flags_python_if_on_tensor", """
        @entry_point
        def step(x):
            if x.any():
                return x
            while x.sum() > 0:
                x = x - 1
            return x
        """, [("error", "step"), ("error", "step")]),
    ("a1_silent_on_metadata_tests", """
        @entry_point
        def step(x):
            if x.shape[0] > 2 and x.device.type == "cpu":
                return x
            if x is None or len(x) == 0 or x.numel() == 0:
                return x
            return x + 1
        """, []),
    ("a1_flags_data_dependent_shapes", """
        @entry_point
        def step(x, counts):
            a = torch.nonzero(x)
            b = torch.unique(x)
            c = x[x > 0]
            d = torch.masked_select(x, x < 0)
            e = x.repeat_interleave(counts)
            f = torch.equal(x, a)
            return a, b, c, d, e, f
        """, [("error", "step")] * 6),
    ("a1_silent_on_fixed_size_ops", """
        @entry_point
        def step(x, counts):
            a = x.repeat_interleave(2, dim=0)
            b = x.repeat_interleave(counts, output_size=8)
            c = torch.where(x > 0, x, 0.0)
            d = x.masked_fill(x < 0, 0.0)
            return a, b, c, d
        """, []),
    ("a1_flags_linalg_info_check", """
        @entry_point
        def step(h, b):
            L = torch.linalg.cholesky(h)
            L2, info = torch.linalg.cholesky_ex(h)
            return torch.cholesky_solve(b, L), L2, info
        """, [("error", "step")]),
    ("a1_flags_blocking_copy_onto_the_card", """
        class Node:
            def __init__(self, dev):
                self.device = dev
                self.create_timer(0.1, self.tick)

            def tick(self):
                arr = np.zeros(3, np.float32)
                a = torch.as_tensor(arr, device=self.device)
                b = torch.from_numpy(arr).to(self.device)
                c = torch.tensor([1.0, 2.0], device=self.device)
                return a, b, c
        """, [("warning", "Node.tick")] * 3),
    ("a1_silent_on_host_tensors_by_construction", """
        def export(arr):
            t = torch.as_tensor(arr, device="cpu")
            u = torch.zeros(3)
            z = torch.zeros(3, device=t.device)
            return t.numpy(), u.tolist(), float(u[0]), z
        """, []),
    ("a1_flags_tensor_attribute_of_an_entry_result", """
        @entry_point
        def step(grid):
            return grid + 1

        class Mapper:
            def __init__(self, grid):
                self.grid = grid

            def tick(self):
                self.grid = step(self.grid)

            def status(self):
                return {"occupied": int((self.grid > 0).sum())}
        """, [("warning", "Mapper.status")]),
    ("a1_flags_a_call_of_a_sync_helper", """
        @entry_point
        def step(x):
            return x * 2

        def to_host(state):
            return state.detach().cpu().numpy()

        def save(x):
            out = step(x)
            return to_host(out)
        """, [("warning", "save")]),
    ("a1_flags_under_a_tensor_guard", """
        def to_numpy(leaf):
            if torch.is_tensor(leaf):
                return leaf.cpu().numpy()
            return np.asarray(leaf)

        def maybe(x):
            return x.cpu().numpy() if torch.is_tensor(x) else x
        """, [("warning", "to_numpy"), ("warning", "maybe")]),
    ("a1_flags_indexed_store_of_a_host_scalar", """
        @entry_point
        def seed(d, rr, cc):
            d = d.clone()
            d[torch.arange(3, device=d.device), rr, cc] = 0.0
            d[0, :2] = 0.0
            d[rr, cc] = d[cc, rr]
            return d
        """, [("error", "seed")]),
    ("a1_silent_on_host_ints_and_lists", """
        @entry_point
        def shift(grid: torch.Tensor, dr: int, dc: int):
            out = grid.clone()
            parts = []
            if dr > 0:
                parts.append(out)
            if parts:
                return parts[0]
            return out
        """, []),
]

A2_CASES = [
    ("a2_flags_for_over_traced_range_and_bad_static_argnums", """
        @entry_point(static=("n", "missing"))
        def step(x, n):
            for i in range(x.sum()):
                x = x + i
            return x
        """, [("error", "step"), ("error", "step")]),
    ("a2_flags_unhashable_literal_in_static_position", """
        @entry_point(static=("shape",))
        def build(x, shape):
            return x.reshape(shape)

        def caller(x):
            a = build(x, [2, 3])
            return build(x, shape={"a": 1}), a
        """, [("error", "caller"), ("error", "caller")]),
    ("a2_silent_on_static_branch_and_hashable_static_args", """
        @entry_point(static=("n",))
        def step(x, n):
            for i in range(n):
                x = x + i
            return x

        def caller(x):
            return step(x, 3), step(x, n=(1, 2))
        """, []),
]

A3_CASES = [
    ("a3_flags_float64_and_dtypeless_float_arrays_in_tpu_path", """
        def build(dev):
            a = torch.zeros(3, dtype=torch.float64, device=dev)
            b = torch.ones(2, device=dev).double()
            c = torch.as_tensor(np.array([0.5, 1.5]))
            d = torch.tensor(np.zeros(3, dtype=float))
            e = a.to(torch.double)
            return a, b, c, d, e
        """, ["warning"] * 5),
    ("a3_silent_with_explicit_float32_or_outside_tpu_path", """
        def build(dev, host):
            a = torch.zeros(3, dtype=torch.float32, device=dev)
            b = torch.as_tensor(np.array([0.5, 1.5]), dtype=torch.float32)
            c = torch.as_tensor(host, dtype=torch.float64, device="cpu")
            d = torch.as_tensor(np.array([0.5, 1.5], np.float32))
            e = torch.arange(4, dtype=torch.float64)
            f = torch.cat([a.double(), b.double()]).cpu().numpy()
            g = a.to("cpu", torch.float64)
            return a, b, c, d, e, f, g
        """, []),
]

A4_CASES = [
    ("a4_flags_time_call_and_self_mutation_under_jit", """
        class Model:
            @entry_point
            def step(self, x):
                self.n_calls = 1
                self.cache[0] = x
                return x + 1
        """, [("error", "Model.step"), ("error", "Model.step")]),
    ("a4_flags_impurity_in_transitive_callee", """
        def noise(shape):
            return torch.randn(shape)

        @entry_point
        def step(x):
            return x + noise(x.shape)
        """, [("error", "noise")]),
    ("a4_flags_global_rngs", """
        @entry_point
        def step(x):
            a = torch.rand(3)
            b = np.random.normal(size=3)
            c = random.random()
            x.normal_()
            return x, a, b, c
        """, [("error", "step")] * 4),
    ("a4_flags_module_global_mutation", """
        COUNTS = {"n": 0}
        LOG = []

        @entry_point
        def step(x):
            COUNTS["n"] += 1
            LOG.append(1)
            return x
        """, [("error", "step"), ("error", "step")]),
    ("a4_silent_on_jax_random_and_host_side_time", """
        @entry_point
        def step(x, generator):
            n = torch.randn(x.shape, generator=generator)
            rng = np.random.default_rng(0)
            return x + n, rng

        class Node:
            def tick(self):
                self.n = torch.rand(3)
                return random.random()
        """, []),
]

C3_CASES = [
    ("c3_flags_write_into_asarray_of_jitted_result", """
        @entry_point
        def refresh(masks):
            return masks.sum(0)

        class Pipeline:
            def step(self, masks):
                obs = np.asarray(refresh(masks))
                obs[0] = True
                return obs
        """, ["Pipeline.step"]),
    ("c3_flags_writes_through_numpy_views", """
        def export(t):
            v = t.numpy()
            v[0] = 1.0
            w = t.detach().cpu().numpy()
            w += 1.0
            row = w[0]
            row.fill(0)
            np.copyto(v, 2.0)
            np.add(v, 1.0, out=v)
            return v, w
        """, ["export"] * 5),
    ("c3_view_taint_propagates_and_copies_sanitize", """
        def export(t):
            a = t.numpy().copy()
            a[0] = 1
            b = np.array(t.cpu().numpy())
            b[0] = 2
            c = t.cpu().numpy().astype(np.float64)
            c[0] = 3
            return a, b, c
        """, []),
    ("c3_host_asarray_is_clean", """
        def embed(occupancy):
            occ = np.asarray(occupancy, np.int8)
            out = np.full(occ.shape, -1, np.int8)
            out[occ == 0] = 1
            occ2 = np.asarray([1, 2])
            occ2[0] = 3
            return out, occ2
        """, []),
]

C4_CASES = [
    ("c4_flags_unbucketed_static_arg_and_slice", """
        @entry_point(static=("n",))
        def fuse(ranges, n):
            return ranges[:n].sum()

        def tick(scans):
            n = len(scans)
            return fuse(torch.as_tensor(scans[:n]), n)
        """, ["tick", "tick"]),
    ("c4_bucketing_sanitizes", """
        def next_pow2(n):
            return 1 << max(0, (n - 1)).bit_length()

        @entry_point(static=("n",))
        def fuse(ranges, n):
            return ranges[:n].sum()

        def tick(scans):
            n = next_pow2(len(scans))
            return fuse(torch.as_tensor(scans[:n]), n)

        def tick_inline(scans):
            n = 2 ** max(1, len(scans)).bit_length()
            return fuse(torch.as_tensor(scans[:n]), n)
        """, []),
    ("c4_static_kwarg_and_config_values_clean", """
        @entry_point(static=("span",))
        def crop(grid, span=8):
            return grid[:span, :span]

        def good(self, grid):
            return crop(grid, span=self.cfg.grid.patch_cells)

        def bad(self, grid, mask):
            return crop(grid, span=int(mask.sum()))
        """, ["bad"]),
    ("c4_jitted_bodies_are_exempt", """
        @entry_point(static=("n",))
        def inner(x, n):
            return x[:n]

        @entry_point
        def outer(x):
            n = x.shape[0]
            return inner(x[:n], n)
        """, []),
    ("c4_shapes_below_an_entry_point_are_its_variant", """
        @entry_point(static=("n",))
        def fuse(x, n):
            return x[:n]

        def _helper(rings):
            cap = rings.shape[1]
            return fuse(rings[:, :cap], cap)

        @entry_point
        def step(rings):
            return _helper(rings)
        """, []),
]


def _check_a(checker_cls, src, expected):
    findings = run_checker(checker_cls(), src)
    if expected and isinstance(expected[0], tuple):
        assert [(f.severity, f.symbol) for f in findings] == expected, \
            "\n".join(f.format() for f in findings)
    else:
        assert [f.severity for f in findings] == expected, \
            "\n".join(f.format() for f in findings)
    assert set(ids(findings)) <= {checker_cls.id}


@pytest.mark.parametrize("src,expected", [c[1:] for c in A1_CASES],
                         ids=[c[0] for c in A1_CASES])
def test_a1_host_sync(src, expected):
    _check_a(torch_hazards.HostSyncChecker, src, expected)


@pytest.mark.parametrize("src,expected", [c[1:] for c in A2_CASES],
                         ids=[c[0] for c in A2_CASES])
def test_a2_entry_hygiene(src, expected):
    _check_a(torch_hazards.EntryHygieneChecker, src, expected)


@pytest.mark.parametrize("src,expected", [c[1:] for c in A3_CASES],
                         ids=[c[0] for c in A3_CASES])
def test_a3_dtype_drift(src, expected):
    _check_a(torch_hazards.DtypeDriftChecker, src, expected)


@pytest.mark.parametrize("src,expected", [c[1:] for c in A4_CASES],
                         ids=[c[0] for c in A4_CASES])
def test_a4_impure_entry(src, expected):
    _check_a(torch_hazards.ImpureEntryChecker, src, expected)


@pytest.mark.parametrize("src,expected", [c[1:] for c in C3_CASES],
                         ids=[c[0] for c in C3_CASES])
def test_c3_device_view(src, expected):
    findings = run_checker(device_views.DeviceViewMutationChecker(), src)
    assert [f.symbol for f in findings] == expected, \
        "\n".join(f.format() for f in findings)
    assert set(ids(findings)) <= {"C3-device-view"}


@pytest.mark.parametrize("src,expected", [c[1:] for c in C4_CASES],
                         ids=[c[0] for c in C4_CASES])
def test_c4_shape_churn(src, expected):
    findings = run_checker(shape_churn.ShapeChurnChecker(), src)
    assert [f.symbol for f in findings] == expected, \
        "\n".join(f.format() for f in findings)
    assert set(ids(findings)) <= {"C4-shape-churn"}


def test_a1_hot_path_context_and_line_span():
    """A hot-path site says so, and a call spread over lines carries the
    span a runtime frame may report anywhere inside."""
    findings = run_checker(torch_hazards.HostSyncChecker(), """
        @entry_point
        def step(x):
            return x + 1

        class Node:
            def __init__(self):
                self.create_timer(0.1, self.tick)

            def tick(self, x):
                y = step(x)
                return np.asarray(
                    y)
        """)
    [f] = findings
    assert "in per-tick hot path" in f.message
    assert f.end_line == f.line + 1


# ------------------------------------------------------------- the CLI

CLI_BAD = {
    "A1-host-sync": """
        @entry_point
        def step(x):
            return x.item()
        """,
    "A2-entry-hygiene": """
        @entry_point(static=("nope",))
        def step(x):
            return x
        """,
    "A3-dtype-drift": """
        def build(dev):
            return torch.zeros(3, dtype=torch.float64, device=dev)
        """,
    "A4-impure-entry": """
        @entry_point
        def step(x):
            return x + torch.randn(3)
        """,
    "B1-lock-order": """
        import threading

        class Pair:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    with self._a:
                        pass
        """,
    "B2-callback-lock": """
        import threading

        class Node:
            def __init__(self, pub):
                self._lock = threading.Lock()
                self.pub = pub

            def tick(self):
                with self._lock:
                    self.pub.publish(1)
        """,
    "B3-unguarded-write": """
        import threading

        class Node:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def read(self):
                with self._lock:
                    return self.n

            def bump(self):
                self.n += 1
        """,
    "C3-device-view": """
        def export(t):
            v = t.numpy()
            v[0] = 1.0
            return v
        """,
    "C4-shape-churn": """
        @entry_point(static=("n",))
        def fuse(x, n):
            return x[:n]

        def tick(scans):
            return fuse(scans, len(scans))
        """,
}


@pytest.mark.parametrize("checker", sorted(CLI_BAD))
def test_cli_flags_a_bad_snippet(checker, tmp_path, capsys):
    """`python -m jax_mapping_torch.analysis` on a bad snippet: exit 1
    and the `path:line: severity: <id>:` line; the same file with the
    checker filtered out is clean."""
    from jax_mapping_torch.analysis.cli import main
    path = tmp_path / "snippet.py"
    path.write_text(HEAD + textwrap.dedent(CLI_BAD[checker]))
    assert main([str(path), "--no-baseline", "--checker", checker]) == 1
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if f": {checker}: " in ln]
    assert lines, out
    head = lines[0].split(": ")
    assert head[0].startswith("snippet.py:") and head[0].split(":")[1]\
        .isdigit()
    assert head[1] in ("error", "warning")
    others = [c for c in sorted(CLI_BAD) if c != checker
              and not (checker.startswith("B") and c.startswith("B"))]
    assert main([str(path), "--no-baseline"]
                + [a for c in others for a in ("--checker", c)]) == 0
