"""The control: the reference with the matcher's correlations in
bfloat16, put in the program's place, comes out not correct where the
program is correct. On the CPU at `tiny_config`, and on the card (the
`cuda` marker; skips without one). The cells' own sizes are read on the
card by `python3 -m port_bench.control.readings`."""

import time

import pytest

from port_bench.bench_checks import tinybench
from port_bench.harness import driver


def _readings(tmp_path, device, seeds):
    reg = tinybench.write(tmp_path)
    cell = reg.cell("tiny2.rooms")
    outs = [driver.run_cell(cell, reg, s, 1.0, False, time.perf_counter(),
                            device=device, control=True) for s in seeds]
    return cell.config["limits"], outs


def test_bf16_control_fails_where_the_program_passes(tmp_path):
    limits, outs = _readings(tmp_path, "cpu", (2 ** 31 + 41,))
    for out in outs:
        assert out["correct"] is True, out["checks"]
        assert out["window"]["checked"], out["window"]
        assert not driver.passes(out["control"], limits), out["control"]


@pytest.mark.cuda
def test_bf16_control_fails_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limits, outs = _readings(tmp_path, "cuda", (11, 12, 13))
    for out in outs:
        assert out["correct"] is True, out["checks"]
        assert out["window"]["checked"], out["window"]
        assert not driver.passes(out["control"], limits), out["control"]
