"""Polynomial atan2, the same function as the JAX package's `ops/trig.py`.

Beam assignment in the inverse sensor model rounds the cell bearing to a
beam index, so a cell on a beam boundary flips beams if two engines
compute its bearing differently. The port therefore keeps the JAX
package's degree-8 polynomial and its operation order (one rounding per
operation, no fused multiply-add); `csrc/sensor_model.cu` evaluates the
same sequence.
"""

from __future__ import annotations

import torch

_HALF_PI = 1.5707963267948966
_PI = 3.141592653589793

# atan(a)/a ~= sum c_i * (a^2)^i on a in [0, 1].
_C = (1.0, -0.33333138, 0.19993694, -0.14211106, 0.10667487,
      -0.075569004, 0.043278243, -0.01641319, 0.002932762)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise atan2(y, x) in (-pi, pi] from the polynomial core."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    a = mn / torch.clamp_min(mx, 1e-30)
    s = a * a
    p = torch.full_like(a, _C[-1])
    for c in _C[-2::-1]:
        p = p * s + c
    r = p * a
    r = torch.where(ay > ax, _HALF_PI - r, r)
    r = torch.where(x < 0.0, _PI - r, r)
    return torch.where(y < 0.0, -r, r)
