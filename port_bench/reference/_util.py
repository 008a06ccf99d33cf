"""Small helpers shared by the reference's modules.

`PRECISION` holds the switch the frozen copy adds for the control, off
in the reference, which computes in full float32 with TF32 off as the
configuration states: "bf16" computes the matcher's correlations (`low`)
in bfloat16."""

from __future__ import annotations

import functools

import numpy as np
import torch


def entry_point(fn=None, *, static=()):
    """Mark `fn` as an entry point of the port: the counterpart of one of
    the JAX package's jitted functions, which the dispatch profiler
    (`obs/devprof.py`) wraps and the warm-up pre-warms. `static` names
    the arguments JAX's jit holds static (they key a variant by value).
    Sets one attribute and returns `fn` itself: no wrapper, no cost."""
    def mark(f):
        f.__entry_point__ = tuple(static)
        return f
    return mark(fn) if fn is not None else mark


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its state on: CUDA unless the
    caller names another. Asking for CUDA without a card raises; the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "reference: no CUDA device; pass device='cpu'")
    return dev


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """A constant tensor of `values` on `device`, made once and cached.
    Building a tensor from Python values on the card copies it from the
    host, and that copy waits for the stream: a host sync on every call.
    The cached tensor is shared, so callers must not modify it."""
    return _const(tuple(values), dtype, str(torch.device(device)))


#: The precision the reference computes in (see the module docstring).
PRECISION = {"bf16": False}


def low(*xs):
    """The operands of a correlation in the control's precision: bfloat16
    while `PRECISION["bf16"]`, unchanged otherwise."""
    if not PRECISION["bf16"]:
        return xs
    return tuple(x.to(torch.bfloat16) for x in xs)


def full_f32() -> None:
    """Turn TF32 off for float32 matmuls and cuDNN convolutions. The
    matcher and the pose-graph solve call this before they run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linspace_f32(start: float, stop: float, num: int,
                 endpoint: bool = True) -> np.ndarray:
    """float32 linspace with jnp.linspace's arithmetic:
    start * (1 - t) + stop * t with t = i / div, then the exact endpoint
    (numpy's own formula rounds differently in the last bit)."""
    div_ = (num - 1) if endpoint else num
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start32], np.float32)
    t = np.arange(div_, dtype=np.float32) / np.float32(div_)
    out = start32 * (np.float32(1) - t) + stop32 * t
    if endpoint:
        out = np.concatenate([out, np.array([stop32], np.float32)])
    return out.astype(np.float32)


def shift2d(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """Shift the last two axes one step (dr, dc in {-1, 0, 1}):
    out[..., r, c] = x[..., r - dr, c - dc], `fill` where that is off
    the array."""
    if abs(dr) > 1 or abs(dc) > 1:
        raise ValueError(f"shift2d is single-step only, got ({dr}, {dc})")
    h, w = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    out[..., max(dr, 0):h + min(dr, 0), max(dc, 0):w + min(dc, 0)] = \
        x[..., max(-dr, 0):h + min(-dr, 0), max(-dc, 0):w + min(-dc, 0)]
    return out


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s with an IEEE division on every device.

    PyTorch's CUDA kernel divides by a Python scalar as a multiplication
    by its reciprocal, which can differ from x / s in the last bit (and so
    flip a rounding that decides a beam or a cell). Dividing by a 0-d
    tensor on x's own device keeps the true division there, as on the
    CPU and in the CUDA kernels."""
    return x / x.new_full((), s)
