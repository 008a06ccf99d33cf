"""The frontier sweeps of kernels K2 (label propagation) and K3 (min-plus
relaxation) on the CPU: their plain versions against the JAX package's
Pallas kernels at the fleet's shapes, and a plain mirror of the kernels'
cluster decomposition against the plain versions.

The kernels (`csrc/cluster_sweep.cuh`) split each field into C row slabs,
one a CTA, each with a halo row above and below and a fill column either
side, and trade boundary rows into the neighbours' halo rows after every
sweep. `slab_sweeps` replays that bookkeeping (slab rows, CTAs left
without rows, where a pushed row lands, the fill past the grid's edges)
in PyTorch, so its exactness is checked here at cluster sizes and widths
that do not divide each other; `thread_cells` replays the kernel's
thread-to-cell map. The inputs are paths longer than the sweep count
that run across every slab boundary: a missing or extra sweep, or a
stale halo, changes the output; they live in tests/torch_kernel_inputs.py,
which tests/test_torch_cuda.py and chip_smoke.py share.

The JAX side runs in a clean subprocess (tests/torch_jaxref.py), its
Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

from jax_mapping_torch.ops import costfield as CF
from jax_mapping_torch.ops import frontier as F

from torch_kernel_inputs import (corridor_maze, label_seed, maze_init,
                                 serpentine_mask)
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# Plain mirror of the cluster decomposition
# ---------------------------------------------------------------------------

def _row_summaries(kind: str, rows: torch.Tensor, n: int):
    """Each buffer row's summary, as the kernels' Op::row folds it: K2 the
    max of a cell's row and its two sides; K3 the centre x, x + 1, and the
    lesser side plus sqrt 2 and plus 1."""
    left, x, right = rows[:, :n], rows[:, 1:n + 1], rows[:, 2:n + 2]
    if kind == "label":
        return (torch.maximum(torch.maximum(left, x), right),)
    s = torch.minimum(left, right)
    return x, x + 1.0, s + CF._SQ2, s + 1.0


def _cell_sweep(kind: str, src: torch.Tensor, rows: int, n: int,
                m: torch.Tensor) -> torch.Tensor:
    """One sweep of a slab's `rows` rows from its padded buffer, from the
    row summaries of the rows above, at and below each cell, as the
    kernels' Op::cell combines them."""
    sm = _row_summaries(kind, src[:rows + 2], n)
    above = [t[:rows] for t in sm]
    centre = [t[1:rows + 1] for t in sm]
    below = [t[2:rows + 2] for t in sm]
    if kind == "label":
        best = torch.maximum(torch.maximum(above[0], centre[0]), below[0])
        return torch.where(m, best, -1)
    x, w = centre[0], centre[3]
    best = torch.minimum(torch.minimum(torch.minimum(x, w),
                                       torch.minimum(above[1], above[2])),
                         torch.minimum(below[1], below[2]))
    return torch.where(m, CF._BIG, best)


def test_relax_row_summary_is_exact():
    """min(l + w, r + w) == min(l, r) + w in float32 for both step costs:
    rounding is monotone. On ties, 1e9, huge and tiny magnitudes."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.uniform(0, 2000, 4000),
                           10.0 ** rng.uniform(-8, 9.5, 4000),
                           [0.0, 1e9, 1e9 - 64, 3.4e38, 1.5, 1.5]])
    l = torch.tensor(rng.permutation(vals), dtype=torch.float32)
    r = torch.tensor(rng.permutation(vals), dtype=torch.float32)
    for w in (1.0, CF._SQ2):
        assert torch.equal(torch.minimum(l + w, r + w),
                           torch.minimum(l, r) + w)


def slab_sweeps(kind: str, mask: torch.Tensor, field: torch.Tensor,
                n_sweeps: int, C: int) -> torch.Tensor:
    """`n_sweeps` sweeps of one (n, n) field as C slabs with pushed halo
    rows, as `cluster_sweep.cuh::sweep_kernel` keeps them. `kind` is
    "label" (K2: mask on, fill -1) or "relax" (K3: mask blocked, fill
    1e9)."""
    n = field.shape[0]
    fill = -1 if kind == "label" else CF._BIG
    marker = n * n + 7 if kind == "label" else -1.0
    S = -(-n // C)
    r0 = [min(n, k * S) for k in range(C)]
    rows = [min(n, r0[k] + S) - r0[k] for k in range(C)]
    # Stage: buffer 0 holds grid rows r0 - 1 .. r1 of the input as given,
    # the fill past the edges; buffer 1 only the fill there.
    padded = torch.full((n + 2, n + 2), fill, dtype=field.dtype)
    padded[1:n + 1, 1:n + 1] = field
    bufs = []
    for k in range(C):
        b0 = torch.full((S + 2, n + 2), fill, dtype=field.dtype)
        b0[:rows[k] + 2] = padded[r0[k]:r0[k] + rows[k] + 2]
        b1 = torch.full((S + 2, n + 2), fill, dtype=field.dtype)
        # Interior halos of buffer 1 are pushed before they are read; mark
        # them with a value that would spread, so that a row read before
        # its push, or a push to the wrong row, shows.
        if r0[k] > 0:
            b1[0, 1:n + 1] = marker
        if r0[k] + rows[k] < n:
            b1[rows[k] + 1, 1:n + 1] = marker
        bufs.append([b0, b1])
    slabs = [mask[r0[k]:r0[k] + rows[k]] for k in range(C)]
    for j in range(n_sweeps):
        s, d = j % 2, (j + 1) % 2
        for k in range(C):
            if rows[k] == 0:
                continue
            v = _cell_sweep(kind, bufs[k][s], rows[k], n, slabs[k])
            bufs[k][d][1:rows[k] + 1, 1:n + 1] = v
            if r0[k] > 0:                        # upper neighbour, row S + 1
                assert rows[k - 1] == S
                bufs[k - 1][d][S + 1, 1:n + 1] = v[0]
            if r0[k] + rows[k] < n:              # lower neighbour, row 0
                bufs[k + 1][d][0, 1:n + 1] = v[-1]
    fin = n_sweeps % 2
    return torch.cat([bufs[k][fin][1:rows[k] + 1, 1:n + 1]
                      for k in range(C) if rows[k]])


def thread_cells(n: int, C: int, threads: int, k: int) -> list:
    """The (row, column) cells of CTA k's slab each thread computes in a
    sweep, by the kernel's map: columns tc, tc + Tc, ... of a band of
    rows."""
    S = -(-n // C)
    r0 = min(n, k * S)
    rows = min(n, r0 + S) - r0
    Tc = threads if n >= threads else n
    G = threads // Tc
    cells = []
    for t in range(threads):
        g, tc = divmod(t, Tc)
        i0, i1 = ((g * rows // G, (g + 1) * rows // G) if g < G
                  else (rows, rows))
        cells += [(i, c) for c in range(tc, n, Tc) for i in range(i0, i1)]
    return cells


MIRROR_CASES = [(40, 4), (40, 16), (48, 16), (50, 8), (37, 4), (37, 16),
                (64, 8), (7, 4)]


@pytest.mark.parametrize("n,C", MIRROR_CASES)
@pytest.mark.parametrize("sweeps", [0, 1, 2, 9, 24])
def test_label_slabs_equal_plain(n, C, sweeps):
    """The slab decomposition of K2 equals the plain sweeps exactly, for a
    seed with labels off the mask too."""
    m = _t(serpentine_mask(n, seed=n))
    seed = _t(label_seed(serpentine_mask(n, seed=n), off_mask=True, seed=C))
    want = seed
    for _ in range(sweeps):
        want = F._neighbor_max_sweep(want, m)
    got = slab_sweeps("label", m, seed, sweeps, C)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,C", MIRROR_CASES)
@pytest.mark.parametrize("sweeps", [0, 1, 6, 16])
@pytest.mark.parametrize("dense", [False, True])
def test_relax_slabs_equal_plain(n, C, sweeps, dense):
    """The slab decomposition of K3 equals the plain sweeps exactly, from
    seeded fields and from dense ones that hold values at blocked
    cells."""
    blocked = corridor_maze(n, seed=n)
    blk = _t(blocked)
    init = _t(maze_init(blocked, 2, seed=C, dense=dense))
    for f in range(2):
        want = init[f]
        for _ in range(sweeps):
            want = CF._relax_once(want, blk)
        got = slab_sweeps("relax", blk, init[f], sweeps, C)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,C", MIRROR_CASES + [(256, 8), (512, 16),
                                                (128, 4)])
@pytest.mark.parametrize("threads", [128, 256, 384, 512])
def test_thread_map_covers_each_cell_once(n, C, threads):
    for k in range(C):
        S = -(-n // C)
        rows = min(n, min(n, k * S) + S) - min(n, k * S)
        cells = thread_cells(n, C, threads, k)
        assert len(cells) == len(set(cells)) == rows * n


def test_inputs_cross_every_slab_and_outrun_the_sweeps():
    """The serpentine's runs cross every row, and the labels after the
    fleet's 49 sweeps still differ from those after 47 and 51: the paths
    are longer than the sweep count."""
    n = 256
    m = serpentine_mask(n)
    assert m[:, 2].all() and m[:, 254].sum() >= n - 1
    mt = _t(m)
    seed = _t(label_seed(m))
    a, b, c = (F._label_prop_plain(mt, seed, it) for it in (23, 24, 25))
    assert not torch.equal(a, b) and not torch.equal(b, c)
    blocked = corridor_maze(64)
    init = _t(maze_init(blocked, 8))
    d31, d32 = (CF._relax_level_xla(_t(blocked), init, it) for it in (31, 32))
    assert not torch.equal(d31, d32)
    assert bool((d32 < CF._BIG).any()) and bool((d32[:, ~_t(blocked)]
                                                  >= CF._BIG).any())


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's Pallas kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    # Imported here: the card's tests and chip_smoke.py import this module
    # for its inputs alone.
    from tests.torch_jaxref import run_reference
    d = tmp_path_factory.mktemp("sweeps")
    mask = serpentine_mask(256)
    maze64, maze256 = corridor_maze(64), corridor_maze(256)
    inputs = {"lp.mask": mask, "lp.seed": label_seed(mask),
              "lp.seed_off": label_seed(mask, off_mask=True),
              "rx64.blocked": maze64, "rx64.init": maze_init(maze64, 8),
              "rx256.blocked": maze256, "rx256.init": maze_init(maze256, 8),
              "rx256.dense": maze_init(maze256, 8, dense=True)}
    np.savez(d / "inputs.npz", **inputs)
    out = run_reference(f"""
        import jax.numpy as jnp
        from jax_mapping.ops import costfield as CF
        from jax_mapping.ops import frontier as F
        IN = dict(np.load({str(d / "inputs.npz")!r}))
        mask = jnp.asarray(IN["lp.mask"])
        for k in ("lp.seed", "lp.seed_off"):
            OUT[k] = F._label_prop_pallas(mask, jnp.asarray(IN[k]), 24)
        OUT["rx64"] = CF._relax_level_pallas(
            jnp.asarray(IN["rx64.blocked"]), jnp.asarray(IN["rx64.init"]), 32)
        for k in ("rx256.init", "rx256.dense"):
            OUT[k] = CF._relax_level_pallas(
                jnp.asarray(IN["rx256.blocked"]), jnp.asarray(IN[k]), 8)
    """, d / "ref.npz")
    return inputs, out


@pytest.mark.parametrize("key", ["lp.seed", "lp.seed_off"])
def test_label_prop_plain_matches_pallas_at_fleet_shape(ref, key):
    """256^2 x 24 iterations (49 sweeps) on the serpentine: exact."""
    inputs, out = ref
    got = F.label_prop(_t(inputs["lp.mask"]), _t(inputs[key]), 24)
    np.testing.assert_array_equal(got.numpy(), out[key])
    assert len(np.unique(out[key])) > 50


@pytest.mark.parametrize("key,n,iters", [("rx64.init", 64, 32),
                                         ("rx256.init", 256, 8),
                                         ("rx256.dense", 256, 8)])
def test_relax_plain_matches_pallas_at_fleet_shape(ref, key, n, iters):
    """8 robots' fields on the maze at (64^2, 32) and (256^2, 8): exact."""
    inputs, out = ref
    name = key.split(".")[0]
    got = CF.relax_level(_t(inputs[name + ".blocked"]), _t(inputs[key]),
                         iters)
    want = out[name] if name == "rx64" else out[key]
    np.testing.assert_array_equal(got.numpy(), want)
    reach = (want < 1e9).mean()
    assert 0.0 < reach < 1.0
