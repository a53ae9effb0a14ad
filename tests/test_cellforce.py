"""Cell-lattice force pass (ops/cellforce.py): the Triton kernel in the
Pallas interpreter against the plain-XLA reference, the wrapper's cap
padding and occupancy loop, row restriction, and the exact lookup's
gather path against a float64 evaluation of the same Hermite formula."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from edm_tpu import bias as B
from edm_tpu.models.lj import LJParams
from edm_tpu.ops.cellforce import lattice_force
from edm_tpu.ops.chebyshev import fit_gauss_grid
from edm_tpu.utils.config import parse_edm_text

CFG = (
    "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
    "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
)
LJ = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
EDGE = 3.05


def _pair_grid():
    """A 1-D pairwise-CV bias grid with a few hills on it (float32)."""
    params, state = B.subdivide(
        parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
        dtype=jnp.float32,
    )
    gg, _ = state.bias.add_value(
        jnp.asarray([[1.1], [1.6], [2.2], [2.7]], jnp.float32),
        jnp.asarray([0.5, 0.3, 0.4, 0.2], jnp.float32),
    )
    return gg


def _lattice(ncells, cap, seed=0, holes=False):
    """Slot lattice with atoms on a jittered sub-lattice of each cell (no
    close contacts, so LJ does not drown the bias term).  ``holes`` puts
    each cell's atoms in random slots instead of a prefix, as incremental
    rebins leave them."""
    rng = np.random.default_rng(seed)
    C = int(np.prod(ncells))
    sub = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1)
    sub = sub.reshape(-1, 3) * (EDGE / 3.0) + EDGE / 6.0
    xs = np.zeros((C, cap, 3), np.float32)
    mc = np.zeros((C, cap), np.float32)
    ts = np.zeros((C, cap), np.float32)
    for c in range(C):
        cell = np.array(
            [c // (ncells[1] * ncells[2]), (c // ncells[2]) % ncells[1],
             c % ncells[2]], np.float32,
        )
        occ = int(rng.integers(1, min(cap, 27) + 1))
        slots = rng.permutation(cap)[:occ] if holes else np.arange(occ)
        sites = rng.permutation(27)[:occ]
        xs[c, slots] = cell * EDGE + sub[sites] + rng.uniform(-0.1, 0.1, (occ, 3))
        mc[c, slots] = 1.0
        ts[c, slots] = rng.integers(1, 3, occ)
    box = tuple(n * EDGE for n in ncells)
    return jnp.asarray(xs), jnp.asarray(mc), jnp.asarray(ts), box


def _compare(ref, got):
    e_ref, f_ref = ref
    e_got, f_got = got
    assert f_got.shape == f_ref.shape
    scale = max(1.0, float(jnp.abs(f_ref).max()))
    # f32 summation order differs (27 blocks vs one 27*cap row) and the
    # kernel takes 1/r through rsqrt: agreement to f32 rounding of the row
    # sums, relative to the largest force
    np.testing.assert_allclose(np.asarray(f_got), np.asarray(f_ref), atol=2e-5 * scale)
    assert abs(float(e_got) - float(e_ref)) <= 1e-5 * max(1.0, abs(float(e_ref)))


@pytest.mark.parametrize("row_box", [None, ((1, 0, 1), (2, 3, 3))], ids=["all", "rowbox"])
@pytest.mark.parametrize("typed", [False, True], ids=["untyped", "typed"])
@pytest.mark.parametrize("energy", [True, False], ids=["energy", "noenergy"])
@pytest.mark.parametrize("lookup", ["hermite", "chebyshev"])
def test_triton_kernel_matches_xla(lookup, energy, typed, row_box):
    gg = _pair_grid()
    table = gg if lookup == "hermite" else fit_gauss_grid(gg, 16, 4)
    ncells = (4, 3, 5)
    xs, mc, ts, box = _lattice(ncells, 16)
    kw = dict(
        ts=ts if typed else None, type_pair=(1, 2) if typed else None,
        row_box=row_box,
    )
    ref = lattice_force(xs, mc, mc, ncells, box, LJ, table, energy, **kw)
    got = lattice_force(
        xs, mc, mc, ncells, box, LJ, table, energy, impl="triton",
        interpret=True, **kw,
    )
    _compare(ref, got)
    if energy:
        assert float(ref[0]) != 0.0  # the bias term is exercised
    else:
        assert float(got[0]) == 0.0


@pytest.mark.parametrize("cap", [8, 12, 24], ids=lambda c: f"cap{c}")
def test_triton_kernel_pads_cap(cap):
    """Caps that are not a power of two are padded in the wrapper (12 ->
    16, 24 -> 32) and sliced back; padded slots carry zero masks."""
    gg = _pair_grid()
    ncells = (3, 4, 3)
    xs, mc, _, box = _lattice(ncells, cap, seed=cap)
    ref = lattice_force(xs, mc, mc, ncells, box, LJ, gg)
    got = lattice_force(xs, mc, mc, ncells, box, LJ, gg, impl="triton", interpret=True)
    assert got[1].shape == (xs.shape[0], cap, 3)
    _compare(ref, got)


def test_triton_kernel_sweeps_to_highest_slot():
    """Occupied slots need not be a prefix (incremental rebins leave
    holes): the kernel's per-cell candidate loop must run to the highest
    occupied slot, not to the atom count."""
    gg = _pair_grid()
    ncells = (3, 3, 4)
    xs, mc, _, box = _lattice(ncells, 32, seed=5, holes=True)
    ref = lattice_force(xs, mc, mc, ncells, box, LJ, gg)
    got = lattice_force(xs, mc, mc, ncells, box, LJ, gg, impl="triton", interpret=True)
    _compare(ref, got)


def test_triton_kernel_refuses_non_gpu_backend():
    """Asked to compile (not interpret) on a backend without the Triton
    route, the kernel raises instead of falling back."""
    gg = _pair_grid()
    ncells = (3, 3, 3)
    xs, mc, _, box = _lattice(ncells, 8)
    with pytest.raises(ValueError, match="interpret"):
        lattice_force(xs, mc, mc, ncells, box, LJ, gg, impl="triton")


def test_unknown_force_impl_rejected():
    gg = _pair_grid()
    ncells = (3, 3, 3)
    xs, mc, _, box = _lattice(ncells, 8)
    with pytest.raises(ValueError, match="unknown force implementation"):
        lattice_force(xs, mc, mc, ncells, box, LJ, gg, impl="cuda")


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_row_box_equals_masked_rows(impl):
    """Restricting rows to a sub-box gives the same forces as the full
    lattice with rows outside the box masked out."""
    gg = _pair_grid()
    ncells = (5, 4, 3)
    xs, mc, _, box = _lattice(ncells, 16, seed=3)
    origin, rdims = (1, 1, 0), (3, 2, 3)
    g = np.zeros(ncells, bool)
    g[1:4, 1:3, 0:3] = True
    rows = mc * jnp.asarray(g.reshape(-1), jnp.float32)[:, None]
    kw = dict(impl=impl, interpret=impl == "triton")
    full = lattice_force(xs, rows, mc, ncells, box, LJ, gg, **kw)
    boxed = lattice_force(xs, mc, mc, ncells, box, LJ, gg, row_box=(origin, rdims), **kw)
    _compare(full, boxed)
    assert float(jnp.abs(boxed[1]).max()) > 0


@pytest.mark.parametrize("n_points", [1000, 32768, 200000])
def test_lookup_gather_matches_float64(n_points):
    """The exact pair-CV lookup (scalar gathers) agrees with a float64
    evaluation of the same formula to float32 rounding at every size —
    including the bulk sizes that once took a matmul-based fetch."""
    from edm_tpu.ops.interp import grid_value_deriv, hermite_1d_f64

    grid = _pair_grid().grid
    lo, dx = float(grid.spec.min[0]), float(grid.spec.dx[0])
    hi = float(grid.spec.max[0]) - 2 * dx
    x = np.random.default_rng(n_points).uniform(lo, hi, n_points)
    val, der = grid_value_deriv(grid, jnp.asarray(x, jnp.float32)[:, None])
    x32 = np.asarray(np.float32(x), np.float64)
    v64, d64 = hermite_1d_f64(grid.values, grid.derivs[:, 0], lo, dx, x32)
    vs = np.abs(v64).max()
    ds = np.abs(d64).max()
    assert np.abs(np.asarray(val) - v64).max() <= 1e-5 * vs
    assert np.abs(np.asarray(der)[:, 0] - d64).max() <= 1e-4 * ds


@pytest.mark.gpu
@pytest.mark.parametrize("lookup", ["hermite", "chebyshev"])
def test_triton_kernel_compiled_matches_xla(gpu, lookup):
    """The kernel as compiled for the card (not interpreted) against the
    plain-XLA pass on the same card."""
    gg = _pair_grid()
    table = gg if lookup == "hermite" else fit_gauss_grid(gg, 16, 4)
    ncells = (5, 4, 6)
    xs, mc, ts, box = _lattice(ncells, 32, seed=9, holes=True)
    for typed in (False, True):
        kw = dict(ts=ts if typed else None, type_pair=(1, 2) if typed else None)
        ref = lattice_force(xs, mc, mc, ncells, box, LJ, table, **kw)
        got = lattice_force(xs, mc, mc, ncells, box, LJ, table, impl="triton", **kw)
        _compare(ref, got)


@pytest.mark.gpu
def test_lookup_precision_on_card(gpu):
    """No TF32 in the exact lookup on the card: float32 agreement with the
    float64 evaluation of the same formula."""
    from edm_tpu.ops.interp import grid_value_deriv, hermite_1d_f64

    grid = _pair_grid().grid
    lo, dx = float(grid.spec.min[0]), float(grid.spec.dx[0])
    hi = float(grid.spec.max[0]) - 2 * dx
    x = np.random.default_rng(0).uniform(lo, hi, 1_000_000).astype(np.float32)
    val, der = jax.jit(lambda x: grid_value_deriv(grid, x[:, None]))(jnp.asarray(x))
    v64, d64 = hermite_1d_f64(grid.values, grid.derivs[:, 0], lo, dx, x.astype(np.float64))
    assert np.abs(np.asarray(val) - v64).max() <= 1e-5 * np.abs(v64).max()
    assert np.abs(np.asarray(der)[:, 0] - d64).max() <= 1e-4 * np.abs(d64).max()
