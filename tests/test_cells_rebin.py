"""Incremental slot-to-slot cell rebinning (models/cells.plan_incremental_
rebin / apply_incremental_rebin): stayers keep their slots, boundary
crossers move into holes of their target cells, infeasible plans are
detected for the in-graph argsort fallback.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from edm_tpu.models.cells import (
    CellSpec,
    apply_incremental_rebin,
    build_table,
    cell_of,
    plan_incremental_rebin,
)


def _setup(n=500, seed=0, cap=None):
    rng = np.random.default_rng(seed)
    box = [12.0, 12.0, 12.0]
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=n, cap=cap)
    x = jnp.asarray(rng.uniform(0, 12.0, (n, 3)))
    t = build_table(spec, x)
    assert not bool(t.overflow)
    Cg = spec.n_cells
    aid_g = t.aid
    # slot positions
    aid_c = jnp.clip(aid_g, 0, n - 1)
    xs = jnp.where((aid_g < n)[:, None], x[aid_c], 0.0).reshape(
        spec.n_cells, spec.cap, 3
    )
    return spec, Cg, x, aid_g, xs


def _check_consistent(spec, aid_g, xs_flat, n):
    """Every atom in exactly one slot, in the cell its position maps to."""
    aid = np.asarray(aid_g)
    real = aid < n
    # permutation property
    assert sorted(aid[real].tolist()) == list(range(n))
    # cell consistency
    cells = np.arange(aid.shape[0]) // spec.cap
    pos = np.asarray(xs_flat)[real]
    want = np.asarray(cell_of(spec, jnp.asarray(pos)))
    np.testing.assert_array_equal(cells[real], want)


def test_incremental_rebin_moves_crossers():
    spec, Cg, x, aid_g, xs = _setup()
    n = spec.n_atoms
    # drift: push ~10% of atoms across a boundary along x
    rng = np.random.default_rng(1)
    xs_np = np.array(xs)
    aid2 = np.asarray(aid_g).reshape(Cg, spec.cap)
    moved = 0
    for c in range(Cg):
        for s in range(spec.cap):
            if aid2[c, s] < n and rng.random() < 0.1:
                xs_np[c, s, 0] += spec.edge[0] * 0.6  # crosses for some
                moved += 1
    xs2 = jnp.asarray(xs_np)

    plan = plan_incremental_rebin(spec, aid_g, xs2, mover_cap=256)
    assert bool(plan.feasible)
    n_mov = int(plan.n_movers)
    assert 0 < n_mov <= moved

    aid_new, (xs_new,) = apply_incremental_rebin(
        spec, plan, aid_g, [xs2.reshape(-1, 3)]
    )
    _check_consistent(spec, aid_new, xs_new, n)
    # stayers kept their slots
    aid_old = np.asarray(aid_g)
    aid_nw = np.asarray(aid_new)
    cur = np.asarray(cell_of(spec, xs2.reshape(-1, 3)))
    for i in range(aid_old.shape[0]):
        if aid_old[i] < n and cur[i] == i // spec.cap:
            assert aid_nw[i] == aid_old[i]


def test_incremental_rebin_swap_at_full_occupancy():
    """Two atoms swapping cells stay feasible even with zero pre-existing
    holes in either cell (vacated slots count as holes)."""
    n = 16
    spec = CellSpec.create([9.0, 9.0, 9.0], cutoff=3.0, n_atoms=n, cap=8)
    # cells are 3x3x3 of edge 3; place 8 atoms in cell (0,0,0), 8 in (1,0,0)
    pts = []
    for k in range(8):
        pts.append([0.2 + 0.3 * k, 1.5, 1.5])
    for k in range(8):
        pts.append([3.2 + 0.3 * k, 1.5, 1.5])
    x = jnp.asarray(np.asarray(pts))
    t = build_table(spec, x)
    assert not bool(t.overflow)
    aid_g = t.aid
    aid_c = jnp.clip(aid_g, 0, n - 1)
    xs = jnp.where((aid_g < n)[:, None], x[aid_c], 0.0)
    # swap: move one atom from cell A to B and one from B to A
    xs_np = np.array(xs).reshape(spec.n_cells, spec.cap, 3)
    a_slot = np.nonzero(np.asarray(aid_g).reshape(spec.n_cells, spec.cap)[0] < n)[0][0]
    b_cell = int(cell_of(spec, jnp.asarray([[3.3, 1.5, 1.5]]))[0])
    b_slot = np.nonzero(np.asarray(aid_g).reshape(spec.n_cells, spec.cap)[b_cell] < n)[0][0]
    xs_np[0, a_slot, 0] += 3.0
    xs_np[b_cell, b_slot, 0] -= 3.0
    xs2 = jnp.asarray(xs_np)

    plan = plan_incremental_rebin(spec, aid_g, xs2, mover_cap=64)
    assert bool(plan.feasible)
    assert int(plan.n_movers) == 2
    aid_new, (xs_new,) = apply_incremental_rebin(
        spec, plan, aid_g, [xs2.reshape(-1, 3)]
    )
    _check_consistent(spec, aid_new, xs_new, n)


def test_incremental_rebin_infeasible_detected():
    # mover_cap exceeded
    spec, Cg, x, aid_g, xs = _setup(n=500, seed=3)
    xs_np = np.array(xs)
    xs_np[..., 0] += spec.edge[0]  # EVERY atom crosses
    plan = plan_incremental_rebin(spec, aid_g, jnp.asarray(xs_np), mover_cap=16)
    assert not bool(plan.feasible)
    assert int(plan.n_movers) > 16


@pytest.mark.slow
def test_cell_host_incremental_matches_full_rebuild():
    """The cell host with incremental rebins produces the same atom-order
    trajectory as one forced onto the full argsort rebuild (kT=0:
    deterministic; slot layouts may differ, physics must not)."""
    from edm_tpu import bias as B
    from edm_tpu.models import pair_edm
    from edm_tpu.models.langevin import LangevinParams
    from edm_tpu.models.lj import LJParams
    from edm_tpu.models.pair_edm_cells import (
        atom_positions,
        init_cell_state,
        make_cell_step,
    )
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    side, a = 8, 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    # perturb off-lattice so atoms drift across boundaries under forces
    rng = np.random.default_rng(5)
    pts = pts + rng.uniform(-0.3, 0.3, pts.shape)
    box = [side * a] * 3
    lp = LangevinParams(dt=0.004, friction=1.0, kT=0.0)
    lj = LJParams()
    from edm_tpu.models.cells import CellSpec

    spec = CellSpec.create(box, cutoff=3.0, n_atoms=len(pts))
    core = pair_edm.init_state(
        state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0),
        pair_lookup="chebyshev",
    )
    cst = init_cell_state(spec, core)

    def run(mover_cap):
        step = make_cell_step(
            params, lp, lj, spec, hill_stride=10**6, rebuild_stride=3,
            mover_cap=mover_cap,
        )
        s = cst
        for _ in range(12):
            s, _ = step(s, None)
        return s

    s_inc = run(None)  # default: incremental when feasible
    s_full = run(1)    # mover_cap=1: essentially always falls back to full
    xi = np.asarray(atom_positions(spec, s_inc))
    xf = np.asarray(atom_positions(spec, s_full))
    # identical physics; slot-order f32 summation differences only
    np.testing.assert_allclose(xi, xf, rtol=5e-5, atol=5e-6)
    assert not bool(s_inc.table_overflow)
