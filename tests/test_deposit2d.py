"""Separable matmul 2-D deposition (ops/deposit.dense_tables_2d), used by
add_hills_round on fully-periodic 2-D grids.

Divergence (README ledger): per-dim square support instead of the
reference's circular dp^2 < 8 cutoff — corner contributions <= e^-8 of the
hill peak are kept.  Tests pin (a) agreement with the windowed reference
path at that tolerance, (b) the bias-limiter invariant exactly (deposited
grid integral == h*s with the path's own s), (c) engine-round equivalence.
"""

import numpy as np
import jax.numpy as jnp

from edm_tpu import GaussGrid
from edm_tpu import bias as B
from edm_tpu.ops.deposit import dense_tables_2d, deposit_from_tables_2d
from edm_tpu.utils.config import parse_edm_text


def _mk(dtype=jnp.float64):
    return GaussGrid.create(
        [0.0, 0.0], [4.0, 4.0], [0.05, 0.05], [True, True], [0.2, 0.2],
        dtype=dtype,
    )


def test_dense2d_matches_windowed():
    g = _mk()
    rng = np.random.default_rng(0)
    centers = jnp.asarray(rng.uniform(0, 4, (40, 2)))
    heights = jnp.asarray(rng.uniform(0.1, 0.5, (40,)))

    g_ref, added_ref = g.add_value(centers, heights)  # windowed (circular)

    ux, uy, dux, duy, s = dense_tables_2d(g, centers)
    g_fast = deposit_from_tables_2d(g, ux, uy, dux, duy, heights)
    added_fast = heights * s

    scale = float(jnp.max(jnp.abs(g_ref.grid.values)))
    # square-vs-circular support: differences bounded by the e^-8 corner tail
    np.testing.assert_allclose(
        np.asarray(g_fast.grid.values), np.asarray(g_ref.grid.values),
        atol=1e-3 * scale,
    )
    np.testing.assert_allclose(
        np.asarray(g_fast.grid.derivs), np.asarray(g_ref.grid.derivs),
        atol=1e-2 * scale,
    )
    np.testing.assert_allclose(
        np.asarray(added_fast), np.asarray(added_ref), rtol=5e-4
    )

    # exact limiter invariant: deposited integral == h * s for THIS path
    vol = 0.05 * 0.05
    got = float(jnp.sum(g_fast.grid.values)) * vol
    want = float(jnp.sum(added_fast))
    assert abs(got - want) < 1e-9 * max(1.0, abs(want))


def test_engine_round_uses_dense2d():
    """A fully-periodic 2-D engine round must produce the same state as the
    reference windowed math within the square-support tolerance, and exact
    internal consistency (cum_bias == grid integral)."""
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.5\nbias_per_step 50\ndimension 2\n"
        "box_low 0 0\nbox_high 4 4\nbias_spacing 0.05 0.05\nbias_sigma 0.2 0.2\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0, 0], [4, 4], [0, 0], [4, 4], [True, True], [0, 0],
        dtype=jnp.float64,
    )
    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.uniform(0, 4, (30, 2)))
    state2, rec = B.add_hills_round(
        params, state, pos, jnp.zeros(30), 30.0
    )
    vol = float(np.prod(state2.bias.spec.grid.dx))
    integral = float(jnp.sum(state2.bias.grid.values)) * vol
    assert abs(integral - float(state2.cum_bias)) < 1e-9 * max(1.0, integral)
    # deposited heights = prefactor / est (no tempering, accept-all)
    np.testing.assert_allclose(
        np.asarray(rec.hill_dep_h), 0.5 / 30.0, rtol=1e-12
    )


def test_dense3d_matches_windowed():
    """3-D separable (einsum) deposition vs the windowed reference path."""
    from edm_tpu.ops.deposit import dense_tables_sep, deposit_from_tables_sep

    g = GaussGrid.create(
        [0.0] * 3, [4.0] * 3, [0.1] * 3, [True] * 3, [0.25] * 3,
        dtype=jnp.float64,
    )
    rng = np.random.default_rng(3)
    centers = jnp.asarray(rng.uniform(0, 4, (12, 3)))
    heights = jnp.asarray(rng.uniform(0.1, 0.5, (12,)))
    g_ref, added_ref = g.add_value(centers, heights)
    tabs, s = dense_tables_sep(g, centers)
    g_fast = deposit_from_tables_sep(g, tabs, heights)
    scale = float(jnp.max(jnp.abs(g_ref.grid.values)))
    np.testing.assert_allclose(
        np.asarray(g_fast.grid.values), np.asarray(g_ref.grid.values),
        atol=2e-3 * scale,
    )
    np.testing.assert_allclose(
        np.asarray(heights * s), np.asarray(added_ref), rtol=1e-3
    )
    # exact limiter invariant for this path
    vol = 0.1**3
    got = float(jnp.sum(g_fast.grid.values)) * vol
    want = float(jnp.sum(heights * s))
    assert abs(got - want) < 1e-9 * max(1.0, abs(want))


def test_engine_round_3d_periodic():
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.5\nbias_per_step 50\ndimension 3\n"
        "box_low 0 0 0\nbox_high 4 4 4\nbias_spacing 0.1 0.1 0.1\n"
        "bias_sigma 0.25 0.25 0.25\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0]*3, [4]*3, [0]*3, [4]*3, [True]*3, [0]*3,
        dtype=jnp.float64,
    )
    rng = np.random.default_rng(5)
    pos = jnp.asarray(rng.uniform(0, 4, (10, 3)))
    state2, rec = B.add_hills_round(params, state, pos, jnp.zeros(10), 10.0)
    vol = float(np.prod(state2.bias.spec.grid.dx))
    integral = float(jnp.sum(state2.bias.grid.values)) * vol
    assert abs(integral - float(state2.cum_bias)) < 1e-9 * max(1.0, integral)
