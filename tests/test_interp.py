"""Interpolation tests — ported from reference tests/edm_test.cpp:182-430."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from edm_tpu import Grid, GridSpec


def test_interpolation_1d():
    # edm_test.cpp:182-218 — log function oracle
    spec = GridSpec.create([0], [10], [1], [False])
    vals = np.array([np.log(i) if i > 0 else -np.inf for i in range(11)])
    vals[0] = 0.0  # reference stores log(0) = -inf; avoid poisoning: start at 1
    vals = np.log(np.maximum(np.arange(11), 1e-300))
    vals[0] = vals[1]  # keep the probed region (x~5) unaffected
    ders = np.array([1.0 / i if i > 0 else 0.0 for i in range(11)])
    g = Grid(
        values=jnp.asarray(vals),
        derivs=jnp.asarray(ders)[:, None],
        spec=spec,
        interpolate=True,
    )
    v, der = g.get_value_deriv(jnp.array([5.3]))
    v, der = float(v), float(der[0])
    assert math.log(5) < v < math.log(6)
    assert 1 / 6 < der < 1 / 5
    assert (v - math.log(5.3)) ** 2 < 0.1
    assert (der - 1 / 5.3) ** 2 < 0.1
    # edge probes
    for x in (5.0, 5.5, 0.0 + 1e-9, 9.999):
        g.get_value(jnp.array([x]))


def test_interp_1d_periodic():
    # edm_test.cpp:220-250 — sin/cos oracle with periodic wrap
    spec = GridSpec.create([-math.pi], [math.pi], [math.pi / 100], [True])
    xs = spec.min[0] + spec.dx[0] * np.arange(spec.nbins[0])
    g = Grid(
        values=jnp.asarray(np.sin(xs)),
        derivs=jnp.asarray(np.cos(xs))[:, None],
        spec=spec,
        interpolate=True,
    )
    for x in (math.pi / 4, 5 * math.pi / 4):
        v, der = g.get_value_deriv(jnp.array([x]))
        assert (float(v) - math.sin(x)) ** 2 < 0.1
        assert (float(der[0]) - math.cos(x)) ** 2 < 0.1


def test_interp_3d_mixed():
    # edm_test.cpp:392-430 — cos(x)sin(y)z with mixed periodicity
    spec = GridSpec.create(
        [-math.pi, -math.pi, 0],
        [math.pi, math.pi, 10],
        [math.pi / 100, math.pi / 100, 1],
        [True, True, False],
    )
    ax = [spec.min[d] + spec.dx[d] * np.arange(spec.nbins[d]) for d in range(3)]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    vals = np.cos(X) * np.sin(Y) * Z
    ders = np.stack(
        [-np.sin(X) * np.sin(Y) * Z, np.cos(X) * np.cos(Y) * Z, np.cos(X) * np.sin(Y)],
        axis=-1,
    )
    # reference stores derivatives but b_interpolate=0 in this test; the
    # nearest-bin branch returns stored values. We test the interpolating
    # branch too since that's the production path.
    g = Grid(
        values=jnp.asarray(vals), derivs=jnp.asarray(ders), spec=spec, interpolate=False
    )
    pt = jnp.array([-10.75 * math.pi / 2, 8.43 * math.pi / 2, 3.5])
    v, der = g.get_value_deriv(pt)
    x0 = [-10.75 * math.pi / 2, 8.43 * math.pi / 2, 3.5]
    f = math.cos(x0[0]) * math.sin(x0[1]) * x0[2]
    tru = [
        -math.sin(x0[0]) * math.sin(x0[1]) * x0[2],
        math.cos(x0[0]) * math.cos(x0[1]) * x0[2],
        math.cos(x0[0]) * math.sin(x0[1]),
    ]
    # nearest-bin: loose tolerance
    assert (float(v) - f) ** 2 < 0.1
    gi = dataclasses.replace(g, interpolate=True)
    v, der = gi.get_value_deriv(pt)
    assert (float(v) - f) ** 2 < 0.1
    for d in range(3):
        assert (float(der[d]) - tru[d]) ** 2 < 0.1


def test_out_of_grid_returns_zero():
    spec = GridSpec.create([0], [10], [1], [False])
    g = Grid(
        values=jnp.ones(spec.nbins),
        derivs=jnp.ones(spec.nbins + (1,)),
        spec=spec,
        interpolate=True,
    )
    v, der = g.get_value_deriv(jnp.array([[11.0], [-0.5]]))
    np.testing.assert_allclose(np.asarray(v), 0.0)
    np.testing.assert_allclose(np.asarray(der), 0.0)


def test_matvec_lookup_bitwise_matches_gather():
    """A bulk 1-D lookup (>= 32768 points, the size that used to switch
    to a one-hot matmul fetch) is bitwise the same lookup done in small
    chunks: one gather path, whatever the batch size."""
    import numpy as np
    import jax.numpy as jnp

    from edm_tpu import GaussGrid

    for per in (True, False):
        g = GaussGrid.create([0], [3], [0.02], [per], [0.1], dtype=jnp.float64)
        rng = np.random.default_rng(1)
        g, _ = g.add_value(
            jnp.asarray(rng.uniform(0.2, 2.8, (30, 1))), jnp.full(30, 0.3)
        )
        xs = jnp.asarray(rng.uniform(-0.5, 3.5, (40000, 1)))
        vb, db = g.grid.get_value_deriv(xs)
        parts = [g.grid.get_value_deriv(xs[i : i + 1000]) for i in range(0, 40000, 1000)]
        vg = jnp.concatenate([p[0] for p in parts])
        dg = jnp.concatenate([p[1] for p in parts])
        assert float(jnp.max(jnp.abs(vb - vg))) == 0.0
        assert float(jnp.max(jnp.abs(db - dg))) == 0.0
