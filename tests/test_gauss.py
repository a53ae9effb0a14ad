"""Gaussian deposition tests — ported from reference tests/edm_test.cpp:252-843.

These encode the invariants the physics depends on: pointwise Gaussian shape
(incl. periodic images and system-boundary wrapping), integral conservation
(sum of added bias == returned bias_added == requested height), finite-
difference gradient consistency, and McGovern–De Pablo zero-force boundaries.
"""

import math

import jax.numpy as jnp
import numpy as np

from edm_tpu import GaussGrid

SQRT2PI = math.sqrt(2 * math.pi)


def make_gauss(min, max, spacing, periodic, sigma, dtype=jnp.float64):
    return GaussGrid.create(min, max, spacing, periodic, sigma, dtype=dtype)


def test_gauss_grid_add_check():
    # edm_test.cpp:432-457
    g = make_gauss([-10], [10], [1], [True], [1])
    g, _ = g.add_value(jnp.array([0.0]), 1.0)

    v = float(g.get_value(jnp.array([0.0])))
    assert (v - 1 / SQRT2PI) ** 2 < 1e-10

    for i in range(-6, 7):
        v, der = g.get_value_deriv(jnp.array([float(i)]))
        assert (float(v) - math.exp(-i * i / 2) / SQRT2PI) ** 2 < 0.01
        assert (float(der[0]) - (-i * math.exp(-i * i / 2)) / SQRT2PI) ** 2 < 0.01


def test_gauss_pbc_check():
    # edm_test.cpp:460-493
    g = make_gauss([2], [10], [1], [True], [1])
    g, _ = g.add_value(jnp.array([2.0]), 1.0)
    L = 2 - 10
    for i in range(-6, 7):
        dx = i - 2.0
        dx -= round(dx / L) * L
        v, der = g.get_value_deriv(jnp.array([float(i)]))
        assert (float(v) - math.exp(-dx * dx / 2) / SQRT2PI) ** 2 < 0.01
        assert (float(der[0]) - (-dx * math.exp(-dx * dx / 2)) / SQRT2PI) ** 2 < 0.01


def test_gauss_subdivided_pbc_check():
    # edm_test.cpp:496-534 — grid is a subdomain of a periodic box
    g = make_gauss([2], [4], [1], [False], [1])
    g = g.set_boundary([2], [10], [True])
    g, _ = g.add_value(jnp.array([11.0]), 1.0)  # equivalent to x=1 after wrap
    L = 2 - 10
    for i in range(2, 4):
        dx = i - 11.0
        dx -= round(dx / L) * L
        v, der = g.get_value_deriv(jnp.array([float(i)]))
        assert (float(v) - math.exp(-dx * dx / 2) / SQRT2PI) ** 2 < 0.01
        assert (float(der[0]) - (-dx * math.exp(-dx * dx / 2)) / SQRT2PI) ** 2 < 0.01


def _integrate(g, lo, hi, dx=0.1):
    xs = np.arange(lo, hi, dx)[:, None]
    return float(jnp.sum(g.get_value(jnp.asarray(xs)))) * dx


def test_gauss_grid_integral():
    # edm_test.cpp:537-574
    g = make_gauss([-100], [100], [1], [True], [1.2])
    rng = np.random.default_rng(42)
    N = 20
    centers = (rng.integers(0, 200, N) - 100 + np.arange(N) / N).astype(float)[:, None]
    g, bias_added = g.add_value(jnp.asarray(centers), jnp.full((N,), 1.5))
    g_integral = float(jnp.sum(bias_added))
    area = _integrate(g, -100, 100)
    assert (area - N * 1.5) ** 2 < 1
    assert (area - g_integral) ** 2 < 0.1


def test_gauss_grid_integral_mcgdp():
    # edm_test.cpp:576-628 — boundary-corrected hills: area == sum(bias_added).
    # NOTE: the reference's own `(area - N*1.5)^2 < 1` assertion FAILS in the
    # shipped code (boundary-centered hills deposit 1.7697, not the author's
    # printed expectation of 1.5; verified by compiling the reference serial
    # build: area=32.856, N*1.5=30). We assert the invariant that actually
    # holds — conservation — plus oracle values from the reference binary.
    g = make_gauss([-100], [100], [1], [False], [10])
    total = 0.0
    for x0, oracle in ((-100.0, 1.769664355334), (100.0, 1.769538885991)):
        g, added = g.add_value(jnp.array([x0]), 1.5)
        total += float(added)
        assert abs(float(added) - oracle) < 1e-6  # reference-binary oracle
    g, added = g.add_value(jnp.array([-55.5]), 1.5)
    total += float(added)
    assert abs(float(added) - 1.496694614837) < 1e-6
    rng = np.random.default_rng(7)
    N = 20
    centers = (rng.integers(0, 200, N) - 100 + np.arange(N) / N).astype(float)[:, None]
    g, added = g.add_value(jnp.asarray(centers), jnp.full((N,), 1.5))
    total += float(jnp.sum(added))
    area = _integrate(g, -100, 100)
    assert (area - total) ** 2 < 0.1


def test_gauss_grid_derivative():
    # edm_test.cpp:631-672 — FD consistency of interpolated values/gradients
    g = make_gauss([-100], [100], [1], [True], [1.2])
    rng = np.random.default_rng(11)
    N = 20
    centers = (rng.integers(0, 200, N) - 100 + np.arange(N) / N).astype(float)[:, None]
    g, _ = g.add_value(jnp.asarray(centers), jnp.full((N,), 1.5))

    dx = 0.1
    xs = (-100 + dx * np.arange(int(200 / dx)))[:, None]
    v, der = g.get_value_deriv(jnp.asarray(xs))
    v = np.asarray(v)
    der = np.asarray(der)[:, 0]
    approx = (v[2:] - v[:-2]) / (2 * dx)
    assert np.max((approx - der[1:-1]) ** 2) < 0.01


def test_gauss_grid_derivative_mcgdp():
    # edm_test.cpp:674-721 — zero slope at the (grid==boundary) edges
    g = make_gauss([-100], [100], [1], [False], [1.2])
    rng = np.random.default_rng(13)
    N = 20
    centers = (rng.integers(0, 200, N) - 100 + np.arange(N) / N).astype(float)[:, None]
    g, _ = g.add_value(jnp.asarray(centers), jnp.full((N,), 1.5))

    dx = 0.1
    xs = (-100 + dx * np.arange(int(200 / dx)))[:, None]
    v, der = g.get_value_deriv(jnp.asarray(xs))
    v = np.asarray(v)
    der = np.asarray(der)[:, 0]
    approx = (v[2:] - v[:-2]) / (2 * dx)
    assert np.max((approx - der[1:-1]) ** 2) < 0.001
    assert der[0] ** 2 < 0.001  # flat at the left boundary
    assert der[-1] ** 2 < 0.01


def test_boundary_remap_wrap():
    # edm_test.cpp:252-298
    g = make_gauss([0, 0], [10, 5], [1, 1], [True, False], [0.1, 0.1])
    g = g.set_boundary([0, 0], [10, 10], [True, True])

    def remap(p):
        return np.asarray(g.remap(jnp.array(p, dtype=jnp.float64)))

    np.testing.assert_allclose(remap([0.0, 1.0]), [0, 1], atol=1e-6)
    np.testing.assert_allclose(remap([-1.0, 1.0]), [9, 1], atol=1e-6)
    np.testing.assert_allclose(remap([-1.0, 6.0]), [9, 6], atol=1e-6)
    np.testing.assert_allclose(remap([-1.0, 11.0]), [9, 1], atol=1e-6)
    np.testing.assert_allclose(remap([-1.0, 9.0]), [9, -1], atol=1e-6)
    np.testing.assert_allclose(remap([-1.0, -1.0]), [9, -1], atol=1e-6)


def test_boundary_remap_wrap_2():
    # edm_test.cpp:300-333
    g = make_gauss([-2], [7], [0.1], [False], [0.1])
    g = g.set_boundary([0], [10], [True])

    def remap(x):
        return float(g.remap(jnp.array([x], dtype=jnp.float64))[0])

    assert abs(remap(0.0) - 0.0) < 1e-6
    assert abs(remap(-1.0) - -1.0) < 1e-6
    assert abs(remap(9.0) - -1.0) < 1e-6
    assert abs(remap(6.0) - 6.0) < 1e-6


def test_boundary_remap_wrap_3():
    # edm_test.cpp:336-360 — deposit just inside; force nonzero at 0
    g = make_gauss([-2], [7], [0.1], [False], [0.1])
    g = g.set_boundary([0], [10], [True])
    g, _ = g.add_value(jnp.array([0.01]), 1.0)
    _, der = g.get_value_deriv(jnp.array([0.0]))
    assert abs(float(der[0])) > 0.1


def test_boundary_remap_nowrap():
    # edm_test.cpp:363-387 — non-periodic boundary rejects outside deposits
    g = make_gauss([-2], [7], [0.1], [False], [0.1])
    g = g.set_boundary([0], [10], [False])
    g2, added = g.add_value(jnp.array([-0.01]), 1.0)
    assert float(added) == 0.0
    np.testing.assert_allclose(np.asarray(g2.grid.values), np.asarray(g.grid.values))


def test_gauss_interp_mcgdp_1d_boundary_duplication():
    # edm_test.cpp:723-769
    g = make_gauss([-100], [100], [1], [True], [10.0])
    g = g.set_boundary([-50], [50], [False])

    rng = np.random.default_rng(17)
    centers = (rng.integers(0, 200, 20) - 100).astype(float)[:, None]
    g, _ = g.add_value(jnp.asarray(centers), jnp.ones((20,)))

    # boundary rows are duplicated outward (zero-force flattening)
    vals = np.asarray(g.grid.values)
    assert (vals[50] - vals[49]) ** 2 < 1e-10
    assert (vals[150] - vals[151]) ** 2 < 1e-10

    # NOTE: the shipped reference test asserts v(50.1)==v(50.0), but the
    # reference binary itself returns v(50.1)=0 (outside the non-periodic
    # boundary get_value short-circuits to 0, gaussian_grid.h:109-113) while
    # v(50.0) is finite — that assertion is bit-rotted.  The invariants that
    # actually hold (verified against the compiled reference): 0 outside the
    # boundary, finite at the edge, derivative exactly 0 at the boundary.
    assert float(g.get_value(jnp.array([50.1]))) == 0.0
    assert float(g.get_value(jnp.array([50.0]))) > 0.0
    _, der = g.get_value_deriv(jnp.array([50.0]))
    assert float(der[0]) ** 2 < 1e-10
    assert float(g.get_value(jnp.array([-50.1]))) == 0.0
    assert float(g.get_value(jnp.array([-50.0]))) > 0.0
    _, der = g.get_value_deriv(jnp.array([-50.0]))
    assert float(der[0]) ** 2 < 1e-10


def test_mcgdp_reference_binary_parity():
    """Pin grid values against the compiled reference binary for the
    edm_test.cpp:723-769 scenario (20 known hills, sub-boundary [-50,50])."""
    g = make_gauss([-100], [100], [1], [True], [10.0])
    g = g.set_boundary([-50], [50], [False])
    centers = np.array(
        [83, -14, 77, 15, 93, 35, 86, -8, -51, -79, 62, -73, -10, -41, 63, 26, 40, -74, 72, 36],
        dtype=float,
    )[:, None]
    g, _ = g.add_value(jnp.asarray(centers), jnp.ones((20,)))
    vals = np.asarray(g.grid.values)
    # oracle values from the reference serial build (-O2, srand(1) stream)
    assert abs(vals[49] - 0.0533661964) < 1e-8
    assert abs(vals[50] - 0.0533661964) < 1e-8
    assert abs(vals[150] - 0.1088965998) < 1e-8
    assert abs(vals[151] - 0.1088965998) < 1e-8
    assert abs(float(g.get_value(jnp.array([50.0]))) - 0.1088965998) < 1e-8
    assert abs(float(g.get_value(jnp.array([-50.0]))) - 0.0533661964) < 1e-8


def test_gauss_grid_integral_regression_1():
    # edm_test.cpp:823-843 — historical failing center
    g = make_gauss([0], [10], [0.009765625], [True], [0.1])
    g = g.set_boundary([0], [10], [True])
    g, bias_added = g.add_value(jnp.array([-3.91944]), 1.0)
    assert (float(bias_added) - 1.0) ** 2 < 0.1


def test_deposit_linearity_matches_sequential():
    # batched scatter-add must equal the reference's sequential deposition
    g0 = make_gauss([-10], [10], [0.5], [True], [0.7])
    centers = np.array([[0.0], [0.2], [-3.0], [9.9]])
    heights = np.array([1.0, 0.5, 2.0, 0.25])

    gb, added_b = g0.add_value(jnp.asarray(centers), jnp.asarray(heights))

    gs = g0
    added_s = []
    for c, h in zip(centers, heights):
        gs, a = gs.add_value(jnp.asarray(c), float(h))
        added_s.append(float(a))

    np.testing.assert_allclose(np.asarray(added_b), added_s, rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(gb.grid.values), np.asarray(gs.grid.values), rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(gb.grid.derivs), np.asarray(gs.grid.derivs), rtol=1e-10, atol=1e-12
    )


def test_gauss_grid_from_file(tmp_path, fixture_dir):
    """read_gauss_grid parity (gaussian_grid.cpp:20-33): rebuild from a grid
    file with sigma supplied; deposition continues on the restored surface."""
    g0 = make_gauss([0], [10], [0.05], [True], [0.2], dtype=jnp.float32)
    g0, _ = g0.add_value(jnp.array([[4.0]], jnp.float32), jnp.array([1.0], jnp.float32))
    from edm_tpu.utils.gridio import write_grid

    f = tmp_path / "g.grid"
    write_grid(g0.grid, str(f))

    g1 = GaussGrid.from_file(str(f), [0.2], dtype=jnp.float32)
    v0, _ = g0.get_value_deriv(jnp.array([[4.1]], jnp.float32))
    v1, _ = g1.get_value_deriv(jnp.array([[4.1]], jnp.float32))
    assert abs(float(v0[0]) - float(v1[0])) < 1e-5
    # deposition continues with the supplied sigma
    g1b, added = g1.add_value(jnp.array([[6.0]], jnp.float32), jnp.array([0.5], jnp.float32))
    assert abs(float(added[0]) - 0.5) < 1e-2
