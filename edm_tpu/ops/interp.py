"""Cubic-spline grid interpolation as a vectorized 2^D-corner gather.

Ports the polynomial of the reference's ``interp<DIM>`` (lib/grid.h:52-139,
itself adapted from PLUMED 1.3) to batched JAX: each lookup gathers the 2^D
surrounding grid points and combines per-dimension cubic polynomials whose
endpoint slope is set from the stored gradient (the qq = -der/value ratio,
with the 1e-7 zero-table guard at grid.h:113-114).  The reference's
periodic "stride wrap" trick (grid.h:432-433) becomes a modular index wrap.

This is the force-lookup hot path: O(atoms * 2^D) fused gathers + FMA that
XLA vectorizes.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp


def _shift_corner(arr, corner, periodic):
    """Shift ``arr`` so element [i...] holds the value at [i + corner]
    (periodic wrap, or clamped +1 like the reference's nidx clip)."""
    for d, c in enumerate(corner):
        if not c:
            continue
        if periodic[d]:
            arr = jnp.roll(arr, -1, axis=d)
        else:
            first = jnp.take(arr, jnp.arange(1, arr.shape[d]), axis=d)
            last = jnp.take(arr, jnp.asarray([arr.shape[d] - 1]), axis=d)
            arr = jnp.concatenate([first, last], axis=d)
    return arr


def _packed_corner_table(grid):
    """(G..., (1+D)*2^D) fused table: per grid point, value+gradient of all
    2^D interpolation corners, contiguous in the minor axis.

    The 2^D-corner lookup then needs ONE gather of a contiguous row per
    query point instead of (1+D)*2^D scalar gathers.  The table is rebuilt
    inline per call (12 lattice rolls for 2-D — ~4x the grid in memory
    writes) unless the caller passes a cached one."""
    D = grid.spec.dim
    per = grid.spec.periodic
    parts = []
    for corner in itertools.product((0, 1), repeat=D):
        parts.append(_shift_corner(grid.values, corner, per)[..., None])
        parts.append(_shift_corner(grid.derivs, corner, per))
    return jnp.concatenate(parts, axis=-1)


packed_corner_table = _packed_corner_table  # public alias for host caching


def grid_value_deriv(grid, x, packed=None):
    """Batched value+gradient lookup with optional interpolation.

    ``packed``: optional prebuilt fused corner table from
    ``_packed_corner_table(grid)`` — hosts that look up against a grid
    that changes only on hill rounds cache it in their state (build cost
    ~4x the grid per call otherwise).

    Args:
      grid: ``edm_tpu.grid.Grid`` with derivatives stored.
      x: (..., D) query points.

    Returns:
      (value (...), deriv (..., D)) — zeros outside a non-periodic grid
      (reference grid.h:398-409).
    """
    spec = grid.spec
    D = spec.dim
    dtype = grid.dtype
    x = jnp.asarray(x, dtype)

    lo = jnp.asarray(spec.min, dtype)
    dx = jnp.asarray(spec.dx, dtype)
    nbins = jnp.asarray(spec.nbins, jnp.int32)
    per = jnp.asarray(spec.periodic)

    ok = grid.in_grid(x)
    xw = grid.wrap(x)
    idx = jnp.clip(jnp.floor((xw - lo) / dx).astype(jnp.int32), 0, nbins - 1)

    if not grid.interpolate:
        gather = tuple(jnp.moveaxis(idx, -1, 0))
        value = grid.values[gather]
        deriv = grid.derivs[gather]
        zero = jnp.zeros((), dtype)
        return jnp.where(ok, value, zero), jnp.where(ok[..., None], deriv, zero)

    # bulk multi-dim path: one fused-table row gather per point (see
    # _packed_corner_table); bit-identical arithmetic to the scalar-gather
    # path, just a packed fetch
    F = (1 + D) * (2 ** D)
    use_packed = packed is not None or (
        D >= 2
        and grid.derivs is not None
        and x.size // D >= 4096
        and grid.values.size * F <= 64_000_000
    )
    if use_packed and packed is None:
        packed = _packed_corner_table(grid)
    if use_packed:
        gather = tuple(jnp.moveaxis(idx, -1, 0))
        fetched = packed[gather]  # (..., F)

    # position relative to the floor grid point, in [0, dx)
    where = xw - lo - idx.astype(dtype) * dx

    value = jnp.zeros(x.shape[:-1], dtype)
    deriv = jnp.zeros(x.shape, dtype)

    for ci_c, corner in enumerate(itertools.product((0, 1), repeat=D)):
        if use_packed:
            base = ci_c * (1 + D)
            tabf = fetched[..., base]
            tabder = fetched[..., base + 1 : base + 1 + D]
        else:
            c = jnp.asarray(corner, jnp.int32)
            nidx = idx + c
            # periodic wrap of the +1 neighbor (reference stride trick
            # grid.h:432-433)
            nidx = jnp.where(per, nidx % nbins, jnp.clip(nidx, 0, nbins - 1))
            gather = tuple(jnp.moveaxis(nidx, -1, 0))
            tabf = grid.values[gather]  # (...,)
            tabder = grid.derivs[gather]  # (..., D)

        # qq: desired endpoint slope / endpoint value, 0/0-guarded (grid.h:113-116)
        safe = jnp.abs(tabf) >= 1e-7
        qq = jnp.where(safe[..., None], -tabder / jnp.where(safe[..., None], tabf[..., None], 1.0), 0.0)

        X = jnp.abs(where / dx - jnp.asarray(corner, dtype))
        X2 = X * X
        X3 = X2 * X
        sign = jnp.asarray([-1.0 if ci else 1.0 for ci in corner], dtype)
        C = (1 - 3 * X2 + 2 * X3) - sign * qq * (X - 2 * X2 + X3) * dx
        Dp = (-6 * X + 6 * X2) - sign * qq * (1 - 4 * X + 3 * X2) * dx
        Dp = Dp * sign / dx

        ff = jnp.prod(C, axis=-1)
        value = value + tabf * ff
        # fd[d] = Dp[d] * prod_{j != d} C[j]
        prodC = jnp.prod(C, axis=-1, keepdims=True)
        # safe divide: C can be 0; compute leave-one-out product explicitly
        if D == 1:
            loo = jnp.ones_like(C)
        else:
            # leave-one-out product via masked prod per dim (D <= 3: cheap)
            loo = jnp.stack(
                [
                    jnp.prod(
                        jnp.concatenate(
                            [C[..., :d], C[..., d + 1 :]], axis=-1
                        ),
                        axis=-1,
                    )
                    for d in range(D)
                ],
                axis=-1,
            )
        del prodC
        deriv = deriv + tabf[..., None] * Dp * loo

    zero = jnp.zeros((), dtype)
    return jnp.where(ok, value, zero), jnp.where(ok[..., None], deriv, zero)


def hermite_1d_f64(values, derivs, lo, dx, x):
    """float64 NumPy evaluation of the 1-D cubic Hermite interpolant
    (reference lib/grid.h:95-137) at points ``x`` inside a non-periodic
    grid: (value, d value/dx).  A plain reference for checking the device
    lookup's precision; not used by the hosts."""
    import numpy as np

    values = np.asarray(values, np.float64)
    derivs = np.asarray(derivs, np.float64)
    x = np.asarray(x, np.float64)
    idx = np.floor((x - lo) / dx).astype(int)
    t = (x - lo - idx * dx) / dx
    val = np.zeros_like(x)
    der = np.zeros_like(x)
    for corner, sign in ((0, 1.0), (1, -1.0)):
        j = np.minimum(idx + corner, len(values) - 1)
        f, d = values[j], derivs[j]
        safe = np.abs(f) >= 1e-7
        qq = np.where(safe, -d / np.where(safe, f, 1.0), 0.0)
        X = np.abs(t - corner)
        C = (1 - 3 * X**2 + 2 * X**3) - sign * qq * (X - 2 * X**2 + X**3) * dx
        Dp = ((-6 * X + 6 * X**2) - sign * qq * (1 - 4 * X + 3 * X**2) * dx) * sign / dx
        val += f * C
        der += f * Dp
    return val, der
