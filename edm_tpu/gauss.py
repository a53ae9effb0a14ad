"""Gaussian-hill grid — JAX equivalent of the reference's
``DimmedGaussGrid`` (lib/gaussian_grid.h:41-631).

A ``GaussGrid`` is a pytree composing a derivative-carrying ``Grid`` with the
hill-deposition geometry: sigma (stored pre-scaled by sqrt(2), matching
gaussian_grid.h:74-76), an optional *system* boundary distinct from the grid
bounds (set_boundary, gaussian_grid.h:378-435), the support-truncated
"minigrid" window sizes (update_minigrid, gaussian_grid.h:559-569), and the
McGovern–De Pablo boundary-correction lookup tables (65,536 entries per
non-periodic dim) stored as device arrays.

The deposition kernel itself lives in ``edm_tpu.ops.deposit``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .grid import Grid, GridSpec

GAUSS_SUPPORT = 8.0  # sigma^2 support cutoff (gaussian_grid.h:10)
BC_TABLE_SIZE = 65536  # boundary-correction table entries (gaussian_grid.h:11)
BC_MAR = 2.0  # sigmoid margin in sigmas (gaussian_grid.h:12)


def sigmoid(x):
    """Interval sigmoid u(x)=2x^3-3x^2+1 on [0,1], 1 below, 0 above
    (gaussian_grid.h:16-23; derived in algorithms/hill_design/equations.tex)."""
    x = jnp.asarray(x)
    core = 2 * x**3 - 3 * x**2 + 1
    return jnp.where(x < 0, 1.0, jnp.where(x > 1, 0.0, core))


def sigmoid_dx(x):
    x = jnp.asarray(x)
    core = 6 * x**2 - 6 * x
    return jnp.where((x < 0) | (x > 1), 0.0, core)


def ref_round(x):
    """Round-half-away-from-zero (reference lib/grid.h:22-26) — NOT numpy's
    banker's rounding; matters for exact-midpoint image selection."""
    return jnp.where(x < 0, jnp.ceil(x - 0.5), jnp.floor(x + 0.5))


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class GaussSpec:
    """Static deposition geometry layered over a GridSpec."""

    grid: GridSpec
    sigma: Tuple[float, ...]  # pre-scaled by sqrt(2)
    boundary_min: Tuple[float, ...]
    boundary_max: Tuple[float, ...]
    boundary_periodic: Tuple[bool, ...]

    @property
    def dim(self) -> int:
        return self.grid.dim

    @property
    def minisize(self) -> Tuple[int, ...]:
        """Per-dim window half-width in grid points (gaussian_grid.h:559-569)."""
        out = []
        for d in range(self.dim):
            dist = math.sqrt(2 * GAUSS_SUPPORT) * self.sigma[d]
            out.append(int(math.floor(dist / self.grid.dx[d])))
        return tuple(out)

    @property
    def window_shape(self) -> Tuple[int, ...]:
        return tuple(2 * m + 1 for m in self.minisize)

    @property
    def volume(self) -> float:
        """Boundary volume (gaussian_grid.h:437-444)."""
        v = 1.0
        for d in range(self.dim):
            v *= self.boundary_max[d] - self.boundary_min[d]
        return v


def compute_bc_tables(spec: GaussSpec, dtype=jnp.float32):
    """Precompute the McGovern–De Pablo denominator and its derivative
    tables (gaussian_grid.h:392-433), host-side in float64 then cast.
    For periodic-boundary dims the tables are unused; filled with 1/0."""
    D = spec.dim
    denom = np.ones((D, BC_TABLE_SIZE), dtype=np.float64)
    ddenom = np.zeros((D, BC_TABLE_SIZE), dtype=np.float64)

    def _sig(x):
        core = 2 * x**3 - 3 * x**2 + 1
        return np.where(x < 0, 1.0, np.where(x > 1, 0.0, core))

    def _sig_dx(x):
        core = 6 * x**2 - 6 * x
        return np.where((x < 0) | (x > 1), 0.0, core)

    from math import erf as _erf

    verf = np.vectorize(_erf)

    for d in range(D):
        if spec.boundary_periodic[d]:
            continue
        bmin, bmax = spec.boundary_min[d], spec.boundary_max[d]
        sig = spec.sigma[d]
        s = np.arange(BC_TABLE_SIZE) * (bmax - bmin) / (BC_TABLE_SIZE - 1) + bmin
        tmp1 = math.sqrt(math.pi) * sig / 2.0 * (verf((s - bmin) / sig) + verf((bmax - s) / sig))
        tmp2 = math.sqrt(math.pi) * sig / 2.0 * _erf((bmax - bmin) / sig)
        t = tmp1.copy()
        t += (tmp2 - tmp1) * _sig((s - bmin) / (BC_MAR * sig))
        t += (tmp2 - tmp1) * _sig((bmax - s) / (BC_MAR * sig))
        denom[d] = t

        tmp3 = np.exp(-((s - bmin) ** 2) / sig**2) - np.exp(-((bmax - s) ** 2) / sig**2)
        dt = tmp3.copy()
        dt += (tmp2 - tmp1) * _sig_dx((s - bmin) / (BC_MAR * sig)) / (BC_MAR * sig) - tmp3 * _sig(
            (s - bmin) / (BC_MAR * sig)
        )
        dt += -(tmp2 - tmp1) * _sig_dx((bmax - s) / (BC_MAR * sig)) / (BC_MAR * sig) - tmp3 * _sig(
            (bmax - s) / (BC_MAR * sig)
        )
        ddenom[d] = dt

    return jnp.asarray(denom, dtype), jnp.asarray(ddenom, dtype)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GaussGrid:
    """Pytree: derivative-carrying grid + BC tables + static GaussSpec."""

    grid: Grid
    bc_denom: jax.Array  # (D, BC_TABLE_SIZE)
    bc_denom_deriv: jax.Array
    spec: GaussSpec = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def create(
        cls,
        min: Sequence[float],
        max: Sequence[float],
        bin_spacing: Sequence[float],
        periodic: Sequence[bool],
        sigma: Sequence[float],
        interpolate: bool = True,
        boundary_min: Optional[Sequence[float]] = None,
        boundary_max: Optional[Sequence[float]] = None,
        boundary_periodic: Optional[Sequence[bool]] = None,
        dtype=jnp.float32,
        grid: Optional[Grid] = None,
    ) -> "GaussGrid":
        gspec = grid.spec if grid is not None else GridSpec.create(min, max, bin_spacing, periodic)
        spec = GaussSpec(
            grid=gspec,
            sigma=tuple(float(s) * math.sqrt(2.0) for s in sigma),
            boundary_min=tuple(float(v) for v in (boundary_min if boundary_min is not None else min)),
            boundary_max=tuple(float(v) for v in (boundary_max if boundary_max is not None else max)),
            boundary_periodic=tuple(
                bool(v) for v in (boundary_periodic if boundary_periodic is not None else periodic)
            ),
        )
        g = grid if grid is not None else Grid.zeros(gspec, derivatives=True, interpolate=interpolate, dtype=dtype)
        bcd, bcdd = compute_bc_tables(spec, g.dtype)
        return cls(grid=g, bc_denom=bcd, bc_denom_deriv=bcdd, spec=spec)

    @classmethod
    def from_file(
        cls,
        filename: str,
        sigma: Sequence[float],
        interpolate: bool = True,
        dtype=jnp.float32,
    ) -> "GaussGrid":
        """Rebuild from a Plumed-1 grid file; files don't store sigma, so it
        must be given again (reference gaussian_grid.h:82-93 /
        read_gauss_grid, gaussian_grid.cpp:20-33).  Boundary defaults to the
        grid bounds, as in the reference file constructor."""
        import dataclasses as _dc

        from .utils.gridio import read_grid_file

        g = read_grid_file(filename, interpolate=interpolate, dtype=dtype)
        if g.derivs is None:
            # FORCE 0 files carry no gradients; deposition needs them
            # (the reference would dereference a null pointer here)
            g = _dc.replace(
                g, derivs=jnp.zeros(g.spec.nbins + (g.spec.dim,), g.dtype)
            )
        g = _dc.replace(g, interpolate=interpolate)
        gs = g.spec
        bmax = tuple(
            gs.max[d] if gs.periodic[d] else gs.max[d] - gs.dx[d]
            for d in range(gs.dim)
        )
        return cls.create(
            gs.min, bmax, gs.dx, gs.periodic, sigma,
            interpolate=interpolate, dtype=dtype, grid=g,
        )

    def set_boundary(
        self,
        boundary_min: Sequence[float],
        boundary_max: Sequence[float],
        boundary_periodic: Sequence[bool],
    ) -> "GaussGrid":
        """Re-derive boundary behavior (gaussian_grid.h:378-435). Returns a
        new GaussGrid; hill state (the grid arrays) is preserved."""
        spec = dataclasses.replace(
            self.spec,
            boundary_min=tuple(float(v) for v in boundary_min),
            boundary_max=tuple(float(v) for v in boundary_max),
            boundary_periodic=tuple(bool(v) for v in boundary_periodic),
        )
        bcd, bcdd = compute_bc_tables(spec, self.grid.dtype)
        return GaussGrid(grid=self.grid, bc_denom=bcd, bc_denom_deriv=bcdd, spec=spec)

    @property
    def dtype(self):
        return self.grid.dtype

    # ------------------------------------------------------------------ query

    def in_bounds(self, x: jax.Array, boundary_offset=None) -> jax.Array:
        """Inside the *boundary* box (gaussian_grid.h:490-499) — checked for
        every dim, periodic or not, exactly as the reference does.

        ``boundary_offset`` (D,): local->global coordinate shift for grids
        stored in local coordinates with a GLOBAL static boundary (the
        spatially-sharded host's non-periodic sharded dim): the boundary
        compares against ``x + boundary_offset``."""
        if boundary_offset is not None:
            x = x + jnp.asarray(boundary_offset, self.dtype)
        bmin = jnp.asarray(self.spec.boundary_min, self.dtype)
        bmax = jnp.asarray(self.spec.boundary_max, self.dtype)
        return jnp.all((x >= bmin) & (x <= bmax), axis=-1)

    def remap(self, x: jax.Array) -> jax.Array:
        """Nearest-image (not minimal-image) remap of points across the
        system boundary toward the grid (gaussian_grid.h:504-541)."""
        spec = self.spec
        g = spec.grid
        x = jnp.asarray(x, self.dtype)
        gmin = jnp.asarray(g.min, self.dtype)
        gmax = jnp.asarray(g.max, self.dtype)
        Lg = gmax - gmin
        bmin = jnp.asarray(spec.boundary_min, self.dtype)
        bmax = jnp.asarray(spec.boundary_max, self.dtype)
        Lb = bmax - bmin

        outside = (x < gmin) | (x > gmax)
        # case 1: grid-periodic wrap into grid range
        wrapped = x - Lg * jnp.floor((x - gmin) / Lg)
        # case 2: boundary-periodic nearest-image toward either grid edge
        dp0 = ref_round((gmin - x) / Lb) * Lb
        dp1 = ref_round((gmax - x) / Lb) * Lb
        pick0 = jnp.abs(gmin - x - dp0) < jnp.abs(gmax - x - dp1)
        bwrapped = x + jnp.where(pick0, dp0, dp1)

        gper = jnp.asarray(g.periodic)
        bper = jnp.asarray(spec.boundary_periodic)
        out = jnp.where(
            outside & gper,
            wrapped,
            jnp.where(outside & ~gper & bper, bwrapped, x),
        )
        return out

    def get_value(self, x: jax.Array, boundary_offset=None) -> jax.Array:
        """Boundary-aware value lookup (gaussian_grid.h:99-116)."""
        x = jnp.asarray(x, self.dtype)
        xin = jnp.where(
            self.in_bounds(x, boundary_offset)[..., None], x, self.remap(x)
        )
        ok = self.in_bounds(xin, boundary_offset)
        return jnp.where(ok, self.grid.get_value(xin), jnp.zeros((), self.dtype))

    def get_value_deriv(self, x: jax.Array, packed=None, boundary_offset=None):
        """Boundary-aware value+gradient lookup (gaussian_grid.h:118-138)."""
        x = jnp.asarray(x, self.dtype)
        xin = jnp.where(
            self.in_bounds(x, boundary_offset)[..., None], x, self.remap(x)
        )
        ok = self.in_bounds(xin, boundary_offset)
        v, d = self.grid.get_value_deriv(xin, packed=packed)
        zero = jnp.zeros((), self.dtype)
        return jnp.where(ok, v, zero), jnp.where(ok[..., None], d, zero)

    # --------------------------------------------------------------- deposit

    def add_value(self, centers: jax.Array, heights) -> Tuple["GaussGrid", jax.Array]:
        """Deposit a batch of hills; returns (new_gaussgrid, bias_added (H,)).

        See ops/deposit.py for the kernel.  ``centers``: (H, D) or (D,).
        """
        from .ops.deposit import deposit

        centers = jnp.asarray(centers, self.dtype)
        squeeze = centers.ndim == 1
        if squeeze:
            centers = centers[None]
        heights = jnp.broadcast_to(jnp.asarray(heights, self.dtype), centers.shape[:1])
        out, bias_added = deposit(self, centers, heights)
        return out, (bias_added[0] if squeeze else bias_added)

    def expected_bias(self):
        return self.grid.expected_bias()

    def clear(self) -> "GaussGrid":
        return dataclasses.replace(self, grid=self.grid.clear())
