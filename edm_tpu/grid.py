"""Dense N-D grid storage for EDM — the JAX equivalent of the
reference's ``DimmedGrid<DIM>`` (reference: lib/grid.h:184-905).

Design: the reference is a mutable C++ class; here a grid is a pure pytree
(``Grid``) holding device arrays plus a hashable static ``GridSpec``.  All
operations are pure functions usable under ``jax.jit``; the array layout is
``values[i0, i1, ..., i_{D-1}]`` with dimension 0 the *fastest-running* index
for file I/O purposes (reference stores a flat column-major array,
lib/grid.h:315-338).  Flattening with Fortran order reproduces the reference's
``multi2one`` index exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .utils.errors import edm_error


def int_floor(x):
    """Round-toward -inf floor returning integer (reference lib/grid.h:17-20)."""
    return jnp.floor(x).astype(jnp.int32)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static (trace-time) geometry of a grid.

    Mirrors the reference constructor logic at lib/grid.h:199-211:
    ``nbins = ceil((max-min)/spacing)``; ``dx = (max-min)/nbins``;
    non-periodic dims get one extra point and an *inflated* max
    (``max += dx``).  ``max`` stored here is the inflated max, exactly as the
    reference stores ``max_``.
    """

    min: Tuple[float, ...]
    max: Tuple[float, ...]  # inflated for non-periodic dims
    dx: Tuple[float, ...]
    nbins: Tuple[int, ...]  # points per dim (reference grid_number_)
    periodic: Tuple[bool, ...]

    @classmethod
    def create(
        cls,
        min: Sequence[float],
        max: Sequence[float],
        bin_spacing: Sequence[float],
        periodic: Sequence[bool],
    ) -> "GridSpec":
        mins, maxs, dxs, ns, ps = [], [], [], [], []
        for lo, hi, sp, p in zip(min, max, bin_spacing, periodic):
            lo, hi, sp = float(lo), float(hi), float(sp)
            n = int(math.ceil((hi - lo) / sp))
            dx = (hi - lo) / n
            if not p:
                n += 1
                hi += dx
            mins.append(lo)
            maxs.append(hi)
            dxs.append(dx)
            ns.append(n)
            ps.append(bool(p))
        return cls(tuple(mins), tuple(maxs), tuple(dxs), tuple(ns), tuple(ps))

    @classmethod
    def from_deflated(
        cls,
        min: Sequence[float],
        max: Sequence[float],
        nbins: Sequence[int],
        periodic: Sequence[bool],
    ) -> "GridSpec":
        """Build from on-file (deflated) header values: non-periodic dims are
        stored with BIN = n-1 and MAX = max-dx and are re-inflated on read
        (reference lib/grid.h:800-806)."""
        mins, maxs, dxs, ns, ps = [], [], [], [], []
        for lo, hi, n, p in zip(min, max, nbins, periodic):
            lo, hi, n = float(lo), float(hi), int(n)
            dx = (hi - lo) / n
            if not p:
                hi += dx
                n += 1
            mins.append(lo)
            maxs.append(hi)
            dxs.append(dx)
            ns.append(n)
            ps.append(bool(p))
        return cls(tuple(mins), tuple(maxs), tuple(dxs), tuple(ns), tuple(ps))

    @property
    def dim(self) -> int:
        return len(self.nbins)

    @property
    def grid_size(self) -> int:
        out = 1
        for n in self.nbins:
            out *= n
        return out

    @property
    def lengths(self) -> Tuple[float, ...]:
        return tuple(hi - lo for lo, hi in zip(self.min, self.max))

    def axis_points(self, d: int) -> np.ndarray:
        """Host-side coordinates of grid points along dim d."""
        return self.min[d] + self.dx[d] * np.arange(self.nbins[d])

    def multi2one(self, index: Sequence[int]) -> int:
        """Collapse an index tuple; dim 0 fastest (reference grid.h:315-325)."""
        result = index[self.dim - 1]
        for i in range(self.dim - 1, 0, -1):
            result = result * self.nbins[i - 1] + index[i - 1]
        return result

    def one2multi(self, index: int) -> Tuple[int, ...]:
        out = []
        for i in range(self.dim - 1):
            out.append(index % self.nbins[i])
            index //= self.nbins[i]
        out.append(index)
        return tuple(out)


def _tuplify(x, dim):
    arr = jnp.asarray(x)
    if arr.ndim == 0:
        arr = arr[None]
    return arr


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Grid:
    """A dense grid pytree: values and (optionally) stored gradients.

    ``values``: shape ``spec.nbins``; ``derivs``: shape ``spec.nbins + (D,)``
    or None.  ``interpolate`` selects cubic interpolation on lookup
    (reference b_interpolate_).
    """

    values: jax.Array
    derivs: Optional[jax.Array]
    spec: GridSpec = dataclasses.field(metadata=dict(static=True))
    interpolate: bool = dataclasses.field(metadata=dict(static=True), default=False)

    @classmethod
    def zeros(
        cls,
        spec: GridSpec,
        derivatives: bool = False,
        interpolate: bool = False,
        dtype=jnp.float32,
    ) -> "Grid":
        values = jnp.zeros(spec.nbins, dtype=dtype)
        derivs = (
            jnp.zeros(spec.nbins + (spec.dim,), dtype=dtype) if derivatives else None
        )
        return cls(values=values, derivs=derivs, spec=spec, interpolate=interpolate)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def has_derivatives(self) -> bool:
        return self.derivs is not None

    # ----------------------------------------------------------------- lookup

    def wrap(self, x: jax.Array) -> jax.Array:
        """Wrap periodic dims into [min, max) (reference grid.h:269-270)."""
        spec = self.spec
        lo = jnp.asarray(spec.min, self.dtype)
        length = jnp.asarray(spec.lengths, self.dtype)
        per = jnp.asarray(spec.periodic)
        wrapped = x - length * jnp.floor((x - lo) / length)
        return jnp.where(per, wrapped, x)

    def in_grid(self, x: jax.Array) -> jax.Array:
        """Boundary check (reference grid.h:865-874): non-periodic dims must
        satisfy ``min <= x < max - dx`` (max here is the inflated max)."""
        spec = self.spec
        lo = jnp.asarray(spec.min, self.dtype)
        hi = jnp.asarray(spec.max, self.dtype) - jnp.asarray(spec.dx, self.dtype)
        per = jnp.asarray(spec.periodic)
        ok = jnp.where(per, True, (x >= lo) & (x < hi))
        return jnp.all(ok, axis=-1)

    def get_index(self, x: jax.Array) -> jax.Array:
        """Point -> per-dim bin index (reference grid.h:264-273)."""
        spec = self.spec
        lo = jnp.asarray(spec.min, self.dtype)
        dx = jnp.asarray(spec.dx, self.dtype)
        xw = self.wrap(x.astype(self.dtype))
        idx = jnp.floor((xw - lo) / dx).astype(jnp.int32)
        # guard against float edge cases at the top of the range
        return jnp.clip(idx, 0, jnp.asarray(spec.nbins, jnp.int32) - 1)

    def get_value(self, x: jax.Array) -> jax.Array:
        """Value lookup; batch shape allowed: x is (..., D).

        With interpolation+derivatives, matches reference grid.h:357-360
        (delegates to get_value_deriv); otherwise nearest-bin.
        """
        if self.interpolate and self.has_derivatives:
            v, _ = self.get_value_deriv(x)
            return v
        x = jnp.asarray(x, self.dtype)
        idx = self.get_index(x)
        vals = self.values[tuple(jnp.moveaxis(idx, -1, 0))]
        return jnp.where(self.in_grid(x), vals, jnp.zeros((), self.dtype))

    def get_value_deriv(self, x: jax.Array, packed=None):
        from .ops.interp import grid_value_deriv

        return grid_value_deriv(self, jnp.asarray(x, self.dtype), packed=packed)

    # -------------------------------------------------------------- mutation

    def add_value(self, x: jax.Array, value) -> Tuple["Grid", jax.Array]:
        """Nearest-bin accumulate (reference grid.h:370-385). Only valid
        for non-interpolating grids (reference aborts otherwise). Returns
        (new_grid, amount_actually_added) — 0 if out of grid.

        Batched: x (..., D), value broadcastable to x[..., 0].
        """
        if self.interpolate:
            edm_error("Cannot add_value when using derivatives", "grid.py:add_value")
        x = jnp.asarray(x, self.dtype)
        value = jnp.broadcast_to(jnp.asarray(value, self.dtype), x.shape[:-1])
        ok = self.in_grid(x)
        contrib = jnp.where(ok, value, 0)
        idx = self.get_index(x)
        new_values = self.values.at[tuple(jnp.moveaxis(idx, -1, 0))].add(contrib)
        return dataclasses.replace(self, values=new_values), contrib

    def clear(self) -> "Grid":
        new = jnp.zeros_like(self.values)
        nd = None if self.derivs is None else jnp.zeros_like(self.derivs)
        return dataclasses.replace(self, values=new, derivs=nd)

    def add_grid(self, other: "Grid", scale, offset) -> "Grid":
        """Accumulate another grid into this one, evaluated at this grid's
        points (reference grid.h:275-290). Requires self.has_derivatives."""
        pts = grid_points(self.spec, self.dtype)
        val, der = other.get_value_deriv(pts)
        new_values = self.values + scale * val + offset
        new_derivs = self.derivs + scale * der
        return dataclasses.replace(self, values=new_values, derivs=new_derivs)

    # ------------------------------------------------------------- reductions

    def max_value(self) -> jax.Array:
        return jnp.max(self.values)

    def min_value(self) -> jax.Array:
        return jnp.min(self.values)

    def expected_bias(self) -> jax.Array:
        """E[g] under the Boltzmann weight exp(-g), treating the grid as an
        unnormalized -ln(p) (reference grid.h:692-710). The reference's
        ``offset`` (a running fmax seeded from 0) cancels in the ratio; it is
        kept for overflow protection only."""
        g = self.values
        offset = jnp.maximum(jnp.max(g), 0.0)
        w = jnp.exp(-g - offset)
        return jnp.sum(g * w) / jnp.sum(w)


def grid_points(spec: GridSpec, dtype=jnp.float32) -> jax.Array:
    """All grid point coordinates, shape ``spec.nbins + (D,)``."""
    axes = [
        jnp.asarray(spec.min[d] + spec.dx[d] * np.arange(spec.nbins[d]), dtype)
        for d in range(spec.dim)
    ]
    mesh = jnp.meshgrid(*axes, indexing="ij")
    return jnp.stack(mesh, axis=-1)
