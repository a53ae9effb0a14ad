"""Cell-lattice pair force pass (LJ + pairwise-CV bias), plain JAX.

The slot-resident cell hosts (models/pair_edm_cells.py) keep atoms in a
(C, cap) slot lattice of cells whose edge covers every interaction range,
so all interacting pairs live in a cell's 27-cell stencil.  This module
holds the force pass over that lattice and the pieces shared with the
Triton kernel (ops/cellforce_triton.py):

  - ``lattice_force`` — one entry point with two implementations of the
    same contract: ``impl="xla"`` (below; also the reference every test
    compares against) and ``impl="triton"`` (a Pallas kernel through
    Triton for NVIDIA GPUs);
  - ``HermiteTable`` / ``hermite_pair_table`` — the exact cubic-Hermite
    bias table in monomial form, the kernel's lookup table;
  - ``HALF_OFFSETS`` — the 13 lexicographically positive stencil offsets
    the half-stencil hill collection walks;
  - ``stencil_views`` — the 27-cell candidate tiles, also used by the
    type-filtered hill collection.

Full stencil, no Newton credits: every row atom sums its own force over
all 27 neighbour cells, so each unordered pair is evaluated twice (once
per member) and no cell writes another cell's forces.  The pass is
deterministic, a row's result depends only on its own program, and a
sharded host that restricts rows to the cells it owns gets the complete
force on those rows locally; rows it does not own stay zero, so a psum
over devices combines the shards.  The energy counts each pair from both
members and is halved.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Half stencil: the 13 lexicographically positive cell offsets.  Every
# unordered cross-cell pair (c, c+d) appears exactly once (for ncells >= 3
# per dim, distinct half offsets never alias).
HALF_OFFSETS = tuple(
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
    if (dx, dy, dz) > (0, 0, 0)
)

# Full stencil in (dx, dy, dz) lexicographic order; offset 13 is the cell
# itself.
FULL_OFFSETS = tuple(
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
)
SELF_OFFSET = FULL_OFFSETS.index((0, 0, 0))


class HermiteTable(NamedTuple):
    """Exact cubic-Hermite pair table in monomial form.

    ``tab`` (4, G): per grid interval the Horner coefficients (a, b1, c1,
    d1) of the interval cubic that ops/interp.py evaluates from corner
    pairs (reference lib/grid.h:95-137): dV/dr = b1 + c1*t + d1*t^2 and
    V = a + dx*(b1*t + c1*t^2/2 + d1*t^3/3).  Same polynomial as the grid
    lookup, different evaluation order: agreement is to f32 rounding.
    ``geom`` is the static lookup geometry (G, grid_lo, dx,
    grid_hi_exclusive, boundary_lo, boundary_hi), the range floats computed
    in the grid dtype so the masks reproduce GaussGrid.get_value_deriv's
    edges."""

    tab: jax.Array
    geom: tuple


def hermite_pair_table(gg) -> HermiteTable:
    """Build the monomial table from a 1-D pairwise-CV GaussGrid.

    Requires the standard fix_edm_pair grid shape (non-periodic grid and
    boundary, stored derivatives): remap is then the identity and lookup
    validity is a range check."""
    g = gg.grid
    spec = gg.spec
    if spec.dim != 1:
        raise ValueError("hermite pair table is for 1-D CV grids")
    if g.spec.periodic[0] or spec.boundary_periodic[0]:
        raise ValueError("hermite pair table requires a non-periodic grid")
    if g.derivs is None or not g.interpolate:
        raise ValueError("hermite pair table needs an interpolating grid")
    dt = np.dtype(g.values.dtype)
    glo = float(np.asarray(g.spec.min[0], dt))
    gdx = float(np.asarray(g.spec.dx[0], dt))
    # grid.in_grid upper edge: max_inflated - dx, computed in grid dtype
    ghi_eff = float(np.asarray(g.spec.max[0], dt) - np.asarray(g.spec.dx[0], dt))
    blo = float(np.asarray(spec.boundary_min[0], dt))
    bhi = float(np.asarray(spec.boundary_max[0], dt))
    v = g.values
    d = g.derivs[:, 0]
    # qq = endpoint slope / endpoint value with the 0/0 guard (grid.h:113-116)
    safe = jnp.abs(v) >= 1e-7
    qq = jnp.where(safe, -d / jnp.where(safe, v, 1.0), 0.0)
    vn = jnp.concatenate([v[1:], v[-1:]])
    qn = jnp.concatenate([qq[1:], qq[-1:]])
    # Horner coefficients of V(t) = a + b*t + c*t^2 + d*t^3 (t in [0, 1))
    # from the two-corner form; b1 = b/dx, c1 = 2c/dx, d1 = 3d/dx make
    # dV/dr one 2-FMA Horner chain
    gq0 = gdx * qq
    gq1 = gdx * qn
    ccoef = v * (gq0 + gq0 - 3.0) + vn * (gq1 + 3.0)
    dcoef = v * (2.0 - gq0) - vn * (gq1 + 2.0)
    tab = jnp.stack([v, -qq * v, (ccoef + ccoef) / gdx, (dcoef * 3.0) / gdx])
    G = int(g.spec.nbins[0])
    return HermiteTable(tab=tab, geom=(G, glo, gdx, ghi_eff, blo, bhi))


def _halo_wrap(g):
    """(nx, ny, nz, ...) -> (nx+2, ny+2, nz+2, ...) with periodic wrap, so
    every stencil view is a static slice."""
    for ax in range(3):
        lo = jax.lax.slice_in_dim(g, g.shape[ax] - 1, g.shape[ax], axis=ax)
        hi = jax.lax.slice_in_dim(g, 0, 1, axis=ax)
        g = jnp.concatenate([lo, g, hi], axis=ax)
    return g


def _row_box(ncells, row_box):
    if row_box is None:
        return (0, 0, 0), tuple(ncells)
    (ox, oy, oz), (rx, ry, rz) = row_box
    return (int(ox), int(oy), int(oz)), (int(rx), int(ry), int(rz))


def _rows(a, ncells, origin, rdims):
    """(C, ...) lattice array -> (R, ...) rows of the sub-box."""
    nx, ny, nz = ncells
    (ox, oy, oz), (rx, ry, rz) = origin, rdims
    g = a.reshape((nx, ny, nz) + a.shape[1:])
    return g[ox : ox + rx, oy : oy + ry, oz : oz + rz].reshape(
        (rx * ry * rz,) + a.shape[1:]
    )


def stencil_views(a, ncells, origin, rdims):
    """(C, cap, ...) -> (R, 27*cap, ...): the 27 neighbour cells' slots of
    every row cell of the sub-box ``rdims`` at ``origin``, FULL_OFFSETS
    order, periodic over ``ncells``."""
    nx, ny, nz = ncells
    (ox, oy, oz), (rx, ry, rz) = origin, rdims
    cap = a.shape[1]
    E = _halo_wrap(a.reshape((nx, ny, nz) + a.shape[1:]))
    views = [
        E[1 + ox + dx : 1 + ox + dx + rx, 1 + oy + dy : 1 + oy + dy + ry,
          1 + oz + dz : 1 + oz + dz + rz].reshape((rx * ry * rz, cap) + a.shape[2:])
        for (dx, dy, dz) in FULL_OFFSETS
    ]
    return jnp.concatenate(views, axis=1)


def _place_rows(f_rows, ncells, origin, rdims):
    """(R, cap, 3) sub-box rows -> (C, cap, 3) lattice plane, zero elsewhere."""
    nx, ny, nz = ncells
    (ox, oy, oz), (rx, ry, rz) = origin, rdims
    cap = f_rows.shape[1]
    if (rx, ry, rz) == (nx, ny, nz):
        return f_rows
    out = jnp.zeros((nx, ny, nz, cap, 3), f_rows.dtype)
    out = jax.lax.dynamic_update_slice(
        out, f_rows.reshape(rx, ry, rz, cap, 3), (ox, oy, oz, 0, 0)
    )
    return out.reshape(nx * ny * nz, cap, 3)


def table_value_deriv(table, r):
    """(value, dV/dr) of the pair bias at distances ``r``; zero outside the
    CV domain.  ``table`` is a ChebTable or the 1-D pairwise GaussGrid."""
    from .chebyshev import ChebTable

    if isinstance(table, ChebTable):
        return table.value_deriv(r)
    val, der = table.get_value_deriv(r[..., None])
    return val, der[..., 0]


def lattice_force_xla(
    xs, mc_rows, mc_cand, ncells, box, lj, table, energy=True,
    ts=None, type_pair=None, row_box=None, cell_chunk=64,
):
    """Plain-JAX full-stencil force pass; see ``lattice_force``."""
    C, cap = mc_rows.shape
    origin, rdims = _row_box(ncells, row_box)
    R = rdims[0] * rdims[1] * rdims[2]
    dtype = xs.dtype
    xr = _rows(xs, ncells, origin, rdims)  # (R, cap, 3)
    mr = _rows(mc_rows, ncells, origin, rdims)  # (R, cap)
    xn = stencil_views(xs, ncells, origin, rdims)  # (R, 27cap, 3)
    mn = stencil_views(mc_cand, ncells, origin, rdims)  # (R, 27cap)
    typed = ts is not None and type_pair is not None
    if typed:
        tr = _rows(ts, ncells, origin, rdims)
        tn = stencil_views(ts, ncells, origin, rdims)
    n_chunks = -(-R // cell_chunk)
    Rp = n_chunks * cell_chunk
    if Rp > R:
        def pad(a):
            return jnp.concatenate(
                [a, jnp.zeros((Rp - R,) + a.shape[1:], a.dtype)], 0
            )
        xr, mr, xn, mn = pad(xr), pad(mr), pad(xn), pad(mn)
        if typed:
            tr, tn = pad(tr), pad(tn)
    b = jnp.asarray(box, dtype)
    # the cell's own slots sit at candidate columns SELF_OFFSET*cap + s
    self_col = (
        jnp.arange(27 * cap)[None, :] == (SELF_OFFSET * cap + jnp.arange(cap))[:, None]
    )

    def one_chunk(ci):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, ci * cell_chunk, cell_chunk)
        xc, mcr, xnb, mnb = sl(xr), sl(mr), sl(xn), sl(mn)
        disp = xc[:, :, None, :] - xnb[:, None, :, :]  # (B, cap, 27cap, 3)
        disp = disp - jnp.round(disp / b) * b
        r2 = jnp.sum(disp * disp, axis=-1)
        valid = (mcr[:, :, None] > 0.5) & (mnb[:, None, :] > 0.5) & ~self_col[None]
        r = jnp.sqrt(jnp.where(valid, r2, jnp.inf))
        inr = jnp.where(r < lj.rcut, 1.0 / r, 0.0)
        sr6 = (lj.sigma * inr) ** 6
        fmag = 4 * lj.epsilon * (12 * sr6 * sr6 - 6 * sr6) * inr * inr
        if typed:
            ti, tj = (float(type_pair[0]), float(type_pair[1]))
            tc, tnb = sl(tr)[:, :, None], sl(tn)[:, None, :]
            cv_ok = ((tc == ti) & (tnb == tj)) | ((tc == tj) & (tnb == ti))
            r_cv = jnp.where(cv_ok, r, jnp.inf)
        else:
            r_cv = r
        fin = jnp.isfinite(r_cv)
        val, der = table_value_deriv(table, jnp.where(fin, r_cv, -1.0))
        binr = jnp.where(fin, 1.0 / r_cv, 0.0)
        fpair = fmag - jnp.where(fin, der, 0.0) * binr
        f_rows = jnp.sum(fpair[..., None] * disp, axis=2)
        e_b = jnp.sum(jnp.where(fin, val, 0.0)) if energy else jnp.zeros((), dtype)
        return f_rows, e_b

    f_rows, e_bs = jax.lax.map(one_chunk, jnp.arange(n_chunks))
    f_rows = f_rows.reshape(Rp, cap, 3)[:R]
    return 0.5 * jnp.sum(e_bs), _place_rows(f_rows, ncells, origin, rdims)


def lattice_force(
    xs, mc_rows, mc_cand, ncells, box, lj, table, do_energy=None,
    ts=None, type_pair=None, row_box=None, impl="xla", interpret=False,
    cell_chunk=64,
):
    """Full-stencil pair force pass over an (nx, ny, nz) slot lattice.

    xs (C, cap, 3) slot positions; ``mc_rows`` (C, cap) marks the slots
    that act as rows (receive forces), ``mc_cand`` the slots visible as
    candidates.  They differ under slab/brick sharding, where a device's
    halo cells are candidates but not rows.  ``row_box=((ox, oy, oz), (rx,
    ry, rz))`` restricts the rows to that sub-box of the lattice, so a
    sharded host pays for its owned cells only.  ``table`` is a ChebTable
    (spectral lookup) or the 1-D pairwise GaussGrid (exact lookup).  ``ts``
    (C, cap) float slot types (0 = empty) with ``type_pair`` restrict the
    CV term, never LJ, to one unordered type pair (fix_edm_pair.cpp:39-44).

    ``do_energy``: None or True computes the bias energy, False skips it,
    and a traced bool chooses per step under ``lax.cond``.  Returns
    (bias energy, forces (C, cap, 3)), zero on slots outside the rows.

    ``impl``: "xla" (plain JAX) or "triton" (the Pallas kernel in
    ops/cellforce_triton.py, GPU only; ``interpret=True`` runs it in the
    Pallas interpreter)."""
    if impl == "xla":
        def run(energy):
            return lattice_force_xla(
                xs, mc_rows, mc_cand, ncells, box, lj, table, energy,
                ts=ts, type_pair=type_pair, row_box=row_box,
                cell_chunk=cell_chunk,
            )
    elif impl == "triton":
        from .cellforce_triton import lattice_force_triton

        def run(energy):
            return lattice_force_triton(
                xs, mc_rows, mc_cand, ncells, box, lj, table, energy,
                ts=ts, type_pair=type_pair, row_box=row_box,
                interpret=interpret,
            )
    else:
        raise ValueError(f"unknown force implementation {impl!r}")
    if do_energy is None or isinstance(do_energy, bool):
        return run(do_energy is not False)
    return jax.lax.cond(do_energy, lambda: run(True), lambda: run(False))
