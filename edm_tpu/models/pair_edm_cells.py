"""Cell-list pairwise EDM — the production large-N host (1e4-1e5 atoms on one
device): same physics as pair_edm.py / fix_edm_pair, with O(N) pair work.

SLOT-RESIDENT layout: the MD state (positions/velocities/forces) lives in
cell-slot order ``(C, cap, 3)`` between table rebuilds, so the per-step
pipeline runs no per-atom gathers or scatters:

  1. force pass: the full-stencil cell-lattice pass of ops/cellforce.py —
     LJ plus the pair-CV bias from either the Chebyshev table
     (pair_lookup='chebyshev') or the exact cubic-Hermite grid lookup
     (pair_lookup='interp'), with optional rdf type-pair CV filtering.
     ``force_impl`` picks the plain-XLA implementation or the Pallas
     Triton kernel (ops/cellforce_triton.py, NVIDIA GPUs);
  2. BAOAB integration directly on slot arrays (padded slots are masked
     out of all pair math and hill collection); thermostat noise comes
     from a counter-hash Box-Muller stream keyed by GLOBAL slot row
     (ops/hashrng.normal_rows_cols), so under slab/brick sharding each
     device can draw just its owned columns' noise bitwise
     (shard_floor);
  3. every ``rebuild_stride`` steps: incremental slot-to-slot rebin —
     only boundary-crossing atoms move, into free holes of their target
     cells (models/cells.plan_incremental_rebin; work ~ movers, not
     atoms).  Infeasible plans (mover_cap exceeded / a full target cell)
     fall back in-graph to the full argsort rebuild, which also refreshes
     ``core.x/v/f``;
  4. hill rounds: two-level collection on half-stencil tiles — per-slot
     accepted counts (counter-hash uniforms, ops/hashrng; two draws per
     unordered pair = the reference's two ordered candidates), slot
     compaction, exact per-candidate extraction on the selected slots —
     then the standard add_hills_round.  Type-filtered runs keep the
     27-stencil gather collection.  Under slab sharding the collection
     itself is slab-decomposed by default (slab_collect): per-device
     passes over owned x-columns + one all_gather that reproduces the
     single-device deposit order exactly.

``core.x/v/f`` (atom order) are refreshed only at FULL (argsort) rebuilds
— incremental rebins leave them stale; use ``atom_positions(spec, state)``
for an up-to-date atom-order view.
``slab_axis``/``slab_ndev`` shard the force pass over a 1-D mesh (see
parallel.make_slab_cell_step); ``brick_axes``/``brick_ndev`` decompose it
over a 2-D (px, py) or 3-D (px, py, pz) device grid with a one-cell halo
ring along every bricked dim (see parallel.make_brick_cell_step).

The cell edge is max(lj.rcut, bias domain) + skin, so both force laws and
the hill candidate set live within the stencil.  The per-atom BAOAB noise
stream differs from the dense host's (slot-shaped draws), so cross-host
trajectory comparisons must run at kT=0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import bias as B
from ..ops.cellforce import HALF_OFFSETS, lattice_force, stencil_views
from ..ops.chebyshev import fit_gauss_grid
from .cells import CellSpec, build_table
from .langevin import LangevinParams
from .lj import LJParams
from .pair_edm import PairEDMState


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CellPairState:
    core: PairEDMState  # x/v/f in atom order, refreshed at rebuilds only
    aid: jax.Array  # (C*cap,) slot -> atom id (n_atoms = empty)
    xs: jax.Array  # (C, cap, 3) slot positions (authoritative)
    vs: jax.Array  # (C, cap, 3)
    fs: jax.Array  # (C, cap, 3)
    mc: jax.Array  # (C, cap) 1.0 for real local atoms (cached per rebuild)
    table_overflow: jax.Array  # bool
    mnf: jax.Array  # (C, 13cap) rolled half-stencil candidate mask
    # (HALF_OFFSETS order), cached per rebuild/rebin for the hill
    # collection: occupancy changes only when slots move


def _slots_from_atoms(spec: CellSpec, x, v, f, aid):
    """Gather atom arrays into slot layout + rebuild the cached masks."""
    n = spec.n_atoms
    C, cap = spec.n_cells, spec.cap
    aid_c = jnp.clip(aid, 0, n - 1)
    mc = (aid.reshape(C, cap) < n).astype(x.dtype)
    # empty slots are zeroed: they are masked from pair math and hills
    xs = x[aid_c].reshape(C, cap, 3) * mc[..., None]
    vs = v[aid_c].reshape(C, cap, 3) * mc[..., None]
    fs = f[aid_c].reshape(C, cap, 3) * mc[..., None]
    return xs, vs, fs, mc, _half_concat(mc, spec.ncells, cap)


def _atoms_from_slots(spec: CellSpec, aid, xs, vs, fs):
    """Scatter slot arrays back to atom order (each atom in exactly one
    slot; padded slots drop out of bounds)."""
    n = spec.n_atoms
    idx = jnp.where(aid < n, aid, n)
    x = jnp.zeros((n, 3), xs.dtype).at[idx].set(xs.reshape(-1, 3), mode="drop")
    v = jnp.zeros((n, 3), xs.dtype).at[idx].set(vs.reshape(-1, 3), mode="drop")
    f = jnp.zeros((n, 3), xs.dtype).at[idx].set(fs.reshape(-1, 3), mode="drop")
    return x, v, f


def _half_concat(plane, ncells, cap):
    """(C, cap) per-slot plane -> (C, 13cap) half-stencil candidate concat
    (HALF_OFFSETS roll order)."""
    nx, ny, nz = ncells
    C = nx * ny * nz
    g = plane.reshape(nx, ny, nz, cap)
    return jnp.concatenate(
        [
            jnp.roll(g, (-di, -dj, -dk), (0, 1, 2)).reshape(C, cap)
            for (di, dj, dk) in HALF_OFFSETS
        ],
        axis=1,
    )


def atom_positions(spec: CellSpec, state: CellPairState) -> jax.Array:
    """Up-to-date atom-order positions (core.x is only rebuild-fresh)."""
    n = spec.n_atoms
    idx = jnp.where(state.aid < n, state.aid, n)
    return (
        jnp.zeros((n, 3), state.xs.dtype)
        .at[idx]
        .set(state.xs.reshape(-1, 3), mode="drop")
    )


def cell_diag(spec: CellSpec, state: CellPairState):
    """Host-side occupancy telemetry (one device fetch of ``state.aid``):
    per-cell occupancy stats and the cell-overflow flag."""
    aid2 = np.asarray(jax.device_get(state.aid)).reshape(-1, spec.cap)
    occ = (aid2 < spec.n_atoms).sum(1)
    return {
        "n_cells": spec.n_cells,
        "cap": spec.cap,
        "occ_max": int(occ.max()),
        "occ_mean": float(occ.mean()),
        "occ_p99": float(np.percentile(occ, 99)),
        "occ_hist": np.bincount(occ, minlength=spec.cap + 1).tolist(),
        "cell_overflow": bool(state.table_overflow),
    }


def _local_planar_gate(loc_cols: int, nx: int) -> bool:
    """True -> the sharded hill collection builds its planar candidate
    views LOCALLY (owned x-columns + halo; see collect_hills_half).  Cost
    model: the local build pays one full-array origin-roll per input
    (~1 D-write) to shrink the 13-roll + 14-wide concat to the window
    fraction f (~27 f D-writes vs 27 global), a win when 1 + 27 f < 27;
    gate at f <= 3/4 for noise margin — at toy CPU-mesh widths the window
    is nearly the whole dim and the roll is pure loss.  Module-level so
    tests can monkeypatch it to pin the local path on toy lattices."""
    return 4 * loc_cols <= 3 * nx


def _extract_first_m(acc, rvals, uvals, m_per_row: int, dtype):
    """First ``m_per_row`` accepted candidates per row, ascending column
    order: (hills_rows, runif_rows, valid_rows), each (R, m_per_row).

    Rank one-hot select: within-row prefix counts make the m-th accepted
    column the unique accepted column with rank m+1, so each output column
    is a masked row-sum — replaces a sequential argmax/take_along/scatter
    chain over the work matrix.  ``rvals`` may hold inf at masked-out
    columns; selection uses where-masks (never multiplication) so no
    0*inf NaNs.  Rows with fewer than m accepts get valid=False there
    (the values at invalid slots are never consumed — the caller's
    compaction drops them)."""
    ranks = jnp.cumsum(acc.astype(jnp.int32), axis=1)
    R = acc.shape[0]
    hills_rows = jnp.zeros((R, m_per_row), dtype)
    runif_rows = jnp.ones((R, m_per_row), dtype)
    valid_rows = jnp.zeros((R, m_per_row), bool)
    for m in range(m_per_row):
        sel = acc & (ranks == (m + 1))
        hills_rows = hills_rows.at[:, m].set(
            jnp.sum(jnp.where(sel, rvals, 0), axis=1)
        )
        runif_rows = runif_rows.at[:, m].set(
            jnp.sum(jnp.where(sel, uvals, 0), axis=1)
        )
        valid_rows = valid_rows.at[:, m].set(jnp.any(sel, axis=1))
    return hills_rows, runif_rows, valid_rows


def init_cell_state(spec: CellSpec, core: PairEDMState) -> CellPairState:
    """Bin ``core``'s atoms into the slot table.  ``table_overflow`` flags
    cell-cap exhaustion (atoms dropped from the table — wrong physics,
    sticky)."""
    table = build_table(spec, core.x)
    xs, vs, fs, mc, mnf = _slots_from_atoms(spec, core.x, core.v, core.f, table.aid)
    return CellPairState(
        core=core, aid=table.aid, xs=xs, vs=vs, fs=fs, mc=mc,
        table_overflow=table.overflow, mnf=mnf,
    )


def make_cell_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    spec: CellSpec,
    hill_stride: int,
    rebuild_stride: int = 10,
    hill_capacity: int = 2048,
    cell_chunk: int = 32,
    row_cap: int = 2048,
    m_per_row: int = 16,
    axis_name: Optional[str] = None,
    types=None,
    type_pair=None,
    force_impl: str = "xla",
    collect_records: bool = False,
    energy_stride: int = 1,
    slab_axis: Optional[str] = None,
    slab_ndev: int = 1,
    mover_cap: Optional[int] = None,
    slab_collect: bool = True,
    brick_axes: Optional[Tuple[str, ...]] = None,
    brick_ndev: Tuple[int, ...] = (1, 1),
    shard_floor: bool = True,
    row_cap_local: Optional[int] = None,
    static_do_hills: Optional[bool] = None,
    static_do_energy: Optional[bool] = None,
    static_do_rebuild: Optional[bool] = None,
):
    """``force_impl``: "xla" (plain JAX) or "triton" (the Pallas Triton
    kernel, GPU only) — see ops/cellforce.lattice_force.

    ``slab_axis``/``slab_ndev``: run the force pass slab-sharded under
    ``shard_map`` over that mesh axis — each device evaluates the rows of
    its contiguous range of x-columns against a window of those columns
    plus one halo column per side, and the per-slot forces combine with
    one psum (the analog of the reference's spatial domain decomposition,
    edm_bias.cpp:98-222, with the hill exchange collapsed into the
    replicated-state psum).  With ``slab_collect`` (default) the
    hill-collection passes are ALSO slab-sharded — each device samples
    candidates only over its own x-columns and the per-device hill lists
    are all_gathered in device order, which replays bitwise in the
    single-device deposit order (see collect_hills_half) — leaving only
    integration, deposition and rebuilds as the replicated Amdahl terms.
    Type-filtered runs keep the replicated 27-stencil collection.

    ``brick_axes``/``brick_ndev``: BRICK decomposition over a (px, py) or
    (px, py, pz) device grid — each device owns a contiguous x-range x
    y-range (x z-range) of cells plus a one-cell halo ring along every
    bricked dim, cutting the halo fraction to ~sum_d 2/w_d vs the 1-D
    slab's 2/w at equal device count.  Hill collection is brick-sharded
    too: per-device passes over owned cells, merged back to the EXACT
    single-device deposit order by a global row-key sort (see
    collect_hills_half).  Mutually exclusive with ``slab_axis``; same
    replicated-state psum contract (the reference's 3-D MPI subdivision,
    edm_bias.cpp:98-222).  A dim with p_d == 1 is unsharded (no halo
    along it).

    ``shard_floor`` (default True, slab/brick modes): decompose the
    replicated Amdahl-floor terms too — (a) the BAOAB pre-force phase
    (B-A-O-A: velocity/position updates + the thermostat noise draw) runs
    per device over owned columns only and the halves combine with one
    fused (x, v) psum; (b) the hill pass-2/extraction tiles shrink to
    ``row_cap_local`` rows (default row_cap/n_dev, min 64, rounded to 8).
    Bitwise-neutral by construction: the noise is drawn by global slot
    row with a counter-hash Box-Muller generator
    (ops/hashrng.normal_rows_cols) — a sliced row range draws the exact
    values the replicated draw produces — and ALL cells hosts (sharded
    or not) use this noise stream, so sharded trajectories match the
    single-device host bit-for-bit at any kT.  Deposition and rebuilds
    remain the replicated floor.

    ``static_do_hills`` / ``static_do_energy`` / ``static_do_rebuild``:
    resolve the corresponding stride branch at TRACE time instead of a
    dynamic ``lax.cond``, whose pass-through branch may copy every carried
    array it returns unchanged.  Hosts with aligned strides build one
    step per phase of the stride cycle (e.g. hills+energy at index 0,
    plain at 1..8, rebuild at 9 for strides of 10) and drive them with
    ``driver.pattern_segment``; the caller owns phase alignment (a
    ``static_do_hills=True`` step deposits regardless of ``state.step``).
    ``None`` keeps the dynamic cond; the static and dynamic paths match
    to XLA loop-fusion rounding (integer leaves exactly — same RNG
    stream; see tests/test_strided.py)."""
    if brick_axes is not None and slab_axis is not None:
        raise ValueError("brick_axes and slab_axis are mutually exclusive")
    if force_impl not in ("xla", "triton"):
        raise ValueError(f"unknown force_impl {force_impl!r}")
    if brick_axes is not None:
        if len(brick_axes) not in (2, 3) or len(brick_axes) != len(brick_ndev):
            raise ValueError("brick_axes/brick_ndev must be 2-D or 3-D")
        # normalized per-lattice-dim partition: p_d == 1 along unbricked
        # trailing dims (a 2-D brick is a 3-D brick with pz = 1)
        brick_p3 = tuple(brick_ndev) + (1,) * (3 - len(brick_ndev))
        brick_ax3 = tuple(brick_axes) + (None,) * (3 - len(brick_axes))

    def _brick_part(n_cells_d, p, ax):
        """(start, width, max_width) of this device's balanced partition
        of ``n_cells_d`` cells over ``p`` devices along mesh axis ``ax``.
        p == 1 returns static ints (whole dim, no halo)."""
        if p == 1:
            return 0, n_cells_d, n_cells_d
        q, r = n_cells_d // p, n_cells_d % p
        dv = jax.lax.axis_index(ax)
        start = (dv * q + jnp.minimum(dv, r)).astype(jnp.int32)
        width = (q + (dv < r)).astype(jnp.int32)
        return start, width, -(-n_cells_d // p)
    if min(spec.ncells) < 3:
        raise ValueError(
            "cell list needs >= 3 cells per dim (box >= 3x interaction "
            "range); use the dense/blocked host for small boxes"
        )
    C = spec.n_cells
    cap = spec.cap
    n = spec.n_atoms
    # incremental-rebin mover buffer: sized for ~3% boundary crossers per
    # rebuild (typical is 1-2% at stride 10); infeasible plans fall back to
    # the full argsort rebuild inside the step, so this is a speed knob —
    # and every mover-proportional gather/scatter scales with the CAP, not
    # the live mover count, so oversizing it costs every rebuild
    if mover_cap is None:
        mover_cap = max(256, -(-n // 32))
    box_arr = jnp.asarray(spec.box)
    n_chunks = -(-C // cell_chunk)
    Cp = n_chunks * cell_chunk
    bmax_cv = params.cfg.box_high[0]
    # rdf type-pair filtering (fix_edm_pair.cpp:39-44,177-202): the LJ fluid
    # interacts between all atoms; only the biased CV is restricted to i-j
    # type pairs.  types are padded with 0 (matches nothing) for empty slots.
    if types is not None and type_pair is not None:
        types_arr = jnp.asarray(types, jnp.int32)
        tpair = (int(type_pair[0]), int(type_pair[1]))
    else:
        types_arr = None
        tpair = None

    # sharded hill collection (slab/brick modes, untyped): per-device passes
    # over owned columns, gathered + re-compacted to exactly hill_capacity
    # slots in global order (bitwise the replicated collection's round)
    slab_hills = slab_axis is not None and slab_collect and types_arr is None
    brick_hills = (
        brick_axes is not None and slab_collect and types_arr is None
    )

    # sharded-floor pass-2 row budget: each device extracts hills only from
    # rows of its owned columns, so the fixed-shape pass-2/extraction tiles
    # shrink to the owned-CELL fraction of the global budget — the ceil
    # partition width over the lattice, NOT 1/n_dev (8 devices over 3
    # x-columns leave one device a third of the rows).  A device
    # overflowing its local budget raises the same hills_truncated flag
    # the replicated overflow does.
    n_dev_shard = (
        slab_ndev
        if slab_axis is not None
        else (int(np.prod(brick_ndev)) if brick_axes is not None else 1)
    )
    if row_cap_local is None:
        if n_dev_shard == 1 or not shard_floor:
            row_cap_local = row_cap
        else:
            ncx, ncy, ncz = spec.ncells
            if brick_axes is not None:
                frac = (
                    (-(-ncx // brick_p3[0]))
                    * (-(-ncy // brick_p3[1]))
                    * (-(-ncz // brick_p3[2]))
                ) / (ncx * ncy * ncz)
            else:
                frac = (-(-ncx // slab_ndev)) / ncx
            row_cap_local = min(
                row_cap,
                max(64, (int(row_cap * frac) + 7) // 8 * 8),
            )

    def pad_cells(a, fill):
        """(C, ...) -> (Cp, ...) so the chunked collection's slices stay
        in range."""
        if Cp == C:
            return a
        return jnp.concatenate(
            [a, jnp.full((Cp - C,) + a.shape[1:], fill, a.dtype)], 0
        )

    def slot_types(aid):
        """Atom types of the slots in ``aid`` (0 = empty slot)."""
        return jnp.where(aid < n, types_arr[jnp.clip(aid, 0, n - 1)], 0)

    def chunk_pairs(xs3, aid2, xn3, an2, ci, dtype):
        """Squared-distance pair tile for cells [ci*chunk, ...) over their
        27 stencil cells (``xn3``/``an2``: the cells' stencil views):
        returns (r^2 (B, cap, 27cap) with invalid = inf, candidate-type
        mask or None)."""
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, ci * cell_chunk, cell_chunk)
        xc, ac, xn, an = sl(xs3), sl(aid2), sl(xn3), sl(an2)
        disp = xc[:, :, None, :] - xn[:, None, :, :]
        b = box_arr.astype(dtype)
        disp = disp - jnp.round(disp / b) * b
        r2 = jnp.sum(disp * disp, axis=-1)  # (B, cap, 27cap)
        anf = an[:, None, :]
        valid = (ac[:, :, None] < n) & (anf < n) & (ac[:, :, None] != anf)
        rm = jnp.where(valid, r2, jnp.inf)
        if types_arr is None:
            cv_ok = None
        else:
            tc, tn = slot_types(ac)[:, :, None], slot_types(anf)
            ti, tj = tpair
            cv_ok = ((tc == ti) & (tn == tj)) | ((tc == tj) & (tn == ti))
        return rm, cv_ok

    nx, ny, nz = spec.ncells

    # balanced slab partition: the first (nx % n_dev) devices own q+1
    # x-columns, the rest q — per-device column counts differ by <= 1
    # (a ceil-based split leaves the tail device a ragged remainder:
    # nx=13, n=4 gives [4,4,4,1]).  The halo window stays a static
    # ceil-width slice; ownership is masked per device in-graph.
    nxd_slab = -(-nx // slab_ndev) if slab_axis is not None else None

    def force_fn_for(state: CellPairState, do_energy=None):
        # pair-bias table: the carried ChebTable, or the live grid itself
        # (exact lookup, pair_lookup='interp')
        table = (
            state.core.cheb
            if state.core.cheb is not None
            else state.core.bias.bias
        )
        if types_arr is None:
            ts = None
        else:
            # per-slot types (0 = empty), refreshed from the slot table
            ts = jnp.where(
                state.aid < n, types_arr[jnp.clip(state.aid, 0, n - 1)], 0
            ).reshape(C, cap).astype(state.xs.dtype)

        def lf(xs_w, rows, cand, ncells_w, ts_w, row_box=None):
            return lattice_force(
                xs_w, rows, cand, ncells_w, spec.box, lj, table, do_energy,
                ts=ts_w, type_pair=tpair, row_box=row_box, impl=force_impl,
                cell_chunk=cell_chunk,
            )

        def owned_rows(xs, starts, widths, parts):
            """Full-lattice pass with rows restricted to this device's
            cells — for lattices too small to slice a window with halo
            (test-scale only; correct, no compute saving)."""
            cidx = jnp.arange(C, dtype=jnp.int32)
            cco = (cidx // (ny * nz), (cidx // nz) % ny, cidx % nz)
            mine = jnp.ones((C,), bool)
            for d in range(3):
                if parts[d] > 1:
                    mine = (
                        mine
                        & (cco[d] >= starts[d])
                        & (cco[d] < starts[d] + widths[d])
                    )
            return lf(
                xs, state.mc * mine.astype(xs.dtype)[:, None], state.mc,
                spec.ncells, ts,
            )

        def windowed(xs, starts, widths, wmax, parts, axes):
            """Force pass of this device's owned cells: the rows of its
            brick (or slab) inside a window of the brick plus a one-cell
            halo along every sharded dim, then one psum over ``axes``.
            The window's own periodic wrap joins cells >= 2 apart
            globally (or is the real wrap when it spans the dim), so
            wrapped pairs are either correct or beyond the cutoff."""
            ncd = (nx, ny, nz)
            halo = [1 if parts[d] > 1 else 0 for d in range(3)]
            sliceable = all(
                parts[d] == 1 or wmax[d] + 2 <= ncd[d] for d in range(3)
            )
            if not sliceable:
                e, f = owned_rows(xs, starts, widths, parts)
                return jax.lax.psum(e, axes), jax.lax.psum(f, axes)
            wdims = tuple(
                wmax[d] + 2 if halo[d] else ncd[d] for d in range(3)
            )
            shifts = tuple(halo[d] - starts[d] for d in range(3))

            def window(a):
                g = a.reshape((nx, ny, nz) + a.shape[1:])
                return jnp.roll(g, shifts, axis=(0, 1, 2))[
                    : wdims[0], : wdims[1], : wdims[2]
                ]

            Cw = wdims[0] * wdims[1] * wdims[2]
            subm = window(state.mc)
            # rows: owned cells only (the halo ring and a ragged device's
            # surplus cells are candidates, never rows)
            ok1 = [
                (jnp.arange(wdims[d]) >= halo[d])
                & (jnp.arange(wdims[d]) < halo[d] + widths[d])
                for d in range(3)
            ]
            row_ok = (
                ok1[0][:, None, None]
                & ok1[1][None, :, None]
                & ok1[2][None, None, :]
            )
            rows = subm * row_ok[..., None].astype(subm.dtype)
            e, f_sub = lf(
                window(xs).reshape(Cw, cap, 3), rows.reshape(Cw, cap),
                subm.reshape(Cw, cap), wdims,
                None if ts is None else window(ts).reshape(Cw, cap),
                row_box=(
                    tuple(halo),
                    tuple(wmax[d] if halo[d] else ncd[d] for d in range(3)),
                ),
            )
            fsg = f_sub.reshape(wdims + (cap, 3))
            for d in range(3):
                if ncd[d] > wdims[d]:
                    padshape = (
                        fsg.shape[:d] + (ncd[d] - wdims[d],) + fsg.shape[d + 1:]
                    )
                    fsg = jnp.concatenate(
                        [fsg, jnp.zeros(padshape, fsg.dtype)], d
                    )
            f_full = jnp.roll(
                fsg, tuple(-s for s in shifts), axis=(0, 1, 2)
            ).reshape(C, cap, 3)
            return jax.lax.psum(e, axes), jax.lax.psum(f_full, axes)

        def force_fn(xs):
            if brick_axes is not None:
                parts = [
                    _brick_part((nx, ny, nz)[d], brick_p3[d], brick_ax3[d])
                    for d in range(3)
                ]
                return windowed(
                    xs, [p[0] for p in parts], [p[1] for p in parts],
                    [p[2] for p in parts], brick_p3, brick_axes,
                )
            if slab_axis is not None:
                dev = jax.lax.axis_index(slab_axis)
                q, rem = nx // slab_ndev, nx % slab_ndev
                x0 = (dev * q + jnp.minimum(dev, rem)).astype(jnp.int32)
                wd = (q + (dev < rem)).astype(jnp.int32)
                return windowed(
                    xs, [x0, 0, 0], [wd, ny, nz], [nxd_slab, ny, nz],
                    (slab_ndev, 1, 1), slab_axis,
                )
            return lf(xs, state.mc, state.mc, spec.ncells, ts)

        return force_fn

    # BAOAB split around the force pass: the pre-force phase (B-A-O-A —
    # velocity half-kick, drift, thermostat, drift) is elementwise over
    # slots plus the noise draw, so under slab/brick sharding each device
    # runs it over its OWNED columns only and the halves combine with one
    # fused (x, v) psum (shard_floor).  Noise comes from the counter-hash
    # Box-Muller generator keyed by GLOBAL slot row
    # (ops/hashrng.normal_rows_cols): a sliced row range draws exactly the
    # values the replicated draw produces, so sharded and single-device
    # trajectories are bitwise identical at any kT.  The reference
    # delegates integration to LAMMPS (fix nve/langevin); this is the
    # analog of LAMMPS's per-rank thermostat over owned atoms.
    _c1_np = float(np.exp(-lp.friction * lp.dt))
    _c2_np = float(
        np.sqrt(max(0.0, (1.0 - _c1_np * _c1_np)) * lp.kT / lp.mass)
    )
    _rows_all = jnp.arange(C * cap, dtype=jnp.int32)
    rowlen_z = nz * cap
    rowlen_yz = ny * rowlen_z

    def _p1_update(xsub, vsub, fsub, xi, dtype):
        v1 = vsub + jnp.asarray(0.5 * lp.dt / lp.mass, dtype) * fsub  # B
        x1 = xsub + jnp.asarray(0.5 * lp.dt, dtype) * v1  # A
        v2 = jnp.asarray(_c1_np, dtype) * v1 + jnp.asarray(_c2_np, dtype) * xi  # O
        x2 = x1 + jnp.asarray(0.5 * lp.dt, dtype) * v2  # A
        return x2, v2

    def phase1_full(state, seeds):
        from ..ops.hashrng import normal_rows_cols

        dtype = state.xs.dtype
        xi = normal_rows_cols(seeds, _rows_all, 3, dtype).reshape(C, cap, 3)
        x2, v2 = _p1_update(state.xs, state.vs, state.fs, xi, dtype)
        m = state.mc[..., None]
        return x2 * m, v2 * m

    def _p1_scatter(x2, v2, pads, rolls, axis_names, dtype):
        """Zero-pad the owned window back to lattice shape, roll it into
        place and psum — disjoint ownership makes the sum exact."""
        for ax, padw in pads:
            if padw > 0:
                z = jnp.zeros(
                    x2.shape[:ax] + (padw,) + x2.shape[ax + 1:], dtype
                )
                x2 = jnp.concatenate([x2, z], ax)
                v2 = jnp.concatenate([v2, z], ax)
        shifts = tuple(s for s, _ in rolls)
        axes = tuple(a for _, a in rolls)
        x2 = jnp.roll(x2, shifts, axes).reshape(C, cap, 3)
        v2 = jnp.roll(v2, shifts, axes).reshape(C, cap, 3)
        return jax.lax.psum((x2, v2), axis_names)

    def phase1_slab(state, seeds):
        from ..ops.hashrng import normal_rows_cols

        dtype = state.xs.dtype
        dev = jax.lax.axis_index(slab_axis)
        q, rem = nx // slab_ndev, nx % slab_ndev
        x0 = (dev * q + jnp.minimum(dev, rem)).astype(jnp.int32)
        wd = (q + (dev < rem)).astype(jnp.int32)
        w = -(-nx // slab_ndev)

        def sub(a, extra):
            return jnp.roll(
                a[:C].reshape((nx, ny, nz, cap) + extra), -x0, axis=0
            )[:w]

        cols = (x0 + jnp.arange(w, dtype=jnp.int32)) % nx
        rows = (
            cols[:, None] * rowlen_yz
            + jnp.arange(rowlen_yz, dtype=jnp.int32)[None, :]
        ).reshape(-1)
        xi = normal_rows_cols(seeds, rows, 3, dtype).reshape(w, ny, nz, cap, 3)
        x2, v2 = _p1_update(sub(state.xs, (3,)), sub(state.vs, (3,)),
                            sub(state.fs, (3,)), xi, dtype)
        own = (jnp.arange(w) < wd).astype(dtype)
        m = (sub(state.mc, ()) * own[:, None, None, None])[..., None]
        return _p1_scatter(
            x2 * m, v2 * m, [(0, nx - w)], [(x0, 0)], slab_axis, dtype
        )

    def phase1_brick(state, seeds):
        from ..ops.hashrng import normal_rows_cols

        dtype = state.xs.dtype
        ncd = (nx, ny, nz)
        parts = [
            _brick_part(ncd[d], brick_p3[d], brick_ax3[d]) for d in range(3)
        ]
        starts = [p[0] for p in parts]
        widths = [p[1] for p in parts]
        wX, wY, wZ = (p[2] for p in parts)

        def sub(a, extra):
            return jnp.roll(
                a[:C].reshape((nx, ny, nz, cap) + extra),
                (-starts[0], -starts[1], -starts[2]), axis=(0, 1, 2),
            )[:wX, :wY, :wZ]

        colx = (starts[0] + jnp.arange(wX, dtype=jnp.int32)) % nx
        coly = (starts[1] + jnp.arange(wY, dtype=jnp.int32)) % ny
        colz = (starts[2] + jnp.arange(wZ, dtype=jnp.int32)) % nz
        rows = (
            colx[:, None, None, None] * rowlen_yz
            + coly[None, :, None, None] * rowlen_z
            + colz[None, None, :, None] * cap
            + jnp.arange(cap, dtype=jnp.int32)[None, None, None, :]
        ).reshape(-1)
        xi = normal_rows_cols(seeds, rows, 3, dtype).reshape(
            wX, wY, wZ, cap, 3
        )
        x2, v2 = _p1_update(sub(state.xs, (3,)), sub(state.vs, (3,)),
                            sub(state.fs, (3,)), xi, dtype)
        own = (
            (jnp.arange(wX) < widths[0])[:, None, None]
            & (jnp.arange(wY) < widths[1])[None, :, None]
            & (jnp.arange(wZ) < widths[2])[None, None, :]
        ).astype(dtype)
        m = (sub(state.mc, ()) * own[..., None])[..., None]
        return _p1_scatter(
            x2 * m, v2 * m,
            [(0, nx - wX), (1, ny - wY), (2, nz - wZ)],
            [(starts[0], 0), (starts[1], 1), (starts[2], 2)],
            brick_axes, dtype,
        )

    if shard_floor and brick_axes is not None:
        phase1 = phase1_brick
    elif shard_floor and slab_axis is not None:
        phase1 = phase1_slab
    else:
        phase1 = phase1_full

    def collect_hills_half(state: CellPairState, xs, key, last_calls, dtype,
                           slab: bool = False, brick: bool = False):
        """Two-level hill collection over HALF-stencil tiles.

        Each unordered pair appears once (self block strictly upper,
        13 lex-positive neighbor cells) and draws TWO independent
        acceptance uniforms — the reference's two ordered candidates per
        pair (fix_edm_pair.cpp:229-237, both i- and j-owned hills at the
        same r).  Candidate tiles are dynamic slices of roll-built planar
        views (no gathers) and distances stay squared until extraction.
        Used whenever no type filter is active (the typed path keeps the
        27-stencil gather collection).

        ``slab=True`` (slab_axis set): pass 1 + extraction run ONLY over
        this device's owned x-columns — a contiguous ascending cell range
        in the x-major cell order — and the per-device compacted hill
        lists are ``all_gather``ed in device order.  Because compaction
        preserves row order within each device and devices own ascending
        ranges, the gathered round replays in EXACTLY the single-device
        deposit order (the cap semantics see the same sequence); the
        counter-hash uniforms are keyed by global row index, so the
        draws are identical too.  This shards the collection the same
        way the force pass is sharded (the reference's per-rank hill
        sampling over its own subdomain, edm_bias.cpp:397-411).

        ``brick=True`` (brick_axes set): pass 1 + extraction run over this
        device's owned x-range x y-range of columns — for each owned
        x-column a contiguous run of wy*nz cells — and the per-device
        compacted lists carry their GLOBAL (slot-row, within-row) sort key.
        Brick ownership is not contiguous in the x-major cell order, so
        device-order concatenation cannot reproduce the global order;
        instead the gathered lists are merged by one argsort of the keys,
        which IS the single-device enumeration order (ascending flat cell,
        slot, candidate column) — bitwise, including truncation (a hill
        with global rank < capacity has within-device rank < capacity, so
        it survives the per-device compaction and the merge keeps it)."""
        from ..ops.hashrng import seeds_from_key, uniform_rows_cols

        k13 = len(HALF_OFFSETS)
        width = (k13 + 1) * cap
        # sharded passes extract from owned rows only: the pass-2 tiles
        # shrink to the per-device row budget (shard_floor)
        rc = row_cap_local if (slab or brick) else row_cap
        seeds = seeds_from_key(key)
        thresh = (
            None
            if params.cfg.hill_density < 0
            else params.cfg.hill_density / last_calls.astype(dtype)
        )
        g = xs[:C].reshape(nx, ny, nz, cap, 3)
        gm = state.mc[:C].reshape(nx, ny, nz, cap)

        def build_planar(gp):
            return jnp.concatenate(
                [gp.reshape(C, cap)]
                + [
                    jnp.roll(gp, (-di, -dj, -dk), (0, 1, 2)).reshape(C, cap)
                    for (di, dj, dk) in HALF_OFFSETS
                ],
                axis=1,
            )

        n_chunks_h = -(-C // cell_chunk)
        Cp_h = n_chunks_h * cell_chunk
        c_start = jnp.zeros((), jnp.int32)
        c_end = jnp.full((), C, jnp.int32)
        if slab:
            # per-device scan over owned cells [x0*ny*nz, (x0+wd)*ny*nz);
            # balanced column partition as in slab_newton_force
            q_s, rem_s = nx // slab_ndev, nx % slab_ndev
            dev = jax.lax.axis_index(slab_axis)
            x0c = (dev * q_s + jnp.minimum(dev, rem_s)).astype(jnp.int32)
            wdc = (q_s + (dev < rem_s)).astype(jnp.int32)
            c_start = x0c * (ny * nz)
            c_end = (x0c + wdc) * (ny * nz)
            max_cells = (q_s + (1 if rem_s else 0)) * ny * nz
            n_chunks_loc = -(-max_cells // cell_chunk)
            pad_extra = n_chunks_loc * cell_chunk
        elif brick:
            # per-device scan over owned cells: for each owned x-column, a
            # contiguous span covering its owned (y, z) range — with z
            # unsharded (pz == 1) the span is exactly wy*nz cells; with z
            # bricked it is ((wy-1)*nz + wz) cells whose non-owned z rows
            # are masked off by the ownership test.  Balanced per-axis
            # partitions as in brick_newton_force.
            parts_h = [
                _brick_part((nx, ny, nz)[d], brick_p3[d], brick_ax3[d])
                for d in range(3)
            ]
            (x0c, wxc, wxm_h) = parts_h[0]
            (y0c, wyc, wym_h) = parts_h[1]
            (z0c, wzc, wzm_h) = parts_h[2]
            span_h = (wym_h - 1) * nz + wzm_h
            n_sub_h = -(-span_h // cell_chunk)
            n_chunks_loc = wxm_h * n_sub_h
            # chunk overruns may reach into the next x-row of cells (masked
            # by ownership); pad enough that the slices never clamp
            pad_extra = ny * nz + span_h + 2 * cell_chunk
        else:
            n_chunks_loc = n_chunks_h
            pad_extra = 0
        rows_pad = Cp_h + pad_extra  # sharded slices never clamp
        sent = rows_pad * cap  # GLOBAL slot-row sentinel (keys/draws/order)
        n_rows_loc = n_chunks_loc * cell_chunk * cap

        # Sharded modes build the planar candidate views LOCALLY over the
        # owned x-columns + one +x halo column (+ chunk-overrun slack): the
        # 3x13 full-array roll / 14-wide concat planar build was the
        # dominant REPLICATED hill-round term.  One full-array roll brings
        # the window to the local origin; the in-window x-roll's wrap only
        # corrupts the halo column's own planar row, which is never an
        # owned row.  Global slot-row ids still key the RNG, the sort keys
        # and the sentinel, so the merged round stays bitwise the
        # replicated one (the existing slab/brick parity pins cover this).
        if slab:
            x_lo = x0c
            own_cols = q_s + (1 if rem_s else 0)
        elif brick:
            x_lo = x0c
            own_cols = wxm_h + 1  # chunk spans cross into the next x-row
        else:
            x_lo = None
        if x_lo is not None:
            loc_cols = min(own_cols + 1, nx)
            if not _local_planar_gate(loc_cols, nx):
                x_lo = None
        if x_lo is not None:
            if slab:
                pad_extra = 2 * cell_chunk  # local slices never clamp
            C_loc = loc_cols * ny * nz
            base_cell = x_lo * (ny * nz)
        else:
            C_loc = C
            base_cell = jnp.zeros((), jnp.int32)
        rows_pad_loc = C_loc + pad_extra

        def chunk_range(hi):
            """(first cell id, per-cell ownership mask) of scan chunk hi."""
            if brick:
                ixo = hi // n_sub_h
                c0 = (
                    (x0c + ixo) * (ny * nz)
                    + y0c * nz
                    + z0c
                    + (hi % n_sub_h) * cell_chunk
                )
                gcell = c0 + jnp.arange(cell_chunk)
                gy_ = (gcell // nz) % ny
                gz_ = gcell % nz
                own = (
                    (ixo < wxc)
                    & (gcell // (ny * nz) == x0c + ixo)
                    & (gy_ >= y0c)
                    & (gy_ < y0c + wyc)
                    & (gz_ >= z0c)
                    & (gz_ < z0c + wzc)
                )
                return c0, own
            c0 = c_start + hi * cell_chunk
            # cells past c_end belong to the next device (slab) or are
            # lattice padding (replicated tail chunk)
            return c0, (c0 + jnp.arange(cell_chunk)) < c_end

        def pad_rows(a):
            tgt = rows_pad_loc if x_lo is not None else rows_pad
            if tgt > a.shape[0]:
                return jnp.concatenate(
                    [a, jnp.zeros((tgt - a.shape[0], a.shape[1]), a.dtype)], 0
                )
            return a

        if x_lo is not None:
            def localize4(a4):  # (nx, ny, nz, ...) -> (loc_cols, ny, nz, ...)
                return jnp.roll(a4, -x_lo, axis=0)[:loc_cols]

            def build_planar_loc(gp):  # gp (loc_cols, ny, nz, cap)
                return jnp.concatenate(
                    [gp.reshape(C_loc, cap)]
                    + [
                        jnp.roll(gp, (-di, -dj, -dk), (0, 1, 2)).reshape(
                            C_loc, cap
                        )
                        for (di, dj, dk) in HALF_OFFSETS
                    ],
                    axis=1,
                )

            g_l = localize4(g)
            cand = [pad_rows(build_planar_loc(g_l[..., c])) for c in range(3)]
            candm = pad_rows(
                localize4(
                    jnp.concatenate([state.mc, state.mnf], axis=1).reshape(
                        nx, ny, nz, width
                    )
                ).reshape(C_loc, width)
            )
        else:
            cand = [pad_rows(build_planar(g[..., c])) for c in range(3)]
            candm = pad_rows(jnp.concatenate([state.mc, state.mnf], axis=1))
        bb = box_arr.astype(dtype)
        bmax2 = bmax_cv * bmax_cv

        def half_tile(c0, B):
            """r2 tile (B, cap, width) + geometric-candidate mask."""
            r2 = None
            ms = jax.lax.dynamic_slice_in_dim(candm, c0, B)
            for d, L in zip(cand, (bb[0], bb[1], bb[2])):
                sl = jax.lax.dynamic_slice_in_dim(d, c0, B)
                dd = sl[:, :cap, None] - sl[:, None, :]
                dd = dd - jnp.round(dd / L) * L
                r2 = dd * dd if r2 is None else r2 + dd * dd
            valid = (ms[:, :cap, None] * ms[:, None, :]) > 0.5
            ri = jnp.arange(cap)[None, :, None]
            ci = jnp.arange(width)[None, None, :]
            # self block strictly upper: each intra-cell pair exactly once
            valid = valid & jnp.where(ci < cap, ci > ri, True)
            return r2, valid & (r2 < bmax2)

        def draws(rows, B):
            u = uniform_rows_cols(seeds, rows, 2 * width, dtype)
            return u.reshape(B, cap, width, 2) if B else u

        def p1_chunk(carry, hi):
            row_counts, ncalls = carry
            c0, own = chunk_range(hi)  # global cell ids (RNG/order keys)
            _, cand_ok = half_tile(c0 - base_cell, cell_chunk)
            cand_ok = cand_ok & own[:, None, None]
            rows = (c0 * cap + jnp.arange(cell_chunk * cap)).astype(jnp.int32)
            u = draws(rows, cell_chunk)
            if thresh is None:
                acc = jnp.broadcast_to(
                    cand_ok[..., None], cand_ok.shape + (2,)
                )
            else:
                acc = cand_ok[..., None] & (u < thresh)
            rc = jnp.sum(acc.astype(jnp.int32), axis=(2, 3)).reshape(-1)
            row_counts = jax.lax.dynamic_update_slice_in_dim(
                row_counts, rc.astype(jnp.int32), hi * cell_chunk * cap, axis=0
            )
            ncalls = (
                ncalls + 2 * jnp.sum(cand_ok.astype(jnp.int32))
            ).astype(jnp.int32)
            return (row_counts, ncalls), None

        (row_counts, ncalls), _ = jax.lax.scan(
            p1_chunk,
            (jnp.zeros((n_rows_loc,), jnp.int32), jnp.zeros((), jnp.int32)),
            jnp.arange(n_chunks_loc),
        )

        # local scan-buffer position -> global slot-row id (pure arithmetic
        # mirror of chunk_range; the RNG and the deposit order are keyed by
        # these global ids, so sharded and replicated passes draw alike)
        l_pos = jnp.arange(n_rows_loc, dtype=jnp.int32)
        if brick:
            hi_l = l_pos // (cell_chunk * cap)
            c0_l = (
                (x0c + hi_l // n_sub_h) * (ny * nz)
                + y0c * nz
                + z0c
                + (hi_l % n_sub_h) * cell_chunk
            )
            local_gids = c0_l * cap + l_pos % (cell_chunk * cap)
        else:
            local_gids = (c_start * cap + l_pos).astype(jnp.int32)

        has = row_counts > 0
        rranks = jnp.cumsum(has.astype(jnp.int32)) - 1
        rtgt = jnp.where(has, rranks, rc)
        rows_sel = jnp.full((rc,), sent, jnp.int32).at[rtgt].set(
            local_gids, mode="drop"
        )
        n_rows = jnp.sum(has.astype(jnp.int32)).astype(jnp.int32)

        # pass 2 on selected slot-rows: row gather of the planar views.
        # rows_c stays GLOBAL (RNG keys); gathers index the LOCAL views
        rows_c = jnp.clip(rows_sel, 0, sent - 1)
        loc_rows = jnp.clip(
            rows_sel - base_cell * cap, 0, rows_pad_loc * cap - 1
        ) if x_lo is not None else rows_c
        cells_c = loc_rows // cap
        slot_c = rows_c % cap
        r2 = None
        ms = candm[cells_c]  # (row_cap, width)
        for d, L in zip(cand, (bb[0], bb[1], bb[2])):
            sl = d[cells_c]
            lc = jnp.take_along_axis(sl, slot_c[:, None], axis=1)
            dd = lc - sl
            dd = dd - jnp.round(dd / L) * L
            r2 = dd * dd if r2 is None else r2 + dd * dd
        mrow = jnp.take_along_axis(ms, slot_c[:, None], axis=1)
        row_valid = rows_sel < sent
        ci = jnp.arange(width)[None, :]
        valid = (
            row_valid[:, None]
            & ((mrow * ms) > 0.5)
            & jnp.where(ci < cap, ci > slot_c[:, None], True)
        )
        cand_ok = valid & (r2 < bmax2)
        r = jnp.sqrt(jnp.where(cand_ok, r2, jnp.inf))
        u = uniform_rows_cols(seeds, rows_c, 2 * width, dtype).reshape(
            rc, width, 2
        )
        if thresh is None:
            acc = jnp.broadcast_to(cand_ok[..., None], cand_ok.shape + (2,))
        else:
            acc = cand_ok[..., None] & (u < thresh)
        acc2 = acc.reshape(rc, 2 * width)
        u2 = u.reshape(rc, 2 * width)
        r21 = jnp.repeat(r, 2, axis=1)  # r[w] at work columns 2w, 2w+1

        hills_rows, runif_rows, valid_rows = _extract_first_m(
            acc2, r21, u2, m_per_row, dtype
        )
        row_overflow = jnp.any(row_counts > m_per_row)

        hflat = hills_rows.reshape(-1)
        uflat = runif_rows.reshape(-1)
        vflat = valid_rows.reshape(-1)
        ranks = jnp.cumsum(vflat.astype(jnp.int32)) - 1
        tgt = jnp.where(vflat, ranks, hill_capacity)
        hills = jnp.zeros((hill_capacity,), dtype).at[tgt].set(hflat, mode="drop")
        runifs = jnp.ones((hill_capacity,), dtype).at[tgt].set(uflat, mode="drop")
        count = jnp.sum(vflat.astype(jnp.int32)).astype(jnp.int32)
        active = jnp.arange(hill_capacity) < count
        truncated = (count > hill_capacity) | (n_rows > rc) | row_overflow
        if brick:
            # global (slot-row, within-row) sort key per hill: ascending
            # key order IS the single-device enumeration order.  Keys fit
            # int32 comfortably (sent * m_per_row ~ 4M at 100k atoms).
            BIGKEY = jnp.iinfo(jnp.int32).max
            kflat = (
                rows_sel[:, None] * m_per_row
                + jnp.arange(m_per_row, dtype=jnp.int32)[None, :]
            ).reshape(-1)
            keys = jnp.full((hill_capacity,), BIGKEY, jnp.int32).at[tgt].set(
                kflat, mode="drop"
            )
            hills_g = jax.lax.all_gather(hills, brick_axes, tiled=True)
            runifs_g = jax.lax.all_gather(runifs, brick_axes, tiled=True)
            keys_g = jax.lax.all_gather(keys, brick_axes, tiled=True)
            active_g = jax.lax.all_gather(active, brick_axes, tiled=True)
            total = jax.lax.psum(count, brick_axes)
            ncalls = jax.lax.psum(ncalls, brick_axes)
            order = jnp.argsort(
                jnp.where(active_g, keys_g, BIGKEY), stable=True
            )[:hill_capacity]
            hills = hills_g[order]
            runifs = runifs_g[order]
            count = total
            active = jnp.arange(hill_capacity) < total
            truncated = (
                jax.lax.psum(truncated.astype(jnp.int32), brick_axes) > 0
            ) | (total > hill_capacity)
        elif slab:
            # device-order concatenation of per-device segments == the
            # single-device (global cell-row) deposit order; re-compacting
            # the gathered segments to the FIRST hill_capacity actives
            # reproduces the replicated collection bitwise, including its
            # truncation-at-capacity semantics (a hill the global pass
            # keeps has global rank < capacity, hence within-device rank
            # < capacity, so it survives the per-device compaction too)
            hills_g = jax.lax.all_gather(hills, slab_axis, tiled=True)
            runifs_g = jax.lax.all_gather(runifs, slab_axis, tiled=True)
            active_g = jax.lax.all_gather(active, slab_axis, tiled=True)
            total = jax.lax.psum(count, slab_axis)
            ncalls = jax.lax.psum(ncalls, slab_axis)
            granks = jnp.cumsum(active_g.astype(jnp.int32)) - 1
            keep = active_g & (granks < hill_capacity)
            gtgt = jnp.where(keep, granks, hill_capacity)
            hills = jnp.zeros((hill_capacity,), dtype).at[gtgt].set(
                hills_g, mode="drop"
            )
            runifs = jnp.ones((hill_capacity,), dtype).at[gtgt].set(
                runifs_g, mode="drop"
            )
            count = total
            active = jnp.arange(hill_capacity) < total
            truncated = (
                jax.lax.psum(truncated.astype(jnp.int32), slab_axis) > 0
            ) | (total > hill_capacity)
        return hills[:, None], runifs, active, count, ncalls, truncated

    def collect_hills(state: CellPairState, xs, key, last_calls, dtype):
        """Two-level hill collection over cell-slot rows."""
        aid2 = state.aid.reshape(C, cap)
        xs3, aid2p = pad_cells(xs, 0), pad_cells(aid2, n)
        whole = ((0, 0, 0), spec.ncells)
        xn3 = pad_cells(stencil_views(xs, spec.ncells, *whole), 0)  # (Cp, 27cap, 3)
        an2 = pad_cells(stencil_views(aid2, spec.ncells, *whole), n)  # (Cp, 27cap)

        # counter-hash uniforms (ops/hashrng): ~2x cheaper than Threefry at
        # the ~2e8 draws/round this pass needs, re-derivable in pass 2
        from ..ops.hashrng import seeds_from_key, uniform_rows_cols

        seeds = seeds_from_key(key)

        def row_uniform(slot_rows):
            return uniform_rows_cols(seeds, slot_rows, 27 * cap, dtype)

        def accept_of(candidate, runif):
            if params.cfg.hill_density < 0:
                acc = candidate
            else:
                acc = candidate & (
                    runif < params.cfg.hill_density / last_calls.astype(dtype)
                )
            return candidate, acc

        def p1_chunk(carry, ci):
            row_counts, ncalls = carry
            # r2-only tile: the accept pass needs neither displacements nor
            # the sqrt (candidate test compares squared distances)
            r2m, cv_ok = chunk_pairs(xs3, aid2p, xn3, an2, ci, dtype)
            if cv_ok is not None:
                r2m = jnp.where(cv_ok, r2m, jnp.inf)
            rows = (ci * cell_chunk * cap + jnp.arange(cell_chunk * cap)).astype(jnp.int32)
            runif = row_uniform(rows).reshape(cell_chunk, cap, 27 * cap)
            candidate, acc = accept_of(r2m < bmax_cv * bmax_cv, runif)
            rc = jnp.sum(acc.astype(jnp.int32), axis=2).reshape(-1).astype(jnp.int32)
            row_counts = jax.lax.dynamic_update_slice_in_dim(
                row_counts, rc, ci * cell_chunk * cap, axis=0
            )
            ncalls = (ncalls + jnp.sum(candidate.astype(jnp.int32))).astype(jnp.int32)
            return (row_counts, ncalls), None

        (row_counts, ncalls), _ = jax.lax.scan(
            p1_chunk,
            (jnp.zeros((Cp * cap,), jnp.int32), jnp.zeros((), jnp.int32)),
            jnp.arange(n_chunks),
        )

        has = row_counts > 0
        rranks = jnp.cumsum(has.astype(jnp.int32)) - 1
        rtgt = jnp.where(has, rranks, row_cap)
        rows_sel = jnp.full((row_cap,), Cp * cap, jnp.int32).at[rtgt].set(
            jnp.arange(Cp * cap, dtype=jnp.int32), mode="drop"
        )
        n_rows = jnp.sum(has.astype(jnp.int32)).astype(jnp.int32)

        # pass 2 on selected slot-rows
        rows_c = jnp.clip(rows_sel, 0, Cp * cap - 1)
        cell_ids = rows_c // cap
        xi = xs3.reshape(-1, 3)[rows_c]  # (row_cap, 3)
        ai = aid2p.reshape(-1)[rows_c]
        xn = xn3[cell_ids]  # (row_cap, 27cap, 3)
        an = an2[cell_ids]
        disp = xi[:, None, :] - xn
        b = box_arr.astype(dtype)
        disp = disp - jnp.round(disp / b) * b
        r2 = jnp.sum(disp * disp, axis=-1)
        row_valid = rows_sel < Cp * cap
        valid = row_valid[:, None] & (ai[:, None] < n) & (an < n) & (ai[:, None] != an)
        r = jnp.sqrt(jnp.where(valid, r2, jnp.inf))
        if types_arr is not None:
            ti, tj = tpair
            t_i, t_j = slot_types(ai), slot_types(an)
            cv_ok2 = ((t_i[:, None] == ti) & (t_j == tj)) | (
                (t_i[:, None] == tj) & (t_j == ti)
            )
            r = jnp.where(cv_ok2, r, jnp.inf)
        runif = row_uniform(rows_c)
        _, acc = accept_of(jnp.isfinite(r) & (r < bmax_cv), runif)

        hills_rows, runif_rows, valid_rows = _extract_first_m(
            acc, r, runif, m_per_row, dtype
        )
        row_overflow = jnp.any(row_counts > m_per_row)

        hflat = hills_rows.reshape(-1)
        uflat = runif_rows.reshape(-1)
        vflat = valid_rows.reshape(-1)
        ranks = jnp.cumsum(vflat.astype(jnp.int32)) - 1
        tgt = jnp.where(vflat, ranks, hill_capacity)
        hills = jnp.zeros((hill_capacity,), dtype).at[tgt].set(hflat, mode="drop")
        runifs = jnp.ones((hill_capacity,), dtype).at[tgt].set(uflat, mode="drop")
        count = jnp.sum(vflat.astype(jnp.int32)).astype(jnp.int32)
        active = jnp.arange(hill_capacity) < count
        truncated = (count > hill_capacity) | (n_rows > row_cap) | row_overflow
        return hills[:, None], runifs, active, count, ncalls, truncated

    def step(state: CellPairState, _) -> Tuple[CellPairState, jax.Array]:
        core = state.core
        if energy_stride == 1:
            do_energy = None
        elif static_do_energy is not None:
            do_energy = bool(static_do_energy)
        else:
            do_energy = (core.step % energy_stride) == 0
        from ..ops.hashrng import seeds_from_key

        key, sub_noise = jax.random.split(core.key)
        xs, vh = phase1(state, seeds_from_key(sub_noise))
        e_bias, fs = force_fn_for(state, do_energy)(xs)
        # final B half-kick; pin padded slots (noise would random-walk them)
        vs = (
            vh + jnp.asarray(0.5 * lp.dt / lp.mass, xs.dtype) * fs
        ) * state.mc[..., None]
        if isinstance(do_energy, bool):
            # static phase: carry resolved at trace time
            e_bias = e_bias if do_energy else core.energy
        elif do_energy is not None:
            # carry the last computed bias energy through skipped steps
            e_bias = jnp.where(do_energy, e_bias, core.energy)

        do_hills = (core.step % hill_stride) == 0

        def with_hills(args):
            bs, key, last_calls = args
            key, sub = jax.random.split(key)
            if types_arr is not None:
                hills, runifs, active, count, ncalls, truncated = (
                    collect_hills(state, xs, sub, last_calls, xs.dtype)
                )
            else:
                hills, runifs, active, count, ncalls, truncated = (
                    collect_hills_half(
                        state, xs, sub, last_calls, xs.dtype,
                        slab=slab_hills, brick=brick_hills,
                    )
                )
            new_bs, rec = B.add_hills_round(
                params, bs, hills, runifs, last_calls.astype(xs.dtype),
                active=active, axis_name=axis_name,
            )
            # refit at the carried table's degree/panels (a mismatched
            # cheb_deg arg would give cond branches different shapes)
            new_cheb = (
                fit_gauss_grid(new_bs.bias, core.cheb.deg, core.cheb.npanels)
                if core.cheb is not None
                else None
            )
            log = (
                B.HillRoundLog(jnp.ones((), bool), hills, rec)
                if collect_records
                else None
            )
            return new_bs, key, ncalls, truncated, new_cheb, log

        def without_hills(args):
            bs, key, last_calls = args
            log = (
                B.round_log_zeros(params, bs, hill_capacity)
                if collect_records
                else None
            )
            return bs, key, last_calls, jnp.zeros((), bool), core.cheb, log

        if static_do_hills is None:
            bias_state, key, last_calls, truncated, cheb, log = jax.lax.cond(
                do_hills, with_hills, without_hills,
                (core.bias, key, core.last_calls),
            )
        elif static_do_hills:
            bias_state, key, last_calls, truncated, cheb, log = with_hills(
                (core.bias, key, core.last_calls)
            )
        else:
            bias_state, key, last_calls, truncated, cheb, log = without_hills(
                (core.bias, key, core.last_calls)
            )

        step_no = core.step + 1
        do_rebuild = (step_no % rebuild_stride) == 0

        def full_rebuild(_):
            x_at, v_at, f_at = _atoms_from_slots(spec, state.aid, xs, vs, fs)
            t = build_table(spec, x_at)
            nxs, nvs, nfs, mc, mnf = _slots_from_atoms(
                spec, x_at, v_at, f_at, t.aid
            )
            return (
                t.aid, nxs, nvs, nfs, mc, mnf,
                state.table_overflow | t.overflow, x_at, v_at, f_at,
            )

        def rebuild(_):
            from .cells import apply_incremental_rebin, plan_incremental_rebin

            S = C * cap
            plan = plan_incremental_rebin(spec, state.aid, xs, mover_cap)

            def fast(_):
                # slot-to-slot incremental rebin: only boundary-crossing
                # atoms move (~1-2% at stride 10); the full argsort path
                # round-trips EVERY atom through atom order
                aid_new, outs = apply_incremental_rebin(
                    spec, plan, state.aid,
                    [xs.reshape(S, 3), vs.reshape(S, 3), fs.reshape(S, 3)],
                )
                mc2 = (aid_new.reshape(C, cap) < n).astype(xs.dtype)
                nxs, nvs, nfs = (
                    o.reshape(C, cap, 3) * mc2[..., None] for o in outs
                )
                # core.x/v/f stay stale (atom_positions() is the live view)
                return (
                    aid_new, nxs, nvs, nfs, mc2,
                    _half_concat(mc2, spec.ncells, cap),
                    state.table_overflow, core.x, core.v, core.f,
                )

            return jax.lax.cond(plan.feasible, fast, full_rebuild, None)

        def keep(_):
            return (
                state.aid, xs, vs, fs, state.mc, state.mnf,
                state.table_overflow, core.x, core.v, core.f,
            )

        if static_do_rebuild is None:
            outs = jax.lax.cond(do_rebuild, rebuild, keep, None)
        elif static_do_rebuild:
            outs = rebuild(None)
        else:
            outs = keep(None)
        aid_g, nxs, nvs, nfs, mc, mnf, overflow, x_at, v_at, f_at = outs

        new_core = PairEDMState(
            x=x_at, v=v_at, f=f_at, key=key, bias=bias_state,
            step=step_no, last_calls=last_calls, energy=e_bias,
            hills_truncated=core.hills_truncated | truncated,
            cheb=cheb,
        )
        new_state = CellPairState(
            core=new_core, aid=aid_g, xs=nxs, vs=nvs, fs=nfs, mc=mc,
            table_overflow=overflow, mnf=mnf,
        )
        return new_state, ((e_bias, log) if collect_records else e_bias)

    return step
