"""Sharded cell-list pairwise EDM — the multi-device path (100k-atom
pairwise EDM across several cards).

Decomposition: each device owns a contiguous range of *cells* (a spatial
domain decomposition, the analog of the reference's MPI subdivision,
edm_bias.cpp:98-222) — but where the reference must exchange hills with
neighbor ranks through a deadlock-free P2P schedule, here positions are
small enough to all-gather every step (N*3 floats), each device
computes LJ+bias forces for atoms in its own cells against the replicated
positions, and per-atom forces combine with one psum.  Hill rounds use the
same per-device collection + gathered replay as parallel/pair.py.

This is halo-free: the "halo" is the replicated position array, which at
1e5 atoms is 1.2 MB — far cheaper to move than the bookkeeping of true
ghost regions, and it keeps every device's bias grid replica bitwise
identical.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .. import bias as B
from ..models.cells import CellSpec, build_table
from ..models.langevin import LangevinParams
from ..models.lj import LJParams
from ..models.pair_edm import PairEDMState


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedCellPairState:
    """Replicated-leaf state for the work-sharded cells host (the
    single-device host moved to a slot-resident layout; this host splits
    cell chunks across devices over a replicated atom-order state)."""

    core: PairEDMState
    aid: jax.Array  # (C*cap,) slot -> atom id (n_atoms = empty)
    table_overflow: jax.Array  # bool


def init_sharded_cell_state(spec, core) -> ShardedCellPairState:
    table = build_table(spec, core.x)
    return ShardedCellPairState(
        core=core, aid=table.aid, table_overflow=table.overflow
    )
from ..ops.chebyshev import fit_gauss_grid
from .mesh import DATA_AXIS


def make_sharded_cell_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    spec: CellSpec,
    hill_stride: int,
    mesh,
    rebuild_stride: int = 10,
    hill_capacity: int = 1024,
    cell_chunk: int = 32,
    row_cap: int = 1024,
    m_per_row: int = 16,
    cheb_deg: int = 64,
    collect_records: bool = False,
    static_do_hills: "Optional[bool]" = None,
    static_do_rebuild: "Optional[bool]" = None,
):
    """Replicated-state sharded step: every leaf of CellPairState is
    replicated; the *work* (cell chunks) is split across the mesh and the
    per-atom forces / hill batches are combined with collectives.

    Run it like the single-device step: ``state, e = step_fn(state)``.
    With ``collect_records`` the step also returns a ``B.HillRoundLog`` over
    the gathered global round (every device replays the identical round on
    its grid replica, so one log stream represents every replica — the
    reference's per-rank hills files, edm_bias.cpp:586-599, differ only by
    which rank originated each hill).
    """
    n_dev = mesh.devices.size
    axis = DATA_AXIS
    C = spec.n_cells
    cap = spec.cap
    n = spec.n_atoms
    # per-device cell range (pad C to a multiple of n_dev * cell_chunk)
    per_dev_chunks = -(-C // (n_dev * cell_chunk))
    Cp = per_dev_chunks * cell_chunk * n_dev

    box_arr = jnp.asarray(spec.box)
    import numpy as np

    stencil_np = spec.stencil()
    stencil_p = jnp.asarray(
        np.concatenate([stencil_np, np.zeros((Cp - C, 27), np.int32)], axis=0)
    )
    bmax_cv = params.cfg.box_high[0]

    def chunk_pairs(xs3, aid2, c0, dtype):
        xc = jax.lax.dynamic_slice_in_dim(xs3, c0, cell_chunk)
        ac = jax.lax.dynamic_slice_in_dim(aid2, c0, cell_chunk)
        nbr = jax.lax.dynamic_slice_in_dim(stencil_p, c0, cell_chunk)
        xn = xs3[nbr]
        an = aid2[nbr]
        disp = xc[:, :, None, :] - xn.reshape(cell_chunk, 1, 27 * cap, 3)
        b = box_arr.astype(dtype)
        disp = disp - jnp.round(disp / b) * b
        r2 = jnp.sum(disp * disp, axis=-1)
        anf = an.reshape(cell_chunk, 1, 27 * cap)
        valid = (ac[:, :, None] < n) & (anf < n) & (ac[:, :, None] != anf)
        r = jnp.sqrt(jnp.where(valid, r2, jnp.inf))
        return disp, r, valid, ac

    def padded_tables(state, x, dtype):
        aid_c = jnp.clip(state.aid, 0, n - 1)
        xs3 = x[aid_c].reshape(C, cap, 3)
        xs3 = jnp.concatenate([xs3, jnp.zeros((Cp - C, cap, 3), dtype)], axis=0)
        aid2 = jnp.concatenate(
            [state.aid.reshape(C, cap), jnp.full((Cp - C, cap), n, jnp.int32)],
            axis=0,
        )
        return xs3, aid2

    def step_local(state: ShardedCellPairState):
        core = state.core
        dtype = core.x.dtype
        dev = jax.lax.axis_index(axis)
        my_c0 = dev * per_dev_chunks * cell_chunk

        def force_fn(x):
            xs3, aid2 = padded_tables(state, x, dtype)

            def one_chunk(ci):
                disp, r, valid, ac = chunk_pairs(
                    xs3, aid2, my_c0 + ci * cell_chunk, dtype
                )
                inr = jnp.where(r < lj.rcut, 1.0 / r, 0.0)
                sr6 = (lj.sigma * inr) ** 6
                fmag = 4 * lj.epsilon * (12 * sr6 * sr6 - 6 * sr6) * inr * inr
                f_rows = jnp.sum(fmag[..., None] * disp, axis=2)
                val, der0 = core.cheb.value_deriv(jnp.where(jnp.isfinite(r), r, -1.0))
                binr = jnp.where(jnp.isfinite(r), 1.0 / r, 0.0)
                f_rows = f_rows + jnp.sum((-der0 * binr)[..., None] * disp, axis=2)
                e_b = jnp.sum(jnp.where(jnp.isfinite(r), val, 0.0))
                return f_rows, ac, e_b

            f_rows, acs, e_bs = jax.lax.map(one_chunk, jnp.arange(per_dev_chunks))
            f_flat = f_rows.reshape(-1, 3)
            a_flat = acs.reshape(-1)
            f_atoms = jnp.zeros((n + 1, 3), dtype).at[
                jnp.where(a_flat < n, a_flat, n)
            ].add(f_flat)[:n]
            # combine device contributions (each atom's force computed only
            # on the device owning its cell)
            f_atoms = jax.lax.psum(f_atoms, axis)
            e_b = 0.5 * jax.lax.psum(jnp.sum(e_bs), axis)
            return e_b, f_atoms

        from ..models.langevin import baoab_step

        x, v, f, e_bias, _ = baoab_step(
            lp, core.x, core.v, core.f, core.key, force_fn
        )
        key = jax.random.split(core.key)[0]

        do_hills = (core.step % hill_stride) == 0

        def with_hills(args):
            bs, last_calls = args
            xs3, aid2 = padded_tables(state, x, dtype)
            hkey = jax.random.fold_in(core.key, 7)

            def row_uniform(slot_rows):
                keys = jax.vmap(lambda i: jax.random.fold_in(hkey, i))(slot_rows)
                return jax.vmap(
                    lambda k: jax.random.uniform(k, (27 * cap,), dtype)
                )(keys)

            def accept_of(r, runif):
                candidate = jnp.isfinite(r) & (r < bmax_cv)
                if params.cfg.hill_density < 0:
                    acc = candidate
                else:
                    acc = candidate & (
                        runif < params.cfg.hill_density / last_calls.astype(dtype)
                    )
                return candidate, acc

            # pass 1 over MY cells only
            def p1(carry, ci):
                row_counts, ncalls = carry
                c0 = my_c0 + ci * cell_chunk
                _, r, valid, _ = chunk_pairs(xs3, aid2, c0, dtype)
                rows = (c0 * cap + jnp.arange(cell_chunk * cap)).astype(jnp.int32)
                runif = row_uniform(rows).reshape(cell_chunk, cap, 27 * cap)
                candidate, acc = accept_of(r, runif)
                rc = jnp.sum(acc.astype(jnp.int32), axis=2).reshape(-1).astype(jnp.int32)
                row_counts = jax.lax.dynamic_update_slice_in_dim(
                    row_counts, rc, ci * cell_chunk * cap, axis=0
                )
                ncalls = (ncalls + jnp.sum(candidate.astype(jnp.int32))).astype(jnp.int32)
                return (row_counts, ncalls), None

            my_rows = per_dev_chunks * cell_chunk * cap
            (row_counts, ncalls_local), _ = jax.lax.scan(
                p1,
                (jnp.zeros((my_rows,), jnp.int32), jnp.zeros((), jnp.int32)),
                jnp.arange(per_dev_chunks),
            )
            ncalls = jax.lax.psum(ncalls_local, axis).astype(jnp.int32)

            has = row_counts > 0
            rranks = jnp.cumsum(has.astype(jnp.int32)) - 1
            rtgt = jnp.where(has, rranks, row_cap)
            rows_sel = jnp.full((row_cap,), Cp * cap, jnp.int32).at[rtgt].set(
                (my_c0 * cap + jnp.arange(my_rows)).astype(jnp.int32), mode="drop"
            )
            n_rows = jnp.sum(has.astype(jnp.int32)).astype(jnp.int32)

            rows_c = jnp.clip(rows_sel, 0, Cp * cap - 1)
            cell_ids = rows_c // cap
            xi = xs3.reshape(-1, 3)[rows_c]
            ai = aid2.reshape(-1)[rows_c]
            nbr = stencil_p[cell_ids]
            xn = xs3[nbr].reshape(row_cap, 27 * cap, 3)
            an = aid2[nbr].reshape(row_cap, 27 * cap)
            disp = xi[:, None, :] - xn
            b = box_arr.astype(dtype)
            disp = disp - jnp.round(disp / b) * b
            r2 = jnp.sum(disp * disp, axis=-1)
            row_valid = rows_sel < Cp * cap
            valid = row_valid[:, None] & (ai[:, None] < n) & (an < n) & (ai[:, None] != an)
            r = jnp.sqrt(jnp.where(valid, r2, jnp.inf))
            runif = row_uniform(rows_c)
            _, acc = accept_of(r, runif)

            hills_rows = jnp.zeros((row_cap, m_per_row), dtype)
            runif_rows = jnp.ones((row_cap, m_per_row), dtype)
            valid_rows = jnp.zeros((row_cap, m_per_row), bool)
            work = acc
            for m in range(m_per_row):
                j = jnp.argmax(work, axis=1)
                found = jnp.take_along_axis(work, j[:, None], axis=1)[:, 0]
                hills_rows = hills_rows.at[:, m].set(
                    jnp.take_along_axis(r, j[:, None], axis=1)[:, 0]
                )
                runif_rows = runif_rows.at[:, m].set(
                    jnp.take_along_axis(runif, j[:, None], axis=1)[:, 0]
                )
                valid_rows = valid_rows.at[:, m].set(found)
                work = work.at[jnp.arange(row_cap), j].set(False)
            row_overflow = jnp.any(row_counts > m_per_row)

            hflat = hills_rows.reshape(-1)
            uflat = runif_rows.reshape(-1)
            vflat = valid_rows.reshape(-1)
            ranks = jnp.cumsum(vflat.astype(jnp.int32)) - 1
            tgt = jnp.where(vflat, ranks, hill_capacity)
            local_hills = jnp.zeros((hill_capacity,), dtype).at[tgt].set(hflat, mode="drop")
            local_runifs = jnp.ones((hill_capacity,), dtype).at[tgt].set(uflat, mode="drop")
            count = jnp.sum(vflat.astype(jnp.int32)).astype(jnp.int32)
            local_active = jnp.arange(hill_capacity) < count
            truncated = jax.lax.psum(
                ((count > hill_capacity) | (n_rows > row_cap) | row_overflow).astype(jnp.int32),
                axis,
            ) > 0

            hills_g = jax.lax.all_gather(local_hills[:, None], axis, tiled=True)
            runifs_g = jax.lax.all_gather(local_runifs, axis, tiled=True)
            active_g = jax.lax.all_gather(local_active, axis, tiled=True)

            new_bs, rec = B.add_hills_round(
                params, bs, hills_g, runifs_g, last_calls.astype(dtype), active=active_g
            )
            new_cheb = fit_gauss_grid(new_bs.bias, core.cheb.deg, core.cheb.npanels)
            log = (
                B.HillRoundLog(jnp.ones((), bool), hills_g, rec)
                if collect_records
                else None
            )
            return new_bs, ncalls, truncated, new_cheb, log

        def without_hills(args):
            bs, last_calls = args
            log = (
                B.round_log_zeros(params, bs, hill_capacity * n_dev)
                if collect_records
                else None
            )
            return bs, last_calls, jnp.zeros((), bool), core.cheb, log

        if static_do_hills is None:
            bias_state, last_calls, truncated, cheb, log = jax.lax.cond(
                do_hills, with_hills, without_hills,
                (core.bias, core.last_calls),
            )
        elif static_do_hills:
            bias_state, last_calls, truncated, cheb, log = with_hills(
                (core.bias, core.last_calls)
            )
        else:
            bias_state, last_calls, truncated, cheb, log = without_hills(
                (core.bias, core.last_calls)
            )

        new_core = PairEDMState(
            x=x, v=v, f=f, key=key, bias=bias_state,
            step=core.step + 1, last_calls=last_calls, energy=e_bias,
            hills_truncated=core.hills_truncated | truncated,
            cheb=cheb,
        )

        do_rebuild = (new_core.step % rebuild_stride) == 0
        rebuild_f = lambda _: (
            lambda t: (t.aid, state.table_overflow | t.overflow)
        )(build_table(spec, x))
        keep_f = lambda _: (state.aid, state.table_overflow)
        if static_do_rebuild is None:
            aid, overflow = jax.lax.cond(do_rebuild, rebuild_f, keep_f, None)
        elif static_do_rebuild:
            aid, overflow = rebuild_f(None)
        else:
            aid, overflow = keep_f(None)
        new_state = ShardedCellPairState(
            core=new_core, aid=aid, table_overflow=overflow
        )
        if collect_records:
            return new_state, e_bias, log
        return new_state, e_bias

    def _specs(state):
        return jax.tree.map(lambda _: P(), state)

    def one_step(state):
        if collect_records:
            log_shape = jax.eval_shape(
                lambda bs: B.round_log_zeros(params, bs, hill_capacity * n_dev),
                state.core.bias,
            )
            out_specs = (
                _specs(state), P(), jax.tree.map(lambda _: P(), log_shape)
            )
        else:
            out_specs = (_specs(state), P())
        fn = jax.shard_map(
            step_local,
            mesh=mesh,
            in_specs=(_specs(state),),
            out_specs=out_specs,
            check_vma=False,
        )
        return fn(state)

    return jax.jit(one_step)


def make_slab_cell_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    spec: CellSpec,
    hill_stride: int,
    mesh,
    **kw,
):
    """Slot-resident slab-sharded cells host — the production multi-device
    force path.

    Wraps ``models.pair_edm_cells.make_cell_step`` (same state, same
    physics, same force pass) in ``shard_map`` with the force
    pass slab-decomposed over the mesh's x-columns (one psum of slot
    forces per step) and — by default — the hill-collection passes
    slab-decomposed the same way (per-device candidate sampling over
    owned columns, one all_gather of compacted hills per round that
    replays in the single-device deposit order; ``slab_collect=False``
    restores replicated collection).  The BAOAB pre-force phase and the
    hill pass-2 budgets are slab-decomposed too (``shard_floor``, default
    on — slot-row-keyed thermostat noise + one fused (x, v) psum keep the
    result bitwise the replicated floor's); deposition and rebuilds run
    replicated and deterministic, so the state stays bitwise identical
    across devices — the reference's entire MPI hill-exchange layer
    (edm_bias.cpp:614-920) has no analog here.

    Use with ``models.pair_edm_cells.init_cell_state`` state; returns a
    jitted ``state, e = step(state)`` — or ``state, (e, log) = step(state)``
    with ``collect_records`` (the replicated hill rounds produce one
    HillRoundLog stream representing every replica).
    """
    from ..models.pair_edm_cells import make_cell_step

    collect_records = kw.get("collect_records", False)
    inner = make_cell_step(
        params, lp, lj, spec, hill_stride,
        slab_axis=DATA_AXIS, slab_ndev=mesh.devices.size, **kw,
    )

    hill_capacity = kw.get("hill_capacity", 2048)

    def one_step(state):
        specs = jax.tree.map(lambda _: P(), state)
        if collect_records:
            log_shape = jax.eval_shape(
                lambda bs: B.round_log_zeros(params, bs, hill_capacity),
                state.core.bias,
            )
            out_specs = (
                specs, (P(), jax.tree.map(lambda _: P(), log_shape)),
            )
        else:
            out_specs = (specs, P())
        fn = jax.shard_map(
            lambda s: inner(s, None),
            mesh=mesh,
            in_specs=(specs,),
            out_specs=out_specs,
            check_vma=False,
        )
        return fn(state)

    return jax.jit(one_step)


def make_brick_cell_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    spec: CellSpec,
    hill_stride: int,
    mesh,
    **kw,
):
    """Brick-decomposed slot-resident cells host (2-D or 3-D device grid).

    Like ``make_slab_cell_step`` but the force pass (and, by default, the
    hill collection) is decomposed over a (px, py) or (px, py, pz) device
    grid — each device owns an x-range x y-range (x z-range) of cells
    plus a one-cell halo ring.  At equal device count the halo fraction
    is ~sum_d 2/w_d instead of the slab's 2/w, and the decomposition
    scales to prod_d p_d ~ nx*ny*nz devices where the 1-D slab saturates
    at nx.  This is the analog of the reference's 3-D MPI box subdivision
    (edm_bias.cpp:98-222).  On an all-to-all host (NVLink) the grid shape
    follows the algorithm alone: choose the (px, py[, pz]) that minimises
    the halo fraction for the lattice.

    ``mesh`` must be a 2-D or 3-D mesh (see parallel.make_brick_mesh);
    pass ``init_cell_state`` state; returns a jitted
    ``state, e = step(state)`` (or ``state, (e, log)`` with
    ``collect_records``)."""
    from ..models.pair_edm_cells import make_cell_step

    if mesh.devices.ndim not in (2, 3):
        raise ValueError(
            "brick host needs a 2-D (px, py) or 3-D (px, py, pz) device mesh"
        )
    ndev = tuple(mesh.devices.shape)
    axes = tuple(mesh.axis_names)
    collect_records = kw.get("collect_records", False)
    inner = make_cell_step(
        params, lp, lj, spec, hill_stride,
        brick_axes=axes, brick_ndev=ndev, **kw,
    )

    hill_capacity = kw.get("hill_capacity", 2048)

    def one_step(state):
        specs = jax.tree.map(lambda _: P(), state)
        if collect_records:
            log_shape = jax.eval_shape(
                lambda bs: B.round_log_zeros(params, bs, hill_capacity),
                state.core.bias,
            )
            out_specs = (
                specs, (P(), jax.tree.map(lambda _: P(), log_shape)),
            )
        else:
            out_specs = (specs, P())
        fn = jax.shard_map(
            lambda s: inner(s, None),
            mesh=mesh,
            in_specs=(specs,),
            out_specs=out_specs,
            check_vma=False,
        )
        return fn(state)

    return jax.jit(one_step)
