"""Coordinate-CV EDM host — the JAX equivalent of LAMMPS ``fix edm``
(reference lammps/fix_edm.cpp): biases raw particle coordinates (1-3 dims)
during a Langevin MD run.

The LAMMPS hooks map to a single jit-compiled MD step under ``lax.scan``:
  post_force  -> bias gradient lookup fused into the force function
  hill stride -> a ``lax.cond``-gated add_hills_round with jax.random
                 uniforms standing in for RanMars (fix_edm.cpp:145-151)
  write stride-> host-side segment boundary (bias/histogram writers)

The whole inner loop — integrate, CV lookup, hill deposition — is one XLA
program; per-step host traffic is zero within a write segment.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .. import bias as B
from .langevin import LangevinParams, baoab_step
from ..ops.interp import packed_corner_table


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoordEDMState:
    x: jax.Array  # (N, ndim_space)
    v: jax.Array
    f: jax.Array
    key: jax.Array
    bias: B.BiasState
    step: jax.Array  # int64
    energy: jax.Array  # last bias energy
    # cached fused corner table for multi-dim interp force lookups
    # (ops/interp.packed_corner_table); rebuilt after hill rounds
    ptab: Optional[jax.Array] = None
    # True if an accepted-hill batch ever exceeded the compaction capacity
    # (hill_capacity; the round then dropped the tail — raise the capacity)
    hills_truncated: Optional[jax.Array] = None


def make_step(
    params: B.BiasParams,
    lp: LangevinParams,
    hill_stride: int,
    external_force: Optional[Callable] = None,
    axis_name: Optional[str] = None,
    group_mask=None,
    collect_records: bool = False,
    hill_capacity: Optional[int] = None,
    static_do_hills: Optional[bool] = None,
    hill_passes: int = 1,
):
    """Build the jitted single-step transition.

    ``external_force(x) -> (energy, force)`` adds a physical potential on
    top of the bias (None = free particle, the reference's sanity setup).
    ``group_mask`` (N,) bool restricts biasing to a group of atoms — the
    LAMMPS groupbit filter (fix_edm.cpp:104,140,153): masked-out atoms feel
    no bias force and deposit no hills (external forces still apply).

    ``hill_capacity``: accepted-hill compaction.  With stochastic sampling
    (hill_density >= 0) only ~hill_density of the N per-atom candidates
    are accepted per round, but every per-hill cost of the round — deposit
    tables, cap scan, histogram scatter — scales with the BATCH size, so
    the host compacts accepted candidates (order-preserving, same draws,
    same est_hill_count) into a ``hill_capacity`` batch first, exactly as
    the reference's rejected candidates never reach do_add_hill
    (edm_bias.cpp:543).  Default: ~8x the expected acceptance count
    (>40 sigma of Poisson headroom), rounded to 512; overflow — which
    drops the tail of a round — is flagged in ``state.hills_truncated``.
    Pass 0 to disable compaction (replicates the full-batch round
    bit-for-bit including its records shape).

    ``hill_passes``: never-drop headroom for the compacted round — the
    compaction buffer grows to ``hill_passes * hill_capacity`` rows and the
    round runs as ``hill_passes`` cond-gated sub-batches
    (``bias.add_hills_round(n_passes=...)``), the static-shape analog of
    the reference's mid-round flush-and-continue (edm_bias.cpp:459-462).
    Rounds that fit in ``hill_capacity`` pay only pass-through copies for
    the gated extra passes; an acceptance spike spills into later passes
    instead of being dropped, and ``hills_truncated`` fires only past
    ``hill_passes * hill_capacity``.

    ``static_do_hills``: resolve the hill-round branch at TRACE time
    instead of with a per-step ``lax.cond``.  The cond's pass-through
    branch must materialize a fresh copy of every carried array it
    returns unchanged — at bench scale that is the 48 MB fused corner
    table plus ~13 MB of bias grids copied on every NON-hill step
    (measured ~0.15 ms/step of the 0.33 ms 2-D step).  A host that knows
    the stride phase statically builds one step with
    ``static_do_hills=True`` (always runs the round; the caller must keep
    ``state.step % hill_stride == 0`` alignment) and one with ``False``
    (never runs it; the acceptance uniforms are still drawn so the key
    stream is bitwise identical to the dynamic step), and drives them
    with ``driver.strided_segment``.  ``None`` keeps the dynamic cond.
    """
    D = params.cfg.dim
    gmask = None if group_mask is None else jnp.asarray(group_mask, bool)
    density = float(params.cfg.hill_density)
    if hill_capacity is None:
        hill_capacity = (
            0
            if density < 0
            else max(512, int(-(-8.0 * max(density, 64.0) // 512)) * 512)
        )

    def force_fn(bias_state, ptab):
        def fn(x):
            e_b, der = B.update_forces(
                params, bias_state, x, mask=gmask, packed=ptab
            )
            f = jnp.zeros_like(x)
            f = f.at[..., :D].add(-der)
            e = e_b
            if external_force is not None:
                e_ext, f_ext = external_force(x)
                f = f + f_ext
                e = e + e_ext
            return e, f

        return fn

    def step(state: CoordEDMState, _) -> Tuple[CoordEDMState, jax.Array]:
        x, v, f, energy, key = baoab_step(
            lp, state.x, state.v, state.f, state.key,
            force_fn(state.bias, state.ptab),
        )

        do_hills = (state.step % hill_stride) == 0
        key, sub = jax.random.split(key)
        N = x.shape[0]
        runiform = jax.random.uniform(sub, (N,), x.dtype)
        compact = 0 < hill_capacity < N and density >= 0
        Hc = hill_passes * hill_capacity if compact else N

        def with_hills(bs):
            if compact:
                # same acceptance predicate add_hills_round applies
                # (bias.py step 3 <-> edm_bias.cpp:543); order-preserving
                # rank compaction keeps the deposit/cap order, and the
                # engine's re-check on the compacted batch accepts exactly
                # these hills (same draws, same est_hill_count)
                acc = runiform < params.cfg.hill_density / N
                if gmask is not None:
                    acc = acc & gmask
                ranks = jnp.cumsum(acc.astype(jnp.int32)) - 1
                tgt = jnp.where(acc & (ranks < Hc), ranks, Hc)
                pos_c = jnp.zeros((Hc, D), x.dtype).at[tgt].set(
                    x[..., :D], mode="drop"
                )
                run_c = jnp.ones((Hc,), x.dtype).at[tgt].set(
                    runiform, mode="drop"
                )
                count = jnp.sum(acc.astype(jnp.int32))
                active_c = jnp.arange(Hc) < count
                trunc = count > Hc
                new_bs, rec = B.add_hills_round(
                    params, bs, pos_c, run_c, N,
                    active=active_c, axis_name=axis_name,
                    n_passes=hill_passes,
                )
                log_pos = pos_c
            else:
                trunc = jnp.zeros((), bool)
                new_bs, rec = B.add_hills_round(
                    params, bs, x[..., :D], runiform, N,
                    active=gmask, axis_name=axis_name,
                )
                log_pos = x[..., :D]
            ptab = (
                None
                if state.ptab is None
                else packed_corner_table(new_bs.bias.grid)
            )
            log = (
                B.HillRoundLog(jnp.ones((), bool), log_pos, rec)
                if collect_records
                else None
            )
            return new_bs, ptab, log, trunc

        def without_hills(bs):
            # keep steps aligned with the reference convention: steps_ counts
            # hill rounds, not MD steps (edm_bias.cpp:582)
            log = (
                B.round_log_zeros(params, bs, Hc)
                if collect_records
                else None
            )
            return bs, state.ptab, log, jnp.zeros((), bool)

        if static_do_hills is None:
            bias_state, ptab, log, trunc = jax.lax.cond(
                do_hills, with_hills, without_hills, state.bias
            )
        elif static_do_hills:
            bias_state, ptab, log, trunc = with_hills(state.bias)
        else:
            bias_state, ptab, log, trunc = without_hills(state.bias)
        # states built before the flag existed carry None — keep the pytree
        # structure stable under lax.scan (init_state always sets it)
        new_trunc = (
            None
            if state.hills_truncated is None
            else state.hills_truncated | trunc
        )

        new_state = CoordEDMState(
            x=x, v=v, f=f, key=key, bias=bias_state,
            step=state.step + 1, energy=energy, ptab=ptab,
            hills_truncated=new_trunc,
        )
        return new_state, ((energy, log) if collect_records else energy)

    return step


def init_state(
    params: B.BiasParams,
    bias_state: B.BiasState,
    x0,
    key,
    lp: LangevinParams,
    cache_lookup_table: Optional[bool] = None,
) -> CoordEDMState:
    """``cache_lookup_table`` (default: auto for D >= 2 on bulk-sized
    grids) caches the fused corner table in the state so the multi-dim
    force lookup's ~4x-grid table build runs only after hill rounds."""
    x0 = jnp.asarray(x0)
    D = params.cfg.dim
    g = bias_state.bias.grid
    if cache_lookup_table is None:
        F = (1 + D) * (2 ** D)
        cache_lookup_table = (
            D >= 2 and x0.shape[0] >= 4096 and g.values.size * F <= 64_000_000
        )
    ptab = packed_corner_table(g) if cache_lookup_table else None
    return CoordEDMState(
        x=x0,
        v=jnp.zeros_like(x0),
        f=jnp.zeros_like(x0),
        key=key,
        bias=bias_state,
        step=jnp.zeros((), jnp.int32),
        energy=jnp.zeros((), x0.dtype),
        ptab=ptab,
        hills_truncated=jnp.zeros((), bool),
    )


def run_segment(step_fn, state: CoordEDMState, n_steps: int):
    """Run ``n_steps`` MD steps as one compiled scan; returns final state and
    the per-step bias energies."""
    return jax.lax.scan(step_fn, state, None, length=n_steps)
