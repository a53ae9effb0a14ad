"""Pairwise-distance EDM host — JAX equivalent of LAMMPS
``fix edm_pair`` (reference lammps/fix_edm_pair.cpp): biases the pair-distance
CV of a LJ fluid toward a target RDF-derived PMF.

Reference mapping:
  half-neighbor-list loop           -> dense minimum-image pair matrix; each
                                       ordered pair (i,j) contributes its own
                                       force row, so the equal/opposite pair
                                       forces (fix_edm_pair.cpp:219-227) and
                                       the 2-hills-per-pair rule (:229-237,
                                       both atoms local on one device) emerge
                                       from symmetry; energy is halved.
  per-pair RanMars uniforms         -> jax.random uniforms per ordered pair
  est_hill_count = last ncalls      -> carried per-step pair count
                                       (fix_edm_pair.cpp:105,243-246)
  bias domain [0, cutoff+skin]      -> the .edm box; grid replicated per
                                       device, psum-merged under shard_map

Hill compaction: with ``hill_density`` set, only
~hill_density hills are accepted per round out of O(N^2) candidate pairs, so
accepted pairs are compacted (stable argsort on the accept mask) into a
fixed-capacity hill batch before the expensive window evaluation — the
deposit cost scales with accepted hills, not candidate pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .. import bias as B
from ..ops.chebyshev import ChebTable, fit_gauss_grid
from .langevin import LangevinParams, baoab_step
from .lj import LJParams, lj_energy_forces, pair_displacements


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PairEDMState:
    x: jax.Array  # (N, 3)
    v: jax.Array
    f: jax.Array
    key: jax.Array
    bias: B.BiasState
    step: jax.Array
    last_calls: jax.Array  # est_hill_count for the next round
    energy: jax.Array  # bias energy of the last step
    hills_truncated: jax.Array  # bool: accepted hills exceeded capacity
    cheb: Optional[ChebTable]  # spectral pair-force table (None = exact interp)


def make_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    box,
    hill_stride: int,
    hill_capacity: int = 2048,
    axis_name: Optional[str] = None,
    cheb_deg: int = 64,
    types=None,
    type_pair: Optional[Tuple[int, int]] = None,
    collect_records: bool = False,
    static_do_hills: Optional[bool] = None,
):
    """Build the jitted pairwise-EDM MD step.

    If the state carries a ``cheb`` table (see init_state pair_lookup), the
    per-pair bias lookup uses the gather-free spectral form (ops/chebyshev);
    otherwise the exact cubic-Hermite grid interpolation.

    ``types`` (N,) int array + ``type_pair`` (i, j) restrict the biased CV
    to i-j type pairs, the reference's ``rdf type pair`` arguments
    (fix_edm_pair.cpp:39-44,177-202); None biases all pairs."""
    if types is not None and type_pair is not None:
        t = jnp.asarray(types, jnp.int32)
        ti, tj = int(type_pair[0]), int(type_pair[1])
        pair_mask = ((t[:, None] == ti) & (t[None, :] == tj)) | (
            (t[:, None] == tj) & (t[None, :] == ti)
        )
    else:
        pair_mask = None

    def bias_pair_force(state, disp, r):
        if pair_mask is not None:
            r = jnp.where(pair_mask, r, jnp.inf)
        if state.cheb is not None:
            val, d = state.cheb.value_deriv(jnp.where(jnp.isfinite(r), r, -1.0))
            der0 = d
        else:
            rb = r[..., None]  # (N, N, 1) as 1-D CV points
            val, der = state.bias.bias.get_value_deriv(rb)
            der0 = der[..., 0]
        # force on i from pair (i,j): -dU/dr * r_hat (fix_edm_pair.cpp:216-222)
        inr = jnp.where(jnp.isfinite(r), 1.0 / r, 0.0)
        fvec = (-der0 * inr)[..., None] * disp
        forces = jnp.sum(fvec, axis=1)
        energy = 0.5 * jnp.sum(jnp.where(jnp.isfinite(r), val, 0.0))
        return energy, forces

    def step(state: PairEDMState, _) -> Tuple[PairEDMState, jax.Array]:
        bias_state = state.bias

        def force_fn(x):
            disp, r = pair_displacements(x, box)
            e_lj, f_lj = lj_energy_forces(lj, disp, r)
            e_b, f_b = bias_pair_force(state, disp, r)
            return e_b, f_lj + f_b

        x, v, f, e_bias, key = baoab_step(
            lp, state.x, state.v, state.f, state.key, force_fn
        )

        do_hills = (state.step % hill_stride) == 0

        def with_hills(args):
            bs, key, last_calls = args
            disp, r = pair_displacements(x, box)
            rflat = r.reshape(-1)
            if pair_mask is not None:
                rflat = jnp.where(pair_mask.reshape(-1), rflat, jnp.inf)
            # candidate = ordered in-range pair, like every add_hill call in
            # the reference's neighbor loop
            bmax = params.cfg.box_high[0]
            candidate = jnp.isfinite(rflat) & (rflat < bmax)
            ncalls = jnp.sum(candidate.astype(jnp.int32)).astype(jnp.int32)

            key, sub = jax.random.split(key)
            runif = jax.random.uniform(sub, rflat.shape, rflat.dtype)
            if params.cfg.hill_density < 0:
                accept = candidate
            else:
                accept = candidate & (
                    runif < params.cfg.hill_density / last_calls.astype(rflat.dtype)
                )

            # compact accepted pairs to fixed capacity with a prefix-rank
            # scatter (preserves pair-index deposit order for the capping
            # scan; O(N^2) instead of an O(N^2 log N^2) argsort)
            n_log = min(hill_capacity, state.x.shape[0] ** 2)
            ranks = jnp.cumsum(accept.astype(jnp.int32)) - 1
            tgt = jnp.where(accept, ranks, n_log)
            hills = jnp.zeros((n_log,), rflat.dtype).at[tgt].set(rflat, mode="drop")[:, None]
            runif_c = jnp.ones((n_log,), rflat.dtype).at[tgt].set(runif, mode="drop")
            count = jnp.sum(accept.astype(jnp.int32))
            active = jnp.arange(n_log) < count
            truncated = count > n_log

            new_bs, rec = B.add_hills_round(
                params,
                bs,
                hills,
                runif_c,
                last_calls.astype(rflat.dtype),
                active=active,
                axis_name=axis_name,
            )
            # refit at the carried table's degree, not the cheb_deg arg:
            # a mismatch would give the cond branches different shapes
            new_cheb = (
                fit_gauss_grid(new_bs.bias, state.cheb.deg, state.cheb.npanels)
                if state.cheb is not None
                else state.cheb
            )
            log = (
                B.HillRoundLog(jnp.ones((), bool), hills, rec)
                if collect_records
                else None
            )
            return new_bs, key, ncalls, truncated, new_cheb, log

        def without_hills(args):
            bs, key, last_calls = args
            n_log = min(hill_capacity, state.x.shape[0] ** 2)
            log = (
                B.round_log_zeros(params, bs, n_log)
                if collect_records
                else None
            )
            return bs, key, last_calls, jnp.zeros((), bool), state.cheb, log

        if static_do_hills is None:
            bias_state, key, last_calls, truncated, cheb, log = jax.lax.cond(
                do_hills, with_hills, without_hills,
                (bias_state, key, state.last_calls),
            )
        elif static_do_hills:
            bias_state, key, last_calls, truncated, cheb, log = with_hills(
                (bias_state, key, state.last_calls)
            )
        else:
            bias_state, key, last_calls, truncated, cheb, log = without_hills(
                (bias_state, key, state.last_calls)
            )

        new_state = PairEDMState(
            x=x,
            v=v,
            f=f,
            key=key,
            bias=bias_state,
            step=state.step + 1,
            last_calls=last_calls,
            energy=e_bias,
            hills_truncated=state.hills_truncated | truncated,
            cheb=cheb,
        )
        return new_state, ((e_bias, log) if collect_records else e_bias)

    return step


def init_state(
    bias_state: B.BiasState,
    x0,
    key,
    n_est: Optional[int] = None,
    pair_lookup: str = "interp",
    cheb_deg: int = 64,
    cheb_panels: int = 1,
) -> PairEDMState:
    """``n_est``: initial est_hill_count, the reference's conservative
    atom->nmax guess (fix_edm_pair.cpp:105).

    ``pair_lookup``: 'interp' (exact cubic-Hermite grid lookup) or
    'chebyshev' (gather-free spectral table, refit after each hill round;
    the fast path for large pair counts).  ``cheb_panels > 1`` selects the
    panelized series (ops/chebyshev module docstring): ~panels-fold cheaper
    evaluation at equal accuracy for the same total coefficient count."""
    x0 = jnp.asarray(x0)
    n = x0.shape[0] if n_est is None else n_est
    cheb = (
        fit_gauss_grid(bias_state.bias, cheb_deg, cheb_panels)
        if pair_lookup == "chebyshev"
        else None
    )
    return PairEDMState(
        x=x0,
        v=jnp.zeros_like(x0),
        f=jnp.zeros_like(x0),
        key=key,
        bias=bias_state,
        step=jnp.zeros((), jnp.int32),
        last_calls=jnp.asarray(n, jnp.int32),
        energy=jnp.zeros((), x0.dtype),
        hills_truncated=jnp.zeros((), bool),
        cheb=cheb,
    )


def run_segment(step_fn, state: PairEDMState, n_steps: int):
    return jax.lax.scan(step_fn, state, None, length=n_steps)
