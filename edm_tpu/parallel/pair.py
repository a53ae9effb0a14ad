"""Sharded pairwise EDM — the JAX replacement for the reference's MPI
scale-out of ``fix edm_pair``.

Reference topology (SURVEY.md §2): every rank holds a *replicated* 1-D bias
grid over [0, cutoff+skin] (fix_edm_pair.cpp:96-104), deposits hills for its
local pairs, and broadcasts its hills to all other ranks, which replay them
(edm_bias.cpp:647-660).  Statistical load normalization divides
hill_density/hill_prefactor by mpi_size (edm_bias.cpp:173-180); cum_bias is
an Allreduce (edm_bias.cpp:922-931); the deadlock-free P2P schedule
(edm_bias.cpp:795-920) exists only because MPI point-to-point can deadlock.

Mapping under ``shard_map`` over a 1-D mesh:
  - atoms are sharded over the mesh (the O(N^2/n_dev) force pass is the
    actual bottleneck and parallelizes perfectly);
  - positions are all-gathered for the pair math (N*3 floats — cheap);
  - each device's candidate hills are its local *ordered* pairs (i local),
    which reproduces the reference's one-hill-per-direction rule exactly;
  - accepted hills are compacted locally then all-gathered, and every device
    replays the identical global hill round on its replica of the grid —
    exactly the reference's broadcast mode, with determinism for free (no
    exchange protocol, no flush handshake, no pairing schedule);
  - est_hill_count and cum_bias are psums.

Because every device executes the identical gathered round, the replicated
BiasState stays bitwise consistent without any grid reduction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .. import bias as B
from ..models.langevin import LangevinParams, baoab_step
from ..models.lj import LJParams, lj_energy_forces
from ..models.pair_edm import PairEDMState
from ..ops.chebyshev import fit_gauss_grid
from .mesh import DATA_AXIS


def shard_pair_state(state: PairEDMState, mesh) -> PairEDMState:
    """Place atom arrays sharded over the mesh, everything else replicated."""
    sharded = jax.sharding.NamedSharding(mesh, P(DATA_AXIS))
    repl = jax.sharding.NamedSharding(mesh, P())

    def place(leaf, spec):
        return jax.device_put(leaf, spec)

    import dataclasses

    return dataclasses.replace(
        state,
        x=place(state.x, sharded),
        v=place(state.v, sharded),
        f=place(state.f, sharded),
        key=place(state.key, repl),
        bias=jax.tree.map(lambda l: place(l, repl), state.bias),
        step=place(state.step, repl),
        last_calls=place(state.last_calls, repl),
        energy=place(state.energy, repl),
        hills_truncated=place(state.hills_truncated, repl),
        cheb=None if state.cheb is None else jax.tree.map(lambda l: place(l, repl), state.cheb),
    )


def make_sharded_pair_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    box,
    hill_stride: int,
    mesh,
    hill_capacity: int = 2048,
    cheb_deg: int = 64,
    collect_records: bool = False,
    static_do_hills: "Optional[bool]" = None,
):
    """Jit-compiled sharded MD step over ``mesh``; drives PairEDMState whose
    atom arrays are sharded on axis 0.

    ``hill_capacity`` is the *per-device* accepted-hill capacity; the global
    round handles n_dev * hill_capacity hills.

    ``static_do_hills``: trace-time hill branch (no pass-through copies of
    the replicated bias/cheb state; see models.driver.pattern_segment).
    Callers own the stride phase.
    """
    axis = DATA_AXIS
    box_arr = jnp.asarray(box)

    def local_pair_math(x_local, x_full, dtype):
        disp = x_local[:, None, :] - x_full[None, :, :]
        b = box_arr.astype(dtype)
        disp = disp - jnp.round(disp / b) * b
        r2 = jnp.sum(disp * disp, axis=-1)
        # mask self-pairs: local row i corresponds to global index
        n_local = x_local.shape[0]
        dev = jax.lax.axis_index(axis)
        gidx = dev * n_local + jnp.arange(n_local)
        self_mask = gidx[:, None] == jnp.arange(x_full.shape[0])[None, :]
        r = jnp.sqrt(jnp.where(self_mask, jnp.inf, r2))
        return disp, r

    def step_local(state: PairEDMState, _):
        bias_state = state.bias
        dtype = state.x.dtype
        dev = jax.lax.axis_index(axis)

        def force_fn(x_local):
            x_full = jax.lax.all_gather(x_local, axis, tiled=True)
            disp, r = local_pair_math(x_local, x_full, dtype)
            e_lj, f_lj = lj_energy_forces(lj, disp, r)
            if state.cheb is not None:
                val, der0 = state.cheb.value_deriv(jnp.where(jnp.isfinite(r), r, -1.0))
            else:
                val, der = bias_state.bias.get_value_deriv(r[..., None])
                der0 = der[..., 0]
            inr = jnp.where(jnp.isfinite(r), 1.0 / r, 0.0)
            f_b = jnp.sum((-der0 * inr)[..., None] * disp, axis=1)
            e_b = 0.5 * jax.lax.psum(
                jnp.sum(jnp.where(jnp.isfinite(r), val, 0.0)), axis
            )
            return e_b, f_lj + f_b

        # per-device independent noise stream
        key_dev = jax.random.fold_in(state.key, dev)
        x, v, f, e_bias, key_dev = baoab_step(
            lp, state.x, state.v, state.f, key_dev, force_fn
        )
        # carry one replicated key forward (device streams re-fold each step)
        key = jax.random.split(state.key)[0]

        do_hills = (state.step % hill_stride) == 0

        def with_hills(args):
            bs, last_calls = args
            x_full = jax.lax.all_gather(x, axis, tiled=True)
            disp, r = local_pair_math(x, x_full, dtype)
            rflat = r.reshape(-1)
            bmax = params.cfg.box_high[0]
            candidate = jnp.isfinite(rflat) & (rflat < bmax)
            ncalls = jax.lax.psum(
                jnp.sum(candidate.astype(jnp.int32)), axis
            ).astype(jnp.int32)

            hkey = jax.random.fold_in(jax.random.fold_in(state.key, dev), 7)
            runif = jax.random.uniform(hkey, rflat.shape, dtype)
            if params.cfg.hill_density < 0:
                accept = candidate
            else:
                accept = candidate & (
                    runif < params.cfg.hill_density / last_calls.astype(dtype)
                )

            # prefix-rank scatter compaction: O(N^2) cumsum + bounded
            # scatter instead of an O(N^2 log N^2) argsort; preserves
            # pair-index deposit order (ranks >= capacity drop out of
            # bounds, flagged as truncation)
            ranks = jnp.cumsum(accept.astype(jnp.int32)) - 1
            tgt = jnp.where(accept, ranks, hill_capacity)
            local_hills = (
                jnp.zeros((hill_capacity,), dtype).at[tgt].set(rflat, mode="drop")[:, None]
            )
            local_runif = jnp.ones((hill_capacity,), dtype).at[tgt].set(runif, mode="drop")
            count = jnp.sum(accept.astype(jnp.int32))
            local_active = jnp.arange(hill_capacity) < count
            truncated = jax.lax.psum(
                (jnp.sum(accept.astype(jnp.int32)) > hill_capacity).astype(jnp.int32),
                axis,
            ) > 0

            # broadcast-mode hill exchange: every device replays the global
            # round identically on its grid replica
            hills_g = jax.lax.all_gather(local_hills, axis, tiled=True)
            active_g = jax.lax.all_gather(local_active, axis, tiled=True)
            runif_g = jax.lax.all_gather(local_runif, axis, tiled=True)

            # est_hill_count is the PREVIOUS round's pair count (the
            # reference's last_calls, fix_edm_pair.cpp:105,243-246); ncalls
            # only becomes the estimate for the next round
            new_bs, rec = B.add_hills_round(
                params, bs, hills_g, runif_g, last_calls.astype(dtype), active=active_g
            )
            new_cheb = (
                fit_gauss_grid(new_bs.bias, state.cheb.deg, state.cheb.npanels)
                if state.cheb is not None
                else state.cheb
            )
            # every device replays the identical gathered round, so ONE log
            # stream represents every replica (the reference's per-rank
            # files differ only by which rank originated each hill)
            log = (
                B.HillRoundLog(jnp.ones((), bool), hills_g, rec)
                if collect_records
                else None
            )
            return new_bs, ncalls, truncated, new_cheb, log

        def without_hills(args):
            bs, last_calls = args
            n_log = hill_capacity * mesh.devices.size
            log = (
                B.round_log_zeros(params, bs, n_log)
                if collect_records
                else None
            )
            return bs, last_calls, jnp.zeros((), bool), state.cheb, log

        if static_do_hills is None:
            bias_state, last_calls, truncated, cheb, log = jax.lax.cond(
                do_hills, with_hills, without_hills,
                (bias_state, state.last_calls),
            )
        elif static_do_hills:
            bias_state, last_calls, truncated, cheb, log = with_hills(
                (bias_state, state.last_calls)
            )
        else:
            bias_state, last_calls, truncated, cheb, log = without_hills(
                (bias_state, state.last_calls)
            )

        new_state = PairEDMState(
            x=x, v=v, f=f, key=key, bias=bias_state,
            step=state.step + 1, last_calls=last_calls,
            energy=e_bias,
            hills_truncated=state.hills_truncated | truncated,
            cheb=cheb,
        )
        if collect_records:
            return new_state, e_bias, log
        return new_state, e_bias

    def _state_specs(state):
        bias_specs = jax.tree.map(lambda _: P(), state.bias)
        cheb_specs = None if state.cheb is None else jax.tree.map(lambda _: P(), state.cheb)
        return PairEDMState(
            x=P(DATA_AXIS), v=P(DATA_AXIS), f=P(DATA_AXIS), key=P(),
            bias=bias_specs, step=P(), last_calls=P(), energy=P(),
            hills_truncated=P(), cheb=cheb_specs,
        )

    def one_step(state):
        if collect_records:
            n_log = hill_capacity * mesh.devices.size
            log_shape = jax.eval_shape(
                lambda bs: B.round_log_zeros(params, bs, n_log), state.bias
            )
            out_specs = (
                _state_specs(state), P(), jax.tree.map(lambda _: P(), log_shape)
            )
        else:
            out_specs = (_state_specs(state), P())
        fn = jax.shard_map(
            lambda s: step_local(s, None),
            mesh=mesh,
            in_specs=(_state_specs(state),),
            out_specs=out_specs,
            check_vma=False,
        )
        return fn(state)

    return jax.jit(one_step)
