"""The EDM bias engine — JAX equivalent of the reference's ``EDMBias``
(lib/edm_bias.{h,cpp}).

The reference is a mutable singleton driven one hill at a time; here the
engine is a pure state-transition function over an explicit ``BiasState``
pytree, jit-compiled end to end:

  update_forces:   batched CV lookup -> (energy, dU/dx)  (edm_bias.cpp:276-311)
  add_hills_round: one pre/add/post hill cycle           (edm_bias.cpp:413-583)
    1. global-tempering prefactor shrink                 (:422-426)
    2. drain the deferred-hill buffer under the cap      (:432, :313-380)
    3. skip-whole-round rule if leftovers remain         (:436-439)
    4. stochastic accept + targeting + well-tempering + clamp (:543-558)
    5. sequential bias_per_step capping via scalar scan  (ops/prefix_cap)
    6. one vectorized deposit commit + overflow append
    7. CV histogram bookkeeping and cum_bias update      (:586-612, :922-931)

MPI-isms map to mesh collectives: update_height's Allreduce is a ``psum``
over ``axis_name`` when running under shard_map; the hill send-buffer /
neighbor-exchange protocol (edm_bias.cpp:614-920) is unnecessary — hills
deposit locally into sharded/replicated device grids (see parallel/).

Deliberate fixes vs the reference quirk ledger (SURVEY.md §5):
  Q3: the overflow buffer uses proper FIFO append (the reference
      pre-increments its right cursor, leaving slot 0 unused and replaying a
      spurious zero-height hill on drain); capacity pressure compacts the
      buffer instead of reverse-order left-insertion.
  (MPI) out-of-bounds ranks contribute 0 to cum_bias, not -1 per round.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .gauss import GaussGrid
from .grid import Grid, GridSpec
from .ops.deposit import (
    dense_tables_1d,
    dense_tables_mcgdp_2d,
    dense_tables_sep,
    deposit_from_mcgdp_2d,
    deposit_from_tables,
    deposit_from_tables_sep,
    deposit_precomputed,
    hill_windows,
)
from .ops.prefix_cap import cap_scan, drain_scan
from .utils.config import EDMConfig
from .utils.errors import edm_error

BIAS_CLAMP = 1.0  # edm_bias.h:14
BIAS_BUFFER_SIZE = 2048  # edm_bias.h:15

# hill-event type codes (edm_bias.h:20-25)
NEIGH_HILL = "n"
BUFF_HILL = "b"
BUFF_UNDO_HILL = "v"
ADD_HILL = "h"
ADD_UNDO_HILL = "u"
BUFF_ZERO_HILL = "z"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BiasState:
    bias: GaussGrid
    cv_hist: Grid
    cum_bias: jax.Array  # scalar
    buf_pos: jax.Array  # (CAP, D) deferred hill centers
    buf_h: jax.Array  # (CAP,) deferred hill heights
    buf_left: jax.Array  # int32 scalar
    buf_right: jax.Array  # int32 scalar
    overflow_error: jax.Array  # bool scalar — host must check and raise
    steps: jax.Array  # int32 scalar (hill-round counter)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BiasParams:
    """Per-simulation parameters; target/initial grids ride along as leaves."""

    target: Optional[Grid]
    expected_target: jax.Array  # scalar (0 when not targeting)
    cfg: EDMConfig = dataclasses.field(metadata=dict(static=True))
    boltzmann_factor: float = dataclasses.field(metadata=dict(static=True))
    temperature: float = dataclasses.field(metadata=dict(static=True))
    total_volume: float = dataclasses.field(metadata=dict(static=True))
    b_outofbounds: bool = dataclasses.field(metadata=dict(static=True), default=False)
    # Force the reference-exact windowed deposit in engine rounds even where
    # a separable fast path exists (multi-dim grids: the matmul paths carry the
    # square-support corner class, ~e^-8 of the hill integral — README
    # "Parity with the reference").  For bit-level reference pins.
    exact_deposit: bool = dataclasses.field(metadata=dict(static=True), default=False)


def subdivide(
    cfg: EDMConfig,
    temperature: float,
    boltzmann_constant: float,
    sublo,
    subhi,
    boxlo,
    boxhi,
    b_periodic,
    skin,
    target: Optional[Grid] = None,
    initial_bias: Optional[Grid] = None,
    dtype=jnp.float32,
    buffer_size: int = BIAS_BUFFER_SIZE,
    n_replicas: int = 1,
    exact_deposit: bool = False,
) -> Tuple[BiasParams, BiasState]:
    """Build the local bias grid for this domain (edm_bias.cpp:98-222).

    ``n_replicas`` stands in for mpi_size: total_volume is the sum over
    replica subdomain volumes and (for spatially-identical replicas, the
    edm_pair topology) hill_density/hill_prefactor are divided by it at
    round time via cfg — see parallel/ for the sharded path.
    """
    D = cfg.dim
    if temperature < 0:
        edm_error("Must call setup before subdivide", "bias.py:subdivide")

    b_periodic_boundary = []
    for i in range(D):
        match = abs(boxlo[i] - cfg.box_low[i]) < 1e-6 and abs(boxhi[i] - cfg.box_high[i]) < 1e-6
        b_periodic_boundary.append(bool(b_periodic[i]) if match else False)

    gmin, gmax, grid_period = [], [], []
    bounds_flag = True
    for i in range(D):
        lo, hi = float(sublo[i]), float(subhi[i])
        spans = abs(lo - cfg.box_low[i]) < 1e-6 and abs(hi - cfg.box_high[i]) < 1e-6
        if spans:
            grid_period.append(bool(b_periodic[i]))
            bounds_flag = False
        else:
            grid_period.append(False)
            lo -= skin[i]
            hi += skin[i]
        gmin.append(lo)
        gmax.append(hi)
        bounds_flag &= (lo >= cfg.box_high[i]) or (hi <= cfg.box_low[i])

    bias = GaussGrid.create(
        gmin,
        gmax,
        cfg.bias_dx,
        grid_period,
        cfg.bias_sigma,
        interpolate=True,
        dtype=dtype,
    )
    bias = bias.set_boundary(cfg.box_low, cfg.box_high, b_periodic_boundary)

    cv_hist = Grid.zeros(
        GridSpec.create(gmin, gmax, cfg.bias_sigma, grid_period), dtype=dtype
    )

    if initial_bias is not None:
        bias = dataclasses.replace(bias, grid=bias.grid.add_grid(initial_bias, 1.0, 0.0))

    total_volume = bias.spec.volume * n_replicas

    expected_target = (
        target.expected_bias() if target is not None else jnp.zeros((), dtype)
    )

    params = BiasParams(
        target=target,
        expected_target=jnp.asarray(expected_target, dtype),
        cfg=cfg,
        boltzmann_factor=float(boltzmann_constant * temperature),
        temperature=float(temperature),
        total_volume=float(total_volume),
        b_outofbounds=bool(bounds_flag),
        exact_deposit=bool(exact_deposit),
    )
    state = BiasState(
        bias=bias,
        cv_hist=cv_hist,
        cum_bias=jnp.zeros((), dtype),
        buf_pos=jnp.zeros((buffer_size, D), dtype),
        buf_h=jnp.zeros((buffer_size,), dtype),
        buf_left=jnp.zeros((), jnp.int32),
        buf_right=jnp.zeros((), jnp.int32),
        overflow_error=jnp.zeros((), bool),
        steps=jnp.zeros((), jnp.int32),
    )
    return params, state


# --------------------------------------------------------------------- forces


def update_forces(params: BiasParams, state: BiasState, positions, mask=None,
                  packed=None, boundary_offset=None):
    """Batched bias energy/derivative lookup (edm_bias.cpp:276-311).

    positions: (N, >=D) — only the first D components form the CV, as in the
    LAMMPS fix.  Returns (total_energy, der (N, D)); the host applies
    ``forces[:, :D] -= der``.  ``boundary_offset`` (D,): local->global
    shift for a sharded local-coordinate grid with a global static
    boundary (parallel/spatial.py's non-periodic sharded dim).
    """
    D = params.cfg.dim
    x = jnp.asarray(positions)[..., :D]
    if params.b_outofbounds:
        return jnp.zeros((), state.bias.dtype), jnp.zeros_like(x, dtype=state.bias.dtype)
    v, der = state.bias.get_value_deriv(
        x, packed=packed, boundary_offset=boundary_offset
    )
    if mask is not None:
        v = jnp.where(mask, v, 0)
        der = jnp.where(mask[..., None], der, 0)
    return jnp.sum(v), der


# ---------------------------------------------------------------- hill rounds


class RoundRecords(NamedTuple):
    """Everything the hills log / histogram / tests need about one round."""

    # drain phase (aligned with the pre-round overflow buffer slots)
    drain_pos: jax.Array  # (CAP, D)
    drain_h: jax.Array  # (CAP,) heights attempted
    drain_dep_h: jax.Array  # (CAP,) effective deposited heights
    drain_s: jax.Array  # (CAP,) integral per unit height
    drain_processed: jax.Array  # (CAP,) bool
    drain_straddled: jax.Array  # (CAP,) bool
    # new-hill phase (aligned with the positions argument)
    hill_h: jax.Array  # (H,) post-tempering heights
    hill_dep_h: jax.Array  # (H,) effective deposited heights
    hill_defer_h: jax.Array  # (H,) deferred remainder
    hill_s: jax.Array  # (H,)
    hill_called: jax.Array  # (H,) bool: do_add_hill invoked
    hill_deposited: jax.Array  # (H,) bool
    hill_straddled: jax.Array  # (H,) bool
    skipped: jax.Array  # scalar bool: whole round skipped
    round_bias: jax.Array  # scalar: temp_hill_cum at round end (this replica)
    prefactor: jax.Array  # scalar: post-global-tempering prefactor


class HillRoundLog(NamedTuple):
    """Fixed-shape per-step log payload a compiled host can emit as scan ys.

    The reference logs every hill event unconditionally (output_hill,
    edm_bias.cpp:586-599) from inside its sequential loop; compiled hosts
    instead stack one of these per step and the driver replays the event
    stream host-side (utils/hills_log.py).  ``happened`` is False on
    non-hill-stride steps, where the payload is all-zeros."""

    happened: jax.Array  # scalar bool
    positions: jax.Array  # (H, D) new-hill centers fed to the round
    rec: RoundRecords


def round_log_zeros(params: BiasParams, state: BiasState, n_hills: int) -> HillRoundLog:
    """Trace-time zero template shape-matching ``add_hills_round``'s records
    for ``n_hills`` candidate hills (for the no-hill branch of a host's
    ``lax.cond``)."""
    D = params.cfg.dim
    dtype = state.bias.dtype
    _, rec_s = jax.eval_shape(
        add_hills_round,
        params,
        state,
        jax.ShapeDtypeStruct((n_hills, D), dtype),
        jax.ShapeDtypeStruct((n_hills,), dtype),
        jax.ShapeDtypeStruct((), dtype),
        jnp.zeros((n_hills,), bool),
    )
    rec = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), rec_s)
    return HillRoundLog(
        happened=jnp.zeros((), bool),
        positions=jnp.zeros((n_hills, D), dtype),
        rec=rec,
    )


def round_prefactor(params: BiasParams, state: BiasState) -> jax.Array:
    """Post-global-tempering hill prefactor (edm_bias.cpp:422-426)."""
    cfg = params.cfg
    dtype = state.bias.dtype
    kT = params.boltzmann_factor
    pref = jnp.asarray(cfg.hill_prefactor, dtype)
    if cfg.global_tempering > 0:
        avg = state.cum_bias / params.total_volume
        shrink = jnp.exp(
            -(avg - cfg.global_tempering)
            / (cfg.global_tempering * (cfg.bias_factor - 1) * kT)
        )
        pref = jnp.where(avg >= cfg.global_tempering, pref * shrink, pref)
    return pref


def _hill_heights(params, bias_grid, positions, est_hill_count, pref,
                  target_positions=None, boundary_offset=None):
    """Tempered, normalized, clamped per-hill heights (edm_bias.cpp:543-558)
    evaluated against ``bias_grid``.

    ``target_positions``: coordinates for the target-grid factor when they
    differ from ``positions`` — the spatially-sharded host biases against a
    LOCAL-coordinate grid but targets a GLOBAL-coordinate grid (every rank
    holds the full target, edm_bias.cpp:1054-1064)."""
    cfg = params.cfg
    dtype = bias_grid.dtype
    kT = params.boltzmann_factor
    H = positions.shape[0]
    h = jnp.full((H,), 1.0, dtype) * pref
    if params.target is not None:
        tp = positions if target_positions is None else target_positions
        h = h * jnp.exp(params.target.get_value(tp) - params.expected_target)
    if cfg.b_tempering and cfg.global_tempering < 0:
        # NOTE strict `< 0` as in edm_bias.cpp:547: the reference enables
        # well-tempering only when global_tempering is explicitly negative;
        # with the key unset (0) neither tempering branch fires even though
        # tempering=1 (README.md:92-95 documents different behavior — the
        # code wins for parity).
        h = h * jnp.exp(
            -bias_grid.get_value(positions, boundary_offset=boundary_offset)
            / ((cfg.bias_factor - 1) * kT)
        )
    if cfg.hill_density < 0:
        h = h / jnp.asarray(est_hill_count, dtype)
    else:
        h = h / cfg.hill_density
    return jnp.minimum(h, BIAS_CLAMP * cfg.bias_per_step)


def hill_heights(params: BiasParams, state: BiasState, positions, est_hill_count,
                 target_positions=None, boundary_offset=None):
    """Public helper for hill-exchanging hosts (parallel/spatial.py): the
    heights this replica would attach to its outgoing hills, evaluated
    against the round-START grid (the batched-round approximation — the
    in-round drain's effect on well-tempered heights is not visible, same
    class of divergence as the batch-wide height evaluation documented in
    add_hills_round).  ``target_positions``: see _hill_heights."""
    positions = jnp.asarray(positions, state.bias.dtype)[..., : params.cfg.dim]
    pref = round_prefactor(params, state)
    return _hill_heights(params, state.bias, positions, est_hill_count, pref,
                         target_positions=target_positions,
                         boundary_offset=boundary_offset)


def add_hills_round(
    params: BiasParams,
    state: BiasState,
    positions,
    runiform,
    est_hill_count,
    active=None,
    axis_name: Optional[str] = None,
    override_heights=None,
    boundary_offset=None,
    n_passes: int = 1,
) -> Tuple[BiasState, RoundRecords]:
    """One full pre_add_hill / add_hill* / post_add_hill cycle.

    ``override_heights`` (H,): replay mode — deposit these exact heights
    (already tempered/normalized/clamped by the originating replica) for the
    ``active`` hills, skipping acceptance sampling; the MPI hill-exchange
    replay semantics (do_add_hill communicate=0, edm_bias.cpp:444,630-706).

    ``boundary_offset`` (D,): local->global coordinate shift for sharded
    local-coordinate grids with a GLOBAL static boundary (McGovern-De Pablo
    terms, boundary masks and boundary-row duplication all evaluate at
    ``x + offset``; see parallel/spatial.py).

    ``n_passes``: the new-hill phase runs as ``n_passes`` sequential
    sub-batches of H/n_passes hills (H must divide evenly).  This is the
    static-shape analog of the reference's never-drop guarantee: when its
    mid-round send buffer fills it flushes and CONTINUES depositing
    (edm_bias.cpp:459-462) — hosts that compact accepted hills to a fixed
    capacity can size the batch at K*capacity and let rare spikes spill
    into later passes instead of dropping the tail.  Passes past the first
    are lax.cond-gated on having any called hill, so rounds that fit in
    one pass pay only a pass-through copy of the carried grid/buffer.
    Each pass evaluates well-tempered heights against the grid INCLUDING
    earlier passes' deposits — closer to the reference's hill-by-hill live
    grid (edm_bias.cpp:547-550) than the single-batch round-start
    approximation; with n_passes=1 the behavior (and compiled graph) is
    unchanged.  The cap/defer semantics chain exactly across passes
    (cap_scan continuation via ``cum0``; ops/prefix_cap.py).
    """
    cfg = params.cfg
    D = cfg.dim
    dtype = state.bias.dtype
    positions = jnp.asarray(positions, dtype)[..., :D]
    runiform = jnp.asarray(runiform, dtype)
    H = positions.shape[0]
    CAP = state.buf_h.shape[0]
    vol = float(np.prod(state.bias.spec.grid.dx))
    kT = params.boltzmann_factor
    cap_bias = cfg.bias_per_step

    if active is None:
        active = jnp.ones((H,), bool)

    if params.b_outofbounds:
        # passive replica: contributes 0 to the global reduction (fixes the
        # reference's -1-per-round cum_bias leak from out-of-bounds ranks)
        round_bias = jnp.zeros((), dtype)
        if axis_name is not None:
            round_bias = jax.lax.psum(round_bias, axis_name)
        new_state = dataclasses.replace(
            state, cum_bias=state.cum_bias + round_bias, steps=state.steps + 1
        )
        z = jnp.zeros
        DRAIN0 = min(1024, CAP)
        rec = RoundRecords(
            drain_pos=state.buf_pos[:DRAIN0], drain_h=state.buf_h[:DRAIN0],
            drain_dep_h=z((DRAIN0,), dtype), drain_s=z((DRAIN0,), dtype),
            drain_processed=z((DRAIN0,), bool), drain_straddled=z((DRAIN0,), bool),
            hill_h=z((H,), dtype), hill_dep_h=z((H,), dtype),
            hill_defer_h=z((H,), dtype), hill_s=z((H,), dtype),
            hill_called=z((H,), bool), hill_deposited=z((H,), bool),
            hill_straddled=z((H,), bool), skipped=jnp.ones((), bool),
            round_bias=round_bias, prefactor=jnp.asarray(cfg.hill_prefactor, dtype),
        )
        return new_state, rec

    # ---- 1. global tempering (edm_bias.cpp:422-426)
    pref = round_prefactor(params, state)

    # deposit strategy: for small 1-D CV grids the dense (G, H) unit tables
    # replace window evaluation + scatter with matvecs (see dense_tables_1d).
    # A matvec sums in a fixed order, so replicated pair-CV grids stay
    # bitwise identical across devices and runs; a GPU scatter-add does not
    # promise that (it was slightly faster at the pair-CV shape, PERF.md)
    gspec1 = state.bias.spec
    use_dense = (
        D == 1
        and gspec1.grid.nbins[0] <= 1024
        # dense is nearest-image only: a periodic support window that wraps
        # the whole domain (W >= G) needs the windowed multi-image path
        and (not gspec1.grid.periodic[0] or gspec1.window_shape[0] < gspec1.grid.nbins[0])
    )
    # 2-D/3-D fully-periodic grids: separable outer-product deposition on
    # matmuls (ops/deposit.dense_tables_sep; square-support divergence in
    # the README ledger) — the windowed scatter path is ~100x slower at
    # 1e6-point grids under heavy hill load
    use_dense2 = (
        D in (2, 3)
        and not params.exact_deposit
        and all(gspec1.grid.periodic)
        and all(gspec1.boundary_periodic)
        and all(w < n for w, n in zip(gspec1.window_shape, gspec1.grid.nbins))
    )
    # 2-D/3-D grids with McGovern-De Pablo corrected dims: separable matmul
    # terms for the decaying Gaussian parts + exact-spherical-mask strip
    # fields for the boundary-correction parts (ops/deposit.
    # dense_tables_mcgdp, chunked over hills)
    use_dense2m = (
        D in (2, 3)
        and not params.exact_deposit
        and any(not p for p in gspec1.boundary_periodic)
        and boundary_offset is None
        and all(w < n for w, n in zip(gspec1.window_shape, gspec1.grid.nbins))
    )

    # deposit-table dispatch shared by the drain and every hill pass:
    # (tables, s) built from a grid's GEOMETRY (unit tables, independent of
    # the stored values), then a linear commit of effective heights
    def _tables(bias_g, pos):
        if use_dense:
            bMval, bMder, s = dense_tables_1d(
                bias_g, pos, boundary_offset=boundary_offset
            )
            return (bMval, bMder), s
        if use_dense2:
            tabs, s = dense_tables_sep(bias_g, pos)
            return (tabs,), s
        if use_dense2m:
            tabs_m = dense_tables_mcgdp_2d(bias_g, pos)
            return (tabs_m,), tabs_m.s
        hw = hill_windows(bias_g, pos, boundary_offset=boundary_offset)
        return (hw,), jnp.sum(hw.value_w, axis=-1) * vol

    def _deposit(bias_g, tabs, dep_h):
        if use_dense:
            return deposit_from_tables(
                bias_g, tabs[0], tabs[1], dep_h,
                boundary_offset=boundary_offset,
            )
        if use_dense2:
            return deposit_from_tables_sep(bias_g, tabs[0], dep_h)
        if use_dense2m:
            return deposit_from_mcgdp_2d(bias_g, tabs[0], dep_h)
        b2, _ = deposit_precomputed(
            bias_g, tabs[0], dep_h, boundary_offset=boundary_offset
        )
        return b2

    # ---- 2. drain the deferred buffer (edm_bias.cpp:432, 313-380)
    # Only a bounded window of the buffer (256 slots from buf_left) is
    # evaluated per round: bias_per_step rarely lets more than a handful of
    # hills drain anyway, and evaluating deposition geometry for the whole
    # (possibly 8k-slot) buffer costs more than the entire MD step.  Hills
    # beyond the window simply wait (FIFO preserved; rounds keep skipping
    # while leftovers exist, exactly as with an unbounded drain).
    DRAIN = min(256, CAP)
    win_pos = jax.lax.dynamic_slice(
        state.buf_pos, (state.buf_left, jnp.int32(0)), (DRAIN, D)
    )
    win_h = jax.lax.dynamic_slice(state.buf_h, (state.buf_left,), (DRAIN,))
    n_buf = state.buf_right - state.buf_left
    wslots = jnp.arange(DRAIN, dtype=jnp.int32)
    win_active = wslots < n_buf
    btabs, s_buf = _tables(state.bias, win_pos)
    dr = drain_scan(win_h, s_buf, win_active, cap_bias)
    bias1 = _deposit(state.bias, btabs, dr.dep_heights)
    # write the window's post-drain heights back into the full buffer
    full_buf_h = jax.lax.dynamic_update_slice(
        state.buf_h, dr.new_heights, (state.buf_left,)
    )

    remaining_w = win_active & ~dr.consumed
    any_rem_w = jnp.any(remaining_w)
    # leftovers beyond the window also count as remaining
    beyond = n_buf > DRAIN
    any_rem = any_rem_w | beyond
    first_rem = jnp.where(
        any_rem_w, jnp.argmax(remaining_w).astype(jnp.int32), jnp.int32(DRAIN)
    )
    left1 = jnp.where(any_rem, state.buf_left + jnp.minimum(first_rem, n_buf), 0)
    right1 = jnp.where(any_rem, state.buf_right, 0)
    skip = any_rem  # b_skip_hill_add_ (edm_bias.cpp:436-439)

    # ---- 3. acceptance (edm_bias.cpp:528-543), batch-wide
    if override_heights is not None:
        # replay mode (do_add_hill with communicate=0, edm_bias.cpp:444):
        # acceptance and tempering/clamping happened on the originating
        # replica; the exchanged (position, height) pairs are used as-is
        accept = active
        override_h = jnp.asarray(override_heights, dtype)
    else:
        override_h = None
        if cfg.hill_density < 0:
            accept = active
        else:
            accept = active & (runiform < cfg.hill_density / est_hill_count)
    called_all = accept & ~skip

    # drained-buffer compaction: surviving slots left1..right1 shift to 0
    # (step 5's FIFO base; fixes reference Q3)
    slots = jnp.arange(CAP, dtype=jnp.int32)
    src = slots + left1
    valid_src = src < right1
    src_c = jnp.clip(src, 0, CAP - 1)
    buf_pos2 = jnp.where(valid_src[:, None], state.buf_pos[src_c], 0)
    buf_h2 = jnp.where(valid_src, full_buf_h[src_c], 0)
    size2 = right1 - left1

    # histogram (output_hill bookkeeping, edm_bias.cpp:601-610): drain part
    hist0 = state.cv_hist
    drain_delta = dr.processed.astype(dtype) - dr.straddled.astype(dtype)
    hist0, _ = hist0.add_value(win_pos, drain_delta)

    # ---- 4/5. hill passes: heights (edm_bias.cpp:543-563, live grid per
    # pass) + sequential cap + deposit commit + FIFO overflow append
    if H % n_passes:
        raise ValueError("n_passes must divide the hill batch size")
    Hc = H // n_passes

    def one_pass(p, carry):
        bias_c, hist_c, bufp_c, bufh_c, size_c, cum_c = carry
        sl = slice(p * Hc, (p + 1) * Hc)
        pos_p = positions[sl]
        called_p = called_all[sl]
        if override_h is not None:
            h_p = override_h[sl]
        else:
            # Well-tempering evaluates against the grid including earlier
            # passes' deposits (the reference reads the live grid
            # hill-by-hill; within one pass this is the same grid).
            h_p = _hill_heights(params, bias_c, pos_p, est_hill_count, pref,
                                boundary_offset=boundary_offset)
        tabs_p, s_p = _tables(bias_c, pos_p)
        cr = cap_scan(h_p, s_p, called_p, cap_bias, cum_c)
        bias_n = _deposit(bias_c, tabs_p, cr.dep_heights)
        to_defer = called_p & (cr.defer_heights > 0)
        rank = jnp.cumsum(to_defer.astype(jnp.int32)) - 1
        tgt = jnp.where(to_defer, size_c + rank, CAP)  # CAP -> dropped
        bufp_n = bufp_c.at[tgt].set(pos_p, mode="drop")
        bufh_n = bufh_c.at[tgt].set(cr.defer_heights, mode="drop")
        size_n = size_c + jnp.sum(to_defer.astype(jnp.int32))
        hill_delta = called_p.astype(dtype) - cr.straddled.astype(dtype)
        hist_n, _ = hist_c.add_value(pos_p, hill_delta)
        rec_p = (h_p, cr.dep_heights, cr.defer_heights, s_p, called_p,
                 cr.deposited, cr.straddled)
        return (bias_n, hist_n, bufp_n, bufh_n, size_n, cr.cum), rec_p

    carry = (bias1, hist0, buf_pos2, buf_h2, size2, dr.bias_added)
    recs = []
    for p in range(n_passes):
        if p == 0:
            carry, rec_p = one_pass(0, carry)
        else:
            # gated: rounds that fit earlier passes pay only the cond's
            # pass-through copy of the carried grid/buffer/histogram
            def _skip_pass(c):
                z = jnp.zeros
                rec0 = (z((Hc,), dtype), z((Hc,), dtype), z((Hc,), dtype),
                        z((Hc,), dtype), z((Hc,), bool), z((Hc,), bool),
                        z((Hc,), bool))
                return c, rec0

            carry, rec_p = jax.lax.cond(
                jnp.any(called_all[p * Hc : (p + 1) * Hc]),
                lambda c, p=p: one_pass(p, c),
                _skip_pass,
                carry,
            )
        recs.append(rec_p)
    bias2, hist, buf_pos3, buf_h3, size_f, cum_f = carry
    overflow = size_f > CAP

    def _cat(i):
        if n_passes == 1:
            return recs[0][i]
        return jnp.concatenate([r[i] for r in recs])

    # ---- 7. cum_bias (update_height, edm_bias.cpp:922-931)
    round_bias = cum_f
    if axis_name is not None:
        round_bias = jax.lax.psum(round_bias, axis_name)

    new_state = BiasState(
        bias=bias2,
        cv_hist=hist,
        cum_bias=state.cum_bias + round_bias,
        buf_pos=buf_pos3,
        buf_h=buf_h3,
        buf_left=jnp.zeros((), jnp.int32),
        buf_right=jnp.minimum(size_f, CAP).astype(jnp.int32),
        overflow_error=state.overflow_error | overflow,
        steps=state.steps + 1,
    )
    rec = RoundRecords(
        drain_pos=win_pos,
        drain_h=win_h,
        drain_dep_h=dr.dep_heights,
        drain_s=s_buf,
        drain_processed=dr.processed,
        drain_straddled=dr.straddled,
        hill_h=_cat(0),
        hill_dep_h=_cat(1),
        hill_defer_h=_cat(2),
        hill_s=_cat(3),
        hill_called=_cat(4),
        hill_deposited=_cat(5),
        hill_straddled=_cat(6),
        skipped=skip,
        round_bias=cum_f,
        prefactor=pref,
    )
    return new_state, rec


def check_state(state: BiasState) -> None:
    """Host-side invariant check (the reference aborts inside add_hill;
    compiled programs surface the flag instead — edm_bias.cpp:501-507)."""
    if bool(state.overflow_error):
        edm_error(
            "The bias overflow buffer is full. Too many hills. Either increase "
            "buffer_size, lower hill_density, or lower bias",
            "bias.py:add_hills_round",
        )
