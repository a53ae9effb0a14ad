"""Spatially-sharded coordinate-CV EDM — the JAX analog of the
reference's MPI domain decomposition (edm_bias.cpp:98-222, hill exchange
:614-920) for bias grids too large (or hill loads too heavy) for a
replicated grid.

Design (SPMD over a 1-D mesh axis, one grid shard per device):

* The CV range is split into EQUAL bricks over a per-dim device grid
  ``parts = (p0, ..., pD-1)`` (an int n_dev means ``(n_dev, 1, ...)`` —
  the 1-D slab decomposition); each device owns
  ``prod_d [lo_d + i_d*w_d, lo_d + (i_d+1)*w_d]`` extended by per-dim
  ``skin`` on the sharded dims — the reference's per-rank sub-box +
  neighbor skin (edm_bias.cpp:142-155), whose shape under LAMMPS is
  exactly such a 3-D brick (domain->sublo/subhi, fix_edm.cpp:100-104).
  Equal bricks keep every device's grid the SAME static shape, which is
  what makes the decomposition expressible as one SPMD program.

* Local grids live in LOCAL coordinates (brick start = 0 along every
  sharded dim): the per-device global offset is ``i_d * w_d`` per dim,
  applied to positions in-graph (``i_d`` decoded row-major from
  ``axis_index``).  The system boundary seen by each device is the global
  box length centered on its brick, so the GaussGrid ``remap``
  (nearest-image across the system boundary, gaussian_grid.h:504-541)
  automatically brings any gathered hill to the image nearest this
  device's grid — periodic wraparound neighbor exchange
  (edm_bias.cpp:764-781) with no explicit topology.

* Hill exchange is an ``all_gather`` of accepted (position, height) pairs
  — per-device rank-compacted to ``hill_capacity`` rows, the bounded
  exchange buffer of the reference (BIAS_BUFFER_SIZE=2048 accepted hills
  per round, edm_bias.h:151-154; rejected candidates are never exchanged)
  — replayed on every device with ``override_heights`` (the reference's
  do_add_hill(communicate=0) replay); deposits outside a device's grid are
  masked off by the window machinery — exactly the overlap criterion of
  infer_neighbors (edm_bias.cpp:740-762), point by point instead of rank by
  rank.  The reference never emits 'n' hill-log events (NEIGH_HILL is
  defined but unused; replayed hills log 'h' on the replaying rank), so
  per-device logs here match per-rank logs there.

* ``cum_bias`` is a ``psum`` of per-device round bias (update_height,
  edm_bias.cpp:922-931): hills in skin overlaps are counted once per
  overlapping device, compensated — as in the reference — by
  ``total_volume`` summing per-rank boundary volumes (edm_bias.cpp:206-220,
  gaussian_grid.h:437-444).

* Atom ownership follows slabs.  Between calls to ``rebin_spatial_atoms``
  (host-side, at write-segment boundaries — the LAMMPS reneighboring
  analog) atoms may drift up to ``skin`` outside their slab and still see
  correct forces from the skin region of the local grid.

* Target / initial-bias grids (the E in EDM, edm_bias.cpp:1054-1072): the
  target stays a GLOBAL-coordinate grid replicated on every device (as
  every MPI rank reads the full file) and is evaluated at global hill
  positions; the initial bias is sampled per device at its local grid's
  global coordinates and accumulated at init (edm_bias.cpp:166-167).

* Non-periodic global boundaries along the sharded dim
  (``spatial_subdivide(..., periodic=[False, ...])``): the static boundary
  is the GLOBAL box (shifted so box_low0 -> 0) and a per-device
  ``boundary_offset`` (= axis_index * slab_w) converts local coordinates to
  global in every boundary-relative computation — McGovern-De Pablo
  correction terms, boundary masks, zero-force boundary-row duplication
  (computed in-graph, predicated off on mid-slab devices).  The BC lookup
  tables depend only on the global boundary + sigma, so ONE table serves
  every device (edm_bias.cpp:134-155, lib/gaussian_grid.h:378-435).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import bias as B
from ..models.langevin import LangevinParams, baoab_step
from ..utils.config import EDMConfig
from .mesh import DATA_AXIS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpatialCoordState:
    """All leaves carry a leading device axis (sharded P(dp))."""

    x: jax.Array  # (n_dev, cap, 3) GLOBAL coordinates
    v: jax.Array
    f: jax.Array
    valid: jax.Array  # (n_dev, cap) bool
    key: jax.Array  # (n_dev, 2)
    bias: B.BiasState  # per-device local-coords bias (stacked)
    step: jax.Array  # (n_dev,)
    energy: jax.Array  # (n_dev,)
    # True if a compacted hill exchange ever overflowed hill_capacity
    # (the round then dropped the tail — raise the capacity); None on
    # states built before the flag existed
    hills_truncated: Optional[jax.Array] = None  # (n_dev,) bool


class SpatialSetup(NamedTuple):
    params: B.BiasParams  # per-device params (cfg in LOCAL coordinates;
    # params.target stays a GLOBAL-coordinate grid — every device holds the
    # full target, exactly as every MPI rank reads the full target file,
    # edm_bias.cpp:1054-1064)
    n_dev: int
    slab_w: float
    skin: float
    box_low0: float
    initial_stack: Optional[tuple] = None  # (values (n_dev, ...), derivs
    # (n_dev, ..., D)): per-device local-coordinate samples of the global
    # initial-bias grid, accumulated into the stacked state at init
    # (edm_bias.cpp:166-167 per rank)
    nonperiodic0: bool = False  # global boundary along the sharded dim is
    # non-periodic: the static boundary is the GLOBAL box (shifted so
    # box_low0 -> 0) and every boundary-relative computation shifts by the
    # per-device boundary_offset (McGovern-De Pablo terms included)
    # --- N-D brick decomposition (None => legacy slab along dim 0) ---
    parts: Optional[tuple] = None  # per-dim device counts (p0, ..., pD-1),
    # prod = n_dev; dims with p_d > 1 are sharded (the reference's LAMMPS
    # 3-D domain decomposition arrives as per-rank sublo/subhi bricks,
    # fix_edm.cpp:100-104 -> edm_bias.cpp:98-222)
    widths: Optional[tuple] = None  # per-dim brick widths L_d / p_d
    lows: Optional[tuple] = None  # global box_low per dim
    nonper: Optional[tuple] = None  # per-dim: sharded AND globally
    # non-periodic (engages boundary_offset on that dim)
    skins: Optional[tuple] = None  # per-dim skin (0 on unsharded dims)


def _brick_geometry(setup: SpatialSetup):
    """(parts, widths, lows, nonper) with legacy slab setups normalized
    (pre-brick SpatialSetup pickles / positional constructions)."""
    if setup.parts is not None:
        return setup.parts, setup.widths, setup.lows, setup.nonper
    D = setup.params.cfg.dim
    glo = setup.params.cfg.box_low
    return (
        (setup.n_dev,) + (1,) * (D - 1),
        (setup.slab_w,)
        + tuple(
            setup.params.cfg.box_high[d] - setup.params.cfg.box_low[d]
            for d in range(1, D)
        ),
        (setup.box_low0,) + tuple(glo[d] for d in range(1, D)),
        (setup.nonperiodic0,) + (False,) * (D - 1),
    )


def _dev_strides(parts):
    """Row-major flat-index strides (dim 0 slowest): device d's brick
    multi-index is i_k = (d // stride_k) % parts[k]."""
    D = len(parts)
    strides = [1] * D
    for d in range(D - 2, -1, -1):
        strides[d] = strides[d + 1] * parts[d + 1]
    return tuple(strides)


def spatial_subdivide(
    cfg: EDMConfig,
    temperature: float,
    boltzmann_constant: float,
    n_dev,
    skin,
    dtype=jnp.float32,
    buffer_size: int = B.BIAS_BUFFER_SIZE,
    target=None,
    initial_bias=None,
    periodic=None,
):
    """Equal-brick decomposition of the CV range over a device grid.

    ``n_dev``: an int shards dim 0 into that many equal slabs (the 1-D
    decomposition); a tuple ``(p0, ..., pD-1)`` decomposes the CV range
    into an N-D grid of equal bricks — the shape MPI domain decomposition
    actually takes under LAMMPS (3-D per-rank sublo/subhi bricks,
    fix_edm.cpp:100-104 -> edm_bias.cpp:98-222).  Dims with ``p_d == 1``
    stay unsharded (full range, global coordinates).  ``skin``: a float
    (applied to every sharded dim) or a per-dim sequence.

    ``periodic``: per-dim GLOBAL boundary periodicity (default all True —
    the host's b_periodic argument, fix_edm.cpp:100-104).  A non-periodic
    sharded dim engages the boundary_offset machinery: McGovern-De Pablo
    boundary-corrected zero-force hills against the global box, evaluated
    per device via local->global shifts inside one SPMD program.

    Returns (SpatialSetup, per-device BiasState template).  Mirrors
    EDMBias::subdivide for each rank with ``sublo = i_d*w_d``,
    ``subhi = (i_d+1)*w_d`` per sharded dim, in a coordinate frame where
    the brick starts at 0 — every device gets the identical static grid.

    ``target`` / ``initial_bias``: GLOBAL-coordinate grids (loaded from
    ``cfg.target_filename`` / ``cfg.initial_bias_filename`` when not given
    — the reference reads them per rank, edm_bias.cpp:1054-1072).  The
    target is kept global and evaluated at global hill positions
    (expected_target is the global integral); the initial bias is sampled
    per device at its local grid's global coordinates and accumulated into
    the stacked state by ``init_spatial_state``.
    """
    from ..utils.gridio import read_grid_file

    if target is None and cfg.target_filename:
        target = read_grid_file(
            cfg.target_filename, dim=cfg.dim, interpolate=False, dtype=dtype
        )
    if initial_bias is None and cfg.initial_bias_filename:
        initial_bias = read_grid_file(
            cfg.initial_bias_filename, dim=cfg.dim, interpolate=True, dtype=dtype
        )
    D = cfg.dim
    if isinstance(n_dev, (int, np.integer)):
        parts = (int(n_dev),) + (1,) * (D - 1)
    else:
        parts = tuple(int(p) for p in n_dev)
        if len(parts) < D:
            parts = parts + (1,) * (D - len(parts))
        if len(parts) != D or any(p < 1 for p in parts):
            raise ValueError(f"parts {parts} incompatible with dim {D}")
    n_total = int(np.prod(parts))
    if np.isscalar(skin):
        skins_in = [float(skin)] * D
    else:
        skins_in = [float(s) for s in skin]
    sharded = [p > 1 for p in parts]
    lows = tuple(float(lo) for lo in cfg.box_low)
    lens = tuple(
        float(cfg.box_high[d] - cfg.box_low[d]) for d in range(D)
    )
    widths = tuple(lens[d] / parts[d] for d in range(D))
    # reference normalization (edm_bias.cpp:173-180): per-system density.
    # The reference divides and resets to 1 only on an exact-zero quotient
    # (a double underflow guard, edm_bias.cpp:178-179) — NOT a >=1 clamp:
    # for 0 < hill_density < n_dev the per-replica density stays fractional
    # and acceptance probabilities shrink accordingly.
    if cfg.hill_density > 0:
        hd = cfg.hill_density / n_total
        cfg = dataclasses.replace(
            cfg,
            hill_density=hd if hd != 0 else 1.0,
            hill_prefactor=cfg.hill_prefactor / n_total,
        )
    if periodic is None:
        periodic = [True] * D
    periodic = [bool(p) for p in periodic]
    # local-coordinate cfg per dim:
    #  - unsharded: the global box unchanged
    #  - sharded periodic: the global length centered on the brick so
    #    remap()'s nearest-image wrap targets this device's grid
    #  - sharded non-periodic: the STATIC boundary is the global box
    #    shifted so box_low_d -> 0; per-device boundary_offset
    #    (= i_d * w_d) converts local -> shifted-global in every
    #    boundary-relative computation (edm_bias.cpp:134-155 per rank,
    #    lib/gaussian_grid.h:378-435 — the McGDP tables depend only on the
    #    global boundary + sigma, so one table serves every device)
    box_lo_loc, box_hi_loc = [], []
    sublo, subhi, skins = [], [], []
    for d in range(D):
        if not sharded[d]:
            box_lo_loc.append(cfg.box_low[d])
            box_hi_loc.append(cfg.box_high[d])
            sublo.append(cfg.box_low[d])
            subhi.append(cfg.box_high[d])
            skins.append(0.0)
        else:
            mid = widths[d] / 2.0
            if periodic[d]:
                box_lo_loc.append(mid - lens[d] / 2.0)
                box_hi_loc.append(mid + lens[d] / 2.0)
            else:
                box_lo_loc.append(0.0)
                box_hi_loc.append(lens[d])
            sublo.append(0.0)
            subhi.append(widths[d])
            skins.append(skins_in[d])
    cfg_loc = dataclasses.replace(
        cfg, box_low=tuple(box_lo_loc), box_high=tuple(box_hi_loc)
    )
    params, state = B.subdivide(
        cfg_loc,
        temperature,
        boltzmann_constant,
        sublo,
        subhi,
        cfg_loc.box_low,
        cfg_loc.box_high,
        periodic,
        skins,
        dtype=dtype,
        buffer_size=buffer_size,
        n_replicas=n_total,
    )
    for d in range(D):
        if not (sharded[d] and periodic[d]):
            continue
        # sanity: hills must have a unique nearest image w.r.t. each local
        # grid (non-periodic boundaries never wrap, so no constraint there)
        support = 4.0 * np.sqrt(2.0) * cfg.bias_sigma[d]
        # sqrt(2*GAUSS_SUPPORT)*sigma*sqrt(2)
        if widths[d] + 2 * skins[d] + 2 * support >= lens[d]:
            raise ValueError(
                f"dim {d} bricks too wide for unique nearest-image hill "
                f"delivery: width {widths[d]} + 2*skin {skins[d]} + "
                f"2*support {support} >= L {lens[d]}"
            )

    if target is not None:
        # the target grid stays in GLOBAL coordinates: heights evaluate it
        # at global hill positions (make_spatial_coord_step), and
        # expected_target is the global integral — identical on every
        # device, as in the reference (edm_bias.cpp:1054-1064)
        params = dataclasses.replace(
            params,
            target=target,
            expected_target=jnp.asarray(target.expected_bias(), dtype),
        )

    strides = _dev_strides(parts)
    initial_stack = None
    if initial_bias is not None:
        from ..grid import grid_points

        pts = grid_points(state.bias.grid.spec, dtype)  # local coordinates
        vals, ders = [], []
        for dev in range(n_total):
            ptsd = pts
            for d in range(D):
                if sharded[d]:
                    i_d = (dev // strides[d]) % parts[d]
                    ptsd = ptsd.at[..., d].add(lows[d] + i_d * widths[d])
            v, dv = initial_bias.get_value_deriv(ptsd)
            vals.append(v)
            ders.append(dv)
        initial_stack = (jnp.stack(vals), jnp.stack(ders))

    nonper = tuple(sharded[d] and not periodic[d] for d in range(D))
    setup = SpatialSetup(
        params, n_total, float(widths[0]), float(skins[0] or skins_in[0]),
        float(lows[0]),
        initial_stack=initial_stack, nonperiodic0=nonper[0],
        parts=parts, widths=widths, lows=lows, nonper=nonper,
        skins=tuple(skins),
    )
    return setup, state


def _bin_devices(setup: SpatialSetup, x: np.ndarray) -> np.ndarray:
    """Host-side brick assignment: flat device index per atom (row-major
    multi-index over the sharded dims; periodic dims wrap, non-periodic
    clip — the atom then belongs to the edge brick)."""
    parts, widths, lows, nonper = _brick_geometry(setup)
    strides = _dev_strides(parts)
    dev_of = np.zeros(x.shape[0], int)
    for d in range(len(parts)):
        if parts[d] == 1:
            continue
        L = widths[d] * parts[d]
        if nonper[d]:
            wrapped = np.clip(x[:, d], lows[d], lows[d] + L)
        else:
            wrapped = lows[d] + np.mod(x[:, d] - lows[d], L)
        i_d = np.clip((wrapped - lows[d]) // widths[d], 0, parts[d] - 1)
        dev_of += i_d.astype(int) * strides[d]
    return dev_of


def _park_empty(setup: SpatialSetup, xs: np.ndarray, dev: int, start: int):
    """Park invalid slots at the brick center along every sharded dim (so
    masked lookups stay in range); other columns keep their zeros."""
    parts, widths, lows, _ = _brick_geometry(setup)
    strides = _dev_strides(parts)
    for d in range(len(parts)):
        if parts[d] == 1:
            continue
        i_d = (dev // strides[d]) % parts[d]
        xs[dev, start:, d] = lows[d] + i_d * widths[d] + widths[d] / 2


def init_spatial_state(
    setup: SpatialSetup, state_template: B.BiasState, x0, key, capacity: int, mesh
) -> SpatialCoordState:
    """Bin atoms into bricks (host-side) and build the sharded state."""
    n_dev = setup.n_dev
    x0 = np.asarray(x0, float)
    dev_of = _bin_devices(setup, x0)
    dtype = state_template.bias.dtype
    xs = np.zeros((n_dev, capacity, x0.shape[1]))
    valid = np.zeros((n_dev, capacity), bool)
    for d in range(n_dev):
        mine = np.nonzero(dev_of == d)[0]
        if len(mine) > capacity:
            raise ValueError(f"device {d}: {len(mine)} atoms > capacity {capacity}")
        xs[d, : len(mine)] = x0[mine]
        _park_empty(setup, xs, d, len(mine))
        valid[d, : len(mine)] = True
    keys = jax.random.split(key, n_dev)
    bias_stacked = jax.tree.map(
        lambda l: jnp.broadcast_to(l[None], (n_dev,) + l.shape), state_template
    )
    if setup.initial_stack is not None:
        # per-rank accumulation of the initial bias (edm_bias.cpp:166-167):
        # each device adds the global grid sampled at ITS local coordinates
        iv, idr = setup.initial_stack
        g = bias_stacked.bias.grid
        g = dataclasses.replace(
            g, values=g.values + iv.astype(dtype), derivs=g.derivs + idr.astype(dtype)
        )
        bias_stacked = dataclasses.replace(
            bias_stacked, bias=dataclasses.replace(bias_stacked.bias, grid=g)
        )
    st = SpatialCoordState(
        x=jnp.asarray(xs, dtype),
        v=jnp.zeros((n_dev, capacity, x0.shape[1]), dtype),
        f=jnp.zeros((n_dev, capacity, x0.shape[1]), dtype),
        valid=jnp.asarray(valid),
        key=keys,
        bias=bias_stacked,
        step=jnp.zeros((n_dev,), jnp.int32),
        energy=jnp.zeros((n_dev,), dtype),
        hills_truncated=jnp.zeros((n_dev,), bool),
    )
    shard = NamedSharding(mesh, P(DATA_AXIS))
    return jax.tree.map(lambda l: jax.device_put(l, shard), st)


def rebin_spatial_atoms(setup: SpatialSetup, state: SpatialCoordState, mesh):
    """Host-side atom migration (the LAMMPS domain re-decomposition analog):
    gather all atoms, re-bin by current brick, redistribute.  Call at
    write-segment boundaries; between calls atoms may drift up to ``skin``."""
    xs = np.asarray(state.x).reshape(-1, state.x.shape[-1])
    vs = np.asarray(state.v).reshape(-1, state.v.shape[-1])
    fs = np.asarray(state.f).reshape(-1, state.f.shape[-1])
    ok = np.asarray(state.valid).reshape(-1)
    n_dev = setup.n_dev
    cap = state.x.shape[1]
    dev_of = _bin_devices(setup, xs)
    nx = np.array(np.asarray(state.x))
    nv = np.zeros_like(np.asarray(state.v))
    nf = np.zeros_like(np.asarray(state.f))
    nvalid = np.zeros((n_dev, cap), bool)
    for d in range(n_dev):
        mine = np.nonzero(ok & (dev_of == d))[0]
        if len(mine) > cap:
            raise ValueError(f"device {d}: {len(mine)} atoms > capacity {cap}")
        nx[d, : len(mine)] = xs[mine]
        _park_empty(setup, nx, d, len(mine))
        nv[d, : len(mine)] = vs[mine]
        nf[d, : len(mine)] = fs[mine]
        nvalid[d, : len(mine)] = True
    shard = NamedSharding(mesh, P(DATA_AXIS))
    dtype = state.x.dtype
    return dataclasses.replace(
        state,
        x=jax.device_put(jnp.asarray(nx, dtype), shard),
        v=jax.device_put(jnp.asarray(nv, dtype), shard),
        f=jax.device_put(jnp.asarray(nf, dtype), shard),
        valid=jax.device_put(jnp.asarray(nvalid), shard),
    )


def _global_spec(setup: SpatialSetup, spec):
    """GLOBAL GridSpec assembled from the per-device local spec: sharded
    dims recover the full CV range; unsharded dims pass through (deflating
    the local spec's non-periodic max inflation for GridSpec.create)."""
    from ..grid import GridSpec

    parts, widths, lows, nonper = _brick_geometry(setup)
    D = spec.dim
    lo, hi, per = [], [], []
    for d in range(D):
        if parts[d] > 1:
            lo.append(lows[d])
            hi.append(lows[d] + widths[d] * parts[d])
            per.append(not nonper[d])
        else:
            lo.append(spec.min[d])
            hi.append(spec.max[d] - (0 if spec.periodic[d] else spec.dx[d]))
            per.append(bool(spec.periodic[d]))
    return GridSpec.create(lo, hi, list(spec.dx), per)


def _stitch_arrays(setup: SpatialSetup, spec, arrs):
    """Assemble global arrays from per-device owned brick regions.

    ``arrs``: list of (n_dev, *local_grid_shape, *trailing) numpy arrays
    (trailing axes, e.g. the derivs' component axis, are carried through).
    Each device contributes the rows whose local coordinate along every
    sharded dim lies in [0, w_d) — plus the global-max point on the last
    brick of a non-periodic dim.  The reference's multi_write instead
    elects the max-rank owner per point (grid.h:616-647) — same rows,
    different tie-winner inside the skin.  Returns (global arrays, gspec).
    """
    parts, widths, lows, nonper = _brick_geometry(setup)
    strides = _dev_strides(parts)
    gspec = _global_spec(setup, spec)
    D = spec.dim
    n_dev = int(np.prod(parts))
    # per-dim ownership in INTEGER index space (float comparisons on
    # f32-derived spec values put grid nodes on knife edges): the local
    # index of local coordinate 0 is k0 = round(-min/dx); each device owns
    # the next round(w/dx) points — plus the global-max point on the last
    # brick of a non-periodic dim
    loc_idx = [[None, None] for _ in range(D)]  # [not-last, last]
    n_own = [0] * D
    for d in range(D):
        n_d = int(spec.nbins[d])
        if parts[d] == 1:
            idx = np.arange(n_d)
            loc_idx[d] = [idx, idx]
            continue
        k0 = int(round(-float(spec.min[d]) / float(spec.dx[d])))
        n_own[d] = int(round(widths[d] / float(spec.dx[d])))
        idx = np.arange(k0, k0 + n_own[d])
        idx_last = (
            np.arange(k0, k0 + n_own[d] + 1) if nonper[d] else idx
        )
        if k0 < 0 or idx_last[-1] >= n_d:
            raise ValueError(
                f"dim {d}: owned rows [{k0}, {idx_last[-1]}] exceed the "
                f"local grid ({n_d} points)"
            )
        loc_idx[d] = [idx, idx_last]
    outs = [
        np.zeros(tuple(int(b) for b in gspec.nbins) + a.shape[1 + D:], a.dtype)
        for a in arrs
    ]
    for dev in range(n_dev):
        lsel, gsel = [], []
        for d in range(D):
            i_d = (dev // strides[d]) % parts[d]
            li = loc_idx[d][1 if i_d == parts[d] - 1 else 0]
            lsel.append(li)
            if parts[d] == 1:
                gsel.append(li)
            else:
                gsel.append(li - li[0] + i_d * n_own[d])
        for a, out in zip(arrs, outs):
            out[np.ix_(*gsel)] = a[dev][np.ix_(*lsel)]
    return outs, gspec


def stitch_spatial_grid(setup: SpatialSetup, state: SpatialCoordState):
    """Assemble the GLOBAL bias grid from the per-device brick shards.
    Returns a Grid in global coordinates (values + derivs)."""
    from ..grid import Grid

    spec = state.bias.bias.spec.grid
    vals = np.asarray(state.bias.bias.grid.values)
    ders = state.bias.bias.grid.derivs
    arrs = [vals] + ([] if ders is None else [np.asarray(ders)])
    outs, gspec = _stitch_arrays(setup, spec, arrs)
    return Grid(
        values=jnp.asarray(outs[0]),
        derivs=None if ders is None else jnp.asarray(outs[1]),
        spec=gspec,
        interpolate=bool(state.bias.bias.grid.interpolate),
    )


def gather_spatial_grid(setup: SpatialSetup, state: SpatialCoordState):
    """Stitch the global bias grid and return (global dim-0 coordinates,
    values) — the 1-D-decomposition view (rows ordered by dim 0).  For
    N-D brick decompositions prefer ``stitch_spatial_grid`` (full Grid)."""
    g = stitch_spatial_grid(setup, state)
    xg = g.spec.min[0] + g.spec.dx[0] * np.arange(int(g.spec.nbins[0]))
    return xg, np.asarray(g.values)


def write_spatial_grid(setup: SpatialSetup, state: SpatialCoordState, filename: str):
    """Stitch the global bias grid from the owned brick rows and write it as
    one Plumed-1 file — the reference's multi_write (grid.h:509-674) without
    the per-point Allreduce+Barrier election (gather-to-host + one write,
    SURVEY §3.5)."""
    from ..grid import Grid
    from ..utils.gridio import write_grid

    spec = state.bias.bias.spec.grid
    vals = np.asarray(state.bias.bias.grid.values)
    ders = np.asarray(state.bias.bias.grid.derivs)
    (gvals, gders), gspec = _stitch_arrays(setup, spec, [vals, ders])
    g = Grid(
        values=jnp.asarray(gvals),
        derivs=jnp.asarray(gders),
        spec=gspec,
        interpolate=True,
    )
    write_grid(g, filename)
    return g


def make_spatial_coord_step(
    setup: SpatialSetup,
    lp: LangevinParams,
    hill_stride: int,
    mesh,
    external_force: Optional[Callable] = None,
    collect_records: bool = False,
    hill_capacity: Optional[int] = None,
    overlap_capacity: Optional[int] = None,
    static_do_hills: Optional[bool] = None,
):
    """Jit-compiled sharded step.  ``external_force(x_global) -> (e, f)``.

    ``collect_records=True``: the step additionally returns a per-device
    HillRoundLog (stacked over the mesh axis) with positions in GLOBAL
    coordinates — write per-replica HILLS_<r> files with
    ``log_spatial_round`` (the reference's per-rank hill trace,
    edm_bias.cpp:1075-1084; replayed hills log 'h' on the replaying rank,
    as in the reference, which never emits its defined 'n' type).

    ``hill_capacity``: bounded exchange of ACCEPTED hills only — the
    reference's send_buffer_ semantics (BIAS_BUFFER_SIZE=2048 hills per
    round, edm_bias.h:151-154; rejected candidates are never exchanged).
    Each device rank-compacts its accepted (position, height) pairs, the
    segments are all-gathered and re-compacted in device-major order — the
    full gathered batch's deposit order — so every per-hill cost of the
    replayed round scales with the capacity, not slot_capacity x n_dev.
    Default: ~8x the expected global acceptance count rounded to 512;
    overflow (a dropped tail) is flagged in ``state.hills_truncated``.
    Pass 0 to exchange the full candidate batch.

    ``overlap_capacity``: per-device OVERLAP FILTER on the gathered batch —
    the reference delivers hills only to ranks whose grids overlap the
    hill within Gaussian support (infer_neighbors, edm_bias.cpp:708-789;
    non-overlapping ranks never see the hill, so it can neither deposit
    nor occupy their overflow buffers).  Here each device drops gathered
    hills whose nearest-image local position lies beyond the local grid
    plus one support window along any sharded dim (deposits there are
    exactly zero), then rank-compacts the keepers so the per-device replay
    cost scales with the hills that can REACH this device (~1/n_dev of the
    round for uniform hills) instead of the global round.  Deposit order
    is the global order restricted to the kept subset — dropped hills
    contribute exact zeros, so the local grid agrees to reduction roundoff
    (the dense deposit matvec regroups when the batch length changes; 1-2
    ULP), and under bias_per_step capping the local prefix is unchanged
    (dropped hills have s == 0) while the overflow buffer stops collecting
    unreachable hills, matching the reference.  None (default):
    auto-enable when the expected covered fraction makes the compacted
    batch at least 2x smaller; 0: disable; int: forced capacity.  Overflow
    of the capacity sets the sticky ``state.hills_truncated`` flag.

    ``static_do_hills``: resolve the hill-round branch at trace time (the
    dynamic cond's pass-through branch copies the whole per-device local
    grid + overflow buffers on every non-hill step — the largest carried
    state in this host; see models.driver.pattern_segment).  True always
    runs the round (callers own ``step % hill_stride == 0`` phase
    alignment), False never does; the key stream is identical either way
    (the round key is fold_in-derived, not split)."""
    params = setup.params
    D = params.cfg.dim
    axis = DATA_AXIS
    parts, widths, lows, nonper = _brick_geometry(setup)
    strides = _dev_strides(parts)
    sharded_dims = [d for d in range(D) if parts[d] > 1]
    any_nonper = any(nonper)
    n_dev = mesh.devices.size
    # cfg.hill_density is already the per-replica (divided) density
    # (spatial_subdivide <-> edm_bias.cpp:173-180): the expected GLOBAL
    # acceptance count per round is ~n_dev x hill_density
    density = float(params.cfg.hill_density)
    if hill_capacity is None:
        hill_capacity = (
            0
            if density < 0
            else max(
                512, int(-(-8.0 * max(n_dev * density, 64.0) // 512)) * 512
            )
        )

    def _round_shapes(cap):
        """Static per-round batch shapes for a given slot capacity:
        (compact-exchange?, gathered-round size, overlap-filter capacity,
        replayed-batch size).  The filter capacity is ~4x the expected
        covered share of the round (the fraction of uniform hill positions
        within one support window + skin of this device's grid), rounded
        to 256; auto mode only engages when that at least halves the
        replayed batch."""
        compact = 0 < hill_capacity < cap * n_dev and density >= 0
        n_round = hill_capacity if compact else cap * n_dev
        if overlap_capacity == 0 or not sharded_dims:
            return compact, n_round, 0, n_round
        if overlap_capacity:
            k2 = min(int(overlap_capacity), n_round)
            return compact, n_round, k2, k2
        cov = 1.0
        sk = setup.skins or ((setup.skin,) + (0.0,) * (D - 1))
        for d in sharded_dims:
            sup = 4.0 * np.sqrt(2.0) * params.cfg.bias_sigma[d] + (
                params.cfg.bias_dx[d]
            )
            cov *= min(
                1.0,
                (widths[d] + 2 * sk[d] + 2 * sup) / (widths[d] * parts[d]),
            )
        k2 = max(256, int(-(-4.0 * cov * n_round // 256)) * 256)
        if k2 * 2 > n_round:
            return compact, n_round, 0, n_round
        return compact, n_round, k2, k2

    def brick_index(d):
        # this device's brick coordinate along dim d (row-major flat index)
        idx = jax.lax.axis_index(axis)
        return (idx // strides[d]) % parts[d]

    def to_local(x):
        # global -> this device's local coordinates (sharded dims shifted);
        # remap inside the bias grid handles the periodic nearest-image
        # choice per dim
        for d in sharded_dims:
            off = lows[d] + brick_index(d).astype(x.dtype) * widths[d]
            x = x.at[..., d].add(-off)
        return x

    def boundary_off(dtype):
        # local -> shifted-global conversion for the non-periodic sharded
        # dims (the static boundary is the global box with box_low_d at 0)
        if not any_nonper:
            return None
        off = jnp.zeros((D,), dtype)
        for d in range(D):
            if nonper[d]:
                off = off.at[d].set(
                    brick_index(d).astype(dtype) * widths[d]
                )
        return off

    def step_local(state):
        # shard_map view: strip the leading device axis
        s = jax.tree.map(lambda a: a[0], state)

        def force_fn(x):
            x_loc = to_local(x)
            e_b, der = B.update_forces(
                params, s.bias, x_loc, mask=s.valid,
                boundary_offset=boundary_off(x.dtype),
            )
            f = jnp.zeros_like(x)
            f = f.at[..., :D].add(-der)
            f = jnp.where(s.valid[..., None], f, 0)
            e = jax.lax.psum(e_b, axis)
            if external_force is not None:
                e_ext, f_ext = external_force(x)
                f = f + jnp.where(s.valid[..., None], f_ext, 0)
                e = e + jax.lax.psum(jnp.sum(jnp.where(s.valid, e_ext, 0)), axis)
            return e, f

        x, v, f, energy, key = baoab_step(lp, s.x, s.v, s.f, s.key, force_fn)
        # parked (invalid) slots must not move
        x = jnp.where(s.valid[..., None], x, s.x)
        v = jnp.where(s.valid[..., None], v, 0)

        do_hills = (s.step % hill_stride) == 0
        cap = x.shape[0]
        Hc = hill_capacity
        compact, n_round, K2, n_log = _round_shapes(cap)

        def with_hills(bs):
            hkey = jax.random.fold_in(key, 17)
            runif = jax.random.uniform(hkey, (cap,), x.dtype)
            pos_loc = to_local(x)[:, :D]
            n_local = jnp.sum(s.valid.astype(x.dtype))
            est = jnp.maximum(n_local, 1.0).astype(x.dtype)
            if params.cfg.hill_density < 0:
                accept = s.valid
            else:
                accept = s.valid & (runif < params.cfg.hill_density / est)
            # heights computed on the ORIGIN device against its local grid
            # (round-start; see bias.hill_heights); the target factor
            # evaluates the GLOBAL target grid at global positions
            h = B.hill_heights(
                params, bs, pos_loc, est, target_positions=x[:, :D],
                boundary_offset=boundary_off(x.dtype),
            )
            if compact:
                # bounded exchange of accepted (position, height) pairs;
                # per-device rank compaction preserves slot order, so the
                # device-major re-compaction after the gather replays the
                # full gathered batch's deposit order
                ranks = jnp.cumsum(accept.astype(jnp.int32)) - 1
                tgt = jnp.where(accept & (ranks < Hc), ranks, Hc)
                pos_c = jnp.zeros((Hc, D), x.dtype).at[tgt].set(
                    x[:, :D], mode="drop"
                )
                h_c = jnp.zeros((Hc,), x.dtype).at[tgt].set(h, mode="drop")
                cnt = jnp.sum(accept.astype(jnp.int32))
                act_c = jnp.arange(Hc) < cnt
                pos_gg = jax.lax.all_gather(pos_c, axis, tiled=True)
                h_gg = jax.lax.all_gather(h_c, axis, tiled=True)
                act_gg = jax.lax.all_gather(act_c, axis, tiled=True)
                total = jax.lax.psum(jnp.minimum(cnt, Hc), axis)
                granks = jnp.cumsum(act_gg.astype(jnp.int32)) - 1
                keep = act_gg & (granks < Hc)
                gtgt = jnp.where(keep, granks, Hc)
                pos_g = jnp.zeros((Hc, D), x.dtype).at[gtgt].set(
                    pos_gg, mode="drop"
                )
                h_g = jnp.zeros((Hc,), x.dtype).at[gtgt].set(
                    h_gg, mode="drop"
                )
                act_g = jnp.arange(Hc) < total
                trunc = (
                    jax.lax.psum((cnt > Hc).astype(jnp.int32), axis) > 0
                ) | (total > Hc)
            else:
                # full exchange: gather (global position, height, active)
                # from all devices; each device replays everything, masks
                # do the rest
                pos_g = jax.lax.all_gather(x[:, :D], axis, tiled=True)
                h_g = jax.lax.all_gather(h, axis, tiled=True)
                act_g = jax.lax.all_gather(accept, axis, tiled=True)
                trunc = jnp.zeros((), bool)
            if K2:
                # per-device overlap filter (infer_neighbors per hill,
                # edm_bias.cpp:708-789): keep hills whose nearest-image
                # LOCAL position lies within one support window of the
                # local grid along every sharded dim — anything farther
                # deposits exactly zero here.  Rank compaction preserves
                # the global deposit order on the kept subset.
                gg = bs.bias
                gs = gg.spec
                rmapped = gg.remap(to_local(pos_g))
                keep = act_g
                for d in sharded_dims:
                    hw = (gs.minisize[d] + 1) * gs.grid.dx[d]
                    keep = keep & (
                        (rmapped[..., d] >= gs.grid.min[d] - hw)
                        & (rmapped[..., d] <= gs.grid.max[d] + hw)
                    )
                kranks = jnp.cumsum(keep.astype(jnp.int32)) - 1
                ktgt = jnp.where(keep & (kranks < K2), kranks, K2)
                kcnt = jnp.sum(keep.astype(jnp.int32))
                pos_g = jnp.zeros((K2, D), x.dtype).at[ktgt].set(
                    pos_g, mode="drop"
                )
                h_g = jnp.zeros((K2,), x.dtype).at[ktgt].set(
                    h_g, mode="drop"
                )
                act_g = jnp.arange(K2) < kcnt
                trunc = trunc | (kcnt > K2)
            pos_g_loc = to_local(pos_g)
            new_bs, rec = B.add_hills_round(
                params,
                bs,
                pos_g_loc,
                jnp.zeros(pos_g.shape[:1], x.dtype),
                est,
                active=act_g,
                axis_name=axis,
                override_heights=h_g,
                boundary_offset=boundary_off(x.dtype),
            )
            log = (
                B.HillRoundLog(jnp.ones((), bool), pos_g, rec)
                if collect_records
                else None
            )
            return new_bs, log, trunc

        def without_hills(bs):
            log = (
                B.round_log_zeros(params, bs, n_log)
                if collect_records
                else None
            )
            return bs, log, jnp.zeros((), bool)

        if static_do_hills is None:
            bias_state, log, trunc = jax.lax.cond(
                do_hills, with_hills, without_hills, s.bias
            )
        elif static_do_hills:
            bias_state, log, trunc = with_hills(s.bias)
        else:
            bias_state, log, trunc = without_hills(s.bias)
        new_trunc = (
            None
            if s.hills_truncated is None
            else s.hills_truncated | trunc
        )

        out = SpatialCoordState(
            x=x, v=v, f=f, valid=s.valid, key=key, bias=bias_state,
            step=s.step + 1, energy=energy, hills_truncated=new_trunc,
        )
        out = jax.tree.map(lambda a: a[None], out)
        if collect_records:
            log = jax.tree.map(lambda a: a[None], log)
            return out, energy, log
        return out, energy

    def one_step(state):
        specs = jax.tree.map(lambda _: P(DATA_AXIS), state)
        if collect_records:
            # probe the log pytree structure (no axis ops) for out_specs
            _, _, _, n_log = _round_shapes(state.x.shape[1])
            bias_one = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), state.bias
            )
            log_shape = jax.eval_shape(
                lambda bs: B.round_log_zeros(params, bs, n_log), bias_one
            )
            out_specs = (specs, P(), jax.tree.map(lambda _: P(DATA_AXIS), log_shape))
        else:
            out_specs = (specs, P())
        fn = jax.shard_map(
            step_local,
            mesh=mesh,
            in_specs=(specs,),
            out_specs=out_specs,
            check_vma=False,
        )
        return fn(state)

    stepped = jax.jit(one_step)
    # introspection for tests/benches: the static per-round batch shapes
    # (compact-exchange?, gathered size, overlap-filter capacity, replay
    # size) this step would use at a given slot capacity
    stepped.round_shapes = _round_shapes
    return stepped


def log_spatial_round(hills_logs, logs, round_counter: int, cum_before: float):
    """Replay one step's stacked per-device HillRoundLog into per-replica
    HILLS files.  ``hills_logs``: list of utils.hills_log.HillsLog, one per
    device (reference: '<hills_filename>_<rank>', edm_bias.cpp:1075-1084).
    Returns the global bias added this round (identical on every device)."""
    import numpy as np_

    logs = jax.device_get(logs)
    happened = bool(np_.asarray(logs.happened).any())
    if not happened:
        return 0.0
    round_total = 0.0
    for d, hl in enumerate(hills_logs):
        rec_d = jax.tree_util.tree_map(lambda a: a[d], logs.rec)
        hl.log_round(round_counter, cum_before, rec_d, logs.positions[d])
        round_total += float(rec_d.round_bias)
    return round_total
