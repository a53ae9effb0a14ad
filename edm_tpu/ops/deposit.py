"""Gaussian hill deposition — the hot kernel (reference
``DimmedGaussGrid::add_value``, lib/gaussian_grid.h:176-372).

The reference walks a per-hill "minigrid" (the truncated Gaussian support)
point-by-point on the CPU.  Here the whole batch of hills is evaluated at
once: the window is a *static* shape known at trace time from sigma/dx
(gaussian_grid.h:559-569), every (hill, window-point) contribution is
computed in parallel, and a single scatter-add commits values and
gradients.  Per-hill integrated bias ("bias_added", the invariant the bias
limiter depends on — gaussian_grid.h:349,371) falls out as a masked row sum.

Deposition is linear in hill height, so ``hill_windows`` computes unit-height
window weights usable both for the capping prefix-pass (ops/prefix_cap) and
the final scatter.

McGovern–De Pablo boundary-corrected zero-force hills: the per-dim corrective
loop (gaussian_grid.h:303-343) is replicated *exactly*, including its
sequential running-denominator quirks across dims (the reference only claims
correctness for 1-D boundaries; see README TODO noted in SURVEY.md Q8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..gauss import (
    BC_MAR,
    BC_TABLE_SIZE,
    GAUSS_SUPPORT,
    GaussGrid,
    ref_round,
    sigmoid,
    sigmoid_dx,
)


class HillWindows(NamedTuple):
    idx: jax.Array  # (H, W, D) int32 wrapped/clipped grid indices
    value_w: jax.Array  # (H, W) unit-height value contribution
    deriv_w: jax.Array  # (H, W, D) unit-height gradient contribution
    valid: jax.Array  # (H, W) bool


def _bc_index(xxd, bmin, span):
    """McGDP boundary-table index (gaussian_grid.h:308): TRUNCATION of the
    IEEE quotient (BC_TABLE_SIZE-1)*(xx-bmin)/span.

    XLA rewrites the division (reciprocal multiply / fused reassociation),
    which can land the quotient on the far side of an integer from the
    reference's correctly-rounded C division and shift the lookup one table
    entry.  Near-integer quotients are COMMON, not adversarial: any grid
    whose point lattice is rationally aligned with the 65,536-entry table
    lattice produces them on a fixed subset of points every deposit (e.g.
    spacing 0.0197 on [0,3]: every 9th grid point).  One entry off shifts
    the denominator ~1e-5 relative — measured as a 4e-7 per-hill bias_added
    divergence vs the reference binary (tests/test_oracle_sweep.py,
    captgt1d).

    Worse, XLA CONTRACTS multiply chains (measured: jitted
    65535*(dx*i) single-rounds to 11565.0 where per-op IEEE gives
    11564.999999999998), so no in-graph float expression can reproduce the
    reference's two-step rounding reliably.  Deposit points always lie on
    the grid lattice, so the exact fix lives in _bc_point_index_np
    (host-side numpy per grid point, gathered by integer grid index); this
    in-graph form remains only for lattice points shifted by a TRACED
    boundary_offset (the spatially-sharded hosts), where the reference's
    own per-rank local-coordinate arithmetic is rank-dependent anyway."""
    t = (BC_TABLE_SIZE - 1) * (xxd - bmin) / span
    return jnp.clip(t.astype(jnp.int32), 0, BC_TABLE_SIZE - 1)


def _bc_point_index_np(spec, d: int) -> np.ndarray:
    """Per-grid-point McGDP table index along dim d, computed HOST-SIDE in
    float64 numpy — elementwise IEEE ops, no fusion — replicating the
    reference's exact arithmetic (xx = min + dx*i, gaussian_grid.h:269;
    bc_index = (int)((BC_TABLE_SIZE-1)*(xx-bmin)/span), :308) bit-for-bit,
    including its double-rounding at lattice-aligned quotients.  Embedded
    as a trace-time constant and gathered by integer grid index."""
    g = spec.grid
    G = int(g.nbins[d])
    xx = np.float64(g.min[d]) + np.float64(g.dx[d]) * np.arange(G, dtype=np.float64)
    bmin = np.float64(spec.boundary_min[d])
    span = np.float64(spec.boundary_max[d]) - bmin
    t = (BC_TABLE_SIZE - 1) * (xx - bmin) / span
    return np.clip(t.astype(np.int32), 0, BC_TABLE_SIZE - 1)


def hill_windows(gg: GaussGrid, centers: jax.Array,
                 boundary_offset=None) -> HillWindows:
    """Unit-height window contributions for a batch of hill centers (H, D).

    ``boundary_offset`` (D,): local->global shift for boundary-relative
    terms (see _pointwise_contrib)."""
    spec = gg.spec
    g = spec.grid
    D = spec.dim
    dtype = gg.dtype

    gmin = jnp.asarray(g.min, dtype)
    gdx = jnp.asarray(g.dx, dtype)
    # plain python floats: weak-typed under jnp so an f32 grid stays f32
    # even when jax_enable_x64 is on (np scalars would promote to f64)
    bmin = spec.boundary_min
    bmax = spec.boundary_max
    sigma = spec.sigma

    def _off(d):
        return 0.0 if boundary_offset is None else boundary_offset[d]

    x = gg.remap(jnp.asarray(centers, dtype))  # (H, D)

    # whole-hill rejection outside a non-periodic boundary (gaussian_grid.h:213-216)
    hill_ok = jnp.ones(x.shape[:1], bool)
    for d in range(D):
        if not spec.boundary_periodic[d]:
            xc = x[:, d] + _off(d)
            hill_ok &= (xc >= bmin[d]) & (xc <= bmax[d])

    # center index, possibly negative (gaussian_grid.h:222-224)
    x_index = jnp.floor((x - gmin) / gdx).astype(jnp.int32)

    # static window of offsets covering the Gaussian support
    offs = np.stack(
        np.meshgrid(*[np.arange(-m, m + 1) for m in spec.minisize], indexing="ij"),
        axis=-1,
    ).reshape(-1, D)
    idx_raw = x_index[:, None, :] + jnp.asarray(offs, jnp.int32)[None]  # (H, W, D)

    valid = jnp.broadcast_to(hill_ok[:, None], idx_raw.shape[:2])
    idx_dims = []
    for d in range(D):
        r = idx_raw[..., d]
        n = g.nbins[d]
        if g.periodic[d]:
            r = r % n  # periodic wrap (gaussian_grid.h:251-266)
        else:
            valid = valid & (r >= 0) & (r < n)
            r = jnp.clip(r, 0, n - 1)
        idx_dims.append(r)
    idx = jnp.stack(idx_dims, axis=-1)

    xx = gmin + gdx * idx.astype(dtype)  # (H, W, D)

    # per-point boundary mask (gaussian_grid.h:272-276)
    for d in range(D):
        if not spec.boundary_periodic[d]:
            xg = xx[..., d] + _off(d)
            valid = valid & (xg >= bmin[d]) & (xg <= bmax[d])

    # sigma-scaled distances with periodic wrap (gaussian_grid.h:285-295)
    dp_dims = []
    for d in range(D):
        dpd = xx[..., d] - x[:, None, d]
        if g.periodic[d]:
            L = g.max[d] - g.min[d]
            dpd = dpd - ref_round(dpd / L) * L
        dp_dims.append(dpd / sigma[d])
    dp = jnp.stack(dp_dims, axis=-1)
    dp2 = jnp.sum(dp * dp, axis=-1)

    # Support cutoff with an inclusive epsilon: when the support radius
    # sqrt(8)*sigma/dx lands exactly on a grid offset (e.g. sigma=0.2,
    # dx=0.01 -> 80 points), the reference's double arithmetic computes dp2
    # a hair below 8 and includes the edge points; XLA's arithmetic can land
    # a hair above and would drop them, shifting per-hill integrals by ~1e-5.
    valid = valid & (dp2 < GAUSS_SUPPORT + 1e-12)
    value_w, deriv_w = _pointwise_contrib(
        gg, xx, x[:, None, :], dp, dp2, valid, boundary_offset=boundary_offset,
        grid_idx=idx,
    )
    return HillWindows(idx=idx, value_w=value_w, deriv_w=deriv_w, valid=valid)


def _pointwise_contrib(gg: GaussGrid, xx, x, dp, dp2, valid, boundary_offset=None,
                       grid_idx=None):
    """Unit-height (value, gradient) contribution of a hill centered at x to
    a grid point xx, given sigma-scaled dp and dp2 — the Gaussian +
    McGovern–De Pablo correction block of gaussian_grid.h:299-355, shared by
    the windowed scatter path and the dense 1-D path.

    All arrays broadcast: xx (..., D), x (..., D), dp (..., D), dp2/valid (...).
    ``boundary_offset`` (D,): local->global shift applied to coordinates in
    every boundary-relative term (grids in local coordinates with a GLOBAL
    static boundary — the sharded host's non-periodic dims); distances (dp)
    are shift-invariant.
    ``grid_idx`` (..., D) int: the grid lattice indices behind xx.  When
    given (and no traced boundary_offset), the McGDP table index is the
    host-precomputed per-point constant (_bc_point_index_np) — bit-exact
    reference truncation, immune to XLA float rewrites.
    """
    spec = gg.spec
    D = spec.dim
    dtype = gg.dtype
    bmin = spec.boundary_min
    bmax = spec.boundary_max
    sigma = spec.sigma

    expo = jnp.exp(-dp2)

    # McGovern–De Pablo boundary correction, sequential over dims
    # (gaussian_grid.h:302-343 replicated exactly, running bc_denom included)
    bc_denom = jnp.ones_like(expo)
    bc_correction = jnp.zeros_like(expo)
    bc_force = [None] * D
    for d in range(D):
        if not spec.boundary_periodic[d]:
            off_d = 0.0 if boundary_offset is None else boundary_offset[d]
            xxd = xx[..., d] + off_d
            xcd = x[..., d] + off_d
            sig = sigma[d]
            span = bmax[d] - bmin[d]
            if grid_idx is not None and boundary_offset is None:
                bc_idx = jnp.asarray(_bc_point_index_np(spec, d))[grid_idx[..., d]]
            else:
                bc_idx = _bc_index(xxd, bmin[d], span)
            temp1 = jnp.exp(-((xcd - bmin[d]) ** 2) / sig**2)
            temp2 = sigmoid((xxd - bmin[d]) / (sig * BC_MAR))
            temp3 = jnp.exp(-((xcd - bmax[d]) ** 2) / sig**2)
            temp4 = sigmoid((bmax[d] - xxd) / (sig * BC_MAR))
            bc_correction = (temp1 - expo) * temp2 + (temp3 - expo) * temp4
            bc_denom = bc_denom * gg.bc_denom[d][bc_idx]

            temp5 = -2 * dp[..., d] / sig
            temp6 = sigmoid_dx((xxd - bmin[d]) / (sig * BC_MAR)) / (BC_MAR * sig)
            temp7 = -sigmoid_dx((bmax[d] - xxd) / (sig * BC_MAR)) / (BC_MAR * sig)
            f = temp5 * expo
            f = f + (temp1 - expo) * temp6 - temp5 * expo * temp2 + (temp3 - expo) * temp7 - temp5 * expo * temp4
            f = f * bc_denom - gg.bc_denom_deriv[d][bc_idx] * (expo + bc_correction)
            f = f / (bc_denom * bc_denom)
            bc_correction = bc_correction / bc_denom
            bc_force[d] = f
        else:
            bc_denom = bc_denom * (math.sqrt(math.pi) * sigma[d])

    expo_f = expo / bc_denom

    zero = jnp.zeros((), dtype)
    value_w = jnp.where(valid, expo_f + bc_correction, zero)
    deriv_dims = []
    for d in range(D):
        if spec.boundary_periodic[d]:
            dd = -(2 * dp[..., d] / sigma[d] * expo_f)
        else:
            dd = bc_force[d]
        deriv_dims.append(jnp.where(valid, dd, zero))
    deriv_w = jnp.stack(deriv_dims, axis=-1)
    return value_w, deriv_w


def hill_weights(gg: GaussGrid, centers: jax.Array) -> jax.Array:
    """Per-hill integrated bias per unit height: s_k = sum_w value_w * prod(dx).

    bias_added_k == height_k * s_k — the conservation invariant asserted by
    the reference integral tests (tests/edm_test.cpp:537-628)."""
    hw = hill_windows(gg, centers)
    vol = float(np.prod(gg.spec.grid.dx))
    return jnp.sum(hw.value_w, axis=-1) * vol


def dense_tables_1d(gg: GaussGrid, centers: jax.Array, boundary_offset=None):
    """Unit-height dense contribution tables for a 1-D grid: returns
    (Mval (G, H), Mder (G, H), s (H,)) such that a deposit of heights h is
    ``values += Mval @ h``, ``derivs[:, 0] += Mder @ h`` and the per-hill
    integral is ``bias_added = h * s``.

    For the engine's hill rounds on small CV grids this replaces two window
    evaluations and two scatter passes with two tiny matvecs.  Pointwise math identical to the windowed path
    (shared _pointwise_contrib).  ``boundary_offset``: see hill_windows."""
    spec = gg.spec
    g = spec.grid
    assert spec.dim == 1
    dtype = gg.dtype
    centers = jnp.asarray(centers, dtype)
    x = gg.remap(centers)  # (H, 1)
    H = x.shape[0]
    G = g.nbins[0]
    off0 = 0.0 if boundary_offset is None else boundary_offset[0]

    hill_ok = jnp.ones((H,), bool)
    if not spec.boundary_periodic[0]:
        xc = x[:, 0] + off0
        hill_ok &= (xc >= spec.boundary_min[0]) & (xc <= spec.boundary_max[0])

    gxs = g.min[0] + g.dx[0] * jnp.arange(G, dtype=dtype)
    point_ok = jnp.ones((G,), bool)
    if not spec.boundary_periodic[0]:
        gxo = gxs + off0
        point_ok &= (gxo >= spec.boundary_min[0]) & (gxo <= spec.boundary_max[0])

    xx = gxs[:, None]  # (G, 1)
    dpd = xx[:, 0][:, None] - x[None, :, 0]  # (G, H)
    if g.periodic[0]:
        L = g.max[0] - g.min[0]
        dpd = dpd - ref_round(dpd / L) * L
    dp = (dpd / spec.sigma[0])[..., None]
    dp2 = dp[..., 0] * dp[..., 0]
    valid = point_ok[:, None] & hill_ok[None, :] & (dp2 < GAUSS_SUPPORT + 1e-12)
    Mval, Mder = _pointwise_contrib(
        gg, xx[:, None, :], x[None, :, :], dp, dp2, valid,
        boundary_offset=boundary_offset,
        grid_idx=jnp.arange(G, dtype=jnp.int32)[:, None, None],
    )
    s = jnp.sum(Mval, axis=0) * np.asarray(g.dx[0], dtype)
    return Mval, Mder[..., 0], s


def dense_tables_sep(gg: GaussGrid, centers: jax.Array):
    """Separable per-dim unit tables for N-D deposition: a Gaussian hill is
    ``prod_d u_d(x_d)``, so a batch deposit is a matmul contraction
    (2-D: ``values += (h * Ux)^T @ Uy``; 3-D: an einsum that XLA factors
    into an outer product + one matmul) instead of an H x window scatter.

    Returns ([(u_d (H,G_d), du_d (H,G_d)) per dim], s (H,)).

    DIVERGENCE (README ledger): the support cutoff is applied per dim
    (square/cube |dp_d| < sqrt(8)) instead of the reference's spherical
    dp^2 < 8 (gaussian_grid.h:299) — corner points with 8 < dp2 < D*8 keep
    their exp(-dp2) <= e^-8 contribution instead of being dropped.  The
    bias-limiter invariant (deposited integral == h*s) holds exactly with
    the matching separable-support s.  Requires fully periodic
    grid+boundary (no McGovern-De Pablo corrections, which are not
    separable)."""
    spec = gg.spec
    g = spec.grid
    D = spec.dim
    assert all(g.periodic) and all(spec.boundary_periodic)
    dtype = gg.dtype
    centers = jnp.asarray(centers, dtype)
    x = gg.remap(centers)  # (H, D)

    tabs = []
    for d in range(D):
        G = g.nbins[d]
        gxs = g.min[d] + g.dx[d] * jnp.arange(G, dtype=dtype)
        dpd = gxs[None, :] - x[:, d : d + 1]  # (H, G)
        L = g.max[d] - g.min[d]
        dpd = dpd - ref_round(dpd / L) * L
        dp = dpd / spec.sigma[d]
        dp2 = dp * dp
        ok = dp2 < GAUSS_SUPPORT + 1e-12
        # per-dim normalization 1/(sqrt(pi)*sigma') — the reference deposits
        # normalized Gaussians (peak h / prod_d sqrt(2 pi) sigma_d)
        norm = 1.0 / (math.sqrt(math.pi) * spec.sigma[d])
        u = jnp.where(ok, jnp.exp(-dp2) * norm, 0.0)
        # stored-gradient factor: d/d(grid point) of the normalized Gaussian
        du = u * (-2.0 * dp / spec.sigma[d])
        tabs.append((u, du))
    vol = np.asarray(np.prod(g.dx), dtype)
    s = vol
    for u, _ in tabs:
        s = s * jnp.sum(u, axis=1)
    return tabs, s


def deposit_from_tables_sep(gg: GaussGrid, tabs, heights):
    """Commit a separable N-D deposit as einsum contractions over hills."""
    import jax as _jax

    D = gg.spec.dim
    heights = jnp.asarray(heights, gg.dtype)
    hp = _jax.lax.Precision.HIGHEST
    axes = "xyz"[:D]
    spec_str = ",".join(f"h{a}" for a in axes) + "->" + axes
    us = [u for u, _ in tabs]
    dus = [du for _, du in tabs]

    def contract(which_deriv):
        ops = []
        for k in range(D):
            u = dus[k] if k == which_deriv else us[k]
            if k == 0:
                u = heights[:, None] * u
            ops.append(u)
        return jnp.einsum(spec_str, *ops, precision=hp)

    values = gg.grid.values + contract(-1)
    derivs = gg.grid.derivs + jnp.stack(
        [contract(d) for d in range(D)], axis=-1
    )
    grid = dataclasses.replace(gg.grid, values=values, derivs=derivs)
    return dataclasses.replace(gg, grid=grid)


class McGDPTables(NamedTuple):
    """Linear-in-height deposit tables for a 2-D/3-D grid with McGovern-De
    Pablo boundary-corrected dim(s) — see dense_tables_mcgdp."""

    sep_value: tuple  # per-dim (H, G_d) factors of expo/D_tot
    sep_grads: tuple  # per grad dim: tuple of terms, each a per-dim tuple
    strip_cache: dict  # per-dim base arrays for the strip passes
    s: jax.Array  # (H,) unit-height integral (bias-limiter invariant)


def _mcgdp_base(gg: GaussGrid, centers):
    """Shared per-dim ingredient arrays for the McGDP fast path."""
    spec = gg.spec
    g = spec.grid
    D = spec.dim
    dtype = gg.dtype
    x = gg.remap(jnp.asarray(centers, dtype))  # (H, D)
    H = x.shape[0]

    hill_ok = jnp.ones((H,), bool)
    for d in range(D):
        if not spec.boundary_periodic[d]:
            hill_ok &= (x[:, d] >= spec.boundary_min[d]) & (
                x[:, d] <= spec.boundary_max[d]
            )
    hill_okf = hill_ok.astype(dtype)

    per = []
    for d in range(D):
        G = g.nbins[d]
        gxs = g.min[d] + g.dx[d] * jnp.arange(G, dtype=dtype)
        gxs_np = np.asarray(g.min[d] + g.dx[d] * np.arange(G))
        dpd = gxs[None, :] - x[:, d : d + 1]  # (H, G)
        if g.periodic[d]:
            L = g.max[d] - g.min[d]
            dpd = dpd - ref_round(dpd / L) * L
        dp = dpd / spec.sigma[d]
        dp2 = dp * dp
        m = (dp2 < GAUSS_SUPPORT + 1e-12).astype(dtype)
        e = jnp.exp(-dp2)
        ent = dict(m=m, e=e, dp=dp, dp2=dp2, G=G, gxs=gxs)
        if spec.boundary_periodic[d]:
            ent["inv_fac"] = 1.0 / (math.sqrt(math.pi) * spec.sigma[d])
            ent["strip"] = None
        else:
            bmin, bmax = spec.boundary_min[d], spec.boundary_max[d]
            sig = spec.sigma[d]
            span = bmax - bmin
            pm = ((gxs >= bmin) & (gxs <= bmax)).astype(dtype)
            ent["m"] = m * pm[None, :]
            ent["pm"] = pm
            bc_idx = jnp.asarray(_bc_point_index_np(spec, d))
            ent["den"] = gg.bc_denom[d][bc_idx]  # (G,)
            ent["dden"] = gg.bc_denom_deriv[d][bc_idx]
            ent["inv_fac"] = 1.0 / ent["den"]
            ent["s2"] = sigmoid((gxs - bmin) / (sig * BC_MAR))
            ent["s4"] = sigmoid((bmax - gxs) / (sig * BC_MAR))
            ent["t6"] = sigmoid_dx((gxs - bmin) / (sig * BC_MAR)) / (BC_MAR * sig)
            ent["t7"] = -sigmoid_dx((bmax - gxs) / (sig * BC_MAR)) / (BC_MAR * sig)
            ent["t1"] = jnp.exp(-((x[:, d] - bmin) ** 2) / sig**2)  # (H,)
            ent["t3"] = jnp.exp(-((x[:, d] - bmax) ** 2) / sig**2)
            # static strip: rows where any sigmoid factor can be nonzero
            # (s2/s4/t6/t7 are EXACTLY zero outside |u| < 1) — the
            # correction terms live only here
            u_lo = (gxs_np - bmin) / (sig * BC_MAR)
            u_hi = (bmax - gxs_np) / (sig * BC_MAR)
            strip = np.nonzero((u_lo < 1.0) | (u_hi < 1.0))[0]
            ent["strip"] = strip
        per.append(ent)
    return x, hill_okf, per


def dense_tables_mcgdp(gg: GaussGrid, centers: jax.Array) -> McGDPTables:
    """2-D/3-D deposition tables for grids with McGovern-De Pablo corrected
    dims — the matmul fast path for non-periodic coordinate grids under
    heavy hill load (reference gaussian_grid.h:299-343).

    Split by decay structure of ``_pointwise_contrib``'s algebra (incl.
    its sequential quirks: only the LAST non-periodic dim's correction
    survives; each dim's force divides by the RUNNING denominator):

    * Terms carrying the full Gaussian ``expo`` decay with hill-point
      distance -> evaluated as separable per-dim outer products on the
      matmuls with a per-dim (square) support cutoff.  Divergence vs the
      reference's spherical cutoff is <= e^-8 of the hill peak at corner
      points (the dense_tables_sep ledger entry).
    * Correction terms carrying s2/s4/t6/t7 sigmoid factors do NOT decay
      with distance, but those factors are EXACTLY ZERO outside static
      boundary strips of width BC_MAR*sigma' — they are evaluated densely
      on the strips with the reference's exact spherical mask (no
      square-support divergence at all), chunked over hills to bound the
      (H, G_others..., S) transient.

    Returns McGDPTables; commit with deposit_from_mcgdp (linear in
    height, so the bias-limiter machinery reuses one table build)."""
    spec = gg.spec
    g = spec.grid
    D = spec.dim
    assert D in (2, 3)
    dtype = gg.dtype
    x, hill_okf, per = _mcgdp_base(gg, centers)
    nonper = [d for d in range(D) if not spec.boundary_periodic[d]]
    assert nonper, "use dense_tables_sep for fully-periodic grids"
    dstar = nonper[-1]

    def fac_pow(d, p):
        iv = per[d]["inv_fac"]
        if isinstance(iv, float):
            return iv**p
        return iv**p

    # ---- separable (decaying) terms
    def sepf(d, *, t5=False, dden=False, facpow=1, upto=None):
        ent = per[d]
        f = ent["m"] * ent["e"]
        if d <= upto and facpow:
            f = f * fac_pow(d, facpow)
        if t5:
            f = f * (-2.0 * ent["dp"] / spec.sigma[d])
        if dden:
            f = f * (-per[d]["dden"])[None, :]
        return f

    def sep_term(*, upto, facpow=1, t5_dim=None, dden_dim=None):
        out = []
        for d in range(D):
            f = sepf(
                d, t5=(d == t5_dim), dden=(d == dden_dim),
                facpow=facpow, upto=upto,
            )
            if d == 0:
                f = f * hill_okf[:, None]
            out.append(f)
        return tuple(out)

    sep_value = sep_term(upto=D - 1)
    sep_grads = []
    for gd in range(D):
        terms = []
        if spec.boundary_periodic[gd]:
            # dd = t5 * expo / D_tot (reference ignores correction terms in
            # periodic-dim gradients)
            terms.append(sep_term(upto=D - 1, t5_dim=gd))
        else:
            # t5 * e / D_{<=g}
            terms.append(sep_term(upto=gd, t5_dim=gd))
            # -den'_g * e / D_{<=g}^2
            terms.append(sep_term(upto=gd, facpow=2, dden_dim=gd))
        sep_grads.append(tuple(terms))

    # ---- unit integral s: separable part + value-correction strip part
    vol = np.asarray(np.prod(g.dx), dtype)
    s = jnp.ones((x.shape[0],), dtype)
    for f in sep_value:
        s = s * jnp.sum(f, axis=1)
    sv = _mcgdp_strip_value(gg, per, dstar, hill_okf, heights=None)
    # sv is (H,) unit-integral of the strip correction when heights is None
    s = (s + sv) * vol
    return McGDPTables(
        sep_value=sep_value, sep_grads=tuple(sep_grads),
        strip_cache=dict(per=per, dstar=dstar, hill_okf=hill_okf, x=x), s=s,
    )


# hill-chunk budget for the dense strip transients (elements of the
# (chunk, G_others..., S) block; ~16 MB f32 / 32 MB f64 per chunk)
_STRIP_CHUNK_ELEMS = 1 << 22


def _strip_chunk_fields(gg, per, d_strip, sl):
    """Dense spherical-mask ingredient tensors on dim ``d_strip``'s
    boundary strip for the hill slice ``sl``: (others, strip rows, valid,
    e), each field of shape (h, G_others..., S).  Axis order is (hill,
    other dims in ascending order, strip rows); the caller restores grid
    dim order."""
    D = len(per)
    others = [d for d in range(D) if d != d_strip]
    es = per[d_strip]
    strip = es["strip"]
    dp2s = es["dp2"][sl][:, strip]  # (h, S)
    if D == 2:
        dp2 = per[others[0]]["dp2"][sl][:, :, None] + dp2s[:, None, :]
    else:
        dp2 = (
            per[others[0]]["dp2"][sl][:, :, None, None]
            + per[others[1]]["dp2"][sl][:, None, :, None]
            + dp2s[:, None, None, :]
        )
    valid = (dp2 < GAUSS_SUPPORT + 1e-12).astype(gg.dtype)
    # per-point boundary masks of EVERY non-periodic dim
    for i, o in enumerate(others):
        if "pm" in per[o]:
            shape = [1] * (D + 1)
            shape[1 + i] = -1
            valid = valid * per[o]["pm"].reshape(shape)
    valid = valid * es["pm"][strip].reshape((1,) * D + (-1,))
    e = jnp.exp(-dp2)
    return others, strip, valid, e


def _running_inv_den(per, upto, others, d_strip, strip, power=1):
    """Per-axis factors of 1/D_{<=upto}^power: a list aligned with
    ``others`` (scalars or (G_o,) arrays) plus the strip-axis factor."""
    fac_o = [1.0] * len(others)
    fac_s = 1.0
    for k in range(upto + 1):
        iv = per[k]["inv_fac"]
        if k == d_strip:
            fac_s = (iv if isinstance(iv, float) else iv[strip]) ** power
        elif k in others:
            fac_o[others.index(k)] = (
                iv if isinstance(iv, float) else iv
            ) ** power
    return fac_o, fac_s


def _strip_apply_fac(field, fac_o, fac_s, D):
    """Multiply per-axis running-denominator factors onto a
    (h, G_others..., S) field."""
    for i, fo in enumerate(fac_o):
        if not isinstance(fo, float):
            shape = [1] * (D + 1)
            shape[1 + i] = -1
            field = field * fo.reshape(shape)
        elif fo != 1.0:
            field = field * fo
    if not isinstance(fac_s, float):
        field = field * fac_s.reshape((1,) * D + (-1,))
    elif fac_s != 1.0:
        field = field * fac_s
    return field


def _strip_hill_chunks(per, d_strip, H):
    """(chunk size, padded H) for the strip scan over hills."""
    D = len(per)
    others = [d for d in range(D) if d != d_strip]
    block = int(len(per[d_strip]["strip"]))
    for o in others:
        block *= int(per[o]["dp2"].shape[1])
    ch = max(1, min(H, _STRIP_CHUNK_ELEMS // max(1, block)))
    return ch, -(-H // ch) * ch


def _pad_h(a, Hp):
    """Zero-pad a leading-hill-axis array to Hp rows."""
    H = a.shape[0]
    if Hp == H:
        return a
    return jnp.concatenate(
        [a, jnp.zeros((Hp - H,) + a.shape[1:], a.dtype)], axis=0
    )


def _mcgdp_strip_value(gg, per, dstar, hill_okf, heights):
    """Value-correction field on dim dstar's strip.

    heights=None: return the per-hill unit integral (H,) of the strip
    correction.  heights (H,): return the (G_others..., S) field summed
    over hills.  Both scan over hill chunks to bound the dense
    transient."""
    D = len(per)
    es = per[dstar]
    others = [d for d in range(D) if d != dstar]
    strip = es["strip"]
    H = hill_okf.shape[0]
    s2 = jnp.asarray(es["s2"])[strip].reshape((1,) * D + (-1,))
    s4 = jnp.asarray(es["s4"])[strip].reshape((1,) * D + (-1,))
    fac_o, fac_s = _running_inv_den(per, dstar, others, dstar, strip, 1)
    hsh = (-1,) + (1,) * D

    def corr_of(sl):
        _, _, valid, e = _strip_chunk_fields(gg, per, dstar, sl)
        t1 = es["t1"][sl].reshape(hsh)
        t3 = es["t3"][sl].reshape(hsh)
        corr = ((t1 - e) * s2 + (t3 - e) * s4) * valid
        corr = corr * hill_okf[sl].reshape(hsh)
        return _strip_apply_fac(corr, fac_o, fac_s, D)

    ch, Hp = _strip_hill_chunks(per, dstar, H)
    if Hp == H and Hp == ch:
        corr = corr_of(slice(None))
        if heights is None:
            return jnp.sum(corr, axis=tuple(range(1, D + 1)))
        return jnp.tensordot(
            jnp.asarray(heights, gg.dtype), corr, axes=(0, 0),
            precision=jax.lax.Precision.HIGHEST,
        )

    idx = jnp.arange(Hp).reshape(-1, ch)
    if heights is None:
        def body(_, sl):
            c = corr_of(sl)
            return None, jnp.sum(c, axis=tuple(range(1, D + 1)))

        _, sums = jax.lax.scan(lambda c, sl: body(c, sl), None, idx)
        return sums.reshape(-1)[:H]

    hts = _pad_h(jnp.asarray(heights, gg.dtype), Hp)

    def body_h(acc, sl):
        c = corr_of(sl)
        return acc + jnp.tensordot(
            hts[sl], c, axes=(0, 0), precision=jax.lax.Precision.HIGHEST
        ), None

    shape = tuple(int(per[o]["dp2"].shape[1]) for o in others) + (
        len(strip),
    )
    acc0 = jnp.zeros(shape, gg.dtype)
    acc, _ = jax.lax.scan(body_h, acc0, idx)
    return acc


def _mcgdp_strip_grad(gg, per, gdim, hill_okf, heights):
    """Gradient-correction field of McGDP dim ``gdim`` on its own strip:
    -t5 e (s2+s4)/D_{<=g} + (t1-e) t6/D + (t3-e) t7/D
    - den'_g [(t1-e)s2 + (t3-e)s4]/D^2, all under the spherical mask.
    Returns the (G_others..., S) field summed over hills (chunked)."""
    D = len(per)
    es = per[gdim]
    others = [d for d in range(D) if d != gdim]
    strip = es["strip"]
    spec = gg.spec
    sig = spec.sigma[gdim]
    H = hill_okf.shape[0]
    ssh = (1,) * D + (-1,)
    s2 = jnp.asarray(es["s2"])[strip].reshape(ssh)
    s4 = jnp.asarray(es["s4"])[strip].reshape(ssh)
    t6 = jnp.asarray(es["t6"])[strip].reshape(ssh)
    t7 = jnp.asarray(es["t7"])[strip].reshape(ssh)
    dden = jnp.asarray(es["dden"])[strip].reshape(ssh)
    fac1 = _running_inv_den(per, gdim, others, gdim, strip, 1)
    fac2 = _running_inv_den(per, gdim, others, gdim, strip, 2)
    hsh = (-1,) + (1,) * D
    t5sh = (-1,) + (1,) * (D - 1) + (len(strip),)

    def field_of(sl):
        _, _, valid, e = _strip_chunk_fields(gg, per, gdim, sl)
        t1 = es["t1"][sl].reshape(hsh)
        t3 = es["t3"][sl].reshape(hsh)
        t5 = (-2.0 * es["dp"][sl][:, strip] / sig).reshape(t5sh)
        f1 = -t5 * e * (s2 + s4)
        f1 = f1 + (t1 - e) * t6 + (t3 - e) * t7
        f1 = _strip_apply_fac(f1, *fac1, D)
        f2 = -((t1 - e) * s2 + (t3 - e) * s4)
        f2 = _strip_apply_fac(f2 * dden, *fac2, D)
        return (f1 + f2) * valid * hill_okf[sl].reshape(hsh)

    hts = jnp.asarray(heights, gg.dtype)
    ch, Hp = _strip_hill_chunks(per, gdim, H)
    if Hp == H and Hp == ch:
        return jnp.tensordot(
            hts, field_of(slice(None)), axes=(0, 0),
            precision=jax.lax.Precision.HIGHEST,
        )
    hts = _pad_h(hts, Hp)
    idx = jnp.arange(Hp).reshape(-1, ch)

    def body(acc, sl):
        return acc + jnp.tensordot(
            hts[sl], field_of(sl), axes=(0, 0),
            precision=jax.lax.Precision.HIGHEST,
        ), None

    shape = tuple(int(per[o]["dp2"].shape[1]) for o in others) + (
        len(strip),
    )
    acc, _ = jax.lax.scan(body, jnp.zeros(shape, gg.dtype), idx)
    return acc


# Hill-compaction capacity for the deposit's strip passes (floor of
# max(this, H // 8)).  The dense (hills, G_others..., S) strip fields are
# the dominant cost of a McGDP deposit at production hill loads, yet a
# hill contributes to dim d's strip ONLY if it sits within
# (BC_MAR + sqrt(GAUSS_SUPPORT)) * sigma'_d of a boundary (the spherical
# mask `valid` is exactly zero otherwise) — typically a few % of the
# batch.  deposit_from_mcgdp rank-compacts contributing hills to this
# capacity (recomputing their per-dim fields from the compacted centers:
# gathers touch only (H,)-scalars, never (H, G) rows) and falls back
# in-graph to the dense full-batch pass if more hills reach the strip.
_STRIP_COMPACT_CAP = 256


def _strip_field_compact(gg, tabs, heights, d_strip, kind):
    """(G_others..., S) strip field of dim ``d_strip`` (value or grad),
    summed over hills — via near-boundary hill compaction with a dense
    fallback (see _STRIP_COMPACT_CAP)."""
    spec = gg.spec
    per = tabs.strip_cache["per"]
    hill_okf = tabs.strip_cache["hill_okf"]
    x = tabs.strip_cache["x"]
    fn = _mcgdp_strip_value if kind == "value" else _mcgdp_strip_grad
    H = heights.shape[0]
    cap_s = max(_STRIP_COMPACT_CAP, H // 8)
    if cap_s >= H:
        return fn(gg, per, d_strip, hill_okf, heights)

    sig = spec.sigma[d_strip]
    reach = (BC_MAR + math.sqrt(GAUSS_SUPPORT)) * sig + float(
        spec.grid.dx[d_strip]
    )
    bmin = spec.boundary_min[d_strip]
    bmax = spec.boundary_max[d_strip]
    xd = x[:, d_strip]
    near = (jnp.abs(xd - bmin) < reach) | (jnp.abs(xd - bmax) < reach)
    near = near & (heights != 0)
    ranks = jnp.cumsum(near.astype(jnp.int32)) - 1
    count = jnp.sum(near.astype(jnp.int32))
    tgt = jnp.where(near & (ranks < cap_s), ranks, cap_s)
    hidx = jnp.arange(H, dtype=jnp.int32)
    idx = jnp.zeros((cap_s,), jnp.int32).at[tgt].set(hidx, mode="drop")
    keep = jnp.arange(cap_s) < count
    xc = x[idx]  # (cap_s, D) — scalar-row gather only
    hc = jnp.where(keep, heights[idx], 0)

    def compacted(_):
        _, okf_c, per_c = _mcgdp_base(gg, xc)
        return fn(gg, per_c, d_strip, okf_c, hc)

    def dense(_):
        return fn(gg, per, d_strip, hill_okf, heights)

    return jax.lax.cond(count <= cap_s, compacted, dense, None)


def deposit_from_mcgdp(gg: GaussGrid, tabs: McGDPTables, heights):
    """Commit a 2-D/3-D McGDP deposit: separable einsum terms + strip
    fields (near-boundary hill compaction, _strip_field_compact), then
    boundary-row duplication."""
    spec = gg.spec
    D = spec.dim
    heights = jnp.asarray(heights, gg.dtype)
    hp = jax.lax.Precision.HIGHEST
    per = tabs.strip_cache["per"]
    dstar = tabs.strip_cache["dstar"]
    hill_okf = tabs.strip_cache["hill_okf"]
    axes = "xyz"[:D]
    spec_str = ",".join(f"h{a}" for a in axes) + "->" + axes

    def contract(fs):
        ops = [heights[:, None] * fs[0]] + list(fs[1:])
        return jnp.einsum(spec_str, *ops, precision=hp)

    def place(field, d_strip):
        """(G_others..., S) strip field -> full-grid array (grid dim
        order restored by moving the strip axis into place).  The strip
        is a union of CONTIGUOUS row runs (one per boundary), so the
        placement is static slice-adds — an integer-array index here
        would lower to an XLA scatter (~0.4 ms per pass at 1e6 grids
        at the measured scatter rate)."""
        strip = per[d_strip]["strip"]  # numpy, trace-time
        segs = np.split(
            np.arange(len(strip)), np.where(np.diff(strip) > 1)[0] + 1
        )
        out = jnp.zeros(spec.grid.nbins, gg.dtype)
        f = jnp.moveaxis(field, -1, d_strip)
        for seg in segs:
            a = int(strip[seg[0]])
            b = int(strip[seg[-1]]) + 1
            fsl = jax.lax.slice_in_dim(
                f, int(seg[0]), int(seg[-1]) + 1, axis=d_strip
            )
            idx = tuple(
                slice(a, b) if k == d_strip else slice(None)
                for k in range(D)
            )
            out = out.at[idx].add(fsl)
        return out

    values = gg.grid.values + contract(tabs.sep_value)
    values = values + place(
        _strip_field_compact(gg, tabs, heights, dstar, "value"), dstar
    )
    derivs = gg.grid.derivs
    for d in range(D):
        dd = jnp.zeros(spec.grid.nbins, gg.dtype)
        for fs in tabs.sep_grads[d]:
            dd = dd + contract(fs)
        if not spec.boundary_periodic[d]:
            dd = dd + place(
                _strip_field_compact(gg, tabs, heights, d, "grad"), d
            )
        derivs = derivs.at[..., d].add(dd)
    grid = dataclasses.replace(gg.grid, values=values, derivs=derivs)
    out = dataclasses.replace(gg, grid=grid)
    return duplicate_boundary(out)


# backward-compatible 2-D names
McGDP2DTables = McGDPTables
dense_tables_mcgdp_2d = dense_tables_mcgdp
deposit_from_mcgdp_2d = deposit_from_mcgdp


# backward-compatible 2-D wrappers
def dense_tables_2d(gg: GaussGrid, centers: jax.Array):
    tabs, s = dense_tables_sep(gg, centers)
    (ux, dux), (uy, duy) = tabs
    return ux, uy, dux, duy, s


def deposit_from_tables_2d(gg: GaussGrid, ux, uy, dux, duy, heights):
    return deposit_from_tables_sep(gg, [(ux, dux), (uy, duy)], heights)


def deposit_from_tables(gg: GaussGrid, Mval, Mder, heights, boundary_offset=None):
    """Commit a dense-table deposit (matvec; no scatter)."""
    heights = jnp.asarray(heights, gg.dtype)
    hp = jax.lax.Precision.HIGHEST
    values = gg.grid.values + jnp.matmul(Mval, heights, precision=hp)
    derivs = gg.grid.derivs + jnp.matmul(Mder, heights, precision=hp)[:, None]
    grid = dataclasses.replace(gg.grid, values=values, derivs=derivs)
    out = dataclasses.replace(gg, grid=grid)
    if any(not p for p in gg.spec.boundary_periodic):
        out = duplicate_boundary(out, boundary_offset)
    return out


def _duplication_assignments(spec):
    """Static (outer, bound) single-point copies for zero-force boundary rows
    (reference duplicate_boundary, gaussian_grid.h:571-630)."""
    g = spec.grid
    D = spec.dim
    min_i, max_i = [], []
    for d in range(D):
        for which, b in (("lo", spec.boundary_min[d]), ("hi", spec.boundary_max[d])):
            xi = b
            if g.periodic[d]:
                L = g.max[d] - g.min[d]
                xi -= L * math.floor((xi - g.min[d]) / L)
            i = int(math.floor((xi - g.min[d]) / g.dx[d]))
            if which == "lo":
                lo = i
            else:
                hi = i
        while lo * g.dx[d] + g.min[d] < spec.boundary_min[d]:
            lo += 1
        while hi * g.dx[d] + g.min[d] > spec.boundary_max[d] or hi == g.nbins[d]:
            hi -= 1
        min_i.append(lo)
        max_i.append(hi)

    assignments = []
    for combo in range(4**D):
        temp = combo
        outer, bound = [], []
        skip = False
        for d in range(D):
            off = temp % 4
            temp //= 4
            if off == 0:
                if spec.boundary_periodic[d] or min_i[d] == 0:
                    skip = True
                outer.append(min_i[d] - 1)
                bound.append(min_i[d])
            elif off == 1:
                outer.append(min_i[d])
                bound.append(min_i[d])
            elif off == 2:
                outer.append(max_i[d])
                bound.append(max_i[d])
            else:
                if spec.boundary_periodic[d] or max_i[d] == g.nbins[d] - 1:
                    skip = True
                outer.append(max_i[d] + 1)
                bound.append(max_i[d])
        if not skip:
            assignments.append((tuple(outer), tuple(bound)))
    return assignments


def _duplicate_boundary_dynamic(gg: GaussGrid, boundary_offset) -> GaussGrid:
    """Offset-aware boundary duplication: the reference's 4^D combo copies
    (gaussian_grid.h:571-630) with per-dim boundary indices computed
    in-graph from the shifted boundary.  Combos whose boundary row lies
    outside this grid are predicated off (mid-slab devices of a sharded
    non-periodic dim have no boundary in range, so their copies no-op)."""
    spec = gg.spec
    g = spec.grid
    D = spec.dim
    dtype = gg.dtype
    values = gg.grid.values

    min_i, max_i = [], []
    for d in range(D):
        off_d = boundary_offset[d]
        blo = spec.boundary_min[d] - off_d  # boundary in LOCAL coordinates
        bhi = spec.boundary_max[d] - off_d
        dx = g.dx[d]
        gmin = g.min[d]
        nb = g.nbins[d]
        lo = jnp.floor((blo - gmin) / dx).astype(jnp.int32)
        for _ in range(2):  # the reference's while-adjust, unrolled
            lo = jnp.where(lo.astype(dtype) * dx + gmin < blo, lo + 1, lo)
        hi = jnp.floor((bhi - gmin) / dx).astype(jnp.int32)
        for _ in range(2):
            hi = jnp.where(
                (hi.astype(dtype) * dx + gmin > bhi) | (hi == nb), hi - 1, hi
            )
        min_i.append(lo)
        max_i.append(hi)

    for combo in range(4**D):
        temp = combo
        outer, bound = [], []
        valid = jnp.ones((), bool)
        for d in range(D):
            off = temp % 4
            temp //= 4
            nb = g.nbins[d]
            in_rng = (min_i[d] >= 0) & (max_i[d] <= nb - 1) & (min_i[d] <= max_i[d])
            if off == 0:
                valid &= (not spec.boundary_periodic[d]) & (min_i[d] >= 1) & in_rng
                outer.append(jnp.clip(min_i[d] - 1, 0, nb - 1))
                bound.append(jnp.clip(min_i[d], 0, nb - 1))
            elif off == 1:
                valid &= in_rng
                outer.append(jnp.clip(min_i[d], 0, nb - 1))
                bound.append(jnp.clip(min_i[d], 0, nb - 1))
            elif off == 2:
                valid &= in_rng
                outer.append(jnp.clip(max_i[d], 0, nb - 1))
                bound.append(jnp.clip(max_i[d], 0, nb - 1))
            else:
                valid &= (
                    (not spec.boundary_periodic[d]) & (max_i[d] <= nb - 2) & in_rng
                )
                outer.append(jnp.clip(max_i[d] + 1, 0, nb - 1))
                bound.append(jnp.clip(max_i[d], 0, nb - 1))
        src = values[tuple(bound)]
        cur = values[tuple(outer)]
        values = values.at[tuple(outer)].set(jnp.where(valid, src, cur))
    grid = dataclasses.replace(gg.grid, values=values)
    return dataclasses.replace(gg, grid=grid)


def duplicate_boundary(gg: GaussGrid, boundary_offset=None) -> GaussGrid:
    """Copy boundary values outward so out-of-boundary bias stays flat
    (zero force).  Values only — gradients outside the boundary are never
    deposited and stay 0, matching the reference.  With
    ``boundary_offset``, boundary indices are computed in-graph (sharded
    local-coordinate grids with a global boundary)."""
    if boundary_offset is not None:
        return _duplicate_boundary_dynamic(gg, boundary_offset)
    values = gg.grid.values
    for outer, bound in _duplication_assignments(gg.spec):
        values = values.at[outer].set(values[bound])
    grid = dataclasses.replace(gg.grid, values=values)
    return dataclasses.replace(gg, grid=grid)


def deposit_precomputed(gg: GaussGrid, hw: HillWindows, heights: jax.Array,
                        boundary_offset=None):
    """Scatter-commit precomputed unit windows scaled by per-hill heights.

    Splitting window evaluation from the scatter lets the bias-limiting
    prefix pass (which needs per-hill integrals *before* choosing effective
    heights) reuse one window evaluation — the windows depend only on
    geometry, never on grid contents or heights."""
    dtype = gg.dtype
    heights = jnp.asarray(heights, dtype)
    vol = np.asarray(np.prod(gg.spec.grid.dx), dtype)

    contrib = heights[:, None] * hw.value_w  # (H, W)
    bias_added = jnp.sum(contrib, axis=-1) * vol

    gather = tuple(jnp.moveaxis(hw.idx, -1, 0))
    values = gg.grid.values.at[gather].add(contrib)
    dcontrib = heights[:, None, None] * hw.deriv_w
    derivs = gg.grid.derivs.at[gather].add(dcontrib)

    grid = dataclasses.replace(gg.grid, values=values, derivs=derivs)
    out = dataclasses.replace(gg, grid=grid)
    if any(not p for p in gg.spec.boundary_periodic):
        out = duplicate_boundary(out, boundary_offset)
    return out, bias_added


def deposit(gg: GaussGrid, centers: jax.Array, heights: jax.Array):
    """Deposit hills; returns (new GaussGrid, per-hill bias_added (H,)).

    Linear in height: sequential reference deposition of the same centers
    and heights yields the same grid (scatter-add is order-free).

    Every grid takes the support-window scatter: on an H100 it beat the
    dense (grid x hills) 1-D matmul form at both 1-D shapes the hosts use
    (151-point pair-CV grid, 2048 hills; 1e6-point grid with an 11,313-point
    window, 200 hills — see PERF.md)."""
    return deposit_precomputed(gg, hill_windows(gg, centers), heights)
