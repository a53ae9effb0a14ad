"""Cell-lattice pair force pass as a Pallas kernel through Triton (NVIDIA GPU).

Same contract as ``ops.cellforce.lattice_force_xla`` (full stencil, no
Newton credits, rows optionally restricted to a sub-box).  One program
per row cell:

  - the program loads its own cell's slots (positions and row mask) and
    walks the 27 neighbour cells, computing each neighbour's flat id from
    the lattice coordinates (periodic wrap) and loading its slots
    directly: no rolled candidate views are built in device memory;
  - each neighbour is swept in blocks of ``BLOCK`` candidate slots, only
    up to the block holding its highest occupied slot (a per-cell count
    computed in the wrapper), so the loop follows real occupancy and not
    the padded cap;
  - the pair tile (cap x BLOCK) stays in registers: minimum image, LJ,
    the bias table lookup and the row sums;
  - the exact lookup fetches its monomial Hermite coefficients by index
    from the (4, G) table in device memory (a few KB, cache resident);
    the Chebyshev lookup runs its Clenshaw chain in registers with
    scalar coefficient loads.

Full stencil rather than a half stencil with atomically added Newton
credits: twice the pair arithmetic, but deterministic, no atomics, and a
row's force is finished inside its own program, which is what the
sharded hosts' owned-row passes need.

``interpret=True`` runs the kernel in the Pallas interpreter (any
backend); otherwise Pallas compiles it for the GPU and refuses other
backends.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .cellforce import SELF_OFFSET, HermiteTable, hermite_pair_table, _place_rows, _row_box

# candidate slots per inner block and the launch shape, from a sweep of
# block 8/16/32 x 1/2/4/8 warps x 1/2 stages on an H100 at 10k and 100k
# atoms (force_ab.py; PERF.md): block 8 with 4 warps and 1 stage was
# fastest at 10k, and at 100k the best shapes lie within one shape's
# spread between two measurements
BLOCK = 8
NUM_WARPS = 4
NUM_STAGES = 1


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _hermite(tab_ref, r, ok, geom, energy):
    G, glo, gdx, ghi_eff, blo, bhi = geom
    on = ok & (r >= blo) & (r <= bhi) & (r >= glo) & (r < ghi_eff)
    idxf = jnp.clip(jnp.floor((r - glo) / gdx), 0.0, float(G - 1))
    t = (r - glo - idxf * gdx) / gdx
    idx = idxf.astype(jnp.int32)
    b0 = tab_ref[idx + G]
    c0 = tab_ref[idx + 2 * G]
    d0 = tab_ref[idx + 3 * G]
    der = jnp.where(on, b0 + t * (c0 + t * d0), 0.0)
    if not energy:
        return None, der
    a0 = tab_ref[idx]
    val = a0 + (t * gdx) * (b0 + t * (0.5 * c0 + (1.0 / 3.0) * (t * d0)))
    return jnp.where(on, val, 0.0), der


def _cheb(cv_ref, cd_ref, r, ok, geom, energy):
    deg, npanels, lo, hi = geom
    on = ok & (r >= lo) & (r <= hi)
    rc = jnp.clip(r, lo, hi)
    stride = deg + 1
    if npanels == 1:
        t = (2.0 * rc - (lo + hi)) / (hi - lo)
        masks = []
    else:
        pw = (hi - lo) / npanels
        pf = jnp.clip(jnp.floor((rc - lo) / pw), 0.0, float(npanels - 1))
        t = jnp.clip((2.0 * (rc - lo - pf * pw) - pw) / pw, -1.0, 1.0)
        masks = [pf >= p for p in range(1, npanels)]

    def coef(ref, k):
        v = ref[k]
        for p, m in enumerate(masks, start=1):
            v = jnp.where(m, ref[p * stride + k], v)
        return v

    t2 = 2.0 * t
    z = jnp.zeros_like(t)
    b1, b2, d1, d2 = z, z, z, z
    for k in range(deg, 0, -1):
        if energy:
            b1, b2 = coef(cv_ref, k) + t2 * b1 - b2, b1
        d1, d2 = coef(cd_ref, k) + t2 * d1 - d2, d1
    der = jnp.where(on, coef(cd_ref, 0) + t * d1 - d2, 0.0)
    if not energy:
        return None, der
    return jnp.where(on, coef(cv_ref, 0) + t * b1 - b2, 0.0), der


def _kernel(*refs, cfg):
    (capp, block, ncells, origin, rdims, box, lj, tpair, table_kind, geom,
     energy) = cfg
    n_tab = 1 if table_kind == "hermite" else 2
    n_in = 6 + (tpair is not None) + n_tab
    ins, (fx_ref, fy_ref, fz_ref, e_ref) = refs[:n_in], refs[n_in:]
    x_ref, y_ref, z_ref, mc_ref, mr_ref, nblk_ref = ins[:6]
    t_ref = ins[6] if tpair is not None else None
    tab_refs = ins[n_in - n_tab:]
    nx, ny, nz = ncells
    bx, by, bz = box
    eps, sig, rcut = lj
    # non-negative int32 arithmetic: lax.div/rem lower directly (jnp's
    # floor-division and modulo add sign fix-ups the route rejects), and
    # explicit int32 constants keep x64 mode from promoting them
    i32 = jnp.int32
    div = lambda a, b: jax.lax.div(a, i32(b))
    rem = lambda a, b: jax.lax.rem(a, i32(b))
    p = pl.program_id(0)
    rz = rem(p, rdims[2])
    ry = rem(div(p, rdims[2]), rdims[1])
    ix = div(p, rdims[1] * rdims[2]) + i32(origin[0])
    iy = ry + i32(origin[1])
    iz = rz + i32(origin[2])
    base = (ix * i32(ny * nz) + iy * i32(nz) + iz) * i32(capp)
    row = pl.ds(base, capp)
    xi, yi, zi = x_ref[row], y_ref[row], z_ref[row]
    mi = mr_ref[row] > 0.5
    ti = t_ref[row] if tpair is not None else None
    slot = jax.lax.broadcasted_iota(jnp.int32, (capp, block), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (capp, block), 1)

    def mimage(d, L):
        return d - jnp.floor(d * (1.0 / L) + 0.5) * L

    def neighbour(k, acc):
        jx = rem(ix + div(k, 9) + i32(nx - 1), nx)
        jy = rem(iy + rem(div(k, 3), 3) + i32(ny - 1), ny)
        jz = rem(iz + rem(k, 3) + i32(nz - 1), nz)
        cj = jx * i32(ny * nz) + jy * i32(nz) + jz
        is_self = k == i32(SELF_OFFSET)

        def blk(b, acc):
            fx, fy, fz, e = acc
            cand = pl.ds(cj * i32(capp) + b * i32(block), block)
            dx = mimage(xi[:, None] - x_ref[cand][None, :], bx)
            dy = mimage(yi[:, None] - y_ref[cand][None, :], by)
            dz = mimage(zi[:, None] - z_ref[cand][None, :], bz)
            ok = mi[:, None] & (mc_ref[cand] > 0.5)[None, :]
            ok = ok & ~(is_self & (slot == col + b * i32(block)))
            r2 = dx * dx + dy * dy + dz * dz
            r2s = jnp.where(ok, jnp.maximum(r2, 1e-12), 1.0)
            # r from a correctly rounded sqrt, as the XLA pass takes it: the
            # LJ cutoff test and the table's interval index then fall on
            # the same side of their edges in both implementations
            r = jnp.sqrt(r2s)
            inv_r = jax.lax.rsqrt(r2s)
            inv_r2 = inv_r * inv_r
            sr2 = (sig * sig) * inv_r2
            sr6 = sr2 * sr2 * sr2
            f_over_r = jnp.where(
                ok & (r < rcut),
                4.0 * eps * (12.0 * sr6 * sr6 - 6.0 * sr6) * inv_r2, 0.0,
            )
            ok_cv = ok
            if tpair is not None:
                tj = t_ref[cand][None, :]
                a, c = tpair
                tl = ti[:, None]
                ok_cv = ok & (((tl == a) & (tj == c)) | ((tl == c) & (tj == a)))
            if table_kind == "hermite":
                val, der = _hermite(tab_refs[0], r, ok_cv, geom, energy)
            else:
                val, der = _cheb(tab_refs[0], tab_refs[1], r, ok_cv, geom, energy)
            f_over_r = f_over_r - der * inv_r
            fx = fx + jnp.sum(f_over_r * dx, axis=1)
            fy = fy + jnp.sum(f_over_r * dy, axis=1)
            fz = fz + jnp.sum(f_over_r * dz, axis=1)
            if energy:
                e = e + jnp.sum(val, axis=1)
            return fx, fy, fz, e

        return jax.lax.fori_loop(i32(0), nblk_ref[cj], blk, acc)

    zero = jnp.zeros((capp,), jnp.float32)
    # rows without a real atom skip the stencil walk entirely
    n_off = jnp.where(jnp.sum(mi.astype(jnp.int32)) > 0, i32(27), i32(0))
    fx, fy, fz, e = jax.lax.fori_loop(i32(0), n_off, neighbour, (zero,) * 4)
    out = pl.ds(p * i32(capp), capp)
    fx_ref[out] = fx
    fy_ref[out] = fy
    fz_ref[out] = fz
    e_ref[out] = e


def lattice_force_triton(
    xs, mc_rows, mc_cand, ncells, box, lj, table, energy=True,
    ts=None, type_pair=None, row_box=None, interpret=False,
):
    """Triton kernel form of ``ops.cellforce.lattice_force_xla``; same
    arguments and result.  ``cap`` is padded to a power of two here (the
    route's tensors must have power-of-two sizes); padded slots carry
    zero masks."""
    from .chebyshev import ChebTable

    if xs.dtype != jnp.float32:
        raise ValueError("the Triton force kernel is float32 only")
    C, cap = mc_rows.shape
    capp = max(_next_pow2(cap), 16)
    block = min(BLOCK, capp)
    origin, rdims = _row_box(ncells, row_box)
    R = rdims[0] * rdims[1] * rdims[2]

    def slots(a):
        a = a.astype(jnp.float32)
        if capp > cap:
            a = jnp.pad(a, ((0, 0), (0, capp - cap)))
        return a.reshape(-1)

    x, y, z = (slots(xs[..., c]) for c in range(3))
    mc, mr = slots(mc_cand), slots(mc_rows)
    # candidate blocks to sweep per cell: up to the highest occupied slot
    # (incremental rebins leave holes, so occupancy is not a prefix count)
    top = jnp.max(
        jnp.where(mc_cand > 0.5, jnp.arange(1, cap + 1, dtype=jnp.int32), 0),
        axis=1,
    )
    nblk = ((top + block - 1) // block).astype(jnp.int32)
    inputs = [x, y, z, mc, mr, nblk]
    tpair = None
    if ts is not None and type_pair is not None:
        inputs.append(slots(ts))
        tpair = (float(type_pair[0]), float(type_pair[1]))
    if isinstance(table, ChebTable):
        cv = table.cval if table.cval.ndim == 2 else table.cval[None, :]
        cd = table.cder if table.cder.ndim == 2 else table.cder[None, :]
        inputs += [cv.astype(jnp.float32).reshape(-1), cd.astype(jnp.float32).reshape(-1)]
        kind = "cheb"
        geom = (cv.shape[1] - 1, cv.shape[0], float(table.lo), float(table.hi))
    else:
        ht = table if isinstance(table, HermiteTable) else hermite_pair_table(table)
        inputs.append(ht.tab.astype(jnp.float32).reshape(-1))
        kind = "hermite"
        geom = ht.geom
    cfg = (
        capp, block, tuple(int(n) for n in ncells), origin, rdims,
        tuple(float(b) for b in box),
        (float(lj.epsilon), float(lj.sigma), float(lj.rcut)),
        tpair, kind, geom, bool(energy),
    )
    out = jax.ShapeDtypeStruct((R * capp,), jnp.float32)
    fx, fy, fz, e = pl.pallas_call(
        functools.partial(_kernel, cfg=cfg),
        grid=(R,),
        out_shape=[out] * 4,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="cell_lattice_force",
    )(*inputs)
    f_rows = jnp.stack(
        [a.reshape(R, capp)[:, :cap] for a in (fx, fy, fz)], axis=-1
    ).astype(xs.dtype)
    energy_val = 0.5 * jnp.sum(e) if energy else jnp.zeros((), xs.dtype)
    return energy_val.astype(xs.dtype), _place_rows(f_rows, ncells, origin, rdims)
