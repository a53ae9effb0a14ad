"""Smoke test of the EDM hosts on an NVIDIA GPU, through their normal entry
points.  Run from the root of the repository:

    python chip_smoke.py            # one card, phases 1-6
    python chip_smoke.py --multi    # four cards: the sharded hosts only

Phases on one card, in this one process:
  1. identity: JAX devices, device kind and count, and the card's name and
     power limit from nvidia-smi (read by a child process that never
     imports JAX); no GPU -> failure;
  2. the pairwise cell host at 100k atoms in the bench configuration
     (exact lookup), 100 steps through ``driver.pattern_segment`` so hill
     rounds and rebins run; prints ``compiled.memory_analysis()``;
  3. force parity: at 10k atoms the cell host's first-step forces and bias
     energy against the dense all-pairs host (``pair_edm_blocked``), for
     the exact and the Chebyshev lookup; at 100k atoms the production
     force implementation against the plain-XLA one, when they differ;
  4. the 2-D coordinate host on a 1e6-point grid, periodic and McGDP, 200
     steps; one hill round on the fast separable deposit against the same
     round under ``exact_deposit=True``;
  5. 1e6-point deposition of 200 hills against a float64 NumPy evaluation
     of the same Gaussians;
  6. lookup precision: ``grid_value_deriv`` at 1e6 points against a float64
     evaluation of the same Hermite formula (catches TF32).

``--multi`` runs only the four-card path and what it is compared with: the
slab host on 4 cards and the brick host on (2, 2) at 100k atoms against the
single-device host; the data-parallel pair host with bitwise replica
identity; the spatial coordinate host as 4 slabs and as (2, 2) bricks
against the serial engine.

Every phase prints its checks; any failure makes the exit code non-zero and
suppresses the final line.  On success the last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import sys
import time
import traceback

import numpy as np

# problem sizes (the bench's widths); the phases use these names only
N_PARITY = 10_000  # atoms, cell host vs dense host
N_HOST = 100_000  # atoms, the 100k pairwise cell
N_COORD = 10_000  # walkers on the 2-D coordinate host
GRID_1D = 1_000_000  # deposition grid points
N_LOOKUP = 1_000_000  # lookup precision points


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


# ------------------------------------------------------------------ phases


def phase_identity():
    import jax

    import bench

    devs = jax.devices()
    log("jax.devices():", devs)
    log("device_kind:", devs[0].device_kind, "count:", len(devs))
    check(devs[0].platform == "gpu", f"JAX platform is gpu (got {devs[0].platform!r})")
    log(bench.nvidia_smi_identity())
    return devs


def phase_pairwise_100k():
    import jax
    import jax.numpy as jnp

    import bench
    from edm_tpu.models.pair_edm_cells import init_cell_state

    params, core, spec, lp, lj = bench.pairwise_system(N_HOST, "interp")
    state = init_cell_state(spec, core)
    seg = bench.pairwise_segment(params, lp, lj, spec, 100)
    t0 = time.perf_counter()
    compiled = seg.lower(state).compile()
    log(f"  compiled 100-step segment in {time.perf_counter() - t0:.1f} s")
    log("  memory_analysis:", compiled.memory_analysis())
    t0 = time.perf_counter()
    state, ys = jax.block_until_ready(compiled(state))
    log(f"  100 steps in {time.perf_counter() - t0:.3f} s (first run)")
    check(bool(jnp.isfinite(jnp.sum(state.xs)) & jnp.all(jnp.isfinite(ys))),
          "state and energies finite")
    check(not bool(state.table_overflow), "no cell overflowed its cap")
    check(not bool(state.core.hills_truncated), "no hill round truncated")
    check(float(state.core.bias.cum_bias) > 0,
          f"bias deposited (cum_bias {float(state.core.bias.cum_bias):.6g})")


def phase_force_parity():
    import jax
    import jax.numpy as jnp

    import bench
    from edm_tpu.models.langevin import LangevinParams
    from edm_tpu.models.pair_edm_blocked import make_step_blocked
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.ops.cellforce import lattice_force

    # dt = 0: one step leaves the atoms in place, so both hosts report the
    # forces and bias energy at the same (initial) positions
    still = LangevinParams(dt=0.0, friction=0.0, kT=0.0)
    # Tolerances: both sides are float32 sums of ~60 partner terms taken
    # in different orders (27-cell stencil vs one dense row; 1/r by rsqrt
    # vs division), so forces agree to ~1e-6 of the largest force and the energy
    # (a sum over ~1e6 pairs) to ~1e-6 relative.  The bounds leave 100x
    # for that and stay 10x below what a TF32 product (~5e-4) would give.
    F_TOL, E_TOL = 1e-4, 1e-4
    for lookup in ("interp", "chebyshev"):
        params, core, spec, _, lj = bench.seeded_pairwise_system(N_PARITY, lookup)
        cell_step = jax.jit(make_cell_step(
            params, still, lj, spec, hill_stride=1, static_do_hills=False,
            static_do_rebuild=False, force_impl=bench.FORCE_IMPL,
        ))
        cs, ce = cell_step(init_cell_state(spec, core), None)
        n = spec.n_atoms
        idx = jnp.where(cs.aid < n, cs.aid, n)
        f_cell = jnp.zeros((n, 3)).at[idx].set(cs.fs.reshape(-1, 3), mode="drop")
        dense_step = jax.jit(make_step_blocked(
            params, still, lj, spec.box, hill_stride=1, block_size=500,
            static_do_hills=False,
        ))
        ds, de = dense_step(core, None)
        scale = float(jnp.abs(ds.f).max())
        ferr = float(jnp.abs(f_cell - ds.f).max()) / scale
        eerr = abs(float(ce) - float(de)) / abs(float(de))
        log(f"  10k {lookup}: max |f| {scale:.4g}, bias energy {float(de):.8g}")
        check(ferr < F_TOL, f"10k {lookup}: cell vs dense forces rel err {ferr:.3g} < {F_TOL}")
        check(eerr < E_TOL, f"10k {lookup}: cell vs dense bias energy rel err {eerr:.3g} < {E_TOL}")

    if bench.FORCE_IMPL == "xla":
        log("  100k: the production force pass is the plain-XLA one; nothing to compare")
        return
    for lookup in ("interp", "chebyshev"):
        params, core, spec, _, lj = bench.seeded_pairwise_system(N_HOST, lookup)
        st = init_cell_state(spec, core)
        table = core.cheb if core.cheb is not None else core.bias.bias
        out = {}
        for impl in ("xla", bench.FORCE_IMPL):
            out[impl] = jax.jit(lambda xs, mc, impl=impl: lattice_force(
                xs, mc, mc, spec.ncells, spec.box, lj, table, True,
                impl=impl, cell_chunk=81,
            ))(st.xs, st.mc)
        (e0, f0), (e1, f1) = out["xla"], out[bench.FORCE_IMPL]
        scale = float(jnp.abs(f0).max())
        ferr = float(jnp.abs(f1 - f0).max()) / scale
        eerr = abs(float(e1) - float(e0)) / abs(float(e0))
        check(ferr < F_TOL, f"100k {lookup}: {bench.FORCE_IMPL} vs xla forces rel err {ferr:.3g} < {F_TOL}")
        check(eerr < E_TOL, f"100k {lookup}: {bench.FORCE_IMPL} vs xla energy rel err {eerr:.3g} < {E_TOL}")


def phase_coord2d():
    import jax
    import jax.numpy as jnp

    from edm_tpu import bias as B
    from edm_tpu.models import coord_edm
    from edm_tpu.models.driver import strided_segment
    from edm_tpu.models.langevin import LangevinParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 250\n"
        "dimension 2\nbox_low 0 0\nbox_high 10 10\n"
        "bias_spacing 0.01 0.01\nbias_sigma 0.05 0.05\n"
    )
    lp = LangevinParams(dt=0.002, friction=1.0, kT=1.0)
    x0 = jnp.asarray(np.random.default_rng(77).uniform(0, 10, (N_COORD, 2)), jnp.float32)
    for mcgdp in (False, True):
        per = not mcgdp
        label = "McGDP" if mcgdp else "periodic"

        def setup(exact):
            return B.subdivide(
                cfg, 1.0, 1.0, [0, 0], [10, 10], [0, 0], [10, 10], [per, per],
                [0, 0], dtype=jnp.float32, exact_deposit=exact,
            )

        params, bias_state = setup(False)
        params_x, _ = setup(True)
        step_h = coord_edm.make_step(params, lp, hill_stride=10, static_do_hills=True)
        step_p = coord_edm.make_step(params, lp, hill_stride=10, static_do_hills=False)
        state = coord_edm.init_state(params, bias_state, x0, jax.random.PRNGKey(0), lp)
        seg = jax.jit(strided_segment(step_h, step_p, 10, 200))
        state, e = jax.block_until_ready(seg(state))
        check(bool(jnp.isfinite(jnp.sum(state.x)) & jnp.all(jnp.isfinite(e))),
              f"{label}: 200 steps finite")
        check(not bool(state.bias.overflow_error), f"{label}: no buffer overflow")
        check(float(state.bias.cum_bias) > 0, f"{label}: bias deposited")
        # one more hill round from the same state, fast path vs exact path
        step_x = coord_edm.make_step(params_x, lp, hill_stride=10, static_do_hills=True)
        g0 = state.bias.bias.grid.values
        fast, _ = jax.jit(step_h)(state, None)
        exact, _ = jax.jit(step_x)(state, None)
        d_fast = fast.bias.bias.grid.values - g0
        d_exact = exact.bias.bias.grid.values - g0
        scale = float(jnp.abs(d_exact).max())
        err = float(jnp.abs(d_fast - d_exact).max()) / scale
        # the separable deposit keeps the corners of the square support
        # that the reference's spherical cutoff drops: exp(-8) ~ 3.4e-4 of
        # a hill's peak, plus float32 rounding
        check(scale > 0 and err < 1e-3,
              f"{label}: one hill round, separable vs exact deposit rel err {err:.3g} < 1e-3")


def phase_deposition():
    import jax
    import jax.numpy as jnp

    from edm_tpu import GaussGrid

    G, H, sigma, L = GRID_1D, 200, 0.01, 10.0
    dx = L / G
    g = GaussGrid.create([0], [L], [dx], [True], [sigma], dtype=jnp.float32)
    rng = np.random.default_rng(3)
    c = rng.uniform(0, L, H).astype(np.float32)
    h = np.full(H, 0.1, np.float32)
    g2, added = jax.jit(lambda g, c, h: g.add_value(c[:, None], h))(
        g, jnp.asarray(c), jnp.asarray(h)
    )
    vals = np.asarray(g2.grid.values)
    # float64 reference: the periodic normal density h exp(-d^2 / 2
    # sigma^2) / (sqrt(2 pi) sigma) on the grid points within the support
    # d^2 / 2 sigma^2 < 8 (gaussian_grid.h:10,299)
    ref = np.zeros(G)
    edge = np.zeros(G, bool)
    # the grid coordinates as the device forms them (float32 dx * index)
    xg = (np.float32(dx) * np.arange(G, dtype=np.float32)).astype(np.float64)
    half = int(np.ceil(4.0 * sigma / dx)) + 2
    for ci, hi in zip(c.astype(np.float64), h.astype(np.float64)):
        j = (int(np.floor(ci / dx)) + np.arange(-half, half + 1)) % G
        d = xg[j] - ci
        d -= np.round(d / L) * L
        dp2 = d**2 / (2.0 * sigma**2)
        m = dp2 < 8.0
        ref[j[m]] += hi * np.exp(-dp2[m]) / (np.sqrt(2.0 * np.pi) * sigma)
        # points whose support test sits within float32 rounding of the
        # cutoff may fall either side on the card: excluded from the check
        edge[j[np.abs(dp2 - 8.0) < 1e-3]] = True
    scale = np.abs(ref).max()
    err = np.abs(vals - ref)[~edge].max() / scale
    log(f"  {int(edge.sum())} cutoff-edge points excluded of {G}")
    # float32 coordinates near x = 10 are good to ~1e-6, which moves a
    # width-0.01 Gaussian's flank by up to ~5e-5 of its peak (the compiler
    # may also reorder the coordinate arithmetic); a TF32 product anywhere
    # in the deposit would show ~1e-3
    check(err < 1e-4, f"1e6-point deposit vs float64 reference rel err {err:.3g} < 1e-4")
    integ = np.asarray(added, np.float64)
    ierr = np.abs(integ - h).max() / h.max()
    check(ierr < 1e-3, f"per-hill integrals match the heights (rel err {ierr:.3g} < 1e-3)")


def phase_lookup_precision():
    import jax
    import jax.numpy as jnp

    import bench
    from edm_tpu.ops.interp import grid_value_deriv, hermite_1d_f64

    _, core, _, _, _ = bench.seeded_pairwise_system(1000, "interp")
    grid = core.bias.bias.grid
    lo, dx = float(grid.spec.min[0]), float(grid.spec.dx[0])
    hi = float(grid.spec.max[0]) - 2 * dx
    x = np.random.default_rng(5).uniform(lo, hi, N_LOOKUP).astype(np.float32)
    val, der = jax.jit(lambda x: grid_value_deriv(grid, x[:, None]))(jnp.asarray(x))
    v64, d64 = hermite_1d_f64(grid.values, grid.derivs[:, 0], lo, dx, x.astype(np.float64))
    verr = np.abs(np.asarray(val) - v64).max() / np.abs(v64).max()
    derr = np.abs(np.asarray(der)[:, 0] - d64).max() / np.abs(d64).max()
    # float32 evaluation of the cubic: ~1e-7 relative on values, ~1e-6 on
    # derivatives (t/dx amplification); a TF32 fetch keeps ~3 digits
    check(verr < 1e-5, f"lookup values vs float64 rel err {verr:.3g} < 1e-5")
    check(derr < 1e-4, f"lookup derivatives vs float64 rel err {derr:.3g} < 1e-4")


def multi_cells_100k():
    import jax
    import jax.numpy as jnp

    import bench
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.parallel import make_brick_mesh, make_mesh
    from edm_tpu.parallel.cells import make_brick_cell_step, make_slab_cell_step

    params, core, spec, lp, lj = bench.pairwise_system(N_HOST, "interp")
    kw = dict(hill_stride=5, rebuild_stride=5, hill_capacity=2048, cell_chunk=81,
              force_impl=bench.FORCE_IMPL)
    steps = 10  # two hill rounds and two rebins
    single = jax.jit(make_cell_step(params, lp, lj, spec, **kw))
    s1 = init_cell_state(spec, core)
    for _ in range(steps):
        s1, _ = single(s1, None)
    jax.block_until_ready(s1.xs)
    check(float(s1.core.bias.cum_bias) > 0, "single-device reference deposited bias")
    hosts = (
        ("slab x4", make_slab_cell_step(params, lp, lj, spec, mesh=make_mesh(4), **kw)),
        ("brick (2, 2)", make_brick_cell_step(params, lp, lj, spec, mesh=make_brick_mesh(2, 2), **kw)),
    )
    for label, step in hosts:
        s = init_cell_state(spec, core)
        for _ in range(steps):
            s, _ = step(s)
        jax.block_until_ready(s.xs)
        devs = {sh.device for sh in s.xs.addressable_shards}
        check(len(devs) == 4, f"{label}: state replicas on 4 devices ({sorted(d.id for d in devs)})")
        check(not bool(s.table_overflow) and not bool(s.core.hills_truncated),
              f"{label}: no overflow, no truncation")
        xerr = float(jnp.abs(s.xs - s1.xs).max())
        g1 = s1.core.bias.bias.grid.values
        gerr = float(jnp.abs(s.core.bias.bias.grid.values - g1).max()) / float(jnp.abs(g1).max())
        # same thermostat draws (slot-row keyed) and the same hill rounds;
        # only the psum'd float32 force sums may round differently, which
        # ten steps of dt=0.002 keep far below 1e-4 in position
        check(xerr < 1e-4, f"{label}: positions vs single device max err {xerr:.3g} < 1e-4")
        check(gerr < 1e-5, f"{label}: bias grid vs single device rel err {gerr:.3g} < 1e-5")


def multi_pair_and_spatial():
    import __graft_entry__ as G
    from edm_tpu.parallel import make_mesh

    mesh = make_mesh(4)
    G.check_pair_replicas(mesh, 4096)
    log("  ok: pair host: 4 grid replicas bitwise identical after a hill round")
    G.check_spatial_slabs(mesh)
    log("  ok: spatial host, 4 slabs: stitched grid matches the serial engine")
    G.check_spatial_bricks(mesh)
    log("  ok: spatial host, (2, 2) bricks: stitched grid matches the serial engine")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card sharded hosts only")
    args = ap.parse_args()

    from edm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = phase_identity()
    if args.multi:
        phases = [("cells 100k slab/brick vs single device", multi_cells_100k),
                  ("pair host and spatial host", multi_pair_and_spatial)]
        want = 4
    else:
        phases = [("pairwise 100k", phase_pairwise_100k),
                  ("force parity", phase_force_parity),
                  ("2-D coordinate host", phase_coord2d),
                  ("1e6-point deposition", phase_deposition),
                  ("lookup precision", phase_lookup_precision)]
        want = 1
    if len(devs) < want:
        log(f"FAILED: needs {want} GPUs, JAX found {len(devs)}")
        return 1
    failed = []
    for name, fn in phases:
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report the phase and go on with the next
            traceback.print_exc()
            failed.append(name)
            log(f"== {name}: FAILED")
            continue
        log(f"== {name}: passed in {time.perf_counter() - t0:.1f} s")
    if failed:
        log("FAILED phases:", ", ".join(failed))
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
