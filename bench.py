"""Benchmark: end-to-end rates of the EDM hosts on one NVIDIA GPU.

Prints one JSON line per metric; every line names the device it ran on
(JAX platform, device kind and count, and the card's name and power limit
as nvidia-smi reports them).  Exits non-zero when JAX finds no GPU or
when any metric failed; a failing metric prints an error line and the
others still run.

Primary metric (BASELINE.json): MD steps/sec at 10k-atom pairwise EDM.
The full MD step is measured: LJ forces + pairwise-CV bias forces over all
minimum-image pairs + strided hill rounds — i.e. strictly MORE work per step
than the reference baseline, which was measured on the EDM-side work alone
(synthetic 20-neighbor half list, no LJ, no integration).

Baseline provenance: reference serial build at -O2 on a CPU (MPI stubbed),
10k atoms x 20 neighbors, hill stride 10, hill_density 250: 124.47 steps/s.
Hill deposition on a 1e6-point grid (sigma 0.01, dx 1e-5): 3333.5 hills/s.
See BASELINE.md.

Timing: each metric compiles and warms its segment once, then times three
runs of it, each ending in ``jax.block_until_ready``, and reports the
median.

Usage: python bench.py [--quick]
"""

import argparse
import json
import subprocess
import time

import numpy as np

REF_STEPS_PER_SEC = 124.47  # reference CPU, see module docstring
REF_HILLS_PER_SEC = 3333.5
REF_STEPS_100K = 11.42  # same synthetic workload, 100k atoms (2M pairs/step)
REF_STEPS_2D = 231.6  # 2-D coord EDM, 10k atoms, 1e6-pt grid (ref_bench2d.cpp)

# force pass of the pairwise cell host (ops/cellforce.lattice_force): the
# Triton kernel beat the plain-XLA pass end to end at 10k exact, 10k
# Chebyshev and 100k exact on an H100 (force_ab.py, PERF.md)
FORCE_IMPL = "triton"


def nvidia_smi_identity() -> str:
    """``name, power.limit`` of the first card, read by nvidia-smi in a
    child process (it never imports JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


def device_identity() -> dict:
    """The device every metric runs on; raises SystemExit when JAX finds
    no GPU (a CPU number is never reported as a device metric)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures an NVIDIA GPU; JAX found {devs[0].platform!r}"
        )
    name, power = (s.strip() for s in nvidia_smi_identity().split(",", 1))
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "name": name,
        "power_limit": power,
    }


def _time_segment(seg, state, check):
    """Compile + warm ``seg`` once, then the median wall time of three
    runs, each ending in block_until_ready.  ``check(state, ys)`` raises
    on a bad result.  Returns (median seconds, final state)."""
    import jax

    state, ys = jax.block_until_ready(seg(state))
    check(state, ys)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, ys = jax.block_until_ready(seg(state))
        times.append(time.perf_counter() - t0)
        check(state, ys)
    return float(np.median(times)), state


def pairwise_system(n_atoms, pair_lookup="interp", dtype=None):
    """The bench's pairwise workload: LJ fluid at density ~0.5 on a cubic
    lattice with a well-tempered, RDF-targeted pair bias.  Returns
    (params, core state, cell spec, Langevin params, LJ params)."""
    import jax
    import jax.numpy as jnp

    from edm_tpu import bias as B
    from edm_tpu.grid import Grid, GridSpec
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.langevin import LangevinParams
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    dtype = dtype or jnp.float32
    # Well-tempered, RDF-targeted EDM — the reference's production workload
    # (fix edm_pair with a target grid).  The target is the ideal-gas pair
    # distance distribution -ln(r^2): sampled-p x exp(target) is ~flat, so
    # deposition converges to uniform bias growth (zero added force) and the
    # MD stays stationary indefinitely.  An UNtargeted pair bias fights the
    # fluid's equilibrium structure and blows the system up after ~50 hill
    # rounds; under jit the step cost is shape-determined either way.
    cfg = parse_edm_text(
        "tempering 1\nbias_factor 10\n"
        "hill_prefactor 0.1\nbias_per_step 1.0\nhill_density 250\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    r_pts = np.arange(tspec.nbins[0]) * tspec.dx[0] + tspec.min[0]
    tvals = -2.0 * np.log(np.maximum(r_pts, 0.5))
    target = Grid(
        values=jnp.asarray(tvals, dtype), derivs=None, spec=tspec,
        interpolate=False,
    )
    params, bias_state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=dtype,
        target=target,
    )
    side = int(np.ceil(n_atoms ** (1 / 3)))
    a = 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)[
            :n_atoms
        ]
        * a
        + 0.5 * a
    )
    box = [side * a] * 3
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    # panelized spectral table: 4 panels x deg 16 (see ops/chebyshev.py)
    core = pair_edm.init_state(
        bias_state, jnp.asarray(pts, dtype), jax.random.PRNGKey(0),
        n_est=n_atoms * 40, pair_lookup=pair_lookup, cheb_deg=16,
        cheb_panels=4,
    )
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=n_atoms)
    return params, core, spec, lp, lj


def seeded_pairwise_system(n_atoms, pair_lookup):
    """``pairwise_system`` with a few hills already on the bias grid (so
    the CV force is not zero) and the atoms jittered off the lattice (so
    LJ forces do not cancel by symmetry)."""
    import dataclasses

    import jax.numpy as jnp

    from edm_tpu.ops.chebyshev import fit_gauss_grid

    params, core, spec, lp, lj = pairwise_system(n_atoms, pair_lookup)
    gg, _ = core.bias.bias.add_value(
        jnp.asarray([[1.1], [1.6], [2.2], [2.7]], jnp.float32),
        jnp.asarray([0.5, 0.3, 0.4, 0.2], jnp.float32),
    )
    rng = np.random.default_rng(0)
    core = dataclasses.replace(
        core,
        x=core.x + jnp.asarray(rng.uniform(-0.2, 0.2, core.x.shape), jnp.float32),
        bias=dataclasses.replace(core.bias, bias=gg),
        cheb=None if core.cheb is None else fit_gauss_grid(gg, 16, 4),
    )
    return params, core, spec, lp, lj


def pairwise_segment(params, lp, lj, spec, steps, force_impl=FORCE_IMPL):
    """Jitted ``steps``-step segment of the slot-resident cell host: static
    stride-cycle phases (hills + energy at 0, plain at 1..8, rebuild at 9)
    driven by ``driver.pattern_segment``.  The bias energy is computed on
    hill-round steps only (energy_stride=10; forces are the same)."""
    import jax

    from edm_tpu.models.driver import pattern_segment
    from edm_tpu.models.pair_edm_cells import make_cell_step

    kw = dict(
        hill_stride=10, rebuild_stride=10, hill_capacity=2048,
        cell_chunk=81, energy_stride=10, force_impl=force_impl,
    )

    def phase(hills, rebuild):
        return make_cell_step(
            params, lp, lj, spec, static_do_hills=hills,
            static_do_energy=hills, static_do_rebuild=rebuild, **kw
        )

    return jax.jit(
        pattern_segment(
            [(phase(True, False), 1), (phase(False, False), 8),
             (phase(False, True), 1)],
            steps,
        )
    )


def check_pairwise(spec, state, ys):
    """Raise unless the cell-host state is finite, no cell overflowed its
    cap and no hill round was truncated."""
    import jax.numpy as jnp

    if not bool(jnp.isfinite(jnp.sum(state.xs) + jnp.sum(ys))):
        raise AssertionError("non-finite state in the pairwise bench")
    if bool(state.table_overflow):
        from edm_tpu.models.pair_edm_cells import cell_diag

        d = cell_diag(spec, state)
        raise AssertionError(
            f"cell cap exhausted: max occupancy {d['occ_max']} > cap "
            f"{spec.cap} (atoms dropped)"
        )
    if bool(state.core.hills_truncated):
        raise AssertionError("hill truncation in the pairwise bench")


def bench_pairwise(n_atoms=10000, steps=300, pair_lookup="interp",
                   force_impl=FORCE_IMPL):
    from edm_tpu.models.pair_edm_cells import init_cell_state

    params, core, spec, lp, lj = pairwise_system(n_atoms, pair_lookup)
    seg = pairwise_segment(params, lp, lj, spec, steps, force_impl)
    dt, _ = _time_segment(
        seg, init_cell_state(spec, core),
        lambda s, ys: check_pairwise(spec, s, ys),
    )
    return steps / dt


def bench_coord2d(n_atoms=10000, steps=1000, hill_stride=10, dtype=None,
                  mcgdp=False):
    """2-D coordinate EDM under heavy hill load: 1e6-point grid (1000x1000),
    bias_per_step capping, hill_density 250 — SURVEY config 4 / the
    reference ref_bench2d.cpp workload (free particles, update_force +
    strided add_hills).  Uses the separable matmul deposition path;
    ``mcgdp=True`` makes the box non-periodic (McGovern-De Pablo
    boundary-corrected zero-force hills) exercising the strip-split fast
    path (ops/deposit.dense_tables_mcgdp_2d).

    This workload is untempered (tempering 0), so the f32 bias grid grows
    without bound across the 4 x ``steps`` segments (warm-up + 3 timed);
    the finite/overflow checks guard it."""
    import jax
    import jax.numpy as jnp

    from edm_tpu import bias as B
    from edm_tpu.models import coord_edm
    from edm_tpu.models.driver import strided_segment
    from edm_tpu.models.langevin import LangevinParams
    from edm_tpu.utils.config import parse_edm_text

    dtype = dtype or jnp.float32
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 250\n"
        "dimension 2\nbox_low 0 0\nbox_high 10 10\n"
        "bias_spacing 0.01 0.01\nbias_sigma 0.05 0.05\n"
    )
    per = not mcgdp
    params, bias_state = B.subdivide(
        cfg, 1.0, 1.0, [0, 0], [10, 10], [0, 0], [10, 10], [per, per], [0, 0],
        dtype=dtype,
    )
    rng = np.random.default_rng(77)
    x0 = jnp.asarray(rng.uniform(0, 10, (n_atoms, 2)), dtype)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=1.0)
    # static hill-phase steps + strided runner (driver.strided_segment)
    step_h = coord_edm.make_step(
        params, lp, hill_stride=hill_stride, static_do_hills=True
    )
    step_p = coord_edm.make_step(
        params, lp, hill_stride=hill_stride, static_do_hills=False
    )
    state = coord_edm.init_state(params, bias_state, x0, jax.random.PRNGKey(0), lp)
    seg = jax.jit(strided_segment(step_h, step_p, hill_stride, steps))

    def check(s, e):
        if not bool(jnp.isfinite(jnp.sum(s.x) + jnp.sum(e))):
            raise AssertionError("non-finite state in the 2-D bench")
        if bool(s.bias.overflow_error):
            raise AssertionError("buffer overflow in the 2-D bench")

    dt, _ = _time_segment(seg, state, check)
    return steps / dt


def bench_deposition(grid_points=1_000_000, hills=200, reps=64, dtype=None):
    """1-D hill deposition: ``reps`` batches of ``hills`` hills onto a
    periodic ``grid_points`` grid inside one jitted scan."""
    import jax
    import jax.numpy as jnp

    from edm_tpu import GaussGrid

    dtype = dtype or jnp.float32
    dx = 10.0 / grid_points
    g = GaussGrid.create([0], [10], [dx], [True], [0.01], dtype=dtype)
    rng = np.random.default_rng(3)
    centers = jnp.asarray(rng.uniform(0, 10, (hills, 1)), dtype)
    heights = jnp.full((hills,), 0.1, dtype)

    @jax.jit
    def dep_n(gg):
        def body(g_acc, k):
            g2, added = g_acc.add_value(centers + k * 1e-7, heights)
            return g2, jnp.sum(added)
        return jax.lax.scan(body, gg, jnp.arange(reps, dtype=dtype))

    def check(gg, sums):
        if not bool(jnp.isfinite(jnp.sum(sums))):
            raise AssertionError("non-finite deposition")

    # each timed run starts from the same empty grid
    seg = lambda _: dep_n(g)
    dt, _ = _time_segment(seg, g, check)
    return hills * reps / dt


def _emit(metric, fn, unit, baseline, device):
    """Failure-isolated metric: run ``fn``, print its JSON value line — or
    an error line — and never raise, so one failing metric cannot hide the
    others.  Every line carries ``device``.  Returns True on success."""
    import traceback

    try:
        v = fn()
    except BaseException as e:  # noqa: BLE001 — isolate every failure
        traceback.print_exc()
        print(json.dumps({
            "metric": metric,
            "error": f"{type(e).__name__}: {e}",
            "device": device,
        }), flush=True)
        return False
    print(json.dumps({
        "metric": metric,
        "value": v,
        "unit": unit,
        "vs_baseline": v / baseline,
        "device": device,
    }), flush=True)
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="one small pairwise run")
    args = ap.parse_args()

    from edm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_identity()

    if args.quick:
        ok = _emit(
            "MD steps/sec, 1000-atom pairwise EDM (full LJ+bias MD step)",
            lambda: bench_pairwise(n_atoms=1000, steps=20),
            "steps/s", REF_STEPS_PER_SEC, device,
        )
        raise SystemExit(0 if ok else 1)

    # secondary metrics first; the primary line prints last
    results = [
        _emit(
            "hill depositions/sec, 1e6-point grid",
            bench_deposition, "hills/s", REF_HILLS_PER_SEC, device,
        ),
        _emit(
            "MD steps/sec, 10000-atom pairwise EDM (approx. Chebyshev lookup)",
            lambda: bench_pairwise(pair_lookup="chebyshev"),
            "steps/s", REF_STEPS_PER_SEC, device,
        ),
        _emit(
            "MD steps/sec, 2-D coord EDM, 10000 atoms, 1e6-point grid (heavy hill load)",
            bench_coord2d, "steps/s", REF_STEPS_2D, device,
        ),
        _emit(
            "MD steps/sec, 2-D coord EDM, McGDP non-periodic box (heavy hill load)",
            lambda: bench_coord2d(mcgdp=True), "steps/s", REF_STEPS_2D, device,
        ),
        _emit(
            "MD steps/sec, 100000-atom pairwise EDM (full LJ+bias MD step, exact cubic-interp lookup)",
            lambda: bench_pairwise(n_atoms=100000, steps=100),
            "steps/s", REF_STEPS_100K, device,
        ),
        _emit(
            "MD steps/sec, 10000-atom pairwise EDM (full LJ+bias MD step, exact cubic-interp lookup)",
            bench_pairwise, "steps/s", REF_STEPS_PER_SEC, device,
        ),
    ]
    if not all(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
