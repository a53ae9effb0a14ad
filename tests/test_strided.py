"""Static hill-phase segment runner (driver.strided_segment) parity.

The strided runner must replicate the dynamic-cond step's physics: the
RNG/key stream, step counters, and flags EXACTLY (integer leaves), and
the float trajectories/bias to f64 fusion rounding — different XLA loop
compositions of the same step contract FMAs differently (measured ~1 ulp
between a flat ``lax.scan`` of the cond step and the same step advanced
one jit call at a time), so exact float equality between compositions is
not well-defined on CPU; the pin is rtol=1e-12 against BOTH.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edm_tpu import bias as B
from edm_tpu.models import coord_edm
from edm_tpu.models.driver import strided_segment
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.utils.config import parse_edm_text


def _setup(dim, periodic=True):
    per = "1" if periodic else "0"
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 0.5\nhill_density 20\n"
        f"dimension {dim}\n"
        "box_low " + " ".join(["0"] * dim) + "\n"
        "box_high " + " ".join(["6"] * dim) + "\n"
        "bias_spacing " + " ".join(["0.11"] * dim) + "\n"
        "bias_sigma " + " ".join(["0.3"] * dim) + "\n"
    )
    p = [periodic] * dim
    params, bias_state = B.subdivide(
        cfg, 1.0, 1.0, [0] * dim, [6] * dim, [0] * dim, [6] * dim, p,
        [0] * dim, dtype=jnp.float64,
    )
    rng = np.random.default_rng(11)
    x0 = jnp.asarray(rng.uniform(0.5, 5.5, (96, dim)), jnp.float64)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.7)
    return params, bias_state, x0, lp


@pytest.mark.parametrize("dim,records", [(1, False), (2, True)])
def test_strided_segment_bitwise(dim, records):
    params, bias_state, x0, lp = _setup(dim)
    stride, rounds = 3, 4
    n = stride * rounds
    kw = dict(hill_stride=stride, collect_records=records, hill_capacity=64)
    step_d = coord_edm.make_step(params, lp, **kw)
    step_h = coord_edm.make_step(params, lp, static_do_hills=True, **kw)
    step_p = coord_edm.make_step(params, lp, static_do_hills=False, **kw)
    # cache the fused corner table so the strided path exercises the very
    # carry the cond would copy
    state = coord_edm.init_state(
        params, bias_state, x0, jax.random.PRNGKey(5), lp,
        cache_lookup_table=(dim >= 2),
    )

    # ground truth: the dynamic step advanced one jit call at a time
    st, ys_t = state, []
    step_j = jax.jit(step_d)
    for _ in range(n):
        st, y = step_j(st, None)
        ys_t.append(y)
    ys_t = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys_t)

    sd, yd = jax.jit(
        lambda s: jax.lax.scan(step_d, s, None, length=n)
    )(state)
    ss, ys = jax.jit(strided_segment(step_h, step_p, stride, n))(state)

    def check(tree_a, tree_b):
        for a, b in zip(
            jax.tree_util.tree_leaves(tree_a), jax.tree_util.tree_leaves(tree_b)
        ):
            a, b = np.asarray(a), np.asarray(b)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)
            else:
                # keys, counters, acceptance flags: exact
                np.testing.assert_array_equal(a, b)

    check(st, ss)
    check(ys_t, ys)
    check(sd, ss)
    check(yd, ys)


def test_run_simulation_strided_fast_path(tmp_path):
    """run_simulation(step_hill=...) drives segments via strided_segment and
    produces the same bias grid as the dynamic-cond path (and writes)."""
    from edm_tpu.models.driver import run_simulation

    params, bias_state, x0, lp = _setup(1)
    stride = 3
    kw = dict(hill_stride=stride, hill_capacity=64)
    step_d = coord_edm.make_step(params, lp, **kw)
    step_h = coord_edm.make_step(params, lp, static_do_hills=True, **kw)
    step_p = coord_edm.make_step(params, lp, static_do_hills=False, **kw)
    state = coord_edm.init_state(
        params, bias_state, x0, jax.random.PRNGKey(5), lp
    )

    bias_file = str(tmp_path / "BIAS")
    s1, e1 = run_simulation(step_d, state, 12, 6, bias_file=bias_file)
    s2, e2 = run_simulation(
        step_p, state, 12, 6, bias_file=bias_file,
        step_hill=step_h, hill_stride=stride,
    )
    np.testing.assert_allclose(
        np.asarray(s1.bias.bias.grid.values),
        np.asarray(s2.bias.bias.grid.values),
        rtol=1e-12, atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(e1), np.asarray(e2), rtol=1e-12, atol=1e-13
    )
    assert (tmp_path / "BIAS").exists()


def test_cells_pattern_segment_matches_dynamic():
    """Cells host: the static stride-cycle phases (hills+energy at index 0,
    plain mid-steps, rebuild at the cycle end) driven by pattern_segment
    reproduce the dynamic-cond step — integer leaves (keys, counters,
    slot assignments, flags) exactly, floats to scan-fusion rounding.

    Ground truth is the DYNAMIC step advanced one jit call at a time
    (bitwise identical per step to the static variants, verified
    leaf-by-leaf during development).  The flat ``lax.scan`` of the
    dynamic step is NOT a usable reference: its deposit reduction
    rounds differently (f32 ulp on grid derivs), which the spectral
    derivative refit amplifies ~1000x into the force table (measured
    5e-4 on forces, and at kT>0 LJ chaos takes any composition pair to
    ~0.25 within 10 steps).  kT=0 keeps this comparison non-chaotic;
    the acceptance uniforms are key-derived, so hill rounds still
    exercise the full pipeline."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.driver import pattern_segment
    from edm_tpu.models.lj import LJParams
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, bias_state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    side, a = 8, 1.26
    pts = (
        np.stack(
            np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1
        ).reshape(-1, 3)
        * a
        + 0.5 * a
    )
    box = [side * a] * 3
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    lj = LJParams()
    core = pair_edm.init_state(
        bias_state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(3),
        pair_lookup="chebyshev",
    )
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=len(pts))
    state = init_cell_state(spec, core)

    stride, cycles = 5, 2
    n = stride * cycles
    kw = dict(
        hill_stride=stride, rebuild_stride=stride, energy_stride=stride,
        hill_capacity=256,
    )
    step_d = make_cell_step(params, lp, lj, spec, **kw)
    # cycle phases: hills+energy fire at step % 5 == 0; the rebuild at
    # (step + 1) % 5 == 0, i.e. cycle index 4
    step_0 = make_cell_step(
        params, lp, lj, spec, static_do_hills=True, static_do_energy=True,
        static_do_rebuild=False, **kw
    )
    step_m = make_cell_step(
        params, lp, lj, spec, static_do_hills=False, static_do_energy=False,
        static_do_rebuild=False, **kw
    )
    step_9 = make_cell_step(
        params, lp, lj, spec, static_do_hills=False, static_do_energy=False,
        static_do_rebuild=True, **kw
    )

    # per-jit-call ground truth with the DYNAMIC step
    st, ys_t = state, []
    step_j = jax.jit(step_d)
    for _ in range(n):
        st, y = step_j(st, None)
        ys_t.append(y)
    ys_t = jnp.stack(ys_t)

    ss, ys = jax.jit(
        pattern_segment([(step_0, 1), (step_m, stride - 2), (step_9, 1)], n)
    )(state)

    for a_, b_ in zip(
        jax.tree_util.tree_leaves(st), jax.tree_util.tree_leaves(ss)
    ):
        a_, b_ = np.asarray(a_), np.asarray(b_)
        if np.issubdtype(a_.dtype, np.floating):
            np.testing.assert_allclose(a_, b_, rtol=2e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(a_, b_)
    np.testing.assert_allclose(
        np.asarray(ys_t), np.asarray(ys), rtol=2e-5, atol=1e-5
    )
    assert float(ss.core.bias.cum_bias) > 0  # hills actually landed


@pytest.mark.slow
def test_cells_pattern_segment_bench_config_kt08_statistics():
    """kT>0 guard on the EXACT pipeline bench.py ships:
    the RDF-targeted well-tempered pairwise workload at kT=0.8 with the
    static stride-cycle phases (hills+energy at 0, plain 1..8, rebuild
    at 9) driven by pattern_segment, against the dynamic-cond step
    advanced one jit call at a time.  Asserts cum_bias trace, energy
    statistics, bias grid and CV histogram agree — catching any
    hill-phase/mask bug that only fires under thermal motion.

    Calibration (jax 0.8.x CPU, 400 steps): the two compositions are
    BITWISE identical on the interp-lookup path — unlike the Chebyshev
    path, there is no spectral refit to amplify composition rounding
    (test_cells_pattern_segment_matches_dynamic docstring), and the
    remaining f32 deposit-order rounding did not reach the forces.  The
    bounds below are deliberately DISTRIBUTIONAL (not bitwise) so a
    future XLA fusion change that rounds differently — which kT=0.8 LJ
    chaos would amplify into decorrelated trajectories with the SAME
    statistics — does not false-alarm; a phase/mask bug shifts the
    statistics far beyond them (e.g. a dropped hill round moves cum_bias
    by ~1/40 per round ~ 2.5%)."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.driver import pattern_segment
    from edm_tpu.models.lj import LJParams
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.grid import Grid, GridSpec

    # bench.py's workload, scaled 10k -> 1000 atoms (10^3 lattice; the
    # per-jit ground-truth loop dominates the runtime — ~10 min at 1728
    # atoms x 200 steps under the 8-device conftest mesh, ~5 at this size)
    cfg = parse_edm_text(
        "tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
        "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\n"
        "bias_spacing 0.02\nbias_sigma 0.1\n"
    )
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    r_pts = np.arange(tspec.nbins[0]) * tspec.dx[0] + tspec.min[0]
    tvals = -2.0 * np.log(np.maximum(r_pts, 0.5))
    target = Grid(
        values=jnp.asarray(tvals, jnp.float32), derivs=None, spec=tspec,
        interpolate=False,
    )
    params, bias_state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
        dtype=jnp.float32, target=target,
    )
    side, a = 10, 1.26
    pts = (
        np.stack(
            np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1
        ).reshape(-1, 3) * a + 0.5 * a
    )
    box = [side * a] * 3
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)  # bench kT
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    core = pair_edm.init_state(
        bias_state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0),
        n_est=len(pts) * 40, pair_lookup="interp",
    )
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=len(pts))
    state = init_cell_state(spec, core)
    kw = dict(
        hill_stride=10, rebuild_stride=10, hill_capacity=512,
        cell_chunk=81, energy_stride=10,
    )
    step_d = make_cell_step(params, lp, lj, spec, **kw)
    step_0 = make_cell_step(
        params, lp, lj, spec, static_do_hills=True, static_do_energy=True,
        static_do_rebuild=False, **kw
    )
    step_m = make_cell_step(
        params, lp, lj, spec, static_do_hills=False, static_do_energy=False,
        static_do_rebuild=False, **kw
    )
    step_9 = make_cell_step(
        params, lp, lj, spec, static_do_hills=False, static_do_energy=False,
        static_do_rebuild=True, **kw
    )

    n = 150  # 15 hill rounds
    st, es = state, []
    step_j = jax.jit(step_d)
    for _ in range(n):
        st, e = step_j(st, None)
        es.append(e)
    es = np.asarray(jnp.stack(es))

    ss, ys = jax.jit(
        pattern_segment([(step_0, 1), (step_m, 8), (step_9, 1)], n)
    )(state)
    ys = np.asarray(ys)

    assert np.isfinite(es).all() and np.isfinite(ys).all()
    cum_d = float(st.core.bias.cum_bias)
    cum_s = float(ss.core.bias.cum_bias)
    assert cum_d > 0.5  # hills really landed at bench-like load
    assert abs(cum_d - cum_s) < 1e-2 * cum_d, (cum_d, cum_s)
    # energy trace statistics over the energy-evaluated steps
    ed, esg = es[::10], ys[::10]
    assert abs(ed.mean() - esg.mean()) < 2e-2 * abs(ed.mean())
    assert abs(ed.std() - esg.std()) < 0.2 * ed.std() + 1e-6
    gd = np.asarray(st.core.bias.bias.grid.values)
    gs = np.asarray(ss.core.bias.bias.grid.values)
    assert np.linalg.norm(gd - gs) < 2e-2 * np.linalg.norm(gd)
    hd = np.asarray(st.core.bias.cv_hist.values)
    hs = np.asarray(ss.core.bias.cv_hist.values)
    # total CV-histogram mass counts hill-round bookkeeping events: a
    # phase bug changes it by whole rounds
    assert abs(hd.sum() - hs.sum()) < 5e-3 * hd.sum() + 1.0
    assert not bool(ss.core.hills_truncated)
    assert not bool(st.core.hills_truncated)


def test_spatial_static_do_hills_matches_dynamic():
    """Sharded spatial host: static_do_hills phase variants reproduce the
    dynamic-cond step on the 8-device CPU mesh (per-call jit on both sides,
    so the comparison is composition-free)."""
    from edm_tpu.parallel import make_mesh
    from edm_tpu.parallel.spatial import (
        init_spatial_state,
        make_spatial_coord_step,
        spatial_subdivide,
    )

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 1.0\nbias_per_step 100\ndimension 1\n"
        "box_low 0\nbox_high 10\nbias_spacing 0.01\nbias_sigma 0.2\n"
    )
    n_dev = 8
    setup, template = spatial_subdivide(
        cfg, 1.0, 1.0, n_dev, 1.25, dtype=jnp.float64
    )
    mesh = make_mesh(n_dev)
    xs = []
    for d in range(n_dev):
        xs.append([d * 1.25 + 0.3, 0.0, 0.0])
        xs.append([d * 1.25 + 1.2, 0.0, 0.0])
    x0 = np.asarray(xs)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.5)
    state0 = init_spatial_state(
        setup, template, x0, jax.random.PRNGKey(0), capacity=4, mesh=mesh
    )
    stride = 2
    step_d = make_spatial_coord_step(setup, lp, hill_stride=stride, mesh=mesh)
    step_h = make_spatial_coord_step(
        setup, lp, hill_stride=stride, mesh=mesh, static_do_hills=True
    )
    step_p = make_spatial_coord_step(
        setup, lp, hill_stride=stride, mesh=mesh, static_do_hills=False
    )

    sd = ss = state0
    for i in range(4):
        sd, _ = step_d(sd)
        ss, _ = (step_h if i % stride == 0 else step_p)(ss)
    for a, b in zip(
        jax.tree_util.tree_leaves(sd), jax.tree_util.tree_leaves(ss)
    ):
        a, b = np.asarray(a), np.asarray(b)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)
        else:
            np.testing.assert_array_equal(a, b)
    assert float(jnp.sum(ss.bias.cum_bias)) > 0


def test_strided_segment_rejects_ragged_length():
    params, bias_state, x0, lp = _setup(1)
    step = coord_edm.make_step(params, lp, hill_stride=4)
    with pytest.raises(ValueError):
        strided_segment(step, step, 4, 10)
