"""End-to-end MD slice: 1-D coordinate EDM on a Langevin particle
(the driver's first config; reference analog is fix_edm + fix langevin)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from edm_tpu import bias as B
from edm_tpu.models import coord_edm
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.utils.config import parse_edm_file

import pathlib

SANITY = str(pathlib.Path(__file__).parent / "fixtures" / "sanity.edm")


def test_single_particle_langevin_edm():
    cfg = parse_edm_file(SANITY)
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [10], [0], [10], [True], [0], dtype=jnp.float32
    )
    lp = LangevinParams(dt=0.005, friction=1.0, kT=1.0)
    step = coord_edm.make_step(params, lp, hill_stride=10)

    x0 = jnp.asarray([[5.0]], jnp.float32)
    st = coord_edm.init_state(params, state, x0, jax.random.PRNGKey(0), lp)

    run = jax.jit(lambda s: coord_edm.run_segment(step, s, 200))
    st, energies = run(st)

    # 20 hill rounds of h=0.25 each (cap == prefactor, single hill/round)
    assert int(st.bias.steps) == 20
    cum = float(st.bias.cum_bias)
    assert 0.2 * 19 < cum <= 0.25 * 20 + 1e-4
    # bias deposited where the particle has been (near x=5)
    assert float(st.bias.bias.get_value(jnp.asarray([[5.0]]))[0]) > 0.0
    # trajectory stayed finite and in-box after wrapping
    assert np.isfinite(np.asarray(st.x)).all()
    assert np.isfinite(np.asarray(energies)).all()
    # energy at the end reflects accumulated bias
    assert float(energies[-1]) > 0.0


def test_pairwise_lj_edm():
    """Pairwise EDM on a small LJ fluid (fix edm_pair analog): bias builds on
    the pair-distance CV, pair forces stay finite and antisymmetric."""
    import pathlib
    import tempfile

    from edm_tpu.models import pair_edm
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    # pairwise topology: every rank spans the full 1-D CV domain; grid
    # replicated (fix_edm_pair.cpp:96-104)
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )

    # 4x4x2 cubic lattice in a periodic box, density ~0.5
    nx, ny, nz = 4, 4, 2
    a = 1.26
    box = [nx * a, ny * a, nz * a]
    grid_pts = np.stack(
        np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"), -1
    ).reshape(-1, 3) * a + 0.5 * a
    x0 = jnp.asarray(grid_pts, jnp.float32)

    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    # capacity covers the cold-start round: last_calls inits to N (the
    # reference's conservative atom->nmax guess) so the first round accepts
    # with probability hill_density/N ~ 0.6 over ~N^2 candidate pairs
    step = pair_edm.make_step(params, lp, lj, box, hill_stride=5, hill_capacity=1024)
    st = pair_edm.init_state(state, x0, jax.random.PRNGKey(2))

    run = jax.jit(lambda s: pair_edm.run_segment(step, s, 50))
    st, energies = run(st)

    assert np.isfinite(np.asarray(st.x)).all()
    assert np.isfinite(np.asarray(energies)).all()
    assert not bool(st.hills_truncated)
    assert float(st.bias.cum_bias) > 0.0
    # hills landed inside the CV domain (pair distances), nowhere else
    vals = np.asarray(st.bias.bias.grid.values)
    assert vals.max() > 0
    # est_hill_count tracks the ordered-pair count (reference last_calls)
    assert int(st.last_calls) > 0


@pytest.mark.slow
def test_pairwise_blocked_matches_dense():
    """Blocked large-N path: same physics as the dense path (statistical
    agreement on accumulated bias; identical force law)."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.pair_edm_blocked import make_step_blocked
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    a = 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    box = [4 * a] * 3
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    lj = LJParams()

    st_d = pair_edm.init_state(state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0))
    step_d = pair_edm.make_step(params, lp, lj, box, hill_stride=2, hill_capacity=2048)
    run_d = jax.jit(lambda s: pair_edm.run_segment(step_d, s, 20))
    st_d, _ = run_d(st_d)

    st_b = pair_edm.init_state(state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0))
    step_b = make_step_blocked(params, lp, lj, box, hill_stride=2, hill_capacity=2048, block_size=16)
    run_b = jax.jit(lambda s: jax.lax.scan(step_b, s, None, length=20))
    st_b, e_b = run_b(st_b)

    assert np.isfinite(np.asarray(e_b)).all()
    assert not bool(st_b.hills_truncated)
    cd, cb = float(st_d.bias.cum_bias), float(st_b.bias.cum_bias)
    assert cb > 0
    assert abs(cd - cb) / max(cd, cb) < 0.5  # different RNG streams
    assert int(st_b.last_calls) == int(st_d.last_calls)  # deterministic count


def test_flat_histogram_convergence():
    """The physics end-to-end check: with enough bias the CV distribution
    flattens (free particle + EDM -> uniform sampling). We verify the bias
    grid grows roughly uniformly-peaked around visited states and cum_bias
    increases monotonically across segments."""
    cfg = parse_edm_file(SANITY)
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [10], [0], [10], [True], [0], dtype=jnp.float32
    )
    lp = LangevinParams(dt=0.01, friction=2.0, kT=1.0)
    step = coord_edm.make_step(params, lp, hill_stride=5)
    st = coord_edm.init_state(params, state, jnp.asarray([[2.0]], jnp.float32), jax.random.PRNGKey(1), lp)

    run = jax.jit(lambda s: coord_edm.run_segment(step, s, 100))
    last_cum = 0.0
    for _ in range(3):
        st, _ = run(st)
        cum = float(st.bias.cum_bias)
        assert cum > last_cum
        last_cum = cum
    # histogram recorded visits
    assert float(jnp.sum(st.bias.cv_hist.values)) > 0


@pytest.mark.slow
def test_cell_list_host_matches_blocked():
    """Cell-list host: identical force law to the dense chebyshev path
    (same first-step trajectory), stable over many steps, no overflows."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    side, a = 8, 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    box = [side * a] * 3
    # kT=0: the slot-resident cell host draws noise in slot layout, so
    # cross-host trajectory parity must be deterministic
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    lj = LJParams()
    x0 = jnp.asarray(pts, jnp.float32)

    # dense path with chebyshev lookup (same force law)
    core_d = pair_edm.init_state(
        state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev"
    )
    step_d = pair_edm.make_step(params, lp, lj, box, hill_stride=10**6)
    new_d, _ = step_d(core_d, None)

    # cell-list path
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    assert min(spec.ncells) >= 3
    core_c = pair_edm.init_state(
        state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev"
    )
    cstate = init_cell_state(spec, core_c)
    assert not bool(cstate.table_overflow)
    step_c = make_cell_step(
        params, lp, lj, spec, hill_stride=10**6, rebuild_stride=5
    )
    new_c, _ = step_c(cstate, None)

    from edm_tpu.models.pair_edm_cells import atom_positions

    np.testing.assert_allclose(
        np.asarray(atom_positions(spec, new_c)), np.asarray(new_d.x),
        rtol=2e-4, atol=2e-5,
    )

    # with hills on (thermal), run a stretch: finite, hills land, no overflow
    lpT = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    core_c = pair_edm.init_state(
        state, x0, jax.random.PRNGKey(1), pair_lookup="chebyshev"
    )
    cstate = init_cell_state(spec, core_c)
    step_c = make_cell_step(params, lpT, lj, spec, hill_stride=5, rebuild_stride=5)
    run = jax.jit(lambda s: jax.lax.scan(step_c, s, None, length=30))
    cstate, e = run(cstate)
    assert np.isfinite(np.asarray(cstate.core.x)).all()
    assert float(cstate.core.bias.cum_bias) > 0
    assert not bool(cstate.core.hills_truncated)
    assert not bool(cstate.table_overflow)


@pytest.mark.slow
def test_pair_type_filtering():
    """rdf type-pair filtering (fix_edm_pair.cpp:39-44,177-202): only i-j
    type pairs contribute to the CV — hills and forces ignore same-type
    pairs outside the selected pair."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 10.0\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    a = 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    box = [4 * a] * 3
    types = np.ones(len(pts), np.int32)
    types[: len(pts) // 2] = 2  # half type-2
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)

    st = pair_edm.init_state(state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0))
    step = pair_edm.make_step(
        params, lp, LJParams(), box, hill_stride=1, hill_capacity=2048,
        types=types, type_pair=(1, 2),
    )
    st, _ = step(st, None)
    n12 = int(st.last_calls)

    st_all = pair_edm.init_state(state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0))
    step_all = pair_edm.make_step(params, lp, LJParams(), box, hill_stride=1, hill_capacity=2048)
    st_all, _ = step_all(st_all, None)
    n_all = int(st_all.last_calls)

    # cross-type ordered pairs are a strict subset
    assert 0 < n12 < n_all
    assert float(st.bias.cum_bias) > 0


@pytest.mark.slow
def test_cell_host_type_filtering_pallas_matches_xla(triton_interpret):
    """Type-filtered runs through the Triton force kernel (interpret mode;
    slot types masking only the CV term) reproduce the XLA typed path — the
    rdf type pair is a first-class fix_edm_pair argument and must not lose
    the kernel path (fix_edm_pair.cpp:39-44,177-202)."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 10.0\nhill_density 40\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    side, a = 8, 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    types = np.ones(len(pts), np.int32)
    types[::2] = 2
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    spec = CellSpec.create([side * a] * 3, cutoff=3.0, n_atoms=len(pts))
    core = pair_edm.init_state(
        state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0),
        pair_lookup="chebyshev",
    )
    # seed bias so the CV force is nonzero and the filter matters
    bias2, _ = core.bias.bias.add_value(
        jnp.asarray([[1.2], [1.8]], jnp.float32), jnp.asarray([0.5, 0.3], jnp.float32)
    )
    import dataclasses as dc
    from edm_tpu.ops.chebyshev import fit_gauss_grid

    core = dc.replace(
        core, bias=dc.replace(core.bias, bias=bias2), cheb=fit_gauss_grid(bias2, 64)
    )
    cst = init_cell_state(spec, core)

    def run(force_impl):
        step = make_cell_step(
            params, lp, LJParams(), spec, hill_stride=1,
            types=types, type_pair=(1, 2), force_impl=force_impl,
        )
        return step(cst, None)[0]

    s_xla = run("xla")
    s_pal = run("triton")
    np.testing.assert_allclose(
        np.asarray(s_pal.xs), np.asarray(s_xla.xs), rtol=1e-5, atol=1e-6
    )
    scale = np.abs(np.asarray(s_xla.fs)).max()
    np.testing.assert_allclose(
        np.asarray(s_pal.fs), np.asarray(s_xla.fs), atol=1e-4 * max(scale, 1.0)
    )
    # same typed candidate count and identical hill round (same collector)
    assert int(s_pal.core.last_calls) == int(s_xla.core.last_calls)
    np.testing.assert_allclose(
        np.asarray(s_pal.core.bias.bias.grid.values),
        np.asarray(s_xla.core.bias.bias.grid.values),
        atol=1e-6,
    )
    # filter engaged: typed candidate count strictly below the untyped count
    core_all = dc.replace(core, cheb=core.cheb)
    cst_all = init_cell_state(spec, core_all)
    step_all = make_cell_step(
        params, lp, LJParams(), spec, hill_stride=1, force_impl="triton"
    )
    s_all = step_all(cst_all, None)[0]
    assert 0 < int(s_pal.core.last_calls) < int(s_all.core.last_calls)


@pytest.mark.slow
def test_pallas_interp_exact_matches_xla(triton_interpret):
    """pair_lookup='interp' through the Triton kernel: the in-kernel
    HermiteTable fetch reproduces the XLA exact cubic-Hermite lookup
    (reference lib/grid.h:95-137)."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    side, a = 8, 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    spec = CellSpec.create([side * a] * 3, cutoff=3.0, n_atoms=len(pts))
    core = pair_edm.init_state(
        state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0),
        pair_lookup="interp",
    )
    assert core.cheb is None
    bias2, _ = core.bias.bias.add_value(
        jnp.asarray([[1.2], [1.8]], jnp.float32), jnp.asarray([0.5, 0.3], jnp.float32)
    )
    import dataclasses as dc

    core = dc.replace(core, bias=dc.replace(core.bias, bias=bias2))
    cst = init_cell_state(spec, core)

    s_xla, _ = make_cell_step(params, lp, LJParams(), spec, hill_stride=10**6)(cst, None)
    s_pal, _ = make_cell_step(
        params, lp, LJParams(), spec, hill_stride=10**6, force_impl="triton"
    )(cst, None)
    # same exact table and the same sqrt for r (so interval indices and the
    # LJ cutoff test agree); 1/r comes from rsqrt in the kernel — force
    # tolerance matches the cheb-kernel parity test
    np.testing.assert_allclose(
        np.asarray(s_pal.xs), np.asarray(s_xla.xs), rtol=1e-5, atol=1e-6
    )
    scale = np.abs(np.asarray(s_xla.fs)).max()
    np.testing.assert_allclose(
        np.asarray(s_pal.fs), np.asarray(s_xla.fs), atol=1e-4 * max(scale, 1.0)
    )
    assert abs(float(s_pal.core.energy) - float(s_xla.core.energy)) < 1e-3 * max(
        1.0, abs(float(s_xla.core.energy))
    )
    # and a hill round keeps working (no cheb refit on the interp path)
    s2, _ = make_cell_step(
        params, lp, LJParams(), spec, hill_stride=1, force_impl="triton"
    )(cst, None)
    assert s2.core.cheb is None
    assert float(s2.core.bias.cum_bias) > 0


@pytest.mark.slow
def test_cell_host_type_filtering():
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 10.0\nhill_density 40\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    side, a = 8, 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    box = [side * a] * 3
    types = np.ones(len(pts), np.int32)
    types[::2] = 2
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=len(pts))

    def run(type_pair):
        core = pair_edm.init_state(
            state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0),
            pair_lookup="chebyshev",
        )
        st = init_cell_state(spec, core)
        step = make_cell_step(
            params, lp, LJParams(), spec, hill_stride=1,
            types=types if type_pair else None, type_pair=type_pair,
        )
        st, _ = step(st, None)
        return st

    st_f = run((1, 2))
    st_a = run(None)
    assert 0 < int(st_f.core.last_calls) < int(st_a.core.last_calls)


def test_cell_host_typed_candidates_match_dense():
    """The cell host's type-filtered hill collection (27-stencil tiles)
    counts the same ordered cross-type candidates as the dense host at
    the same positions (dt = 0 keeps the atoms in place)."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 10.0\nhill_density 40\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    side, a = 8, 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    pts = pts + np.random.default_rng(3).uniform(-0.2, 0.2, pts.shape)
    box = [side * a] * 3
    types = np.ones(len(pts), np.int32)
    types[::3] = 2
    still = LangevinParams(dt=0.0, friction=0.0, kT=0.0)
    core = pair_edm.init_state(
        state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0),
        pair_lookup="chebyshev",
    )
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=len(pts))
    assert min(spec.ncells) >= 3
    cell_step = make_cell_step(
        params, still, LJParams(), spec, hill_stride=1, types=types,
        type_pair=(1, 2), hill_capacity=8192, row_cap=4096,
    )
    st_c, _ = cell_step(init_cell_state(spec, core), None)
    dense_step = pair_edm.make_step(
        params, still, LJParams(), box, hill_stride=1, hill_capacity=8192,
        types=types, type_pair=(1, 2),
    )
    st_d, _ = dense_step(core, None)
    assert not bool(st_c.core.hills_truncated)
    assert int(st_c.core.last_calls) == int(st_d.last_calls) > 0


@pytest.mark.slow
def test_pallas_cell_force_matches_xla(triton_interpret):
    """The Triton cell-force kernel (interpret mode on CPU) produces the
    same trajectory as the XLA cell path."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    side, a = 8, 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    spec = CellSpec.create([side * a] * 3, cutoff=3.0, n_atoms=len(pts))
    core = pair_edm.init_state(
        state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0),
        pair_lookup="chebyshev",
    )
    cst = init_cell_state(spec, core)
    # seed some bias so the spectral force is nonzero
    bias2, _ = cst.core.bias.bias.add_value(
        jnp.asarray([[1.2], [1.8]], jnp.float32), jnp.asarray([0.5, 0.3], jnp.float32)
    )
    import dataclasses as dc
    from edm_tpu.ops.chebyshev import fit_gauss_grid

    bs = dc.replace(cst.core.bias, bias=bias2)
    core2 = dc.replace(cst.core, bias=bs, cheb=fit_gauss_grid(bias2, 64))
    cst = dc.replace(cst, core=core2)

    s_xla, _ = make_cell_step(params, lp, LJParams(), spec, hill_stride=10**6)(cst, None)
    s_pal, _ = make_cell_step(
        params, lp, LJParams(), spec, hill_stride=10**6, force_impl="triton"
    )(cst, None)
    np.testing.assert_allclose(
        np.asarray(s_pal.xs), np.asarray(s_xla.xs), rtol=1e-5, atol=1e-6
    )
    # forces include the step's fresh force pass: f32 reorder noise only
    scale = np.abs(np.asarray(s_xla.fs)).max()
    np.testing.assert_allclose(
        np.asarray(s_pal.fs), np.asarray(s_xla.fs), atol=1e-4 * max(scale, 1.0)
    )
    assert abs(float(s_pal.core.energy) - float(s_xla.core.energy)) < 1e-3 * max(
        1.0, abs(float(s_xla.core.energy))
    )

    # energy_stride: identical dynamics, energy recomputed on the stride
    # only (der-only kernel in between) and carried through skipped steps
    step1 = make_cell_step(
        params, lp, LJParams(), spec, hill_stride=10**6, force_impl="triton"
    )
    step2 = make_cell_step(
        params, lp, LJParams(), spec, hill_stride=10**6, force_impl="triton",
        energy_stride=2,
    )
    sa, sb = cst, cst
    for i in range(3):
        sa, _ = step1(sa, None)
        sb, _ = step2(sb, None)
        np.testing.assert_array_equal(np.asarray(sa.xs), np.asarray(sb.xs))
        # step counter starts at 0: energy computed on even core.step
        if int(sa.core.step) % 2 == 1:
            assert float(sb.core.energy) == float(sa.core.energy)


def test_coordinate_edm_2d():
    """2-D coordinate CV end to end (reference fix edm with dim 2):
    hills deposit on the (x, y) plane, forces stay finite, histogram fills."""
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.2\nbias_per_step 5.0\ndimension 2\n"
        "box_low 0 0\nbox_high 6 6\nbias_spacing 0.1 0.1\nbias_sigma 0.3 0.3\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0, 0], [6, 6], [0, 0], [6, 6], [True, True], [0, 0],
        dtype=jnp.float32,
    )
    lp = LangevinParams(dt=0.01, friction=2.0, kT=1.0)
    step = coord_edm.make_step(params, lp, hill_stride=5)
    # 8 walkers in 3-D space; CV = first two coordinates
    x0 = jnp.asarray(np.random.default_rng(1).uniform(0, 6, (8, 3)), jnp.float32)
    st = coord_edm.init_state(params, state, x0, jax.random.PRNGKey(4), lp)
    run = jax.jit(lambda s: coord_edm.run_segment(step, s, 200))
    st, e = run(st)
    assert np.isfinite(np.asarray(st.x)).all()
    assert float(st.bias.cum_bias) > 0
    vals = np.asarray(st.bias.bias.grid.values)
    assert vals.ndim == 2 and vals.max() > 0
    assert float(jnp.sum(st.bias.cv_hist.values)) > 0


def test_coord_hill_compaction_matches_full_batch():
    """Accepted-hill compaction (coord host hill_capacity): with
    stochastic sampling only ~hill_density of the N candidates are
    accepted, so the host compacts them before add_hills_round —
    order-preserving, same draws, same est_hill_count.  The compacted
    round deposits the IDENTICAL hills (same heights, order, cap
    decisions; rejected candidates never reach do_add_hill,
    edm_bias.cpp:543); only the deposit reduction's summation order
    changes with the batch shape, so grids agree to f32 rounding and
    the +-1 histogram scatter stays exact."""
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.2\nbias_per_step 5.0\nhill_density 40\n"
        "dimension 1\nbox_low 0\nbox_high 6\nbias_spacing 0.05\nbias_sigma 0.2\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [6], [0], [6], [True], [0], dtype=jnp.float32
    )
    lp = LangevinParams(dt=0.01, friction=2.0, kT=1.0)
    x0 = jnp.asarray(
        np.random.default_rng(3).uniform(0, 6, (700, 1)), jnp.float32
    )
    st0 = coord_edm.init_state(params, state, x0, jax.random.PRNGKey(4), lp)
    # capacity 512 < N=700 activates compaction; 0 disables it
    step_c = coord_edm.make_step(params, lp, hill_stride=3, hill_capacity=512)
    step_f = coord_edm.make_step(params, lp, hill_stride=3, hill_capacity=0)
    run_c = jax.jit(lambda s: coord_edm.run_segment(step_c, s, 10))
    run_f = jax.jit(lambda s: coord_edm.run_segment(step_f, s, 10))
    sc, _ = run_c(st0)
    sf, _ = run_f(st0)
    assert not bool(sc.hills_truncated)
    np.testing.assert_allclose(
        np.asarray(sc.x), np.asarray(sf.x), rtol=1e-5, atol=1e-5
    )
    gv_c = np.asarray(sc.bias.bias.grid.values)
    gv_f = np.asarray(sf.bias.bias.grid.values)
    np.testing.assert_allclose(
        gv_c, gv_f, atol=1e-6 * max(1.0, np.abs(gv_f).max()), rtol=1e-5
    )
    # the +-1 histogram bookkeeping is order-independent: exact
    assert np.array_equal(
        np.asarray(sc.bias.cv_hist.values), np.asarray(sf.bias.cv_hist.values)
    )
    assert abs(float(sc.bias.cum_bias) - float(sf.bias.cum_bias)) < 1e-5
    assert float(sc.bias.cum_bias) > 0


def test_coord_hill_passes_spill_instead_of_truncate():
    """Never-drop rounds: a hill_capacity smaller than
    the acceptance load truncates single-pass rounds (drops hills, sets the
    sticky flag — biased sampling, the failure mode the reference's
    mid-round flush avoids, edm_bias.cpp:459-462); with
    hill_passes=K the same capacity spills into gated extra passes and the
    trajectory/grid match the uncompacted full-batch host."""
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.2\nbias_per_step 5.0\nhill_density 40\n"
        "dimension 1\nbox_low 0\nbox_high 6\nbias_spacing 0.05\nbias_sigma 0.2\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [6], [0], [6], [True], [0], dtype=jnp.float32
    )
    lp = LangevinParams(dt=0.01, friction=2.0, kT=1.0)
    x0 = jnp.asarray(
        np.random.default_rng(9).uniform(0, 6, (700, 1)), jnp.float32
    )
    st0 = coord_edm.init_state(params, state, x0, jax.random.PRNGKey(7), lp)
    # ~40 accepted/round vs capacity 16: single-pass truncates...
    step_t = coord_edm.make_step(params, lp, hill_stride=3, hill_capacity=16)
    # ...8 passes give 128 rows of headroom: no drop
    step_p = coord_edm.make_step(
        params, lp, hill_stride=3, hill_capacity=16, hill_passes=8
    )
    step_f = coord_edm.make_step(params, lp, hill_stride=3, hill_capacity=0)
    st_t, _ = jax.jit(lambda s: coord_edm.run_segment(step_t, s, 10))(st0)
    st_p, _ = jax.jit(lambda s: coord_edm.run_segment(step_p, s, 10))(st0)
    st_f, _ = jax.jit(lambda s: coord_edm.run_segment(step_f, s, 10))(st0)
    assert bool(st_t.hills_truncated)  # the failure mode being closed
    assert not bool(st_p.hills_truncated)
    np.testing.assert_allclose(
        np.asarray(st_p.x), np.asarray(st_f.x), rtol=1e-5, atol=1e-5
    )
    gv_p = np.asarray(st_p.bias.bias.grid.values)
    gv_f = np.asarray(st_f.bias.bias.grid.values)
    np.testing.assert_allclose(
        gv_p, gv_f, atol=1e-6 * max(1.0, np.abs(gv_f).max()), rtol=1e-5
    )
    assert np.array_equal(
        np.asarray(st_p.bias.cv_hist.values),
        np.asarray(st_f.bias.cv_hist.values),
    )
    assert abs(float(st_p.bias.cum_bias) - float(st_f.bias.cum_bias)) < 1e-5
    assert float(st_p.bias.cum_bias) > 0
    # the truncating run really dropped bias: cum strictly below full-batch
    assert float(st_t.bias.cum_bias) < float(st_f.bias.cum_bias)


@pytest.mark.slow
def test_run_simulation_driver(tmp_path):
    """fix-style host loop: strided bias/histogram/table writes, histogram
    reset each write (README.md:139-141)."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.driver import run_simulation
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text
    from edm_tpu.utils.gridio import read_grid_file

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    a = 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    step = pair_edm.make_step(params, lp, LJParams(), [4 * a] * 3, hill_stride=2, hill_capacity=2048)
    st = pair_edm.init_state(state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0))

    writes = []
    st, e = run_simulation(
        step, st, n_steps=20, write_stride=10,
        bias_file=str(tmp_path / "BIAS"),
        histogram_file=str(tmp_path / "HIST"),
        lammps_table=str(tmp_path / "BIAS.ltab"),
        box_low=cfg.box_low, box_high=cfg.box_high,
        progress=lambda done, s, en: writes.append(done),
    )
    assert writes == [10, 20]
    g = read_grid_file(str(tmp_path / "BIAS"), dtype=np.float32)
    assert np.asarray(g.values).max() > 0
    assert (tmp_path / "BIAS.ltab").exists()
    # histogram was reset after the last write
    assert float(jnp.sum(st.bias.cv_hist.values)) == 0.0
    assert np.isfinite(np.asarray(e)).all()


def test_coord_group_mask():
    """LAMMPS groupbit parity (fix_edm.cpp:104,140,153): masked-out atoms
    neither feel the bias nor deposit hills."""
    from edm_tpu.utils.config import parse_edm_file

    cfg = parse_edm_file(SANITY)
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [10], [0], [10], [True], [0], dtype=jnp.float32
    )
    lp = LangevinParams(dt=0.005, friction=1.0, kT=1.0)
    mask = np.array([True, False])
    step = coord_edm.make_step(params, lp, hill_stride=5, group_mask=mask)
    x0 = jnp.asarray([[3.0, 0, 0], [7.0, 0, 0]], jnp.float32)
    st = coord_edm.init_state(params, state, x0, jax.random.PRNGKey(0), lp)
    run = jax.jit(lambda s: coord_edm.run_segment(step, s, 100))
    st, _ = run(st)
    vals = np.asarray(st.bias.bias.grid.values)
    xs = np.arange(len(vals)) * st.bias.bias.spec.grid.dx[0]
    # all bias deposited near atom 0's region (x~3), none near atom 1 (x~7)
    assert vals[(xs > 2) & (xs < 4)].sum() > 0
    assert vals[(xs > 6.2) & (xs < 7.8)].sum() < 1e-3


@pytest.mark.slow
def test_half_tile_hill_collection_census():
    """The half-tile hill collector enumerates every in-range unordered
    pair exactly once with TWO hills at its r (the reference's two ordered
    candidates per pair, fix_edm_pair.cpp:229-237): with hill_density -1
    (accept all) the collected multiset equals the brute-force pair census
    and ncalls equals the ordered-candidate count."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.models.lj import LJParams
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 100\nhill_density -1\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, bstate = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float64
    )
    side, a = 7, 1.9
    rng = np.random.default_rng(3)
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
        .reshape(-1, 3) * a + 0.5 * a
    )
    pts += rng.uniform(-0.3, 0.3, pts.shape)
    spec = CellSpec.create([side * a] * 3, cutoff=3.05, n_atoms=len(pts))
    core = pair_edm.init_state(
        bstate, jnp.asarray(pts, jnp.float64), jax.random.PRNGKey(0),
        pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4,
    )
    st = init_cell_state(spec, core)
    lp = LangevinParams(dt=0.0, friction=0.0, kT=0.0)

    d = pts[:, None, :] - pts[None, :, :]
    box = side * a
    d -= np.round(d / box) * box
    r = np.sqrt((d ** 2).sum(-1))
    np.fill_diagonal(r, np.inf)
    bf = np.sort(r[np.triu_indices_from(r, 1)][r[np.triu_indices_from(r, 1)] < 3.0])

    step = make_cell_step(
        params, lp, LJParams(epsilon=0.0), spec, hill_stride=1,
        hill_capacity=16384, m_per_row=96, collect_records=True,
    )
    st2, (e, log) = step(st, None)
    assert int(st2.core.last_calls) == 2 * len(bf)
    hills = np.asarray(log.positions)[:, 0]
    hv = np.sort(hills[hills > 0])
    np.testing.assert_allclose(hv, np.sort(np.concatenate([bf, bf])), rtol=1e-6)
    assert not bool(st2.core.hills_truncated)
