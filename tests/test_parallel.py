"""Multi-device tests on the virtual 8-device CPU mesh — the JAX
replacement for the reference's (untested in-repo) MPI paths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from edm_tpu import bias as B
from edm_tpu.models import pair_edm
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.parallel import make_mesh, make_sharded_pair_step, shard_pair_state
from edm_tpu.utils.config import parse_edm_text

CFG = (
    "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
    "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
)


def _setup(n_side=4):
    cfg = parse_edm_text(CFG)
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float32
    )
    a = 1.26
    pts = (
        np.stack(
            np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1
        ).reshape(-1, 3)
        * a
        + 0.5 * a
    )
    box = [n_side * a] * 3
    return params, state, jnp.asarray(pts, jnp.float32), box


def test_sharded_pair_step_8dev():
    assert len(jax.devices()) >= 8
    params, bias_state, x0, box = _setup()
    mesh = make_mesh(8)
    st = pair_edm.init_state(bias_state, x0, jax.random.PRNGKey(0))
    st = shard_pair_state(st, mesh)
    step = make_sharded_pair_step(
        params,
        LangevinParams(dt=0.002, friction=1.0, kT=0.8),
        LJParams(),
        box,
        hill_stride=2,
        mesh=mesh,
        hill_capacity=512,
    )
    for _ in range(6):
        st, e = step(st)
    assert np.isfinite(np.asarray(st.x)).all()
    assert float(st.bias.cum_bias) > 0
    assert not bool(st.hills_truncated)
    # the bias grid replica is identical on every device
    vals = st.bias.bias.grid.values
    shards = [np.asarray(s.data) for s in vals.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)


@pytest.mark.slow
def test_sharded_vs_single_device_statistics():
    """Same physics on 1 vs 8 devices: with the cap not binding and identical
    hill acceptance statistics, cumulative bias per round matches to the
    normalization (different RNG streams -> statistical, not bitwise)."""
    params, bias_state, x0, box = _setup()
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    lj = LJParams()

    # single device
    st1 = pair_edm.init_state(bias_state, x0, jax.random.PRNGKey(0))
    step1 = pair_edm.make_step(params, lp, lj, box, hill_stride=1, hill_capacity=2048)
    run1 = jax.jit(lambda s: pair_edm.run_segment(step1, s, 10))
    st1, _ = run1(st1)

    # 8 devices
    mesh = make_mesh(8)
    st8 = pair_edm.init_state(bias_state, x0, jax.random.PRNGKey(0))
    st8 = shard_pair_state(st8, mesh)
    step8 = make_sharded_pair_step(
        params, lp, lj, box, hill_stride=1, mesh=mesh, hill_capacity=512
    )
    for _ in range(10):
        st8, _ = step8(st8)

    c1, c8 = float(st1.bias.cum_bias), float(st8.bias.cum_bias)
    assert c1 > 0 and c8 > 0
    # same expected bias per round (both normalize by the global pair count)
    assert abs(c1 - c8) / max(c1, c8) < 0.5


@pytest.mark.slow
def test_graft_entry_dryrun():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "graft_entry", pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)

    mod.dryrun_multichip(8)


@pytest.mark.slow
def test_sharded_cell_host():
    """Spatially-sharded cell host on the 8-device mesh: first-step
    trajectory matches the single-device cell host (kT=0 — the hosts now
    draw noise in different layouts); hills accumulate."""
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import (
        atom_positions,
        init_cell_state,
        make_cell_step,
    )
    from edm_tpu.parallel.cells import init_sharded_cell_state, make_sharded_cell_step

    params, bias_state, x0, box = _setup(8)  # 512 atoms, box > 3 cells/dim
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    lj = LJParams()
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    assert min(spec.ncells) >= 3

    core = pair_edm.init_state(
        bias_state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev"
    )

    # single-device (slot-resident), no hills
    step1 = make_cell_step(params, lp, lj, spec, hill_stride=10**6)
    ref, _ = step1(init_cell_state(spec, core), None)
    ref_x = np.asarray(atom_positions(spec, ref))

    mesh = make_mesh(8)
    sstate = init_sharded_cell_state(spec, core)
    stepN = make_sharded_cell_step(
        params, lp, lj, spec, hill_stride=10**6, mesh=mesh
    )
    got, _ = stepN(sstate)
    np.testing.assert_allclose(np.asarray(got.core.x), ref_x, rtol=2e-4, atol=2e-5)

    # with hills (thermal): runs, accumulates, replicas stay consistent
    lpT = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    stepH = make_sharded_cell_step(
        params, lpT, lj, spec, hill_stride=2, mesh=mesh, hill_capacity=512
    )
    st = sstate
    for _ in range(6):
        st, e = stepH(st)
    assert float(st.core.bias.cum_bias) > 0
    assert not bool(st.table_overflow)
    assert np.isfinite(np.asarray(st.core.x)).all()


def test_sharded_coord_host():
    """Data-parallel coordinate EDM on the 8-device mesh: many walkers
    deposit into one replicated bias (multiple-walker metadynamics)."""
    from edm_tpu.models import coord_edm
    from edm_tpu.parallel import make_mesh, make_sharded_coord_step, shard_coord_state
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 10\ndimension 1\n"
        "box_low 0\nbox_high 10\nbias_spacing 0.05\nbias_sigma 0.3\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [10], [0], [10], [True], [0], dtype=jnp.float32
    )
    lp = LangevinParams(dt=0.01, friction=2.0, kT=1.0)
    x0 = jnp.asarray(np.random.default_rng(0).uniform(0, 10, (64, 1)), jnp.float32)
    st = coord_edm.init_state(params, state, x0, jax.random.PRNGKey(0), lp)
    mesh = make_mesh(8)
    st = shard_coord_state(st, mesh)
    step = make_sharded_coord_step(params, lp, hill_stride=2, mesh=mesh)
    for _ in range(6):
        st, e = step(st)
    assert float(st.bias.cum_bias) > 0
    assert np.isfinite(np.asarray(st.x)).all()
    # replicas identical
    shards = [np.asarray(s.data) for s in st.bias.bias.grid.values.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)
    # 64 walkers x 3 hill rounds: histogram recorded all accepted hills
    assert float(jnp.sum(st.bias.cv_hist.values)) > 0


def test_sharded_coord_compaction_matches_full():
    """Compacted hill exchange in the sharded coord host: each device
    rank-compacts its accepted candidates before the all_gather (the
    reference's bounded exchange buffer, edm_bias.h:151-154), and the
    device-major re-compaction replays the full gathered batch's deposit
    order — same draws, same hills, same cap decisions.  Only the deposit
    reduction's summation order changes with the batch shape, so grids
    agree to rounding; the +-1 histogram scatter stays exact."""
    from edm_tpu.models import coord_edm
    from edm_tpu.parallel import make_mesh, make_sharded_coord_step, shard_coord_state
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 10\nhill_density 24\n"
        "dimension 1\nbox_low 0\nbox_high 10\nbias_spacing 0.05\nbias_sigma 0.3\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [10], [0], [10], [True], [0], dtype=jnp.float32
    )
    lp = LangevinParams(dt=0.01, friction=2.0, kT=1.0)
    x0 = jnp.asarray(np.random.default_rng(5).uniform(0, 10, (128, 1)), jnp.float32)
    mesh = make_mesh(8)

    def run(capacity):
        st = coord_edm.init_state(params, state, x0, jax.random.PRNGKey(2), lp)
        st = shard_coord_state(st, mesh)
        step = make_sharded_coord_step(
            params, lp, hill_stride=2, mesh=mesh, hill_capacity=capacity
        )
        for _ in range(6):
            st, e = step(st)
        return st

    sc = run(64)   # 64 < n_global=128 activates compaction (~24 hills/round)
    sf = run(0)    # full candidate gather
    assert not bool(sc.hills_truncated)
    gv_c = np.asarray(sc.bias.bias.grid.values)
    gv_f = np.asarray(sf.bias.bias.grid.values)
    np.testing.assert_allclose(
        gv_c, gv_f, atol=1e-6 * max(1.0, np.abs(gv_f).max()), rtol=1e-5
    )
    assert np.array_equal(
        np.asarray(sc.bias.cv_hist.values), np.asarray(sf.bias.cv_hist.values)
    )
    assert abs(float(sc.bias.cum_bias) - float(sf.bias.cum_bias)) < 1e-5
    assert float(sc.bias.cum_bias) > 0
    np.testing.assert_allclose(
        np.asarray(sc.x), np.asarray(sf.x), rtol=1e-5, atol=1e-5
    )


def test_sharded_pair_hills_logging(tmp_path):
    """Replicated-grid sharded pair host emits the HILLS stream (one log
    represents every replica — they replay identical gathered rounds)."""
    from edm_tpu.parallel import make_mesh, make_sharded_pair_step, shard_pair_state
    from edm_tpu.utils.hills_log import HillsLog

    params, bias_state, x0, box = _setup(4)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    mesh = make_mesh(8)
    core = pair_edm.init_state(bias_state, x0, jax.random.PRNGKey(0))
    state = shard_pair_state(core, mesh)
    step = make_sharded_pair_step(
        params, lp, LJParams(), box, hill_stride=2, mesh=mesh,
        hill_capacity=64, collect_records=True,
    )
    log = HillsLog(str(tmp_path / "SH_0"), 1, params.total_volume)
    cum = 0.0
    rounds = 0
    for r in range(4):
        state, e, lg = step(state)
        import numpy as _np

        lg = jax.device_get(lg)
        if bool(_np.asarray(lg.happened)):
            rec = lg.rec
            log.log_round(rounds, cum, rec, lg.positions)
            cum += float(_np.asarray(rec.round_bias))
            rounds += 1
    log.close()
    lines = [l.split() for l in (tmp_path / "SH_0").read_text().strip().splitlines()]
    assert lines and all(l[1] in "hubvz" and len(l) == 7 for l in lines)
    total = sum(float(l[5]) for l in lines)
    assert abs(total - float(state.bias.cum_bias)) < 1e-4


@pytest.mark.slow
def test_sharded_cells_hills_logging(tmp_path):
    """Sharded cell-list host emits the HILLS stream too (the last compiled
    host without it; one gathered log stream represents every replica)."""
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.parallel.cells import init_sharded_cell_state, make_sharded_cell_step
    from edm_tpu.utils.hills_log import HillsLog

    params, bias_state, x0, box = _setup(8)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    mesh = make_mesh(8)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    core = pair_edm.init_state(
        bias_state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev"
    )
    state = init_sharded_cell_state(spec, core)
    step = make_sharded_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, mesh=mesh,
        hill_capacity=64, collect_records=True,
    )
    log = HillsLog(str(tmp_path / "SC_0"), 1, params.total_volume)
    cum = 0.0
    rounds = 0
    for r in range(4):
        state, e, lg = step(state)
        lg = jax.device_get(lg)
        if bool(np.asarray(lg.happened)):
            log.log_round(rounds, cum, lg.rec, lg.positions)
            cum += float(np.asarray(lg.rec.round_bias))
            rounds += 1
    log.close()
    lines = [l.split() for l in (tmp_path / "SC_0").read_text().strip().splitlines()]
    assert lines and all(l[1] in "hubvz" and len(l) == 7 for l in lines)
    total = sum(float(l[5]) for l in lines)
    assert abs(total - float(state.core.bias.cum_bias)) < 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("force_impl", ["xla", "triton"])
def test_slab_cell_host_matches_single_device(force_impl, triton_interpret):
    """Slab-sharded slot-resident cells host (owned-row force pass per
    x-slab + halo, one psum/step) reproduces the single-device host's trajectory at
    kT > 0 — the slot-row-keyed thermostat noise draws identically under
    any decomposition, so only force-psum roundoff separates them — and
    the hill rounds replay bitwise."""
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.parallel.cells import make_slab_cell_step

    params, bias_state, x0, box = _setup(10)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    assert min(spec.ncells) >= 3
    core = pair_edm.init_state(
        bias_state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev",
        cheb_deg=16, cheb_panels=4,
    )
    st0 = init_cell_state(spec, core)

    step1 = make_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, force_impl=force_impl
    )
    mesh = make_mesh(8)
    stepN = make_slab_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, mesh=mesh,
        force_impl=force_impl,
    )
    s1, sN = st0, st0
    for _ in range(4):
        s1, _ = step1(s1, None)
        sN, _ = stepN(sN)
    np.testing.assert_allclose(
        np.asarray(sN.xs), np.asarray(s1.xs), rtol=1e-5, atol=1e-6
    )
    # the slab-sharded hill collection replays the single-device round
    # bitwise (same draws, same deposit order)
    assert np.array_equal(
        np.asarray(sN.core.bias.bias.grid.values),
        np.asarray(s1.core.bias.bias.grid.values),
    )
    assert abs(
        float(sN.core.bias.cum_bias) - float(s1.core.bias.cum_bias)
    ) < 1e-5
    assert float(sN.core.bias.cum_bias) > 0


@pytest.mark.slow
def test_slab_cell_host_hills_logging(tmp_path):
    """Slab-sharded host threads collect_records through shard_map: the
    replicated hill rounds give one HILLS stream for every replica and
    the logged bias reconciles with cum_bias."""
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state
    from edm_tpu.parallel.cells import make_slab_cell_step
    from edm_tpu.utils.hills_log import HillsLog

    params, bias_state, x0, box = _setup(8)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    mesh = make_mesh(8)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    core = pair_edm.init_state(
        bias_state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev",
        cheb_deg=16, cheb_panels=4,
    )
    state = init_cell_state(spec, core)
    step = make_slab_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, mesh=mesh,
        hill_capacity=512, collect_records=True,
    )
    log = HillsLog(str(tmp_path / "SL_0"), 1, params.total_volume)
    cum = 0.0
    rounds = 0
    for _ in range(4):
        state, (e, lg) = step(state)
        lg = jax.device_get(lg)
        if bool(np.asarray(lg.happened)):
            log.log_round(rounds, cum, lg.rec, lg.positions)
            cum += float(np.asarray(lg.rec.round_bias))
            rounds += 1
    log.close()
    lines = [l.split() for l in (tmp_path / "SL_0").read_text().strip().splitlines()]
    assert lines and all(l[1] in "hubvz" and len(l) == 7 for l in lines)
    total = sum(float(l[5]) for l in lines)
    assert abs(total - float(state.core.bias.cum_bias)) < 1e-4


def test_slab_sharded_hill_collection_matches_replicated():
    """Sharded hill collection (per-device pass over owned x-columns +
    all_gather + global re-compaction) must replay the IDENTICAL round as
    the replicated collection: same counter-hash draws (keyed by global
    row index), same deposit order, same truncation-at-capacity set —
    bitwise."""
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state
    from edm_tpu.parallel.cells import make_slab_cell_step

    params, bias_state, x0, box = _setup(8)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    mesh = make_mesh(8)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    core = pair_edm.init_state(
        bias_state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev",
        cheb_deg=16, cheb_panels=4,
    )
    st0 = init_cell_state(spec, core)
    step_sh = make_slab_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, mesh=mesh,
        hill_capacity=512,
    )
    step_rep = make_slab_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, mesh=mesh,
        hill_capacity=512, slab_collect=False,
    )
    s_sh, s_rep = st0, st0
    for _ in range(4):
        s_sh, _ = step_sh(s_sh)
        s_rep, _ = step_rep(s_rep)
    # the gathered + re-compacted round is BITWISE the replicated round
    # (including its truncation-at-capacity semantics), so the whole
    # trajectory matches exactly
    assert np.array_equal(np.asarray(s_sh.xs), np.asarray(s_rep.xs))
    assert np.array_equal(
        np.asarray(s_sh.core.bias.bias.grid.values),
        np.asarray(s_rep.core.bias.bias.grid.values),
    )
    assert float(s_sh.core.bias.cum_bias) > 0
    assert abs(
        float(s_sh.core.bias.cum_bias) - float(s_rep.core.bias.cum_bias)
    ) < 1e-5
    assert int(s_sh.core.last_calls) == int(s_rep.core.last_calls)


def test_shard_floor_bitwise():
    """Sharded-floor BAOAB (per-device owned-column phase 1 + fused (x, v)
    psum; shrunken per-device pass-2 row budgets) is BITWISE the
    full-replicated floor on the same slab decomposition at kT > 0: the
    counter-hash Box-Muller noise is keyed by global slot row, so the
    sliced draw equals the replicated draw, and the psum of disjoint
    owned windows is exact."""
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state
    from edm_tpu.parallel.cells import make_slab_cell_step

    params, bias_state, x0, box = _setup(8)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    mesh = make_mesh(8)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    core = pair_edm.init_state(
        bias_state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev",
        cheb_deg=16, cheb_panels=4,
    )
    st0 = init_cell_state(spec, core)
    step_f = make_slab_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, mesh=mesh,
        hill_capacity=512,
    )
    step_r = make_slab_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, mesh=mesh,
        hill_capacity=512, shard_floor=False,
    )
    s_f, s_r = st0, st0
    for _ in range(4):
        s_f, _ = step_f(s_f)
        s_r, _ = step_r(s_r)
    assert np.array_equal(np.asarray(s_f.xs), np.asarray(s_r.xs))
    assert np.array_equal(np.asarray(s_f.vs), np.asarray(s_r.vs))
    assert np.array_equal(
        np.asarray(s_f.core.bias.bias.grid.values),
        np.asarray(s_r.core.bias.bias.grid.values),
    )
    assert float(s_f.core.bias.cum_bias) > 0


@pytest.mark.slow
@pytest.mark.parametrize("grid", [(2, 4), (3, 2), (2, 2, 2)])
@pytest.mark.parametrize("force_impl", ["xla", "triton"])
def test_brick_cell_host_matches_single_device(grid, force_impl, triton_interpret):
    """Brick-decomposed cells host (owned-row force pass per x-range x
    y-range (x z-range) brick + halo ring, one psum/step over the mesh axes;
    brick-sharded hill collection merged by global row key) reproduces
    the single-device host's trajectory at kT > 0 (slot-row-keyed noise)
    — including ragged partitions (3 devices over 10 columns own 4/3/3)
    and the 3-D (2, 2, 2) grid."""
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.parallel import make_brick_mesh
    from edm_tpu.parallel.cells import make_brick_cell_step

    params, bias_state, x0, box = _setup(10)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    assert min(spec.ncells) >= 3
    core = pair_edm.init_state(
        bias_state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev",
        cheb_deg=16, cheb_panels=4,
    )
    st0 = init_cell_state(spec, core)

    step1 = make_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, force_impl=force_impl
    )
    mesh = make_brick_mesh(*grid)
    stepN = make_brick_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, mesh=mesh,
        force_impl=force_impl,
    )
    s1, sN = st0, st0
    for _ in range(4):
        s1, _ = step1(s1, None)
        sN, _ = stepN(sN)
    np.testing.assert_allclose(
        np.asarray(sN.xs), np.asarray(s1.xs), rtol=1e-5, atol=1e-6
    )
    # the brick-sharded hill collection merges to the EXACT single-device
    # round (same draws, same deposit order): the grids match bitwise
    assert np.array_equal(
        np.asarray(sN.core.bias.bias.grid.values),
        np.asarray(s1.core.bias.bias.grid.values),
    )
    assert abs(
        float(sN.core.bias.cum_bias) - float(s1.core.bias.cum_bias)
    ) < 1e-5
    assert float(sN.core.bias.cum_bias) > 0
    assert int(sN.core.last_calls) == int(s1.core.last_calls)


@pytest.mark.slow
@pytest.mark.parametrize("grid", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("force_impl", ["xla", "triton"])
def test_brick_cell_host_small_lattice_fallback(grid, force_impl, triton_interpret):
    """On lattices too small to slice a brick+halo window (wxm+2 > nx) the
    brick host falls back to the full lattice with rows restricted to the
    owned cells — trajectory and hill rounds still match the
    single-device host (2-D and 3-D grids)."""
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu.parallel import make_brick_mesh
    from edm_tpu.parallel.cells import make_brick_cell_step

    params, bias_state, x0, box = _setup(8)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    assert spec.ncells == (3, 3, 3)  # forces the fallback on both axes
    core = pair_edm.init_state(
        bias_state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev",
        cheb_deg=16, cheb_panels=4,
    )
    st0 = init_cell_state(spec, core)
    step1 = make_cell_step(
        params, lp, LJParams(), spec, hill_stride=2, hill_capacity=512,
        force_impl=force_impl,
    )
    stepN = make_brick_cell_step(
        params, lp, LJParams(), spec, hill_stride=2,
        mesh=make_brick_mesh(*grid), hill_capacity=512, force_impl=force_impl,
    )
    s1, sN = st0, st0
    for _ in range(3):
        s1, _ = step1(s1, None)
        sN, _ = stepN(sN)
    np.testing.assert_allclose(
        np.asarray(sN.xs), np.asarray(s1.xs), rtol=1e-5, atol=1e-6
    )
    assert np.array_equal(
        np.asarray(sN.core.bias.bias.grid.values),
        np.asarray(s1.core.bias.bias.grid.values),
    )
    assert float(sN.core.bias.cum_bias) > 0


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["slab", "brick"])
def test_local_planar_collection_matches_global(mode, monkeypatch):
    """The sharded hill collection's LOCAL planar candidate build (owned
    x-columns + one +x halo column, rolled to local origin; engaged by
    models.pair_edm_cells._local_planar_gate at production widths) is
    bitwise the GLOBAL planar build: same draws (keyed by global slot-row
    ids), same candidate tiles, same merged round — so whole trajectories
    at kT > 0 match exactly.  Toy lattices disengage the cost-model gate,
    so both settings are forced here."""
    import edm_tpu.models.pair_edm_cells as PC
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state
    from edm_tpu.parallel import make_brick_mesh
    from edm_tpu.parallel.cells import make_brick_cell_step, make_slab_cell_step

    params, bias_state, x0, box = _setup(10)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    core = pair_edm.init_state(
        bias_state, x0, jax.random.PRNGKey(0), pair_lookup="chebyshev",
        cheb_deg=16, cheb_panels=4,
    )
    st0 = init_cell_state(spec, core)

    def build():
        if mode == "slab":
            return make_slab_cell_step(
                params, lp, LJParams(), spec, hill_stride=2,
                mesh=make_mesh(4), hill_capacity=512,
            )
        return make_brick_cell_step(
            params, lp, LJParams(), spec, hill_stride=2,
            mesh=make_brick_mesh(2, 2), hill_capacity=512,
        )

    monkeypatch.setattr(PC, "_local_planar_gate", lambda loc, nx: True)
    step_loc = build()
    monkeypatch.setattr(PC, "_local_planar_gate", lambda loc, nx: False)
    step_glob = build()

    s_l, s_g = st0, st0
    for _ in range(4):
        s_l, _ = step_loc(s_l)
        s_g, _ = step_glob(s_g)
    for a, b in zip(
        jax.tree_util.tree_leaves(s_l), jax.tree_util.tree_leaves(s_g)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(s_l.core.bias.cum_bias) > 0  # hills actually landed
