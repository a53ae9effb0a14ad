"""Exact checkpoint/resume (utils/checkpoint.py): a continued run is
bit-identical to an uninterrupted one — including the deferred-hill buffer,
cum_bias/tempering state, and RNG keys, which the reference's grid-file
resume loses (edm_bias.cpp:1066-1072)."""

import numpy as np
import jax
import jax.numpy as jnp

from edm_tpu import bias as B
from edm_tpu.models import pair_edm
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.utils.checkpoint import load_state, save_state
from edm_tpu.utils.config import parse_edm_text


def _mk_state():
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.5\nbias_per_step 0.4\nhill_density -1\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, bias_state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=jnp.float64
    )
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.uniform(0.5, 3.5, (8, 3)), jnp.float64)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.5)
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=1.4)
    step = pair_edm.make_step(params, lp, lj, [4.0] * 3, hill_stride=2,
                              hill_capacity=64)
    state = pair_edm.init_state(bias_state, x0, jax.random.PRNGKey(1))
    return step, state, params, bias_state


def test_exact_resume_bitwise(tmp_path):
    step, state, params, _ = _mk_state()
    seg = jax.jit(lambda s, n: jax.lax.scan(step, s, None, length=n),
                  static_argnums=1)

    # uninterrupted: 12 steps
    full, _ = seg(state, 12)

    # interrupted: 6 steps, checkpoint (with a non-empty deferred buffer),
    # rebuild from scratch, resume 6 more
    mid, _ = seg(state, 6)
    assert int(mid.bias.buf_right) > int(mid.bias.buf_left), (
        "test config should leave deferred hills in the buffer"
    )
    ckpt = tmp_path / "state.npz"
    save_state(mid, str(ckpt))

    _, fresh, _, _ = _mk_state()  # fresh template, same static config
    resumed = load_state(fresh, str(ckpt))
    cont, _ = seg(resumed, 6)

    for a, b in zip(jax.tree_util.tree_leaves(full),
                    jax.tree_util.tree_leaves(cont)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mismatched_structure_rejected(tmp_path):
    from edm_tpu.utils.errors import EDMError

    step, state, params, bias_state = _mk_state()
    ckpt = tmp_path / "b.npz"
    save_state(bias_state, str(ckpt))  # engine state only
    import pytest

    with pytest.raises(EDMError):
        load_state(state, str(ckpt))  # full host state template: mismatch


def test_sharded_host_resume_bitwise(tmp_path):
    """Checkpoint/resume of a SHARDED host state (slab cells host on the
    8-device mesh): load_state restores each leaf with the template's
    sharding, and a resumed run is bitwise an uninterrupted one — the
    production restart path the reference's grid-file resume cannot
    provide under MPI (buffer/cum_bias/RNG lost, edm_bias.cpp:1066-1072)."""
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import init_cell_state
    from edm_tpu.parallel import make_mesh
    from edm_tpu.parallel.cells import make_slab_cell_step

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )

    def mk():
        params, bias_state = B.subdivide(
            cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
            dtype=jnp.float32,
        )
        a = 1.26
        pts = (
            np.stack(
                np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1
            ).reshape(-1, 3) * a + 0.5 * a
        )
        box = [8 * a] * 3
        spec = CellSpec.create(box, cutoff=3.0, n_atoms=pts.shape[0])
        core = pair_edm.init_state(
            bias_state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0),
            pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4,
        )
        st = init_cell_state(spec, core)
        step = make_slab_cell_step(
            params, LangevinParams(dt=0.002, friction=1.0, kT=0.8),
            LJParams(), spec, hill_stride=2, mesh=make_mesh(8),
            hill_capacity=512,
        )
        return step, st

    step, st0 = mk()
    full = st0
    for _ in range(4):
        full, _ = step(full)

    mid = st0
    for _ in range(2):
        mid, _ = step(mid)
    ckpt = tmp_path / "slab.npz"
    save_state(mid, str(ckpt))

    step2, fresh = mk()
    resumed = load_state(fresh, str(ckpt))
    cont = resumed
    for _ in range(2):
        cont, _ = step2(cont)

    for a, b in zip(jax.tree_util.tree_leaves(full),
                    jax.tree_util.tree_leaves(cont)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_spatial_sharded_resume_bitwise(tmp_path):
    """Resume of an explicitly-sharded state (SpatialCoordState, P(dp)
    leaves committed by init_spatial_state): load_state restores each
    leaf onto the template's sharding (the committed-template branch)."""
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
    mesh = make_mesh(8)
    xs = np.asarray(
        [[d * 1.25 + 0.3, 0.0, 0.0] for d in range(8)]
        + [[d * 1.25 + 1.2, 0.0, 0.0] for d in range(8)]
    )
    lp = LangevinParams(dt=1e-8, friction=0.0, kT=0.0)

    def mk():
        setup, tmpl = spatial_subdivide(cfg, 1.0, 1.0, 8, 1.25,
                                        dtype=jnp.float64)
        st = init_spatial_state(
            setup, tmpl, xs, jax.random.PRNGKey(3), capacity=4, mesh=mesh
        )
        step = make_spatial_coord_step(setup, lp, hill_stride=1, mesh=mesh)
        return step, st

    step, st0 = mk()
    full = st0
    for _ in range(3):
        full, _ = step(full)

    mid = st0
    mid, _ = step(mid)
    ckpt = tmp_path / "spatial.npz"
    save_state(mid, str(ckpt))

    step2, fresh = mk()
    resumed = load_state(fresh, str(ckpt))
    # the committed-template branch restored the P(dp) sharding
    assert resumed.x.sharding == fresh.x.sharding
    cont = resumed
    for _ in range(2):
        cont, _ = step2(cont)

    for a, b in zip(jax.tree_util.tree_leaves(full),
                    jax.tree_util.tree_leaves(cont)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
