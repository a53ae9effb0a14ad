"""Spatially-sharded coordinate EDM across a device mesh — the JAX
form of the reference's MPI domain decomposition (one bias-grid shard per
device, hills exchanged via all_gather, cum_bias via psum).

Runs on the CPU by default, on an 8-device virtual mesh:

    python examples/spatial_sharded.py

On a machine with several GPUs, ``JAX_PLATFORMS=cuda`` runs it on the
cards instead (the mesh takes up to 8 of them).
"""

import os

if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

import numpy as np

from edm_tpu.models.langevin import LangevinParams
from edm_tpu.parallel import (
    gather_spatial_grid,
    init_spatial_state,
    make_mesh,
    make_spatial_coord_step,
    rebin_spatial_atoms,
    spatial_subdivide,
)
from edm_tpu.parallel.spatial import log_spatial_round, write_spatial_grid
from edm_tpu.utils.config import parse_edm_text
from edm_tpu.utils.hills_log import HillsLog

N_DEV = min(8, len(jax.devices()))
CFG = parse_edm_text(
    "tempering 0\nhill_prefactor 0.2\nbias_per_step 2.0\ndimension 1\n"
    "box_low 0\nbox_high 16\nbias_spacing 0.02\nbias_sigma 0.2\n"
)


def make_target():
    """Experiment-directed target: an unnormalized -ln p(x) the sampled
    distribution should converge to (here: two preferred regions).  The
    grid is GLOBAL — every device holds it whole, like every MPI rank
    (edm_bias.cpp:1054-1064)."""
    import jax.numpy as jnp

    from edm_tpu.grid import Grid, GridSpec

    tspec = GridSpec.create([0.0], [16.0], [0.05], [True])
    xs = np.arange(tspec.nbins[0]) * tspec.dx[0]
    tvals = 1.2 * (1.0 - np.cos(2 * np.pi * xs / 8.0)) / 2.0
    return Grid(
        values=jnp.asarray(tvals, jnp.float32), derivs=None, spec=tspec,
        interpolate=False,
    )


def main():
    setup, template = spatial_subdivide(
        CFG, 1.0, 1.0, N_DEV, skin=1.2, target=make_target()
    )
    mesh = make_mesh(N_DEV)
    rng = np.random.default_rng(0)
    x0 = np.stack(
        [rng.uniform(0, 16, 64), np.zeros(64), np.zeros(64)], axis=-1
    )
    state = init_spatial_state(
        setup, template, x0, jax.random.PRNGKey(0), capacity=32, mesh=mesh
    )
    step = make_spatial_coord_step(
        setup, LangevinParams(dt=0.002, friction=2.0, kT=1.0),
        hill_stride=5, mesh=mesh, collect_records=True,
    )
    hills = [
        HillsLog(f"HILLS_{d}", 1, setup.params.total_volume) for d in range(N_DEV)
    ]
    cum, rounds = 0.0, 0
    for seg in range(4):
        for _ in range(25):
            state, e, logs = step(state)
            added = log_spatial_round(hills, logs, rounds, cum)
            if added or bool(np.asarray(logs.happened).any()):
                cum += added
                rounds += 1
        state = rebin_spatial_atoms(setup, state, mesh)  # atom migration
        print(f"segment {seg}: energy {float(np.asarray(e)):.4f} "
              f"cum_bias {float(np.asarray(state.bias.cum_bias)[0]):.4f}")
    for h in hills:
        h.close()
    write_spatial_grid(setup, state, "BIAS_GLOBAL")
    xg, vg = gather_spatial_grid(setup, state)
    print(f"global grid: {xg.shape[0]} points, max bias {vg.max():.4f}; "
          "wrote BIAS_GLOBAL + per-replica HILLS_<r>")


if __name__ == "__main__":
    main()
