"""Weak-scaling proxy for the sharded cell hosts on the virtual CPU mesh.

The CPU "mesh" time-slices one physical core across its virtual devices,
so wall-clock speedup is not measurable with it.  What it does measure:

1. **Per-device work balance**: the decomposition's cells-per-device
   spread (asserted <= one column per sharded axis), which on real
   hardware bounds the load-imbalance term of the scaling efficiency.
2. **Aggregate-work overhead**: T(n devices, n x work) / (n * T(1 device,
   1 x work)).  On a single core every device's compute serializes, so this
   ratio isolates the *extra* work the sharded program does per device
   (halo cells, collectives, replicated hill rounds) — the terms that
   erode weak scaling on real hardware, minus interconnect time.

All three decompositions are measured: the 1-D slab (per-device
x-columns), the 2-D brick (x-range x y-range bricks) and the 3-D brick
((2,2,2) grid).  The force pass runs rows only over the device's owned
cell sub-box (``row_box``), so the halo ring costs no row-side compute —
it survives only as candidate cells and psum payload.  The bricks' value
over the slab: they keep scaling past n = nx devices where the slab
saturates.

With the sharded floor (shard_floor, default on) the fixed-shape global
costs (the pass-2/extraction row budget, the thermostat draw) split per
device instead of replicating.

These are CPU-mesh numbers: they describe work, not device time.

Run: python examples/weak_scaling_cpu_mesh.py  (forces an 8-device CPU mesh)
Prints one JSON line per configuration.
"""

import json
import os
import time

if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

import numpy as np
import jax.numpy as jnp

from edm_tpu import bias as B
from edm_tpu.models import pair_edm
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import init_cell_state
from edm_tpu.parallel import make_brick_mesh, make_mesh
from edm_tpu.parallel.cells import make_brick_cell_step, make_slab_cell_step
from edm_tpu.utils.config import parse_edm_text

SIDE_PER_DEV = 8  # 8x8x8 lattice = 512 atoms per device at density 0.5
A = 1.26
STEPS = 10


def run(n_dev: int, grid=None):
    """grid=None: 1-D slab over n_dev; grid=(px, py[, pz]): 2-D/3-D brick
    (the atom lattice grows along every sharded axis so work/device is
    constant)."""
    if grid and len(grid) == 3:
        px, py, pz = grid
    else:
        px, py = grid if grid else (n_dev, 1)
        pz = 1
    nx, ny, nz = SIDE_PER_DEV * px, SIDE_PER_DEV * py, SIDE_PER_DEV * pz
    n_atoms = nx * ny * nz
    pts = (
        np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij"), -1).reshape(-1, 3) * A + 0.5 * A
    )
    box = [nx * A, ny * A, nz * A]
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 100\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, bias_state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0]
    )
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=n_atoms)
    core = pair_edm.init_state(
        bias_state, jnp.asarray(pts, jnp.float32), jax.random.PRNGKey(0),
        n_est=n_atoms * 20, pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4,
    )
    state = init_cell_state(spec, core)
    kw = dict(hill_stride=10, rebuild_stride=10, energy_stride=10)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    cols = []
    for n_ax, p_ax in ((spec.ncells[0], px), (spec.ncells[1], py),
                       (spec.ncells[2], pz)):
        q, rem = divmod(n_ax, p_ax)
        c = [q + (d < rem) for d in range(p_ax)]
        assert max(c) - min(c) <= 1, f"imbalance: columns per device {c}"
        cols.append(c)
    if grid:
        step = make_brick_cell_step(
            params, lp, LJParams(), spec, mesh=make_brick_mesh(*grid), **kw
        )
    else:
        step = make_slab_cell_step(
            params, lp, LJParams(), spec, mesh=make_mesh(n_dev), **kw
        )

    state, _ = step(state)  # compile + settle
    best = None
    s = state
    for _ in range(3):
        t0 = time.perf_counter()
        s = state
        for _ in range(STEPS):
            s, e = step(s)
        float(jnp.sum(s.xs))  # force completion
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    # the sharded-floor per-device row budgets must not truncate at this
    # workload (truncation would silently shrink the hill rounds measured)
    assert not bool(s.table_overflow) and not bool(s.core.hills_truncated)
    return {
        "mode": (
            "x".join(str(p) for p in grid).join(("brick ", ""))
            if grid
            else "slab"
        ),
        "n_dev": n_dev,
        "atoms": n_atoms,
        "cells_per_dev_xyz": cols,
        "steps_per_sec": round(STEPS / best, 3),
        "sec_per_step": round(best / STEPS, 4),
    }


def main():
    rows = []
    for n, grid in ((1, None), (2, None), (4, None), (8, None),
                    (4, (2, 2)), (8, (4, 2)), (8, (2, 2, 2))):
        r = run(n, grid)
        rows.append(r)
        print(json.dumps(r), flush=True)
    t1 = rows[0]["sec_per_step"]
    for r in rows[1:]:
        # aggregate-work overhead: extra per-device work under sharding
        # (halo columns + collectives + replicated rounds), the scaling
        # loss term measurable on a time-sliced single-core mesh
        r["agg_overhead"] = round(r["sec_per_step"] / (r["n_dev"] * t1) - 1, 3)
        print(json.dumps({"mode": r["mode"], "n_dev": r["n_dev"],
                          "agg_overhead": r["agg_overhead"]}))


if __name__ == "__main__":
    main()
