"""The measurements behind ``bench.FORCE_IMPL`` and the Triton force
kernel's launch constants, on one NVIDIA GPU.

Prints one JSON line per measurement, each naming the device (as
bench.py does):

  - the isolated force pass (exact lookup, energy off) at 10k and 100k
    atoms, XLA and the kernel in turns (XLA, kernel, kernel, XLA) so that
    drift shows;
  - the kernel's launch-shape sweep: BLOCK x NUM_WARPS x NUM_STAGES of
    ops/cellforce_triton.py at both sizes;
  - bench.py's three pairwise metrics end to end, in the same turns.

Exits non-zero when JAX finds no GPU or any measurement but a sweep point
failed (a launch shape the compiler refuses is a result of the sweep).

Usage: python force_ab.py
"""

import itertools
import json
import time

import numpy as np

import bench


def force_pass_ms(n_atoms, impl, reps=20):
    """Median wall ms of one isolated force pass (exact lookup, energy
    off) on the seeded ``n_atoms`` system, each call ending in
    block_until_ready; compilation and one warm call are excluded."""
    import jax

    from edm_tpu.models.pair_edm_cells import init_cell_state
    from edm_tpu.ops.cellforce import lattice_force

    _, core, spec, _, lj = bench.seeded_pairwise_system(n_atoms, "interp")
    st = init_cell_state(spec, core)
    table = core.bias.bias
    f = jax.jit(lambda xs, mc: lattice_force(
        xs, mc, mc, spec.ncells, spec.box, lj, table, False, impl=impl,
        cell_chunk=81,
    ))
    jax.block_until_ready(f(st.xs, st.mc))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(st.xs, st.mc))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def force_ab(device):
    """Runs every measurement of the module docstring, one JSON line each
    tagged with ``device``; True when all but the sweep points succeeded."""
    import edm_tpu.ops.cellforce_triton as CT

    def line(fn, **key):
        try:
            key.update(fn())
        except Exception as e:  # noqa: BLE001 — report and go on
            key["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(dict(key, device=device)), flush=True)
        return "error" not in key

    turns = ("xla", "triton", "triton", "xla")
    ok = True
    for n in (10000, 100000):
        for impl in turns:
            ok &= line(lambda: {"force_ms": force_pass_ms(n, impl)},
                       atoms=n, impl=impl)
    base = (CT.BLOCK, CT.NUM_WARPS, CT.NUM_STAGES)
    try:
        for n, shape in itertools.product(
            (10000, 100000), itertools.product((8, 16, 32), (1, 2, 4, 8), (1, 2))
        ):
            CT.BLOCK, CT.NUM_WARPS, CT.NUM_STAGES = shape
            line(lambda: {"force_ms": force_pass_ms(n, "triton")},
                 atoms=n, impl="triton", block=shape[0], num_warps=shape[1],
                 num_stages=shape[2])
    finally:
        CT.BLOCK, CT.NUM_WARPS, CT.NUM_STAGES = base
    cells = (
        ("10k exact", dict()),
        ("10k Chebyshev", dict(pair_lookup="chebyshev")),
        ("100k exact", dict(n_atoms=100000, steps=100)),
    )
    for cell, kw in cells:
        for impl in turns:
            ok &= line(
                lambda: {"steps_per_s": bench.bench_pairwise(force_impl=impl, **kw)},
                cell=cell, impl=impl,
            )
    return ok


def main():
    from edm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(0 if force_ab(bench.device_identity()) else 1)


if __name__ == "__main__":
    main()
