"""Device-mesh helpers — the stand-in for MPI_COMM_WORLD.

The reference's communicator bootstrap (MPI_Comm_rank/size,
edm_bias.cpp:63-66) maps to a 1-D ``jax.sharding.Mesh`` over the data
axis; collectives are psum/all_gather inside shard_map.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


DATA_AXIS = "dp"
BRICK_X_AXIS = "bx"
BRICK_Y_AXIS = "by"
BRICK_Z_AXIS = "bz"


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_brick_mesh(
    px: int, py: int, pz: Optional[int] = None, axes: Optional[tuple] = None
) -> Mesh:
    """(px, py[, pz]) device grid for brick decomposition.  The cards of
    one host are joined all to all, so the shape follows the algorithm
    (halo fraction per device) and not the wiring."""
    shape = (px, py) if pz is None else (px, py, pz)
    if axes is None:
        axes = (BRICK_X_AXIS, BRICK_Y_AXIS, BRICK_Z_AXIS)[: len(shape)]
    n = int(np.prod(shape))
    devs = jax.devices()
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]).reshape(shape), tuple(axes))
