"""edm-tpu: a JAX (XLA, with Pallas kernels) experiment-directed metadynamics
framework with the capabilities of whitead/electronic-dance-music.

Layering (cf. SURVEY.md §1):
  grid.py         dense N-D grid storage (reference lib/grid.h)
  gauss.py        Gaussian hill deposition kernels (reference lib/gaussian_grid.h)
  bias.py         the EDM bias engine as pure state transitions (lib/edm_bias.cpp)
  api.py          user-facing EDMBias mirroring the Python binding surface
  models/         MD hosts (Langevin, LJ) standing in for the LAMMPS fixes
  parallel/       jax.sharding mesh scale-out (replaces MPI hill exchange)
  ops/            interpolation / deposition / capping kernels
  utils/          config parsing, Plumed-1 I/O, hills log, errors
"""

from .grid import Grid, GridSpec, grid_points
from .gauss import GaussGrid, GaussSpec
from .utils.errors import EDMError, edm_error
from .api import EDMBias

__version__ = "0.1.0"

__all__ = [
    "Grid",
    "GridSpec",
    "GaussGrid",
    "GaussSpec",
    "grid_points",
    "EDMBias",
    "EDMError",
    "edm_error",
]
