"""Lennard-Jones fluid forces — the physical system under the pairwise EDM
host (stands in for LAMMPS pair_lj_cut).

Dense O(N^2) pair math with minimum-image convention, fully vectorized;
the blocked variant (lax.map over row blocks) bounds memory to O(block*N)
for larger N, and the cell hosts (models/pair_edm_cells.py) make the pair
work O(N).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LJParams:
    epsilon: float = dataclasses.field(metadata=dict(static=True), default=1.0)
    sigma: float = dataclasses.field(metadata=dict(static=True), default=1.0)
    rcut: float = dataclasses.field(metadata=dict(static=True), default=2.5)


def pair_displacements(x: jax.Array, box) -> Tuple[jax.Array, jax.Array]:
    """All-pairs minimum-image displacements and distances.

    Returns (disp (N,N,3), r (N,N)); r on the diagonal is set to +inf so
    self-pairs drop out of every downstream cutoff mask.
    """
    box = jnp.asarray(box, x.dtype)
    disp = x[:, None, :] - x[None, :, :]
    disp = disp - jnp.round(disp / box) * box
    r2 = jnp.sum(disp * disp, axis=-1)
    n = x.shape[0]
    eye = jnp.eye(n, dtype=bool)
    r = jnp.sqrt(jnp.where(eye, jnp.inf, r2))
    return disp, r


def lj_energy_forces(p: LJParams, disp: jax.Array, r: jax.Array):
    """Truncated (unshifted) LJ from precomputed displacements."""
    inr = jnp.where(r < p.rcut, 1.0 / r, 0.0)
    sr6 = (p.sigma * inr) ** 6
    e_pair = 4 * p.epsilon * (sr6 * sr6 - sr6)  # (N, N)
    # f(r)/r along disp: dU/dr = 4 eps (-12 sr12 + 6 sr6)/r
    fmag_over_r = 4 * p.epsilon * (12 * sr6 * sr6 - 6 * sr6) * inr * inr
    forces = jnp.sum(fmag_over_r[..., None] * disp, axis=1)
    energy = 0.5 * jnp.sum(e_pair)
    return energy, forces
