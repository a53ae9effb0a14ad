"""Langevin dynamics integrator (BAOAB splitting).

The reference delegates integration to LAMMPS (fix nve + fix langevin);
this module is the MD front end: a pure, jit-compatible step.
BAOAB gives accurate configurational sampling at large dt — the right choice
for sampling-driven metadynamics.

State is a plain pytree; the force function is supplied by the host model
(bias force, LJ, external potential, ...) so the integrator composes under
``lax.scan``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LangevinParams:
    dt: float = dataclasses.field(metadata=dict(static=True))
    friction: float = dataclasses.field(metadata=dict(static=True))  # gamma, 1/time
    kT: float = dataclasses.field(metadata=dict(static=True))
    mass: float = dataclasses.field(metadata=dict(static=True), default=1.0)


def baoab_step(
    p: LangevinParams,
    x: jax.Array,
    v: jax.Array,
    f: jax.Array,
    key: jax.Array,
    force_fn: Callable[[jax.Array], Tuple[jax.Array, jax.Array]],
):
    """One BAOAB step.  ``force_fn(x) -> (energy, force)``.

    Returns (x', v', f', energy, key').
    """
    dt = p.dt
    m = p.mass
    c1 = jnp.exp(-p.friction * dt)
    c2 = jnp.sqrt((1.0 - c1 * c1) * p.kT / m)

    v = v + 0.5 * dt * f / m  # B
    x = x + 0.5 * dt * v  # A
    key, sub = jax.random.split(key)
    xi = jax.random.normal(sub, v.shape, v.dtype)
    v = c1 * v + c2 * xi  # O
    x = x + 0.5 * dt * v  # A
    energy, f = force_fn(x)
    v = v + 0.5 * dt * f / m  # B
    return x, v, f, energy, key
