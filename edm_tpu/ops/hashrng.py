"""Counter-based uniform hashing for hill-acceptance sampling.

The reference draws one RanMars uniform per candidate pair per hill step
(fix_edm_pair.cpp:229-237); this build's streams already differ (README
parity ledger: deterministic jax.random replaces RanMars — statistical,
not bitwise, reproducibility).  The production hosts need ~2e8 uniforms
per hill round at 100k atoms, and Threefry costs ~40 integer ops per draw.

This module provides a murmur3-finalizer counter hash (~10 ops/draw): each (row, column) candidate
slot gets an independent 32-bit uniform keyed by two seeds derived from
the round's Threefry key, so the stream stays deterministic per (key,
slot) and re-derivable between the count and extract passes.  The
finalizer passes avalanche tests; 32-bit granularity (~2.3e-10) is far
below any acceptance threshold in use.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_GOLD = 0x9E3779B9
_MUR1 = 0x85EBCA6B
_MUR2 = 0xC2B2AE35


def seeds_from_key(key) -> jax.Array:
    """Two uint32 seeds from a jax PRNG key (one tiny Threefry draw)."""
    return jax.random.bits(key, (2,), jnp.uint32)


def normal_rows_cols(seeds, rows, n_cols: int, dtype) -> jax.Array:
    """(R,) int32 row ids -> (R, n_cols) standard normals (Box-Muller).

    Deterministic in (seeds, row, col), so a SLICED row range draws the
    exact values the full range draws at those rows — the property the
    sharded-floor BAOAB integration needs: each device draws thermostat
    noise only for its owned slot rows and the result is bitwise the
    replicated draw (models/pair_edm_cells).  The reference has no analog
    (LAMMPS owns the thermostat; RanMars is seeded per rank,
    fix_edm.cpp:61).  Box-Muller from two independent column streams;
    u1 is offset by 2^-33 so log(u1) is finite at the (p = 2^-32) zero
    draw, bounding |z| at ~6.8 sigma."""
    u = uniform_rows_cols(seeds, rows, 2 * n_cols, dtype)
    u1 = u[:, :n_cols] + jnp.asarray(2.0 ** -33, dtype)
    u2 = u[:, n_cols:]
    r = jnp.sqrt(jnp.asarray(-2.0, dtype) * jnp.log(u1))
    return r * jnp.cos(jnp.asarray(2.0 * 3.14159265358979323846, dtype) * u2)


def uniform_rows_cols(seeds, rows, n_cols: int, dtype) -> jax.Array:
    """(R,) int32 row ids -> (R, n_cols) uniforms in [0, 1).

    Deterministic in (seeds, row, col): calling twice with the same rows
    (e.g. the count pass and the extract pass) yields identical draws.
    """
    s0 = seeds[0]
    s1 = seeds[1]
    r = rows.astype(jnp.uint32)[:, None]
    c = jnp.arange(n_cols, dtype=jnp.uint32)[None, :]
    h = s0 + r * jnp.uint32(_GOLD) + c * jnp.uint32(_MUR1)
    h = h ^ s1
    h = h ^ (h >> 16)
    h = h * jnp.uint32(_MUR1)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(_MUR2)
    h = h ^ (h >> 16)
    return h.astype(dtype) * jnp.asarray(2.3283064365386963e-10, dtype)
