"""Cell lists for short-range pair interactions — the neighbor structure
that stands in for LAMMPS's neighbor lists, which the reference consumes in
fix_edm_pair.cpp:166-206.

Design: atoms are binned into cells of edge >= the interaction range, so
all interacting pairs live within a 27-cell stencil.  Per-cell storage is a
fixed-capacity (C, cap) slot table; the pair pass (ops/cellforce.py) reads
each cell's 27 stencil blocks and evaluates a dense (cap, 27*cap) pair
tile, with no per-pair neighbour lists.

Everything is jit-compatible: the binning (argsort + segment ranks) runs
in-graph under a rebuild-stride ``lax.cond``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class CellSpec:
    ncells: Tuple[int, int, int]
    edge: Tuple[float, float, float]
    box: Tuple[float, float, float]
    cap: int  # atom slots per cell
    n_atoms: int

    @classmethod
    def create(cls, box, cutoff: float, n_atoms: int, cap: int | None = None):
        box = tuple(float(b) for b in box)
        nc = tuple(max(1, int(math.floor(b / cutoff))) for b in box)
        edge = tuple(b / n for b, n in zip(box, nc))
        if cap is None:
            density = n_atoms / (box[0] * box[1] * box[2])
            mean = density * edge[0] * edge[1] * edge[2]
            # mean + 4 sigma Poisson headroom, rounded up to a multiple of
            # 8; slot count scales ~cap^2 so slack is quadratic cost.
            # Overflow is detected at table build and surfaced as a flag.
            cap = max(8, int(math.ceil(mean + 4 * math.sqrt(max(mean, 1.0)))))
            cap = ((cap + 7) // 8) * 8
        return cls(ncells=nc, edge=edge, box=box, cap=int(cap), n_atoms=int(n_atoms))

    @property
    def n_cells(self) -> int:
        return self.ncells[0] * self.ncells[1] * self.ncells[2]

    @property
    def n_slots(self) -> int:
        return self.n_cells * self.cap

    def stencil(self) -> np.ndarray:
        """(C, 27) neighbor-cell ids with periodic wrap (static table)."""
        nx, ny, nz = self.ncells
        cid = np.arange(self.n_cells)
        cx, cy, cz = cid // (ny * nz), (cid // nz) % ny, cid % nz
        out = np.empty((self.n_cells, 27), np.int32)
        k = 0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    out[:, k] = (
                        ((cx + dx) % nx) * ny * nz + ((cy + dy) % ny) * nz + ((cz + dz) % nz)
                    )
                    k += 1
        return out


class CellTable(NamedTuple):
    aid: jax.Array  # (C*cap,) atom id per slot; n_atoms marks empty
    overflow: jax.Array  # bool: a cell exceeded cap


def cell_of(spec: CellSpec, x: jax.Array) -> jax.Array:
    """Per-atom flat cell index from wrapped positions."""
    box = jnp.asarray(spec.box, x.dtype)
    edge = jnp.asarray(spec.edge, x.dtype)
    nc = jnp.asarray(spec.ncells, jnp.int32)
    xw = x - box * jnp.floor(x / box)
    c = jnp.clip(jnp.floor(xw / edge).astype(jnp.int32), 0, nc - 1)
    ny, nz = spec.ncells[1], spec.ncells[2]
    return c[:, 0] * (ny * nz) + c[:, 1] * nz + c[:, 2]


def build_table(spec: CellSpec, x: jax.Array) -> CellTable:
    """Bin atoms into slots (argsort + segment ranks); jit-compatible."""
    n = spec.n_atoms
    cid = cell_of(spec, x)
    order = jnp.argsort(cid)  # stable
    cid_s = cid[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), cid_s[1:] != cid_s[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(first, jnp.arange(n), 0))
    rank = jnp.arange(n) - seg_start
    overflow = jnp.any(rank >= spec.cap)
    slot = cid_s * spec.cap + jnp.clip(rank, 0, spec.cap - 1)
    aid = jnp.full((spec.n_slots,), n, jnp.int32).at[slot].set(
        order.astype(jnp.int32), mode="drop"
    )
    return CellTable(aid=aid, overflow=overflow)


class RebinPlan(NamedTuple):
    """Mover placement for a slot-to-slot incremental rebin."""

    feasible: jax.Array  # bool: every mover fits a hole of its target cell
    n_movers: jax.Array  # int32
    m_src: jax.Array  # (M,) flat source slot, sorted by target cell; S = none
    m_dest: jax.Array  # (M,) flat destination slot; S = drop


def plan_incremental_rebin(
    spec: CellSpec, aid_g: jax.Array, xs: jax.Array, mover_cap: int
) -> RebinPlan:
    """Plan a slot-to-slot rebin: stayers keep their slots; atoms that
    crossed a cell boundary since the last rebuild ("movers", ~1-2% of
    atoms at typical rebuild strides) are extracted into a compact list
    and assigned free holes of their target cells.

    The full argsort rebuild round-trips every atom through atom order —
    ~2M gather/scatter elements at 100k atoms — while this plan's cost is
    one S-element compaction scatter plus O(mover_cap) work.  ``feasible`` is False when movers exceed
    ``mover_cap`` or a target cell lacks holes (holes include slots
    vacated this rebin); callers then fall back to the full rebuild, so
    no atom is ever dropped."""
    n = spec.n_atoms
    cap = spec.cap
    C = spec.n_cells
    S = C * cap
    aid2 = aid_g.reshape(C, cap)
    real = aid_g < n
    new_cid = cell_of(spec, xs.reshape(S, 3))
    cur_cid = (jnp.arange(S, dtype=jnp.int32) // cap)
    mover = real & (new_cid != cur_cid)
    n_mov = jnp.sum(mover.astype(jnp.int32))

    ranks = jnp.cumsum(mover.astype(jnp.int32)) - 1
    tgt = jnp.where(mover & (ranks < mover_cap), ranks, mover_cap)
    m_src = jnp.full((mover_cap,), S, jnp.int32).at[tgt].set(
        jnp.arange(S, dtype=jnp.int32), mode="drop"
    )
    msrc_c = jnp.clip(m_src, 0, S - 1)
    m_cell = jnp.where(m_src < S, new_cid[msrc_c], C).astype(jnp.int32)
    order = jnp.argsort(m_cell, stable=True)
    m_cell_s = m_cell[order]
    m_src_s = m_src[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), m_cell_s[1:] != m_cell_s[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(first, jnp.arange(mover_cap), 0))
    q = jnp.arange(mover_cap) - seg_start

    # holes: pre-existing empty slots plus slots vacated by movers, so
    # cell-to-cell swaps at full occupancy stay feasible
    empty_eff = (aid2 == n) | mover.reshape(C, cap)
    hrank = jnp.cumsum(empty_eff.astype(jnp.int32), axis=1) - 1
    holes_per_cell = hrank[:, -1] + 1
    # ht[c, q] = the q-th hole slot of cell c (slot order), via a one-hot
    # rank sum, which fuses into one (C, cap, cap) masked reduction instead
    # of a per-row argsort over (C, cap)
    qi = jnp.arange(cap, dtype=jnp.int32)
    oh = empty_eff[:, :, None] & (hrank[:, :, None] == qi[None, None, :])
    ht = jnp.sum(
        oh * jnp.arange(cap, dtype=jnp.int32)[None, :, None], axis=1
    ).astype(jnp.int32)

    valid = m_src_s < S
    c_cl = jnp.clip(m_cell_s, 0, C - 1)
    slot = ht[c_cl, jnp.clip(q, 0, cap - 1).astype(jnp.int32)]
    fits = q < holes_per_cell[c_cl]
    m_dest = jnp.where(valid & fits, c_cl * cap + slot, S).astype(jnp.int32)
    feasible = (n_mov <= mover_cap) & jnp.all(~valid | fits)
    return RebinPlan(
        feasible=feasible, n_movers=n_mov, m_src=m_src_s, m_dest=m_dest
    )


def apply_incremental_rebin(spec: CellSpec, plan: RebinPlan, aid_g, arrays):
    """Relocate movers per plan.  ``arrays``: flat (S, ...) slot payload
    arrays moved alongside the id table.  Sources are cleared before
    destinations are written, so arrivals may reuse slots vacated this
    rebin.  Returns (new_aid_g, [new arrays]); stale payload left in
    vacated slots is masked everywhere by the (aid < n) occupancy mask."""
    n = spec.n_atoms
    S = aid_g.shape[0]
    src_ok = plan.m_src < S
    src_c = jnp.clip(plan.m_src, 0, S - 1)
    aid_new = aid_g.at[jnp.where(src_ok, plan.m_src, S)].set(n, mode="drop")
    m_aid = jnp.where(src_ok, aid_g[src_c], n)
    aid_new = aid_new.at[plan.m_dest].set(m_aid, mode="drop")
    outs = []
    for a in arrays:
        outs.append(a.at[plan.m_dest].set(a[src_c], mode="drop"))
    return aid_new, outs
