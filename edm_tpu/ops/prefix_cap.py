"""Bias-per-step capping — the sequential hill-limiter semantics of the
reference (do_add_hill, lib/edm_bias.cpp:444-526; flush_bias_buffer,
lib/edm_bias.cpp:313-380) computed by parallel prefix sums.

The reference deposits hills one at a time, tracking the cumulative bias
added this step (``temp_hill_cum_``); the hill that crosses ``bias_per_step``
is deposited in full then *partially undone* so the cap is met exactly, and
the remainder (plus every later hill) is deferred to an overflow buffer —
dropping instead of deferring would bias the sampling (README.md:20-24).

Deposition is linear in hill height and the per-hill integral-per-unit-height
``s_k`` depends only on geometry, so the sequential decision reduces to
locating the prefix-sum crossing of the cap: everything before the crossing
deposits in full, the straddler gets the partial undo, everything after
defers.  One wrinkle keeps this from being a single pass: when the
straddler's s_k > 1 (possible from grid round-off — the case the reference's
regression test guards, edm_test.cpp:823), the post-undo cumulative dips
back *below* the cap and the next hill deposits again; a ``while_loop`` of
parallel passes handles each crossing (virtually always exactly one pass).

A naive ``lax.scan`` over hills is semantically identical but runs one
sequential scalar iteration per hill (2048 per round at the reference's
buffer size); the prefix form is a few fused cumsum/where passes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CapResult(NamedTuple):
    dep_heights: jax.Array  # effective deposited height per hill
    defer_heights: jax.Array  # remainder pushed to the overflow buffer
    deposited: jax.Array  # bool: do_add_hill took the deposit branch
    straddled: jax.Array  # bool: partial-undo happened
    cum: jax.Array  # final temp_hill_cum


def cap_scan(heights, weights, active, cap, cum0) -> CapResult:
    """New-hill capping (do_add_hill with communicate=1, edm_bias.cpp:465-523).

    heights/weights/active: (H,) aligned with deposit order; cum0 is the
    bias already added this step (from the buffer drain).
    """
    dtype = heights.dtype
    N = heights.shape[0]
    cap = jnp.asarray(cap, dtype)
    cum0 = jnp.asarray(cum0, dtype)
    idxs = jnp.arange(N, dtype=jnp.int32)
    contrib_all = jnp.where(active, heights * weights, 0)

    class _St(NamedTuple):
        cum: jax.Array
        start: jax.Array
        dep: jax.Array
        defer: jax.Array
        deposited: jax.Array
        straddled: jax.Array
        done: jax.Array

    # cum0 already at/over the cap: every active hill defers whole
    init_done = cum0 >= cap
    st0 = _St(
        cum=cum0,
        start=jnp.zeros((), jnp.int32),
        dep=jnp.zeros((N,), dtype),
        defer=jnp.where(active & init_done, heights, jnp.zeros((N,), dtype)),
        deposited=jnp.zeros((N,), bool),
        straddled=jnp.zeros((N,), bool),
        done=init_done,
    )

    def cond(st):
        return ~st.done

    def body(st):
        undec = active & (idxs >= st.start)
        c = jnp.where(undec, contrib_all, 0)
        prefix = st.cum + jnp.cumsum(c)
        prev = prefix - c

        full = undec & (prev < cap) & (prefix <= cap)
        crossing = undec & (prev < cap) & (prefix > cap)
        any_cross = jnp.any(crossing)
        k_star = jnp.argmax(crossing).astype(jnp.int32)

        dep = jnp.where(full, heights, st.dep)
        deposited = st.deposited | full

        h_k = heights[k_star]
        s_k = weights[k_star]
        pre_k = prefix[k_star]
        h_undo = jnp.maximum(cap - pre_k, -h_k)
        is_k = any_cross & (idxs == k_star)
        dep = jnp.where(is_k, h_k + h_undo, dep)
        defer = jnp.where(is_k, -h_undo, st.defer)
        deposited = deposited | is_k
        straddled = st.straddled | is_k

        # Exact saturation (prefix == cap, no crossing): later hills hit the
        # reference's `temp_hill_cum_ < bias_per_step_` check as false and are
        # buffered whole without touching temp_hill_cum_ (edm_bias.cpp:465,498)
        # — so only fully-deposited hills may contribute to the running total.
        sat = undec & (prev >= cap)
        cum_after = jnp.where(
            any_cross, pre_k + h_undo * s_k, st.cum + jnp.sum(jnp.where(full, c, 0))
        )
        done = ~any_cross | (cum_after >= cap)
        # cap saturated: everything after the straddler defers whole
        post = undec & (idxs > k_star) & any_cross
        defer = jnp.where(post & done, heights, defer)
        defer = jnp.where(sat & ~any_cross, heights, defer)

        return _St(
            cum=cum_after,
            start=jnp.where(any_cross, k_star + 1, jnp.int32(N)),
            dep=dep,
            defer=defer,
            deposited=deposited,
            straddled=straddled,
            done=done,
        )

    st = jax.lax.while_loop(cond, body, st0)
    return CapResult(st.dep, st.defer, st.deposited, st.straddled, st.cum)


class DrainResult(NamedTuple):
    dep_heights: jax.Array  # (CAP,) effective deposit per slot
    new_heights: jax.Array  # (CAP,) post-drain buffer heights (straddler keeps remainder)
    consumed: jax.Array  # bool: slot fully drained
    processed: jax.Array  # bool: slot touched this drain
    straddled: jax.Array
    bias_added: jax.Array  # total bias deposited by the drain


def drain_scan(heights, weights, active, max_bias) -> DrainResult:
    """Overflow-buffer drain (flush_bias_buffer, edm_bias.cpp:313-380).

    Differs from cap_scan: the loop *stops* at the straddling slot, which
    stays in the buffer holding the un-deposited remainder — a single
    parallel pass (the reference always breaks at the first crossing).
    """
    dtype = heights.dtype
    max_bias = jnp.asarray(max_bias, dtype)
    contrib = jnp.where(active, heights * weights, 0)
    prefix = jnp.cumsum(contrib)
    prev = prefix - contrib

    # slot processed iff the running total had not yet exceeded max_bias
    # BEFORE it (strict >: equality continues, edm_bias.cpp:334)
    processed = active & (prev <= max_bias)
    straddled = processed & (prefix > max_bias)
    consumed = processed & ~straddled

    h_undo = jnp.maximum(max_bias - prefix, -heights)
    dep = jnp.where(consumed, heights, jnp.where(straddled, heights + h_undo, 0))
    new_h = jnp.where(consumed, 0, jnp.where(straddled, -h_undo, heights))

    undo_term = jnp.sum(jnp.where(straddled, h_undo * weights, 0))
    bias_added = jnp.sum(jnp.where(processed, contrib, 0)) + undo_term

    return DrainResult(dep, new_h, consumed, processed, straddled, bias_added)
