"""Scatter-free segment primitives for the dedup pipeline.

All per-layer segment aggregation is expressed over *sorted* candidate
arrays, without `scatter` (`jax.ops.segment_max`, `.at[idx].set`), using:

  * `jax.lax.cummax` to broadcast each run's head position down the run;
  * segmented suffix scans (flip -> forward segmented scan -> flip) so
    that each run head holds the full-run aggregate;
  * `argsort` for permutation inversion instead of `.at[perm].set`.

The segmented-scan operator over (flag, value) pairs is the classic
associative monoid: combine(a, b) = (fa|fb, vb if fb else op(va, vb)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def run_head_positions(head):
    """For each sorted position, the position of its run's head.

    `head` marks the first element of each run (invalid tail rows never
    have head set; their result is the last head seen, mask accordingly).
    """
    C = head.shape[0]
    idx = jnp.arange(C, dtype=jnp.int32)
    return jax.lax.cummax(jnp.where(head, idx, -1))


def _seg_suffix_scan(op, head, values):
    """Segmented *suffix* scan: out[i] = op-fold of values[i..end of run).

    Works on tuples of value arrays (all combined with the same tuple op).
    `head` marks run starts in forward order.
    """
    # run-last flag in forward order == segment-start flag in reversed order
    last = jnp.concatenate([head[1:], jnp.ones((1,), bool)])
    f = jnp.flip(last)
    vs = tuple(jnp.flip(v) for v in values)

    def combine(a, b):
        fa, va = a[0], a[1:]
        fb, vb = b[0], b[1:]
        merged = op(va, vb)
        out = tuple(jnp.where(fb, x_b, m) for x_b, m in zip(vb, merged))
        return (fa | fb,) + out

    res = jax.lax.associative_scan(combine, (f,) + vs)
    return tuple(jnp.flip(v) for v in res[1:])


def seg_max_at_head(head, values):
    """Per-run max, available at every position (exact at run heads)."""
    (out,) = _seg_suffix_scan(lambda a, b: (jnp.maximum(a[0], b[0]),), head, (values,))
    return out


def seg_all_at_head(head, flags):
    """Per-run logical AND, available at run heads."""
    (out,) = _seg_suffix_scan(
        lambda a, b: (a[0] & b[0],), head, (flags,)
    )
    return out


def seg_argmax_pair_at_head(head, values, payload):
    """Per-run (max value, argmax payload) with ties taking the LARGER
    payload — replicating the reference's `>=` last-edge-wins update
    (clean.rs:215-218) when payload is the candidate append index."""

    def op(a, b):
        va, pa = a
        vb, pb = b
        take_b = (vb > va) | ((vb == va) & (pb >= pa))
        return (
            jnp.where(take_b, vb, va),
            jnp.where(take_b, pb, pa),
        )

    mv, mp = _seg_suffix_scan(op, head, (values, payload))
    return mv, mp


def invert_permutation(perm):
    """inv[perm[i]] = i without scatter (argsort of the permutation)."""
    return jnp.argsort(perm)


def seg_broadcast_at_head(head, values):
    """Carry each run head's value FORWARD down its run (one associative
    scan over (flag, values) tuples).  Positions before the first head get
    position 0's value — callers mask invalid rows anyway.

    This replaces per-candidate `table[head_slot]` gathers with
    data-dependent indices."""

    def combine(a, b):
        fa, va = a[0], a[1:]
        fb, vb = b[0], b[1:]
        return (fa | fb,) + tuple(
            jnp.where(fb, y, x) for x, y in zip(va, vb)
        )

    res = jax.lax.associative_scan(combine, (head,) + tuple(values))
    return res[1:]


def onehot_take_i32(table, idx):
    """Exact `table[idx]` for int32 tables as one-hot f32 contractions.

    The lookup is a `[M, T] @ [T]` one-hot matmul instead of a gather
    with data-dependent indices.  Exact for the full int32 range via a
    12-bit split (|v >> 12| < 2^20 and v & 0xfff < 2^12 are both
    f32-exact).  `idx` must already be clipped to [0, T).  `table` may be
    [T] or [T, m] (row gather, one shared one-hot)."""
    T = table.shape[0]
    oh = (idx[:, None] == jax.lax.iota(jnp.int32, T)[None, :]).astype(jnp.float32)
    # precision matters: at DEFAULT precision an f32 matmul may run in a
    # reduced format (TF32 on GPU tensor cores, one bf16 pass elsewhere),
    # which rounds the 20-bit hi part and silently corrupts the gather;
    # "float32" keeps every split value exact.
    hi = jnp.dot(oh, (table >> 12).astype(jnp.float32),
                 precision="float32").astype(jnp.int32)
    lo = jnp.dot(oh, (table & 0xFFF).astype(jnp.float32),
                 precision="float32").astype(jnp.int32)
    return hi * 4096 + lo


def onehot_scatter_i32(idx, values, size):
    """Exact `out[idx[i]] = values[i]` (idx a permutation of range(size))
    as one-hot f32 contractions.

    Small-size replacement for the `lax.sort((idx, values), num_keys=1)`
    inverse-permutation idiom: one `[C] @ [C, C]` one-hot matmul.  Exact
    for the full int32 range (negatives included) via the 12-bit
    arithmetic split of `onehot_take_i32`."""
    oh = (idx[:, None] == jax.lax.iota(jnp.int32, size)[None, :]).astype(jnp.float32)
    hi = jnp.dot((values >> 12).astype(jnp.float32), oh,
                 precision="float32").astype(jnp.int32)
    lo = jnp.dot((values & 0xFFF).astype(jnp.float32), oh,
                 precision="float32").astype(jnp.int32)
    return hi * 4096 + lo


def onehot_take_bool(table, idx):
    """`table[idx]` for bool tables via one one-hot f32 contraction."""
    T = table.shape[0]
    oh = (idx[:, None] == jax.lax.iota(jnp.int32, T)[None, :]).astype(jnp.float32)
    return jnp.dot(oh, table.astype(jnp.float32), precision="float32") > 0.5


# --------------------------------------------------------------------------
# Adaptive dispatch: below the cap the lookups are one-hot contractions;
# the [M, T] one-hot grows quadratically — at LCS-scale widths (C ~ 28k)
# it would be a multi-GB intermediate — so beyond the cap they fall back
# to native gathers and a sort-based scatter.  Whether the one-hot side
# wins on a GPU at all is not measured yet (ROADMAP, Speed).
# --------------------------------------------------------------------------
import os as _os

#: max M*T elements for the one-hot intermediate (env-tunable for perf
#: studies: DDO_ONEHOT_ELEMS=<n>)
_ONEHOT_ELEMS = int(_os.environ.get("DDO_ONEHOT_ELEMS", 1 << 22))


def take_i32(table, idx):
    """Exact `table[idx]` (idx pre-clipped to [0, T)), size-adaptive."""
    if table.shape[0] * idx.shape[0] <= _ONEHOT_ELEMS:
        return onehot_take_i32(table, idx)
    return jnp.take(table, idx, axis=0)


def take_rows_i32(table, idx):
    """Exact int32 row gather `table[idx, :]` for a [T, m] table, adaptive.

    One [M, T] one-hot is shared by all m columns (two contractions
    total) — the workhorse of the payload-free sort pipeline
    (engine/mdd.py): sorts carry only keys, every per-candidate column is
    gathered through the sort permutation afterwards."""
    if table.shape[0] * idx.shape[0] <= _ONEHOT_ELEMS:
        return onehot_take_i32(table, idx)
    return jnp.take(table, idx, axis=0)


def take_bool(table, idx):
    """Exact bool `table[idx]`, size-adaptive."""
    if table.shape[0] * idx.shape[0] <= _ONEHOT_ELEMS:
        return onehot_take_bool(table, idx)
    return jnp.take(table, idx, axis=0)


def scatter_i32(idx, values, size):
    """Exact `out[idx[i]] = values[i]` for a permutation `idx`, adaptive.

    Small sizes use the one-hot contraction; large ones invert through one
    sort keyed on `idx` (out[k] = value paired with idx == k)."""
    if size * idx.shape[0] <= _ONEHOT_ELEMS:
        return onehot_scatter_i32(idx, values, size)
    _, out = jax.lax.sort((idx, values), num_keys=1, is_stable=False)
    return out


def scatter_multi_i32(idx, values, size):
    """`scatter_i32` for several value arrays sharing one permutation:
    ONE inversion sort (or one shared one-hot) instead of per-array
    scatters — every extra array rides as a payload operand."""
    if size * idx.shape[0] <= _ONEHOT_ELEMS:
        return tuple(onehot_scatter_i32(idx, v, size) for v in values)
    out = jax.lax.sort((idx,) + tuple(values), num_keys=1, is_stable=False)
    return out[1:]
