"""Device-side row compaction for the solver's per-superstep extraction.

Why this module exists: after each superstep the solver consumes three row
sets from every compiled DD batch — barrier-cache threshold updates
(clean.rs:534-545), exact nodes for the global dominance store
(clean.rs:697), and the cutset (clean.rs:417-445).  The plane path
fetches whole `[K, n+1, W]` planes to the host and selects rows with
numpy, moving far more bytes than the rows it keeps.

Here the selection runs ON DEVICE: one stable argsort over the flattened
selection mask compacts the selected rows to the front, the payload
columns are gathered for the first `M` rows, and only those rows (a few
hundred KB) cross the link.  Dropping rows beyond `M` is SOUND for the
cache and dominance consumers (both stores are pruning accelerators —
absent entries only weaken pruning); the cutset consumer MUST be
complete, so its extractor returns the true count and the solver falls
back to the plane path when `count > M` (rare: caps default to 8-32k
rows).

All functions are standalone jits over the compile outputs, NOT part of
the compile program: the (expensive, persistent-cached) forward/backward
XLA programs stay byte-identical.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ddo_tpu.utils.num import INF, VALUE_DTYPE, sat_add

I32 = jnp.int32


def prefetch(tree) -> None:
    """Start async device->host copies for every array in `tree`.

    The copies overlap instead of running one blocking read per array; a
    later `np.asarray` on each leaf completes without a fresh blocking
    read."""
    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, jax.Array):
            try:
                leaf.copy_to_host_async()
            except Exception:  # pragma: no cover - backend without async copy
                pass


def _flat_select(sel, M):
    """(idx[M], count) — flat indices of selected rows, selected-first,
    in stable (lane, layer, slot) order."""
    flat = sel.reshape(-1)
    count = jnp.sum(flat.astype(I32))
    idx = jnp.argsort(~flat, stable=True)[:M].astype(I32)
    return idx, count


def _cols_flat(plane_cols):
    """[K, n1, CC, W] key-major plane -> [K*n1*W, CC] row-major."""
    K, n1, CC, W = plane_cols.shape
    return jnp.swapaxes(plane_cols, 2, 3).reshape(K * n1 * W, CC)


@functools.partial(jax.jit, static_argnames=("M",))
def cache_rows(has_theta, above, cutflag, wl_unexplored, theta, keys,
               actives, M):
    """Compact (depth, key, theta, explored) rows for Cache.update_batch.

    Row set identical to `CompiledDD.cache_batch` (has_theta & above,
    explored = not (cutflag | wl_unexplored)) unioned over active lanes."""
    K, n1, W = has_theta.shape
    sel = has_theta & above & actives[:, None, None]
    idx, count = _flat_select(sel, M)
    depths = (idx // W) % n1
    unexplored = (cutflag | wl_unexplored).reshape(-1)[idx]
    return dict(
        count=count,
        depths=depths,
        keys=_cols_flat(keys)[idx],
        thetas=theta.reshape(-1)[idx],
        explored=(~unexplored).astype(jnp.uint8),
    )


@functools.partial(jax.jit, static_argnames=("M",))
def exact_rows(exact, mask, value, dkey, dcoord, actives, M):
    """Compact (depth, dom_key, dom_coord, value) rows of every live exact
    node for DominanceChecker.insert_batch (= CompiledDD.exact_nodes_batch
    unioned over active lanes)."""
    K, n1, W = exact.shape
    sel = exact & mask & actives[:, None, None]
    idx, count = _flat_select(sel, M)
    return dict(
        count=count,
        depths=(idx // W) % n1,
        dkeys=_cols_flat(dkey)[idx],
        dcoords=_cols_flat(dcoord)[idx],
        values=value.reshape(-1)[idx],
    )


@functools.partial(jax.jit, static_argnames=("M", "with_dom"))
def cutset_rows(cutflag, marked, value, rub, value_bot, rank0, keys,
                best_value, feasible, dkey, dcoord, actives, M,
                with_dom):
    """Compact cutset rows (= CompiledDD.cutset_batch over active lanes):
    (lane, layer, slot, key, value, ub, score[, dom_key, dom_coord]).

    ub = min(value + rub, value + locb, lane best_value) exactly as the
    host path computes it (drain_cutset tightening, clean.rs:417-445).
    `count` is the TRUE row count: when count > M the caller must fall
    back to the full-plane path (the cutset may not be truncated)."""
    K, n1, W = value.shape
    sel = cutflag & marked & (actives & feasible)[:, None, None]
    idx, count = _flat_select(sel, M)
    lanes = idx // (n1 * W)
    layers = (idx // W) % n1
    slots = idx % W
    v = value.reshape(-1)[idx]
    ub = jnp.minimum(
        jnp.minimum(sat_add(v, rub.reshape(-1)[idx]),
                    sat_add(v, value_bot.reshape(-1)[idx])),
        best_value.astype(VALUE_DTYPE)[lanes],
    )
    out = dict(
        count=count, lanes=lanes, layers=layers, slots=slots,
        keys=_cols_flat(keys)[idx], values=v, ubs=ub,
        scores=rank0.reshape(-1)[idx],
    )
    if with_dom:
        out["dkeys"] = _cols_flat(dkey)[idx]
        out["dcoords"] = _cols_flat(dcoord)[idx]
    return out


def extract_caps(K: int, n1: int, W: int):
    """(M_cache, M_dom, M_cut) row caps for a [K, n1, W] batch: generous
    enough that truncation is rare (a compact row is ~24-40 bytes), small
    enough that the transfers stay a few MB.  Cache/dominance truncation
    is sound (weaker pruning only); cutset overflow falls back to the
    plane path in the solver."""
    N = K * n1 * W
    cap = lambda m: int(min(m, max(256, 1 << (N - 1).bit_length())))
    return cap(65536), cap(131072), cap(16384)
