"""Device-resident branch-and-bound: k supersteps per dispatch.

Why this exists: on deep/narrow problems (LCS, golomb, ALP, max2sat) every
host-driven superstep costs one device dispatch + one device->host
extraction round-trip + Python absorb work for a handful of nodes, while
the reference's Rust loop (sequential.rs:329-389) pops and expands tiny
nodes at host speed.  No kernel-rate tuning removes a per-superstep
round-trip; the fix is to stop returning to the host.

Design: the open-subproblem fringe lives ON DEVICE as a fixed-capacity
slab of rows (state / value / ub / depth / path), and ONE jitted program
runs up to `max_steps` whole supersteps in a `lax.while_loop`:

    pop K best rows  ->  K restricted + K relaxed DD compiles
    (the engine's `compile_kernel`, unchanged)  ->  in-graph incumbent
    update + best-path walk  ->  in-graph cutset extraction + path walks
    ->  push rows back into the slab  ->  repeat.

Host sync happens once per CHUNK, not per superstep: the driver absorbs
accumulated cache/dominance rows, refreshes the filter snapshot tables,
polls the Cutoff, and re-dispatches.  The host fringe (NoDupFringe)
remains as a spill/overflow area, so the exact semantics of cutset
branch-and-bound (sequential.rs:329-461) are preserved:

  * slab FULL         -> drain the worst rows to the host fringe, go on;
  * cutset rows > cap -> the offending superstep is NOT committed (the
    slab is left untouched); the driver replays it through the host
    path, which has no row cap — cutsets may never be truncated;
  * slab empty, host fringe not -> reseed the slab from the fringe.

Deliberate, SOUND divergences from the host solver (each weakens pruning
or adds duplicate work, never correctness):

  * supersteps within one chunk see the chunk-start cache/dominance
    snapshots (the host path refreshes them every superstep; filtering
    against any sound snapshot is conservative);
  * no pop-time `Cache.must_explore` / dominance probe on slab pops (the
    in-compilation filters still apply to every layer they produce);
  * the slab does not deduplicate states (SimpleFringe semantics,
    fringe/simple.rs:27-54, instead of NoDupFringe's merge rule) — the
    host spill fringe still dedups whatever passes through it.

Everything else mirrors the reference solver loop: incumbent maximization
(sequential.rs:394-400), cutset enqueue with ub tightening
(sequential.rs:403-416), bound recovery on abort (parallel.rs:479-497).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from ddo_tpu.core.heuristics import (
    DivBy,
    FixedWidth,
    NbUnassignedWidth,
    Times,
    WidthHeuristic,
)
from ddo_tpu.core.types import (
    Completion,
    CompilationType,
    Reason,
    SubProblem,
    root_subproblem,
)
from ddo_tpu.engine import extract as EX
from ddo_tpu.engine.mdd import (
    BufferOverflow,
    CutoffInterrupt,
    _batch_stats,
    _depth_bucket,
    _tree_stack_template,
    compile_kernel,
)
from ddo_tpu.search.cache import EmptyCache
from ddo_tpu.search.solver import SequentialSolver
from ddo_tpu.utils.num import INF, NEG_INF, VALUE_DTYPE, sat_add

I32 = jnp.int32


# --------------------------------------------------------------------------
# Width heuristics as static descriptors evaluated in-graph
# --------------------------------------------------------------------------
def width_static(heu: WidthHeuristic):
    """Static (hashable) descriptor of a width heuristic, evaluated on
    device by `_eval_width`.  Covers every heuristic the reference CI uses
    (width.rs:166,397,636,875 + the nb_vars*(depth+1)*factor widths of
    tsptw/sop/srflp heuristics.rs)."""
    if isinstance(heu, FixedWidth):
        return ("fixed", int(heu.width))
    if isinstance(heu, NbUnassignedWidth):
        return ("nbu",)
    if isinstance(heu, Times):
        return ("times", int(heu.factor), width_static(heu.inner))
    if isinstance(heu, DivBy):
        return ("div", int(heu.divisor), width_static(heu.inner))
    if hasattr(heu, "nb_vars") and hasattr(heu, "factor"):
        # TsptwWidth / SopWidth / SrflpWidth shape
        return ("lineardepth", int(heu.nb_vars), int(heu.factor))
    raise TypeError(
        f"{type(heu).__name__} has no device evaluation; give it a "
        "width_static-recognized shape or use the host solvers"
    )


def _eval_width(desc, depth, pset):
    """[K] effective widths from a static descriptor (traced depth/pset)."""
    kind = desc[0]
    if kind == "fixed":
        return jnp.full(depth.shape, desc[1], I32)
    if kind == "nbu":
        n = pset.shape[-1]
        return jnp.maximum(1, n - jnp.sum(pset, axis=-1).astype(I32))
    if kind == "times":
        return desc[1] * _eval_width(desc[2], depth, pset)
    if kind == "div":
        return jnp.maximum(1, _eval_width(desc[2], depth, pset) // desc[1])
    if kind == "lineardepth":
        return desc[1] * (depth.astype(I32) + 1) * desc[2]
    raise ValueError(kind)


# --------------------------------------------------------------------------
# In-graph best-path walk (CompiledDD._path / clean.rs:325-343, batched)
# --------------------------------------------------------------------------
def _walk_paths(bp, bd, bs, var_of, lanes, layers, slots, droot, pv0, ps0,
                active):
    """Walk best in-edges for M rows spread across K lanes, writing
    decisions BY VARIABLE into copies of (pv0, ps0).

    bp/bd/bs are [K, n+1, W] planes, var_of [K, n].  Long (skip) arcs
    record no decision (the pooled MDD's long-arc rule).  The loop runs
    max(layers) - min(droot) iterations — for narrow DDs the cutset sits
    a few layers below the roots, so this is typically short.  Invariant:
    after the iteration processing global layer l, every row with
    layers >= l sits at layer l-1 (each row joins when l reaches its own
    start layer and then moves one layer per iteration)."""
    K, n1, W = bp.shape
    n = n1 - 1
    flat3 = lambda a: a.reshape(K * n1 * W)
    bpf, bdf, bsf = flat3(bp), flat3(bd), flat3(bs)
    varf = var_of.reshape(K * n)
    cols = jnp.arange(n, dtype=I32)[None, :]  # [1, n]

    l0 = jnp.max(jnp.where(active, layers, 0))
    dmin = jnp.min(jnp.where(active, droot, n))

    def cond(c):
        l, cur_s, pv, ps = c
        return l > dmin

    def body(c):
        l, cur_s, pv, ps = c
        act = active & (l <= layers) & (l > droot) & (cur_s >= 0)
        idx = jnp.clip(lanes * (n1 * W) + l * W + cur_s, 0, K * n1 * W - 1)
        var = varf[jnp.clip(lanes * n + (l - 1), 0, K * n - 1)]  # [M]
        rec = act & ~bsf[idx]
        upd = (cols == var[:, None]) & rec[:, None]  # [M, n]
        pv = jnp.where(upd, bdf[idx][:, None], pv)
        ps = ps | upd
        cur_s = jnp.where(act, bpf[idx], cur_s)
        return (l - 1, cur_s, pv, ps)

    _, _, pv, ps = jax.lax.while_loop(
        cond, body, (l0, jnp.where(active, slots, -1).astype(I32), pv0, ps0)
    )
    return pv, ps


def _compact_union(sel_r, sel_x, M):
    """(idx[M], from_x[M], valid[M], count) selecting rows from the union
    of two same-shape flattened selections, selected-first.  Row i < N
    addresses pass r, row i >= N pass x (N = sel_r.size)."""
    both = jnp.concatenate([sel_r.reshape(-1), sel_x.reshape(-1)])
    count = jnp.sum(both.astype(I32))
    idx = jnp.argsort(~both, stable=True)[:M].astype(I32)
    N = sel_r.size
    return idx % N, idx >= N, both[idx], count


def _flat_plane(out, key):
    """[K, n1, W] plane -> [K*n1*W]; key-major [K, n1, CC, W] -> rows."""
    a = out[key]
    if a.ndim == 4:
        K, n1, CC, W = a.shape
        return jnp.swapaxes(a, 2, 3).reshape(K * n1 * W, CC)
    return a.reshape(-1)


def _pick2(out_r, out_x, key, idx, from_x):
    vr = _flat_plane(out_r, key)[idx]
    vx = _flat_plane(out_x, key)[idx]
    if vr.ndim == 2:
        return jnp.where(from_x[:, None], vx, vr)
    return jnp.where(from_x, vx, vr)


def _buf_append(buf, rows_dict, m, M, B):
    """Append `m` (traced, <= M) rows into bounded buffers at the cursor;
    rows beyond the capacity are DROPPED (callers only use this for
    cache/dominance rows, where truncation weakens pruning but stays
    sound).  The write is one fixed-size dynamic_update_slice whose junk
    tail is overwritten by the next append (cursor advances by m only)."""
    fits = buf["cnt"] + M <= B
    off = jnp.where(fits, buf["cnt"], 0)
    out = dict(buf)
    for k, rows in rows_dict.items():
        out[k] = jnp.where(
            fits,
            jax.lax.dynamic_update_slice_in_dim(buf[k], rows, off, axis=0),
            buf[k],
        )
    out["cnt"] = jnp.where(fits, buf["cnt"] + m, buf["cnt"])
    out["dropped"] = buf["dropped"] | ~fits
    return out


# --------------------------------------------------------------------------
# The chunk program
# --------------------------------------------------------------------------
@functools.partial(
    jax.jit,
    static_argnums=(0, 1),
    static_argnames=("wdesc", "start_layer", "Pcut", "Mc", "Md", "Bc", "Bd"),
)
def _device_chunk(spec_r, spec_x, datas, slab, best, max_steps, cache_tab,
                  dom_tab, *, wdesc, start_layer=0, Pcut=512, Mc=4096,
                  Md=4096, Bc=32768, Bd=32768):
    """Run up to `max_steps` full supersteps on device; see module doc.

    Returns (slab', best', cbuf, dbuf, stats).  `stats` flags:
      full    — the last superstep's pushes would not all fit; that
                superstep was NOT committed (driver drains + replays);
      cutov   — a superstep produced > Pcut cutset rows and was NOT
                committed (driver replays it host-side);
      hw_over — engine buffer overflow (driver raises BufferOverflow).
    """
    problem = spec_r.bundle.problem
    n = problem.nb_variables
    n1 = n + 1
    W = spec_r.width
    Cap = slab["val"].shape[0]
    K = slab["kmark"].shape[0]
    # row caps can never exceed the plane sizes they select from
    Pcut = min(Pcut, K * n1 * W)
    Mc = min(Mc, 2 * K * n1 * W)
    Md = min(Md, 2 * K * n1 * W)
    use_cache = cache_tab is not None
    use_dom = dom_tab is not None
    arange_cap = jnp.arange(Cap, dtype=I32)

    def v_compile(spec, rs, rv, rd, lb, ew, ps):
        return jax.vmap(
            lambda s, v, d, w, p: compile_kernel(
                spec, datas, s, v, d, lb, w, p,
                cache_tab=cache_tab, dom_tab=dom_tab,
                start_layer=start_layer,
            )
        )(rs, rv, rd, ew, ps)

    v_pack = jax.vmap(problem.pack)

    def _dedup_slab(sl):
        """NoDupFringe merge rule applied to the whole slab
        (no_duplicate.rs:96-117): among active rows with equal
        (depth, state key), keep ONE — the max-value row's payload with
        the run-max ub.  Scatter-free: one multi-key sort groups runs,
        a segmented suffix scan takes the run ub max, and a second sort
        keyed on the original index maps (keep, ub) back.  Row data
        never moves; only act/ub change."""
        from ddo_tpu.ops import segments as seg_ops

        keysl = v_pack(sl["state"]).astype(I32)  # [Cap, Kc]
        Kc = keysl.shape[1]
        inact = (~sl["act"]).astype(I32)
        ops = (inact, sl["depth"]) + tuple(
            keysl[:, k] for k in range(Kc)
        ) + (-sl["val"], arange_cap)
        sorted_ = jax.lax.sort(ops, num_keys=len(ops))
        sidx = sorted_[-1]
        valid_s = sorted_[0] == 0
        gcols = jnp.stack(sorted_[1 : 2 + Kc], axis=1)  # depth + keys
        first = jnp.concatenate(
            [jnp.ones((1,), bool), jnp.any(gcols[1:] != gcols[:-1], axis=1)]
        )
        head = valid_s & first
        ubmax = seg_ops.seg_max_at_head(head, sl["ub"][sidx])
        _, keep_i, ub_i = jax.lax.sort(
            (sidx, head.astype(I32), jnp.where(head, ubmax, NEG_INF)),
            num_keys=1,
        )
        return dict(
            sl,
            act=sl["act"] & (keep_i > 0),
            ub=jnp.where(keep_i > 0, ub_i, sl["ub"]),
        )

    def body(carry):
        slab, best, cbuf, dbuf, st = carry
        # opportunistic state dedup when the slab runs low on space —
        # duplicate open states are the frontier-explosion driver on
        # merge-heavy families (ALP), and the host NoDupFringe only sees
        # rows that spill
        occ = jnp.sum(slab["act"].astype(I32))
        slab = jax.lax.cond(
            occ * 4 > Cap * 3, _dedup_slab, lambda sl: sl, slab
        )
        lb0 = best["lb"]
        elig = slab["act"] & (slab["ub"] > lb0)

        # ---- pop K best by (ub, value) — MaxUB order (subproblem_ranking
        # .rs:76-91; the ranking tiebreak only affects exploration order)
        inelig = (~elig).astype(I32)
        _, _, _, order = jax.lax.sort(
            (inelig, -slab["ub"], -slab["val"], arange_cap), num_keys=3
        )
        idxK = order[:K]
        lane_ok = elig[idxK]
        idx_safe = jnp.where(lane_ok, idxK, idxK[0])
        popped = (arange_cap[:, None] == idx_safe[None, :]) & lane_ok[None, :]
        act1 = slab["act"] & ~jnp.any(popped, axis=1)

        rs = jax.tree_util.tree_map(lambda a: a[idx_safe], slab["state"])
        rv = slab["val"][idx_safe]
        rd = slab["depth"][idx_safe]
        node_ub = slab["ub"][idx_safe]
        ps = slab["pset"][idx_safe]
        rpv = slab["pvals"][idx_safe]
        ew = _eval_width(wdesc, rd, ps)

        # ---- the two DD passes (one XLA region, like _compile_fused_vjit:
        # the relaxed pass prunes against the restricted pass's incumbent)
        out_r = v_compile(spec_r, rs, rv, rd, lb0, ew, ps)
        g_r, t_r = _batch_stats(out_r, lane_ok)
        lb1 = jnp.maximum(lb0, g_r)
        out_x = v_compile(spec_x, rs, rv, rd, lb1, ew, ps)
        need_x = lane_ok & ~(out_r["is_exact_dd"] | out_r["has_ebp"])
        g_x, t_x = _batch_stats(out_x, need_x)
        lb2 = jnp.maximum(lb1, g_x)
        hw_over = jnp.any(
            (out_r["overflow"] & lane_ok) | (out_x["overflow"] & need_x)
        )

        # ---- incumbent update + in-graph solution path
        # (maybe_update_best, sequential.rs:394-400)
        improved = lb2 > lb0
        use_x = g_x > jnp.maximum(lb0, g_r)

        def upd_best(b):
            lane_r = jnp.argmax(
                jnp.where(lane_ok & out_r["bx_feasible"], out_r["bx_value"],
                          NEG_INF)
            )
            lane_x = jnp.argmax(
                jnp.where(need_x & out_x["bx_feasible"], out_x["bx_value"],
                          NEG_INF)
            )
            lane = jnp.where(use_x, lane_x, lane_r)
            slot = jnp.where(
                use_x, out_x["bx_slot"][lane_x], out_r["bx_slot"][lane_r]
            ).astype(I32)
            pl = lambda key: jnp.where(
                use_x, out_x[key][lane_x], out_r[key][lane_r]
            )[None]
            pv, psm = _walk_paths(
                pl("bp"), pl("bd"), pl("bs"), pl("var_of"),
                jnp.zeros((1,), I32), jnp.full((1,), n, I32), slot[None],
                rd[lane][None], rpv[lane][None], ps[lane][None],
                jnp.ones((1,), bool),
            )
            return dict(lb=lb2, vals=pv[0], set=psm[0],
                        has=jnp.asarray(True))

        best = jax.lax.cond(improved, upd_best,
                            lambda b: dict(b, lb=lb2), best)

        # ---- cutset rows (drain_cutset semantics, clean.rs:417-445; the
        # row set matches engine/extract.cutset_rows)
        act_cut = need_x & ~(out_x["is_exact_dd"] | out_x["has_ebp"])
        sel = (
            out_x["cutflag"] & out_x["marked"]
            & (act_cut & out_x["feasible"])[:, None, None]
        )
        flat = sel.reshape(-1)
        cut_count = jnp.sum(flat.astype(I32))
        cutov = cut_count > Pcut
        cidx = jnp.argsort(~flat, stable=True)[:Pcut].astype(I32)
        lanes = cidx // (n1 * W)
        layers = (cidx // W) % n1
        slots = cidx % W
        rowvalid = flat[cidx]
        v = out_x["value"].reshape(-1)[cidx]
        ub_row = jnp.minimum(
            jnp.minimum(
                sat_add(v, out_x["rub"].reshape(-1)[cidx]),
                sat_add(v, out_x["value_bot"].reshape(-1)[cidx]),
            ),
            out_x["best_value"].astype(VALUE_DTYPE)[lanes],
        )
        ub_row = jnp.minimum(ub_row, node_ub[lanes])
        keep = rowvalid & (ub_row > lb2)

        pv, psm = _walk_paths(
            out_x["bp"], out_x["bd"], out_x["bs"], out_x["var_of"],
            lanes, layers, slots, rd[lanes], rpv[lanes], ps[lanes], keep,
        )
        cstates = jax.tree_util.tree_map(
            lambda a: a.reshape((a.shape[0] * a.shape[1] * a.shape[2],)
                                + a.shape[3:])[cidx],
            out_x["state"],
        )

        # ---- push into free slab slots (<= Pcut-row scatter)
        free = ~act1
        free_cnt = jnp.sum(free.astype(I32))
        push_cnt = jnp.sum(keep.astype(I32))
        full_now = push_cnt > free_cnt
        korder = jnp.argsort(~keep, stable=True).astype(I32)
        rank = jnp.arange(Pcut, dtype=I32)
        dest = jnp.argsort(~free, stable=True)[:Pcut].astype(I32)
        write = (rank < push_cnt) & ~full_now & ~cutov

        def push(a, rows):
            cur = a[dest]
            neww = jnp.where(
                write.reshape((Pcut,) + (1,) * (rows.ndim - 1)),
                rows[korder], cur,
            )
            return a.at[dest].set(neww)

        slab2 = dict(
            state=jax.tree_util.tree_map(push, slab["state"], cstates),
            val=push(slab["val"], v),
            ub=push(slab["ub"], ub_row),
            depth=push(slab["depth"], layers.astype(I32)),
            pvals=push(slab["pvals"], pv),
            pset=push(slab["pset"], psm),
            act=push(act1, keep),
            kmark=slab["kmark"],
        )
        # rows whose ub fell to/under the new incumbent are dead; reclaim
        slab2["act"] = slab2["act"] & (slab2["ub"] > lb2)

        # a cut-overflow or slab-full superstep is NOT committed: the
        # driver replays it (host path / after draining).  Incumbents ARE
        # committed either way — a proved exact value is valid regardless
        # of what happens to this superstep's cutset.
        commit = ~cutov & ~full_now
        slab = jax.tree_util.tree_map(
            lambda new, old: jnp.where(
                jnp.reshape(commit, (1,) * new.ndim), new, old
            ),
            slab2, slab,
        )

        # ---- accumulate cache threshold rows from BOTH passes (the host
        # absorb does the same, solver._process_batch_fused); truncation
        # to Mc / buffer overflow only weakens pruning (sound).
        #
        # GATED ON COMMIT: a threshold row with explored=false is only
        # sound when its cutset subproblem actually reached a fringe (the
        # reference's in-compile filter prunes value <= theta regardless
        # of the explored flag, clean.rs:710-726 — valid precisely
        # because the unexplored node is open elsewhere).  A rolled-back
        # superstep enqueued nothing, so absorbing its thresholds would
        # let the replay prune the re-generated cutset children — losing
        # solutions (observed: golomb8 "proved" -36 with optimum -34).
        if use_cache:
            sel_r = (out_r["has_theta"] & out_r["above"]
                     & lane_ok[:, None, None]) & commit
            sel_x = (out_x["has_theta"] & out_x["above"]
                     & need_x[:, None, None]) & commit
            idx, from_x, valid, ccnt = _compact_union(sel_r, sel_x, Mc)
            unexp_r = out_r["cutflag"] | out_r["wl_unexplored"]
            unexp_x = out_x["cutflag"] | out_x["wl_unexplored"]
            cbuf = _buf_append(
                cbuf,
                dict(
                    keys=_pick2(out_r, out_x, "keys", idx, from_x),
                    depths=jnp.where(valid, ((idx // W) % n1).astype(I32),
                                     -1),
                    thetas=_pick2(out_r, out_x, "theta", idx, from_x),
                    expl=(~jnp.where(
                        from_x, unexp_x.reshape(-1)[idx],
                        unexp_r.reshape(-1)[idx],
                    )).astype(jnp.uint8),
                ),
                jnp.minimum(ccnt, Mc), Mc, Bc,
            )
            cbuf["dropped"] = cbuf["dropped"] | (ccnt > Mc)

        # ---- accumulate dominance rows (exact_nodes_batch row set); the
        # entries are commit-independent facts, but gating keeps rollback
        # replays byte-identical to what the host path would have seen
        if use_dom:
            sel_r = (out_r["exact"] & out_r["mask"]
                     & lane_ok[:, None, None]) & commit
            sel_x = (out_x["exact"] & out_x["mask"]
                     & need_x[:, None, None]) & commit
            idx, from_x, valid, dcnt = _compact_union(sel_r, sel_x, Md)
            dbuf = _buf_append(
                dbuf,
                dict(
                    dkeys=_pick2(out_r, out_x, "dkey", idx, from_x),
                    dcoords=_pick2(out_r, out_x, "dcoord", idx, from_x),
                    depths=jnp.where(valid, ((idx // W) % n1).astype(I32),
                                     -1),
                    values=_pick2(out_r, out_x, "value", idx, from_x),
                ),
                jnp.minimum(dcnt, Md), Md, Bd,
            )
            dbuf["dropped"] = dbuf["dropped"] | (dcnt > Md)

        st = dict(
            steps=st["steps"] + jnp.where(commit, 1, 0),
            explored=st["explored"]
            + jnp.where(commit, jnp.sum(lane_ok.astype(I32)), 0),
            expanded=st["expanded"] + jnp.where(commit, t_r + t_x, 0),
            full=full_now & ~cutov,
            cutov=cutov,
            hw_over=st["hw_over"] | hw_over,
        )
        return (slab, best, cbuf, dbuf, st)

    def cond(carry):
        slab, best, cbuf, dbuf, st = carry
        more = jnp.any(slab["act"] & (slab["ub"] > best["lb"]))
        return (
            (st["steps"] < max_steps)
            & more & ~st["full"] & ~st["cutov"] & ~st["hw_over"]
        )

    st0 = dict(
        steps=jnp.asarray(0, I32),
        explored=jnp.asarray(0, I32),
        expanded=jnp.asarray(0, I32),
        full=jnp.asarray(False),
        cutov=jnp.asarray(False),
        hw_over=jnp.asarray(False),
    )
    if use_cache:
        Kc = cache_tab["keys"].shape[2]
        cbuf = dict(
            keys=jnp.zeros((Bc, Kc), I32),
            depths=jnp.full((Bc,), -1, I32),
            thetas=jnp.zeros((Bc,), I32),
            expl=jnp.zeros((Bc,), jnp.uint8),
            cnt=jnp.asarray(0, I32),
            dropped=jnp.asarray(False),
        )
    else:
        cbuf = dict(cnt=jnp.asarray(0, I32))
    if use_dom:
        KK = dom_tab["keys"].shape[2]
        CC = dom_tab["coords"].shape[2]
        dbuf = dict(
            dkeys=jnp.zeros((Bd, KK), I32),
            dcoords=jnp.zeros((Bd, CC), I32),
            depths=jnp.full((Bd,), -1, I32),
            values=jnp.zeros((Bd,), I32),
            cnt=jnp.asarray(0, I32),
            dropped=jnp.asarray(False),
        )
    else:
        dbuf = dict(cnt=jnp.asarray(0, I32))

    slab, best, cbuf, dbuf, st = jax.lax.while_loop(
        cond, body, (slab, best, cbuf, dbuf, st0)
    )
    act = slab["act"] & (slab["ub"] > best["lb"])
    stats = dict(
        st,
        n_active=jnp.sum(act.astype(I32)),
        ub_max=jnp.max(jnp.where(act, slab["ub"], NEG_INF)),
        min_depth=jnp.min(jnp.where(act, slab["depth"], n)),
    )
    return slab, best, cbuf, dbuf, stats


class DeviceLoopSolver(SequentialSolver):
    """Branch-and-bound whose fringe lives on device (see module doc).

    Drop-in `Solver` with the SequentialSolver surface; `batch` is the
    lane count K per superstep, `slab_cap` the device fringe capacity,
    `chunk_steps` the supersteps per dispatch (host sync cadence)."""

    def __init__(self, bundle, slab_cap: int = 4096, chunk_steps: int = 16,
                 cut_cap: int = 512, **kw):
        super().__init__(bundle, **kw)
        self.slab_cap = int(slab_cap)
        self.chunk_steps = int(chunk_steps)
        self.cut_cap = int(cut_cap)
        if self.cut_cap > self.slab_cap // 2:
            # liveness: after a slab-full drain keeps slab_cap//2 rows, the
            # next superstep's <=cut_cap pushes must fit the freed half
            raise ValueError("cut_cap must be <= slab_cap // 2")
        self._wdesc = width_static(self.width_heu)
        self._n = self.problem.nb_variables
        self._snap_dev = {}  # host snapshot dict -> device copy (by identity)
        #: diagnostics: chunk dispatches / cutset-overflow replays /
        #: slab-full drains / fringe reseeds (read by perf tooling)
        self.loop_events = dict(chunks=0, cutov=0, full=0, seeds=0)

    def _filter_tables(self):
        """Device-cached snapshot tables: the host snapshots are uploaded
        once per CHANGE, not once per chunk (a [n+1, 256, K] cache table is
        multiple MB to re-upload on every dispatch)."""
        cache_tab, dom_tab = super()._filter_tables()
        out = []
        for name, tab in (("cache", cache_tab), ("dom", dom_tab)):
            if tab is None:
                out.append(None)
                continue
            cached = self._snap_dev.get(name)
            if cached is None or cached[0] is not tab:
                cached = (tab, jax.device_put(tab))
                self._snap_dev[name] = cached
            out.append(cached[1])
        return out[0], out[1]

    # ------------------------------------------------------------- slab ops
    def _empty_slab(self, root_state):
        Cap, n = self.slab_cap, self._n
        state = jax.tree_util.tree_map(jnp.asarray, root_state)
        return dict(
            state=_tree_stack_template(state, (Cap,)),
            val=jnp.zeros((Cap,), VALUE_DTYPE),
            ub=jnp.full((Cap,), NEG_INF, VALUE_DTYPE),
            depth=jnp.zeros((Cap,), I32),
            pvals=jnp.zeros((Cap, n), I32),
            pset=jnp.zeros((Cap, n), bool),
            act=jnp.zeros((Cap,), bool),
            # shaped marker carrying the static lane count K into the jit
            kmark=jnp.zeros((self.batch,), jnp.uint8),
        )

    def _seed_slab(self, slab, subs):
        """Write host subproblems into the first len(subs) slots (the
        slab must be empty when called)."""
        m = len(subs)
        states = jax.tree_util.tree_map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
            *[s.state for s in subs],
        )
        upd = lambda a, rows: a.at[:m].set(jnp.asarray(rows))
        return dict(
            slab,
            state=jax.tree_util.tree_map(
                lambda a, r: a.at[:m].set(r), slab["state"], states
            ),
            val=upd(slab["val"],
                    np.asarray([s.value for s in subs], np.int32)),
            ub=upd(slab["ub"],
                   np.asarray([min(s.ub, INF) for s in subs], np.int32)),
            depth=upd(slab["depth"],
                      np.asarray([s.depth for s in subs], np.int32)),
            pvals=upd(slab["pvals"],
                      np.stack([s.path_vals for s in subs]).astype(np.int32)),
            pset=upd(slab["pset"],
                     np.stack([s.path_set for s in subs]).astype(bool)),
            act=upd(slab["act"], np.ones(m, bool)),
        )

    def _drain_slab(self, slab, keep_best: int = 0):
        """Fetch active slab rows into the host fringe; optionally keep
        the `keep_best` best (by ub, value) rows on device."""
        act = np.asarray(slab["act"])
        ub = np.asarray(slab["ub"])
        val = np.asarray(slab["val"])
        rows = np.flatnonzero(act)
        if len(rows) == 0:
            return slab
        if keep_best > 0:
            order = rows[np.lexsort((-val[rows], -ub[rows]))]
            keep_rows = order[:keep_best]
            rows = order[keep_best:]
            keepm = np.zeros(act.shape, bool)
            keepm[keep_rows] = True
            slab = dict(slab, act=jnp.asarray(keepm))
        else:
            slab = dict(slab, act=jnp.zeros(act.shape, bool))
        if len(rows) == 0:
            return slab
        states = jax.tree_util.tree_map(np.asarray, slab["state"])
        pvals = np.asarray(slab["pvals"])
        pset = np.asarray(slab["pset"])
        depth = np.asarray(slab["depth"])
        sel_states = jax.tree_util.tree_map(lambda a: a[rows], states)
        keys = np.asarray(
            jax.vmap(self.problem.pack)(
                jax.tree_util.tree_map(jnp.asarray, sel_states)
            )
        ).astype(np.int32)
        for j, i in enumerate(rows):
            sub = SubProblem(
                state=jax.tree_util.tree_map(lambda a: a[i], states),
                value=int(val[i]), path_vals=pvals[i].copy(),
                path_set=pset[i].copy(), ub=int(ub[i]), depth=int(depth[i]),
                key=np.ascontiguousarray(keys[j]).tobytes(),
            )
            before = len(self.fringe)
            self.fringe.push(sub)
            self.open_by_layer[sub.depth] += len(self.fringe) - before
        return slab

    # ------------------------------------------------------------------ API
    def maximize(self) -> Completion:
        self.stats.start = time.perf_counter()
        self.cache.initialize(self.problem)
        if self.filtering:
            self.dominance.prime(self.problem)
        root = root_subproblem(self.problem)
        self.fringe.push(root)
        self.open_by_layer[0] += 1

        spec_r = self.compiler._specs[CompilationType.RESTRICTED]
        spec_x = self.compiler._specs[CompilationType.RELAXED]
        slab = self._empty_slab(root.state)
        best = dict(
            lb=jnp.asarray(self.best_lb, VALUE_DTYPE),
            vals=jnp.zeros((self._n,), I32),
            set=jnp.zeros((self._n,), bool),
            has=jnp.asarray(False),
        )
        n_active = 0
        aborted = False
        self._min_depth = 0

        while True:
            if self.cutoff.must_stop():
                self._abort_device(slab, n_active)
                aborted = True
                break
            if n_active == 0:
                batch = self._workload_for_seed()
                if not batch:
                    break
                slab = self._seed_slab(slab, batch)
                n_active = len(batch)
                self._min_depth = min(s.depth for s in batch)
                self.loop_events["seeds"] += 1
            if int(best["lb"]) < self.best_lb:
                best = dict(best, lb=jnp.asarray(self.best_lb, VALUE_DTYPE))

            t0 = time.perf_counter()
            cache_tab, dom_tab = self._filter_tables()
            if isinstance(self.cache, EmptyCache):
                cache_tab = None
            i0 = _depth_bucket(self._n, self._min_depth)
            self.loop_events["chunks"] += 1
            slab, best, cbuf, dbuf, stats = _device_chunk(
                spec_r, spec_x, self.bundle.datas, slab, best,
                jnp.asarray(self.chunk_steps, I32), cache_tab, dom_tab,
                wdesc=self._wdesc, start_layer=i0, Pcut=self.cut_cap,
            )
            # ONE overlapped transfer for every scalar the absorb reads,
            # instead of a blocking read per int()
            EX.prefetch(stats)
            EX.prefetch(best)
            EX.prefetch([cbuf.get("cnt"), dbuf.get("cnt")])
            jax.block_until_ready(stats["steps"])
            t1 = time.perf_counter()
            self.stats.restricted_s += t1 - t0

            # ---- absorb chunk results
            if bool(stats["hw_over"]):
                raise BufferOverflow(
                    f"layer exceeded the static buffer width W="
                    f"{spec_r.width} inside the device loop"
                )
            self.stats.supersteps += int(stats["steps"])
            self.explored_count += int(stats["explored"])
            self.expanded_nodes += int(stats["expanded"])
            new_lb = int(best["lb"])
            if new_lb > self.best_lb and bool(best["has"]):
                self.best_lb = new_lb
                self.best_sol = (
                    np.asarray(best["vals"]).copy(),
                    np.asarray(best["set"]).copy(),
                )
            self._absorb_bufs(cbuf, dbuf)
            n_active = int(stats["n_active"])
            if n_active:
                # start-layer bucket source for the next chunk: riding the
                # prefetched stats instead of fetching slab arrays saves
                # two blocking reads per chunk
                self._min_depth = int(stats["min_depth"])
            ubm = int(stats["ub_max"]) if n_active else NEG_INF
            fr_ub = self._fringe_ub_max()
            self.best_ub = min(
                self.best_ub, max(self.best_lb, ubm, fr_ub)
            )
            self.stats.host_s += time.perf_counter() - t1

            if bool(stats["cutov"]):
                # replay the uncommitted superstep through the host path
                # (no cutset row cap there)
                self.loop_events["cutov"] += 1
                slab = self._drain_slab(slab)
                n_active = 0
                batch = self._get_workload()
                if batch:
                    t2 = time.perf_counter()
                    try:
                        self._process_batch(batch)
                    except CutoffInterrupt:
                        self._abort(Reason.CUTOFF_OCCURRED, batch)
                        aborted = True
                        self.stats.host_s += time.perf_counter() - t2
                        break
                    self.stats.supersteps += 1
                    self.stats.host_s += time.perf_counter() - t2
            elif bool(stats["full"]):
                self.loop_events["full"] += 1
                slab = self._drain_slab(slab, keep_best=self.slab_cap // 2)
                n_active = min(n_active, self.slab_cap // 2)

        self.stats.total_s = time.perf_counter() - self.stats.start
        if not aborted and self.abort_proof is None:
            self.best_ub = self.best_lb
        return Completion(
            is_exact=self.abort_proof is None,
            best_value=self.best_lb if self.best_sol is not None else None,
        )

    # ------------------------------------------------------------ internals

    def _workload_for_seed(self):
        """Pop up to slab_cap/2 subproblems for seeding (with the standard
        pop-time pruning of _get_workload).  The pops are counted as
        explored when the device loop actually pops them, so the host-side
        count is rolled back here."""
        saved = self.batch
        try:
            self.batch = max(1, self.slab_cap // 2)
            batch = self._get_workload()
        finally:
            self.batch = saved
        if batch:
            self.explored_count -= len(batch)
        return batch or []

    def _fringe_ub_max(self):
        if self.fringe.is_empty():
            return NEG_INF
        by_state = getattr(self.fringe, "_by_state", None)
        if by_state is not None:
            return max(s.ub for s in by_state.values())
        return INF  # unknown fringe type: stay conservative

    def _absorb_bufs(self, cbuf, dbuf):
        # slice to the row count ON DEVICE before fetching: the full
        # [Bc, K] buffers are multiple MB, the used prefix usually KB
        cnt = int(cbuf["cnt"]) if "keys" in cbuf else 0
        dnt = int(dbuf["cnt"]) if "dkeys" in dbuf else 0
        crows = drows = None
        if cnt:
            crows = [cbuf["depths"][:cnt], cbuf["keys"][:cnt],
                     cbuf["thetas"][:cnt], cbuf["expl"][:cnt]]
            EX.prefetch(crows)
        if dnt:
            drows = [dbuf["depths"][:dnt], dbuf["dkeys"][:dnt],
                     dbuf["dcoords"][:dnt], dbuf["values"][:dnt]]
            EX.prefetch(drows)
        if cnt:
            depths = np.asarray(crows[0])
            ok = depths >= 0
            self.cache.update_batch(
                depths[ok], np.asarray(crows[1])[ok],
                np.asarray(crows[2])[ok], np.asarray(crows[3])[ok],
            )
        if dnt:
            depths = np.asarray(drows[0])
            ok = depths >= 0
            self.dominance.insert_batch(
                depths[ok], np.asarray(drows[1])[ok],
                np.asarray(drows[2])[ok], np.asarray(drows[3])[ok],
            )

    def _abort_device(self, slab, n_active):
        """Bound recovery on cutoff (parallel.rs:479-497): the best open
        ub across slab + host fringe caps the proved upper bound."""
        self.abort_proof = Reason.CUTOFF_OCCURRED
        ubm = NEG_INF
        if n_active:
            act = np.asarray(slab["act"])
            if act.any():
                ubm = int(np.asarray(slab["ub"])[act].max())
        ubf = self._fringe_ub_max()
        self.best_ub = min(self.best_ub, max(self.best_lb, ubm, ubf))
        self.fringe.clear()
        self.cache.clear()
