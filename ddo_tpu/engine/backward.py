"""Fused bottom-up backward pass: local bounds + thresholds in one sweep.

The reference computes local bounds (clean.rs:448-475) and thresholds
(clean.rs:478-532) as two separate bottom-up traversals.  Both walk the
same outbound edge planes, so this module fuses them into a single
reverse `lax.scan` whose per-layer child-value propagation is ONE shared
one-hot [C, W] @ [W, 4] contraction.

`fused_backward` returns, for layers 0..n-1:
  (vb_stack [n, W] i32, mk_stack [n, W] bool,
   th_stack [n, W] i32, hs_stack [n, W] bool)

Carry encodings match the engine's conventions:
  * locb carry: NEG_INF encodes "unmarked";
  * threshold carry: INF encodes "nothing to propagate".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ddo_tpu.utils.num import INF, NEG_INF, sat_add, sat_sub

I32 = jnp.int32


def thresh_rules(best_known, alive, val, rub, vb, cutf, exact, th, hs):
    """Per-node threshold rules (clean.rs:503-517)."""
    tot_rub = sat_add(val, rub)
    b1 = tot_rub <= best_known
    th1 = sat_sub(best_known, rub)
    tot_locb = sat_add(val, vb)
    th2a = jnp.minimum(jnp.where(hs, th, INF), sat_sub(best_known, vb))
    th2 = jnp.where(tot_locb <= best_known, th2a, val)
    b3 = exact & ~hs
    new_th = jnp.where(b1, th1, jnp.where(cutf, th2, jnp.where(b3, INF, th)))
    new_hs = hs | b1 | cutf | b3
    return jnp.where(alive, new_th, th), (alive & new_hs) | (~alive & hs)


def _layer_body(W, D, best_known, vb_eff, th_eff, ec, eco, ev,
                val_l, rub_l, cutf_l, exact_l, mask_l, ep_l, wlp_l, wlth_l):
    """One fused backward layer.

    `ep_l` [W]: per-parent theta contributions from filter-pruned children
    that never materialized (engine in-compilation filtering); `wlp_l` /
    `wlth_l` [W]: within-layer dominance-pruned rows and their thresholds
    (their theta is exactly the pruning threshold, clean.rs:699, and it
    must propagate to parents like any other, clean.rs:522-528)."""
    C = ec.shape[0]
    cc = jnp.clip(ec, 0, W - 1)
    ok = ev & (ec >= 0)
    if C * W <= (1 << 22):
        # one shared one-hot; both carries (12-bit split each) in one matmul
        iota_w = jax.lax.broadcasted_iota(I32, (C, W), 1)
        oh = (cc[:, None] == iota_w).astype(jnp.float32)
        tables = jnp.stack(
            [(vb_eff >> 12).astype(jnp.float32), (vb_eff & 0xFFF).astype(jnp.float32),
             (th_eff >> 12).astype(jnp.float32), (th_eff & 0xFFF).astype(jnp.float32)],
            axis=1,
        )  # [W, 4]
        g4 = jnp.dot(oh, tables, preferred_element_type=jnp.float32, precision="float32")  # [C, 4]
        g_vb = g4[:, 0].astype(I32) * 4096 + g4[:, 1].astype(I32)
        g_th = g4[:, 2].astype(I32) * 4096 + g4[:, 3].astype(I32)
    else:
        # LCS-scale widths: the [C, W] one-hot would not fit; plain gathers
        g_vb = jnp.take(vb_eff, cc)
        g_th = jnp.take(th_eff, cc)

    # local bounds (clean.rs:448-475)
    cm = ok & (g_vb > NEG_INF)
    contrib = jnp.where(cm, sat_add(g_vb, eco), NEG_INF)
    vb_l = jnp.max(contrib.reshape(W, D), axis=1)
    mk_l = jnp.any(cm.reshape(W, D), axis=1)
    new_vb_eff = jnp.where(mk_l, vb_l, NEG_INF)

    # thresholds (clean.rs:478-532)
    g_th = jnp.where(ok, g_th, INF)
    ch_has = g_th < INF
    cand = jnp.where(ch_has, sat_sub(g_th, eco), INF)
    th_l = jnp.min(cand.reshape(W, D), axis=1)
    hs_l = jnp.any(ch_has.reshape(W, D), axis=1)
    th_l = jnp.minimum(th_l, ep_l)
    hs_l = hs_l | (ep_l < INF)
    th_l = jnp.where(hs_l, th_l, INF)
    th_l, hs_l = thresh_rules(
        best_known, mask_l, val_l, rub_l, vb_l, cutf_l, exact_l, th_l, hs_l
    )
    use_wl = wlp_l & (wlth_l < INF)
    th_l = jnp.where(use_wl, wlth_l, th_l)
    hs_l = hs_l | use_wl
    new_th_eff = jnp.where(hs_l & (mask_l | use_wl), th_l, INF)
    return new_vb_eff, new_th_eff, vb_l, mk_l, th_l, hs_l


def fused_backward(E_child, E_cost, E_valid, S_val, S_rub, cutflag, S_exact,
                   S_mask, vb_init, th_init, best_known,
                   ep_theta=None, wl_pruned=None, wl_ptheta=None):
    """Fused local-bounds + thresholds backward pass (see module doc).

    The optional planes default to "nothing pruned": `ep_theta` (per-parent
    theta of filter-pruned children), `wl_pruned` / `wl_ptheta`
    (within-layer dominance-pruned rows and their thresholds)."""
    n, C = E_child.shape
    W = vb_init.shape[0]
    D = C // W
    if ep_theta is None:
        ep_theta = jnp.full((n, W), INF, E_cost.dtype)
    if wl_pruned is None:
        wl_pruned = jnp.zeros((n, W), bool)
        wl_ptheta = jnp.full((n, W), INF, E_cost.dtype)

    def step(carry, xs):
        vb_eff, th_eff = carry
        ec, eco, ev, val_l, rub_l, cutf_l, exact_l, mask_l, ep_l, wlp_l, wlth_l = xs
        nvb, nth, vb_l, mk_l, th_l, hs_l = _layer_body(
            W, D, best_known, vb_eff, th_eff, ec, eco, ev,
            val_l, rub_l, cutf_l, exact_l, mask_l, ep_l, wlp_l, wlth_l,
        )
        return (nvb, nth), (vb_l, mk_l, th_l, hs_l)

    _, (vb, mk, th, hs) = jax.lax.scan(
        step, (vb_init, th_init),
        (E_child, E_cost, E_valid, S_val, S_rub, cutflag, S_exact, S_mask,
         ep_theta, wl_pruned, wl_ptheta),
        reverse=True,
    )
    return vb, mk, th, hs

