"""0/1 knapsack — tensorized DP model.

Reference model: /root/reference/ddo/examples/knapsack/main.rs
  * state = remaining capacity (depth tracked by the engine;
    cf. KnapsackState, main.rs:37-44)
  * domain = {leave out, take} (main.rs:93-99)
  * merge = max capacity (main.rs:150-152)
  * fast upper bound = greedy fractional relaxation over the
    profit/weight-sorted item order (main.rs:158-180) — here O(log n) per
    state via precomputed prefix sums + searchsorted instead of a loop.
  * ranking = capacity (main.rs:188-194)
  * dominance: key=depth, coordinate=capacity, use_value (main.rs:199-218)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ddo_tpu.core.problem import Dominance, Problem, Relaxation, StateRanking
from ddo_tpu.utils.num import VALUE_DTYPE

I32 = jnp.int32


class Knapsack(Problem):
    #: bundled model: all hooks route instance data through `data`
    #: pytrees / root state; trace-relevant scalars are in _trace_statics
    shares_traces = True
    name = "knapsack"

    def __init__(self, capacity: int, profit, weight):
        self.capacity = int(capacity)
        self.profit = np.asarray(profit, np.int64)
        self.weight = np.asarray(weight, np.int64)
        n = len(self.profit)
        self.nb_variables = n
        self.domain_size = 2
        # branch in decreasing profit/weight ratio (main.rs:66-67)
        ratio = -self.profit / np.maximum(self.weight, 1)
        self.order = np.argsort(ratio, kind="stable").astype(np.int32)
        # prefix sums along the order for the greedy bound; the bound's
        # table lookups run as one-hot matmuls (see KPRelax.rub), so
        # every table is pre-split into f32-exact halves (hi*4096 + lo)
        pw = np.concatenate([[0], np.cumsum(self.weight[self.order])])
        pp = np.concatenate([[0], np.cumsum(self.profit[self.order])])
        ord_p = np.concatenate([self.profit[self.order], [0]])  # pad: no frac item
        ord_w = np.concatenate([self.weight[self.order], [1]])
        self._data = dict(
            profit=jnp.asarray(self.profit, I32),
            weight=jnp.asarray(self.weight, I32),
            order=jnp.asarray(self.order, I32),
            prefix_w=jnp.asarray(pw, I32),
            prefix_p=jnp.asarray(pp, I32),
            pw_hi=jnp.asarray(pw >> 12, jnp.float32),
            pw_lo=jnp.asarray(pw & 0xFFF, jnp.float32),
            pp_hi=jnp.asarray(pp >> 12, jnp.float32),
            pp_lo=jnp.asarray(pp & 0xFFF, jnp.float32),
            ord_p_f=jnp.asarray(ord_p, jnp.float32),
            ord_w_f=jnp.asarray(ord_w, jnp.float32),
        )

    @property
    def data(self):
        return self._data

    def initial_state(self, data):
        return {"capacity": jnp.asarray(self.capacity, I32)}

    def var_order(self, data):
        return data["order"]

    def step(self, data, state, var, d, depth):
        cap = state["capacity"]
        w = data["weight"][var]
        take = d == 1
        valid = jnp.where(take, cap >= w, True)
        ncap = jnp.where(take & valid, cap - w, cap)
        cost = jnp.where(take, data["profit"][var], 0).astype(VALUE_DTYPE)
        return {"capacity": ncap}, cost, d.astype(I32), valid

    def pack(self, state):
        return state["capacity"].reshape(1)


class KPRelax(Relaxation):
    """main.rs:147-181."""

    def __init__(self, problem: Knapsack):
        self.problem = problem

    @property
    def data(self):
        return self.problem.data

    def merge(self, data, states, mask):
        cap = jnp.max(jnp.where(mask, states["capacity"], -1))
        return {"capacity": cap}

    def rub(self, data, state, depth):
        # greedy fractional bound from `depth` in ratio order
        # (main.rs:158-180), via prefix sums: items taken whole are the
        # longest order-consecutive run fitting in the capacity, then one
        # fractional item (integer floor).
        #
        # Per-node table scans/gathers over the [n+1] prefix arrays are the
        # kernel's hot spot.  Both the searchsorted count and every table
        # lookup are expressed as one-hot f32 matmuls — under the engine's
        # layer vmap they become [W, n+1] @ [n+1] contractions.
        # i32 exactness: tables are pre-split into 12-bit f32-exact halves.
        pw = data["prefix_w"]
        cap = state["capacity"]
        base_w = pw[depth]
        target = base_w + cap
        L = pw.shape[0]
        # m = (# prefix entries <= target) - 1, never < depth since cap >= 0
        # precision pinned on EVERY one-hot dot: any batching/vmap change
        # can turn them into matrix contractions whose reduced default
        # precision (TF32 on GPU tensor cores) rounds the 12-bit-split
        # halves (the LCS r3 wrong-answer class; enforced by
        # tests/test_precision_guard.py)
        pred = (pw <= target).astype(jnp.float32)
        m = jnp.dot(pred, jnp.ones((L,), jnp.float32),
                    precision="float32").astype(jnp.int32) - 1
        oh = (jax.lax.iota(jnp.int32, L) == m).astype(jnp.float32)

        def take_split(hi_t, lo_t):
            return (jnp.dot(oh, hi_t, precision="float32").astype(jnp.int32) * 4096
                    + jnp.dot(oh, lo_t, precision="float32").astype(jnp.int32))

        pw_m = take_split(data["pw_hi"], data["pw_lo"])
        pp_m = take_split(data["pp_hi"], data["pp_lo"])
        whole = pp_m - data["prefix_p"][depth]
        rem = cap - (pw_m - base_w)
        # fractional item = order[m]; the padded row (m = n) contributes 0
        p_m = jnp.dot(oh, data["ord_p_f"], precision="float32").astype(jnp.int32)
        w_m = jnp.dot(oh, data["ord_w_f"], precision="float32").astype(jnp.int32)
        frac = rem * p_m // jnp.maximum(w_m, 1)
        return (whole + frac).astype(VALUE_DTYPE)


class KPRanking(StateRanking):
    """main.rs:188-194: larger capacity is more promising."""

    def score(self, data, state):
        return state["capacity"].reshape(1)

    def score_host(self, state):
        return int(np.asarray(state["capacity"]))


class KPDominance(Dominance):
    """main.rs:199-218: same depth, coordinate=capacity, value included."""

    use_value = True

    def key_cols(self, state):
        # depth is already the store's partition key: every same-depth
        # state is comparable
        return jnp.zeros((0,), jnp.int32)

    def coord_cols(self, state):
        return jnp.asarray(state["capacity"], jnp.int32).reshape(1)


def read_instance(path: str) -> Knapsack:
    """Parses the `resources/knapsack` format (main.rs:267-299):
    first non-comment line `n capacity`, then n lines `profit weight`."""
    profit, weight = [], []
    n = capa = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("c"):
                continue
            parts = line.split()
            if n is None:
                n, capa = int(parts[0]), int(parts[1])
            else:
                if len(profit) >= n:
                    break
                profit.append(int(parts[0]))
                weight.append(int(parts[1]))
    return Knapsack(capa, profit, weight)


def generate(n: int, R: int, cls: int, h: int, H: int = 100, seed: int = 0) -> Knapsack:
    """Seeded instance of one of Pisinger's knapsack classes.

    D. Pisinger, "Where are the hard knapsack problems?", Computers &
    Operations Research 32 (2005) 2271-2284, section 2 — the generator
    behind the `knapPI_{cls}_{n}_{R}_{h}` files:
      * class 1 (uncorrelated): p, w ~ U[1, R];
      * class 2 (weakly correlated): w ~ U[1, R],
        p ~ U[max(1, w - R/10), w + R/10];
      * class 3 (strongly correlated): w ~ U[1, R], p = w + R/10;
      * capacity c = floor(h / (H + 1) * sum(w)), instance h of H.

    Assumed where the paper leaves it open: numpy's PCG64
    (`np.random.default_rng(seed)`) replaces Pisinger's own generator, so
    a seed does not reproduce the published files, only their class; R/10
    is integer division; the weights are drawn first, then the profits."""
    if cls not in (1, 2, 3):
        raise ValueError(f"Pisinger class must be 1, 2 or 3, got {cls}")
    if n < 1 or R < 1 or not 1 <= h <= H:
        raise ValueError(f"need n >= 1, R >= 1 and 1 <= h <= H (n={n}, R={R}, h={h}, H={H})")
    rng = np.random.default_rng(seed)
    w = rng.integers(1, R + 1, n)
    r10 = R // 10
    if cls == 1:
        p = rng.integers(1, R + 1, n)
    elif cls == 2:
        p = rng.integers(np.maximum(1, w - r10), w + r10 + 1)
    else:
        p = w + r10
    capacity = int(h * int(w.sum()) // (H + 1))
    return Knapsack(capacity, p, w)


def dp_optimum(pb: Knapsack) -> int:
    """Exact optimum by the textbook O(n * capacity) row DP, in numpy —
    the plain reference the solver is checked against (it shares no code
    with the decision-diagram engine)."""
    best = np.zeros(pb.capacity + 1, np.int64)
    for p, w in zip(pb.profit.tolist(), pb.weight.tolist()):
        if w <= pb.capacity:
            # the right side is evaluated from the previous row before the
            # assignment, so each item is taken at most once
            best[w:] = np.maximum(best[w:], best[: best.size - w] + p)
    return int(best[-1])
