"""Golomb ruler — tensorized DP model.

Reference model: /root/reference/ddo/examples/golomb/main.rs
  * state = {marks bitset, pairwise-distance bitset, #marks, last mark}
    (main.rs:49-56), bitsets over positions [0, n^2+1] as uint32 lanes;
  * domain = positions in (last, ub] whose distances to all marks are
    fresh (all-different, main.rs:81-95); ub from the known-optimum
    table pruning (main.rs:43-47);
  * cost = -(new - last) (minimize length as maximization);
  * merge = set intersections + min counts (main.rs:146-171);
  * rough bound = -known_optimal[n - #marks] (main.rs:174-177);
  * ranking = last mark (main.rs GolombRanking).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ddo_tpu.core.problem import Problem, Relaxation, StateRanking
from ddo_tpu.ops import bitset as bs
from ddo_tpu.utils.num import VALUE_DTYPE

I32 = jnp.int32

KNOWN_OPTIMAL_COSTS = np.array(
    [0, 0, 1, 3, 6, 11, 17, 25, 34, 44, 55, 72, 85, 106, 127, 151, 177, 199,
     216, 246, 283, 333, 356, 372, 425, 480, 492, 553, 585], np.int64,
)


class Golomb(Problem):
    #: bundled model: all hooks route instance data through `data`
    #: pytrees / root state; trace-relevant scalars are in _trace_statics
    shares_traces = True
    _trace_statics = ('n', 'P')
    name = "golomb"

    def __init__(self, n: int):
        self.n = int(n)
        self.nb_variables = self.n - 1  # first mark pinned at 0
        self.P = self.n * self.n + 2  # position space for the bitsets
        # widest domain range: ub bounded by n^2+1, lb >= 1
        self.domain_size = (self.n * self.n + 1) // 2 + 1
        self._data = dict(
            known=jnp.asarray(KNOWN_OPTIMAL_COSTS, I32),
        )

    @property
    def data(self):
        return self._data

    def initial_state(self, data):
        return {
            "marks": bs.singleton(self.P, 0),
            "dists": bs.empty_set(self.P),
            "m": jnp.asarray(1, I32),
            "last": jnp.asarray(0, I32),
        }

    def step(self, data, state, var, d, depth):
        n, P = self.n, self.P
        last = state["last"]
        m = state["m"]
        pos = last + 1 + d
        # position upper bound from the known-optima table (main.rs:83-87)
        known = data["known"]
        ub = jnp.where(
            m < n // 2,
            (n * n + 1) // 2 - known[jnp.clip(n // 2 - m, 0, known.shape[0] - 1)],
            n * n + 1 - known[jnp.clip(n - m, 0, known.shape[0] - 1)],
        )
        # The window w[j] = marks[pos - j] (False for j > pos) is the
        # bit-reversed mark set logically shifted right by 32L-1-pos —
        # a handful of lane-wise vector ops instead of a per-candidate
        # data-dependent gather (dist_bits[pos - jarr]).
        Lb = 32 * state["marks"].shape[-1]
        mark_win = bs.shift_right_var(
            bs.reverse_bits(state["marks"]),
            jnp.clip(Lb - 1 - pos, 0, Lb).astype(I32),
        )
        # clash: exists mark j with (pos - j) already a known distance
        # (the marks x dists correlation at lag pos)
        clash = jnp.any((state["dists"] & mark_win) != 0)
        valid = (pos <= ub) & (pos < P) & ~clash

        # transition (main.rs:113-126): distances gain {pos - j : j in marks}
        new_dists = state["dists"] | mark_win
        new_marks = bs.insert(state["marks"], jnp.clip(pos, 0, P - 1))
        cost = -(pos - last)
        nstate = {
            "marks": jnp.where(valid, new_marks, state["marks"]),
            "dists": jnp.where(valid, new_dists, state["dists"]),
            "m": m + 1,
            "last": jnp.where(valid, pos, last),
        }
        return nstate, cost.astype(VALUE_DTYPE), pos.astype(I32), valid

    def pack(self, state):
        return jnp.concatenate([
            jax.lax.bitcast_convert_type(state["marks"], I32).reshape(-1),
            jax.lax.bitcast_convert_type(state["dists"], I32).reshape(-1),
            state["m"].reshape(1),
            state["last"].reshape(1),
        ])

    def unpack(self, cols):
        import numpy as np
        L = bs.nb_lanes(self.P)
        cols = np.asarray(cols, np.int32)
        return {
            "marks": cols[:L].view(np.uint32),
            "dists": cols[L:2 * L].view(np.uint32),
            "m": cols[2 * L],
            "last": cols[2 * L + 1],
        }


class GolombRelax(Relaxation):
    def __init__(self, problem: Golomb):
        self.problem = problem

    @property
    def data(self):
        return self.problem.data

    def merge(self, data, states, mask):
        """Set intersections + min counts (main.rs:146-171)."""
        m = mask[:, None]
        full = jnp.asarray(np.uint32(0xFFFFFFFF))
        marks = bs.and_reduce(jnp.where(m, states["marks"], full), axis=0)
        dists = bs.and_reduce(jnp.where(m, states["dists"], full), axis=0)
        big = jnp.asarray(1 << 30, I32)
        mm = jnp.min(jnp.where(mask, states["m"], big))
        ml = jnp.min(jnp.where(mask, states["last"], big))
        return {"marks": marks, "dists": dists, "m": mm, "last": ml}

    def rub(self, data, state, depth):
        known = data["known"]
        k = jnp.clip(self.problem.n - state["m"], 0, known.shape[0] - 1)
        return (-known[k]).astype(VALUE_DTYPE)


class GolombRanking(StateRanking):
    """Larger last mark preferred (main.rs GolombRanking)."""

    def score(self, data, state):
        return state["last"].reshape(1)

    def score_host(self, state):
        return int(np.asarray(state["last"]))
