"""Longest Common Subsequence (m strings) — tensorized DP model.

Reference model: /root/reference/ddo/examples/lcs/{model,dp,dominance}.rs
  * state = current position in each string (model.rs LcsState);
  * domain = characters still present in every string, else a single
    go-to-end decision (model.rs for_each_in_domain);
  * transition jumps every position past the next occurrence
    (model.rs transition, precomputed `next` tables);
  * merge = min positions (model.rs merge);
  * rough bound = min(per-char remaining-common count, pairwise 2-string
    LCS tables) (model.rs fast_upper_bound, dp.rs LcsDp);
  * ranking prefers smaller total position (model.rs LcsRanking);
  * dominance: key=position[0], coords=-positions, with value
    (dominance.rs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ddo_tpu.core.problem import Dominance, Problem, Relaxation, StateRanking
from ddo_tpu.utils.num import VALUE_DTYPE

I32 = jnp.int32
GO_TO_END = -1


def _lcs_table(a, b):
    """Classic 2-string LCS suffix table (dp.rs LcsDp.solve)."""
    la, lb = len(a), len(b)
    t = np.zeros((la + 1, lb + 1), np.int64)
    for i in range(la - 1, -1, -1):
        for j in range(lb - 1, -1, -1):
            t[i, j] = max(t[i + 1, j], t[i, j + 1], t[i + 1, j + 1] + (a[i] == b[j]))
    return t


class Lcs(Problem):
    #: bundled model: all hooks route instance data through `data`
    #: pytrees / root state; trace-relevant scalars are in _trace_statics
    shares_traces = True
    _trace_statics = ('n_strings', 'n_chars')
    name = "lcs"

    def __init__(self, strings, n_chars: int):
        self.strings = [np.asarray(s, np.int64) for s in strings]
        self.n_strings = len(strings)
        self.n_chars = int(n_chars)
        self.lengths = np.array([len(s) for s in self.strings], np.int64)
        self.nb_variables = int(self.lengths[0])
        self.domain_size = self.n_chars + 1  # chars + go-to-end slot
        L = int(self.lengths.max()) + 1

        nxt = np.full((self.n_strings, self.n_chars, L + 1), L, np.int64)
        rem = np.zeros((self.n_strings, self.n_chars, L + 1), np.int64)
        for i, s in enumerate(self.strings):
            for pos in range(len(s) - 1, -1, -1):
                nxt[i, :, pos] = nxt[i, :, pos + 1]
                rem[i, :, pos] = rem[i, :, pos + 1]
                nxt[i, s[pos], pos] = pos
                rem[i, s[pos], pos] += 1

        tables = np.zeros((max(1, self.n_strings - 1), L + 1, L + 1), np.int64)
        for i in range(self.n_strings - 1):
            t = _lcs_table(self.strings[i], self.strings[i + 1])
            tables[i, : t.shape[0], : t.shape[1]] = t

        # tables are kept in f32 (all values <= L < 2^24, f32-exact):
        # per-node lookups run as one-hot contractions instead of dynamic
        # gathers (see ops/segments.onehot_take_i32)
        self._data = dict(
            next=jnp.asarray(nxt, jnp.float32),
            rem=jnp.asarray(rem, jnp.float32),
            tables=jnp.asarray(tables, jnp.float32),
            lengths=jnp.asarray(self.lengths, I32),
        )

    @property
    def data(self):
        return self._data

    def initial_state(self, data):
        return {"pos": jnp.zeros(self.n_strings, I32)}

    def step(self, data, state, var, d, depth):
        m = self.n_strings
        pos = state["pos"]
        is_end = d == self.n_chars
        c = jnp.clip(d, 0, self.n_chars - 1)
        # one-hot position/char lookups — precision float32 is REQUIRED:
        # a reduced-precision default (one bf16 pass, or TF32 on GPU
        # tensor cores) rounds integers > 256 or > 2048, which
        # silently validated impossible transitions on the length-844
        # reference instances (claimed LCS = whole first string)
        Lr = data["rem"].shape[2]
        oh_pos = (pos[:, None] == jax.lax.broadcasted_iota(I32, (m, Lr), 1)
                  ).astype(jnp.float32)  # [m, L+1]
        remmat = jnp.einsum("ml,mcl->mc", oh_pos, data["rem"],
                    precision="float32")  # [m, n_chars]
        # column-c selection via dynamic_slice, NOT `@ one_hot`: standalone
        # a mat-vec may be exact, but under the engine's (W, D) vmap it
        # batches into a matrix contraction whose reduced default precision
        # rounds large integers — next-position 277 rounded to 276 gave
        # EXACT SELF-LOOPS (pos frozen at 257..297 while value climbed to
        # the full string length on the reference instances)
        remc = jax.lax.dynamic_index_in_dim(remmat, c, 1, keepdims=False)  # [m]
        char_ok = jnp.all(remc > 0.5)
        # the go-to-end slot is valid only when no character is left in
        # every string (model.rs:103-118)
        any_char = jnp.any(jnp.all(remmat > 0.5, axis=0))
        valid = jnp.where(is_end, ~any_char, char_ok)

        nxtmat = jnp.einsum("ml,mcl->mc", oh_pos, data["next"],
                    precision="float32")  # [m, n_chars]
        np_char = jax.lax.dynamic_index_in_dim(
            nxtmat, c, 1, keepdims=False
        ).astype(I32) + 1
        npos = jnp.where(is_end, data["lengths"], np_char).astype(I32)
        cost = jnp.where(is_end, 0, 1).astype(VALUE_DTYPE)
        dval = jnp.where(is_end, GO_TO_END, d).astype(I32)
        return {"pos": npos}, cost, dval, valid

    def is_impacted_by(self, data, state, var):
        """Long arcs (model.rs:162-165): a node only branches at the layer
        equal to its first-string position; every other layer is crossed by
        a zero-cost identity arc (the reference solves LCS with
        ParCachingSolverPooled, main.rs:91 — the pooled/long-arc engine is
        what makes ~850-layer LCS DDs tractable: without it every node is
        re-expanded through all layers, duplicating whole sub-DDs)."""
        return state["pos"][0] == var

    def pack(self, state):
        return state["pos"]


class LcsRelax(Relaxation):
    def __init__(self, problem: Lcs):
        self.problem = problem

    @property
    def data(self):
        return self.problem.data

    def merge(self, data, states, mask):
        big = jnp.asarray(1 << 30, I32)
        pos = jnp.min(jnp.where(mask[:, None], states["pos"], big), axis=0)
        pos = jnp.minimum(pos, data["lengths"])
        return {"pos": pos.astype(I32)}

    def rub(self, data, state, depth):
        pb = self.problem
        m = pb.n_strings
        pos = state["pos"]
        Lr = data["rem"].shape[2]
        oh_pos = (pos[:, None] == jax.lax.broadcasted_iota(I32, (m, Lr), 1)
                  ).astype(jnp.float32)  # [m, L+1]
        remmat = jnp.einsum("ml,mcl->mc", oh_pos, data["rem"],
                            precision="float32")
        tot = jnp.sum(jnp.min(remmat, axis=0)).astype(I32)
        if m > 1:
            Lt = data["tables"].shape[1]
            ohp = oh_pos[:, :Lt]
            # tables[p, pos[p], pos[p+1]] as two chained contractions
            t_rows = jnp.einsum("pl,plk->pk", ohp[:-1], data["tables"],
                                precision="float32")
            pair = jnp.einsum("pk,pk->p", t_rows, ohp[1:],
                              precision="float32").astype(I32)
            tot = jnp.minimum(tot, jnp.min(pair))
        return tot.astype(VALUE_DTYPE)


class LcsRanking(StateRanking):
    """Smaller total position first (model.rs LcsRanking)."""

    def score(self, data, state):
        return (-jnp.sum(state["pos"])).reshape(1)

    def score_host(self, state):
        return -int(np.asarray(state["pos"]).sum())


class LcsDominance(Dominance):
    """dominance.rs: key=position[0], coords=-positions, use_value."""

    use_value = True

    def key_cols(self, state):
        return jnp.asarray(state["pos"], jnp.int32)[:1]

    def coord_cols(self, state):
        return -jnp.asarray(state["pos"], jnp.int32)


def read_instance(path: str) -> Lcs:
    """io_utils format: `n_strings n_chars`, then `len string` lines."""
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    n_strings, n_chars = (int(x) for x in lines[0].split())
    strings = []
    charmap = {}
    for line in lines[1 : 1 + n_strings]:
        parts = line.split()
        text = parts[1]
        s = []
        for ch in text:
            if ch not in charmap:
                charmap[ch] = len(charmap)
            s.append(charmap[ch])
        strings.append(s)
    return Lcs(strings, n_chars)
