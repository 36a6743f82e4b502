"""Tensorized DP-model contract: the accelerator counterpart of the reference
`Problem` / `Relaxation` / `StateRanking` traits.

Reference semantics (re-designed, not translated):
  * `Problem` trait:      /root/reference/ddo/src/abstraction/dp.rs:34-71
  * `Relaxation` trait:   /root/reference/ddo/src/abstraction/dp.rs:77-107
  * `StateRanking`:       /root/reference/ddo/src/abstraction/heuristics.rs:74

Design inversion: the reference walks one node at a time through
user closures (`for_each_in_domain` + `transition` + `transition_cost`,
dp.rs:47-62).  Here a *layer* is a dense `[W, ...]` structure-of-arrays and
the model supplies pure per-(state, domain-slot) functions which the engine
`vmap`s over the whole layer and domain at once.  States are pytrees of
fixed-shape integer arrays, so duplicate detection is done by canonical key
packing + sort instead of hashing, and node-merge is a masked reduction.

Every hook receives the model's `data` pytree explicitly (instance data such
as weights/profits) so that instance arrays are traced jit arguments rather
than baked-in constants.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ddo_tpu.utils.num import INF, VALUE_DTYPE


def _static_key_of(obj):
    """Trace-identity key of a model component: class + the attrs it
    names in `_trace_statics` + (recursively) a referenced problem's key.
    Instance ARRAYS are excluded on purpose — they ride the traced `data`
    pytree, and their shapes are part of the jit signature anyway."""
    extra = tuple(getattr(obj, a, None) for a in getattr(obj, "_trace_statics", ()))
    pb = getattr(obj, "problem", None)
    pkey = pb.static_key() if isinstance(pb, Problem) else None
    return (type(obj), extra, pkey)


class Problem:
    """DP formulation of a maximization problem as a labeled transition system.

    Mirrors the reference `Problem` trait (abstraction/dp.rs:34-71) with the
    iteration inverted for dense batching:

      * ``nb_variables``  -> attribute `nb_variables`
      * ``initial_state`` -> `initial_state(data)` returning a state pytree
      * ``initial_value`` -> `initial_value(data)`
      * ``for_each_in_domain`` + ``transition`` + ``transition_cost``
        -> one fused `step(data, state, var, d, depth)` returning
           `(next_state, cost, decision_value, valid)` for domain *slot* `d`
           in `range(domain_size)`; `valid=False` marks slots outside the
           domain of `var` in `state`.
      * ``next_variable`` -> either a static `var_order(data)` permutation or
        a dynamic `next_variable(data, depth, states, mask, assigned)` hook.
    """

    #: short name used by the CLI / registry
    name: str = "problem"
    #: number of decision variables (static)
    nb_variables: int = 0
    #: maximum number of domain values of any variable (static)
    domain_size: int = 0

    @property
    def data(self):
        """Pytree of instance arrays passed (traced) to every hook."""
        return ()

    #: names of extra instance attrs whose VALUES shape the traced program
    #: (scalars a traced hook reads off `self` instead of `data`); list
    #: them so same-shape instances of one family share compiled kernels
    _trace_statics: tuple = ()

    #: OPT-IN to cross-instance kernel sharing (ADVICE r2, medium).
    #: Setting this True asserts a strict contract for the WHOLE bundle
    #: (problem + relaxation + ranking + dominance): every traced hook
    #: routes ALL instance data through the traced `data` pytrees or the
    #: root state, and every trace-relevant scalar read off `self` is
    #: listed in `_trace_statics`.  A hook that closes over an unlisted
    #: instance array/scalar would get ANOTHER instance's constants baked
    #: into the shared kernel — silent wrong answers.  When False
    #: (default), trace identity is per-instance (id-based): always safe,
    #: but every instance recompiles the engine.  All bundled models set
    #: it True (they follow the contract; the parity suites would compile
    #: hundreds of kernels otherwise).
    shares_traces: bool = False

    def static_key(self):
        """Trace-identity key: instances with equal keys (and equal data
        SHAPES) share one jitted compilation — e.g. every TSPTW Langevin
        n=20 instance compiles the engine once.  Host-only attrs (like a
        knapsack's capacity, which reaches the kernel via the traced root
        state) must NOT be listed in `_trace_statics` or sharing is lost;
        trace-relevant scalars MUST be, or sharing would be wrong.  Only
        honored when the class opts in via `shares_traces` (see above)."""
        if not self.shares_traces:
            return (type(self), id(self))
        return (
            type(self), self.nb_variables, self.domain_size,
            tuple(getattr(self, a, None) for a in self._trace_statics),
        )

    # -- state space ---------------------------------------------------------
    def initial_state(self, data):
        raise NotImplementedError

    def initial_value(self, data):
        return jnp.asarray(0, VALUE_DTYPE)

    def step(self, data, state, var, d, depth):
        """Expand one domain slot: returns (next_state, cost, dval, valid)."""
        raise NotImplementedError

    # -- variable ordering ---------------------------------------------------
    def var_order(self, data):
        """Static branching order: int32[n] permutation, or None if dynamic."""
        return jnp.arange(self.nb_variables, dtype=jnp.int32)

    def next_variable(self, data, depth, states, mask, assigned):
        """Dynamic branching hook (used when `var_order` returns None).

        `states`/`mask` describe the layer about to be expanded, `assigned`
        is a bool[n] mask of already-branched variables.  Must return the
        index of an unassigned variable (int32 scalar).
        """
        raise NotImplementedError

    # -- long arcs -------------------------------------------------------------
    def is_impacted_by(self, data, state, var):
        """Long-arc hook (abstraction/dp.rs:66-71, pooled.rs:608-680).

        Override to return a traced bool: False means branching `var` does
        not impact `state`.  When a model overrides this, the engine runs in
        pooled/long-arc mode: unimpacted nodes cross the layer through one
        zero-cost identity arc whose decision is never recorded on the
        path — the dense-tensor equivalent of the reference's node pool.
        The base implementation (not overridden) means every variable
        impacts every state and the engine skips the extra work entirely.
        """
        return jnp.asarray(True)

    # -- dedup key -----------------------------------------------------------
    def pack(self, state):
        """Canonical fixed-width key: int32[K] uniquely identifying `state`.

        The default flattens every leaf of the state pytree; override for a
        tighter packing.  Used for duplicate-state detection (the engine's
        replacement for the reference's `FxHashMap`, clean.rs:143).
        """
        leaves = jax.tree_util.tree_leaves(state)
        cols = [jnp.ravel(l).astype(jnp.int32) for l in leaves]
        if not cols:
            return jnp.zeros((1,), jnp.int32)
        return jnp.concatenate(cols)

    def unpack(self, cols):
        """Inverse of `pack` on the host: int32[K] numpy -> state pytree.

        Required by the native search runtime, whose fringe stores only the
        canonical key columns.  The default inverts the default `pack` by
        splitting along the leaves of `initial_state`; models with a custom
        packing must override both consistently (pack must be injective for
        dedup correctness anyway, so a bijective encoding costs nothing).

        PURE NUMPY + cached template: unpack runs once per fringe push,
        and rebuilding the template via `initial_state` made every call a
        device round-trip, which turned cutset enqueues into the solver's
        dominant cost (round-4 cProfile of an LCS superstep).
        """
        spec = getattr(self, "_unpack_spec", None)
        if spec is None:
            template = self.initial_state(self.data)
            np_tpl = jax.tree_util.tree_map(np.asarray, template)
            leaves, treedef = jax.tree_util.tree_flatten(np_tpl)
            spec = (treedef, [(l.shape, l.dtype, l.ndim) for l in leaves])
            self._unpack_spec = spec
        treedef, leaf_specs = spec
        out, k = [], 0
        cols = np.asarray(cols)
        for shape, dtype, ndim in leaf_specs:
            size = int(np.prod(shape)) if ndim else 1
            chunk = cols[k : k + size].astype(dtype)
            out.append(chunk.reshape(shape) if ndim else chunk[0])
            k += size
        return jax.tree_util.tree_unflatten(treedef, out)


class Relaxation:
    """Node-merge operator + arc relaxation + rough upper bound.

    Mirrors the reference `Relaxation` trait (abstraction/dp.rs:77-107):
      * ``merge``            -> `merge(data, states, mask)` where `states` is
        a stacked pytree `[C, ...]` and `mask` selects the nodes to merge;
        returns one merged state.
      * ``relax``            -> `relax_cost(data, src, dst, merged, dval,
        cost, var)` adjusting the weight of an arc redirected to the merged
        node (default: unchanged).
      * ``fast_upper_bound`` -> `rub(data, state, depth)` (default +inf).
    """

    @property
    def data(self):
        return ()

    _trace_statics: tuple = ()

    def static_key(self):
        return _static_key_of(self)

    def merge(self, data, states, mask):
        raise NotImplementedError

    def relax_cost(self, data, src, dst, merged, dval, cost, var):
        return cost

    def rub(self, data, state, depth):
        return jnp.asarray(INF, VALUE_DTYPE)


class StateRanking:
    """Orders states by how promising they are (greater = keep).

    Mirrors `StateRanking::compare` (abstraction/heuristics.rs:74) but as a
    vectorizable scoring function: returns an int32 scalar or `[R]` vector
    compared lexicographically, larger is better.
    """

    @property
    def data(self):
        return ()

    _trace_statics: tuple = ()

    def static_key(self):
        return _static_key_of(self)

    def score(self, data, state):
        return jnp.zeros((1,), jnp.int32)


class Dominance:
    """Keyed multi-dimensional dominance relation between same-depth states.

    Mirrors the reference `Dominance` trait (abstraction/dominance.rs:37-99).
    Two evaluation surfaces:

      * device hooks (jax, vectorizable) — used by the engine for
        IN-COMPILATION dominance filtering (clean.rs:689-708):
        `key_cols(state) -> int32[KK]` (states are only comparable when
        every key column matches; KK may be 0 = all same-depth states
        comparable) and `coord_cols(state) -> int32[CC]` (greater is
        better on every axis; CC may be 0 = value-only dominance);
      * host hooks (numpy) — used by the global keyed store:
        `key(state) -> hashable | None` and `coords(state)`.  The
        defaults derive them from the device hooks, so models normally
        implement only `key_cols`/`coord_cols`.

    `use_value` includes the node value as the last comparison dimension
    (and enables pruning thresholds, dominance.rs:57-79).

    PURITY REQUIREMENT (ADVICE r2): the device hooks are closed over the
    instance inside shared compile kernels with no traced-data channel —
    they MUST be pure functions of (state, scalars listed in
    `_trace_statics`).  A Dominance holding unlisted per-instance arrays
    would have them baked as constants into kernels shared across
    instances of a `shares_traces` bundle.
    """

    use_value: bool = False
    _trace_statics: tuple = ()

    def static_key(self):
        return (_static_key_of(self), self.use_value)

    # -- device hooks (jax) --------------------------------------------------
    def key_cols(self, state):
        """int32[KK] comparability key, or None = filtering unsupported."""
        return None

    def coord_cols(self, state):
        """int32[CC] coordinates; greater is better on every axis."""
        return jnp.zeros((0,), jnp.int32)

    # -- host hooks (numpy), derived by default ------------------------------
    def key(self, state):
        cols = self.key_cols(state)
        if cols is None:
            return None
        return np.asarray(cols, np.int64).tobytes()

    def coords(self, state):
        return np.asarray(self.coord_cols(state), np.int64)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Problem + relaxation + ranking, the static part of a compilation.

    The analogue of the reference `CompilationInput` statics
    (abstraction/mdd.rs:51-71); the dynamic residual/bounds are passed per
    compile call.
    """

    problem: Problem
    relaxation: Relaxation
    ranking: StateRanking

    def static_key(self):
        """Trace-identity of the whole bundle: same-family instances with
        identical static keys share every jitted engine compilation (the
        data pytrees are traced arguments, so only their SHAPES matter).
        This is what makes a 400-instance parity sweep compile the kernel
        a handful of times instead of 400."""
        return (
            self.problem.static_key(),
            self.relaxation.static_key(),
            self.ranking.static_key(),
        )

    def __hash__(self):  # jit static-arg identity
        return hash(self.static_key())

    def __eq__(self, other):
        return (
            isinstance(other, ModelBundle)
            and self.static_key() == other.static_key()
        )

    @property
    def datas(self):
        return (self.problem.data, self.relaxation.data, self.ranking.data)
