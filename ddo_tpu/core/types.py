"""Host-side value types crossing every layer of the framework.

Tensorized counterparts of the reference common types
(/root/reference/ddo/src/common.rs):
  * `Variable`/`Decision` (common.rs:33,57) collapse into plain ints: a
    solution is a dense int32[n] array `vals` (+ bool[n] `set_mask`) mapping
    each variable index to its decided value.
  * `SubProblem` (common.rs:75-87) keeps a single-state numpy pytree.
  * `Threshold` (common.rs:96-101), `Reason` (common.rs:108), and
    `Completion` (common.rs:115-121) map 1:1.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np

from ddo_tpu.utils.num import INF


class CompilationType(enum.Enum):
    """Mirrors reference `CompilationType` (abstraction/mdd.rs:41-48)."""

    EXACT = 0
    RELAXED = 1
    RESTRICTED = 2


class CutsetType(enum.IntEnum):
    """Mirrors reference cutset consts (abstraction/mdd.rs:24-28)."""

    LAST_EXACT_LAYER = 1
    FRONTIER = 2


class Reason(enum.Enum):
    """Mirrors reference `Reason` (common.rs:108-111)."""

    CUTOFF_OCCURRED = 0


@dataclasses.dataclass
class Completion:
    """Outcome of a DD development / solver run (common.rs:115-121)."""

    is_exact: bool
    best_value: Optional[int]


@dataclasses.dataclass(frozen=True)
class Threshold:
    """Barrier-pruning threshold for one (state, depth) (common.rs:96-101)."""

    value: int
    explored: bool

    def better_of(self, other: "Threshold") -> "Threshold":
        """Monotone max used by the cache (cache/simple.rs:62-66)."""
        if (other.value, other.explored) > (self.value, self.explored):
            return other
        return self


@dataclasses.dataclass
class SubProblem:
    """A residual problem rooted at an exact cutset node (common.rs:75-87)."""

    state: Any  # pytree of numpy arrays (single state)
    value: int
    path_vals: np.ndarray  # int32[n] decided value per variable
    path_set: np.ndarray  # bool[n] which variables the path decides
    ub: int
    depth: int
    key: bytes = b""  # canonical state key (set by the engine/solver)
    #: dominance key/coord columns captured from the compiled planes at
    #: enqueue time (saves per-pop hook evaluations); None = evaluate hooks
    dom_key: Optional[np.ndarray] = None
    dom_coords: Optional[np.ndarray] = None

    def solution_values(self) -> np.ndarray:
        return np.asarray(self.path_vals, dtype=np.int64)


def root_subproblem(problem) -> SubProblem:
    """Builds the root subproblem (sequential.rs:315-323).

    The canonical subproblem key is the engine's packed int32 key columns
    (`problem.pack`), so fringe dedup and the barrier cache agree with
    the keys the compiled planes carry."""
    import jax
    import jax.numpy as jnp

    n = problem.nb_variables
    state = jax.tree_util.tree_map(
        lambda x: np.asarray(x), problem.initial_state(problem.data)
    )
    key = np.asarray(
        problem.pack(jax.tree_util.tree_map(jnp.asarray, state)), np.int32
    ).tobytes()
    return SubProblem(
        state=state,
        value=int(problem.initial_value(problem.data)),
        path_vals=np.zeros(n, np.int32),
        path_set=np.zeros(n, bool),
        ub=INF,
        depth=0,
        key=key,
    )


def state_key_bytes(state) -> bytes:
    """Canonical bytes of a single host-side state pytree (dedup key)."""
    import jax

    leaves = jax.tree_util.tree_leaves(state)
    return b"|".join(np.ascontiguousarray(np.asarray(l, np.int64)).tobytes() for l in leaves)
