"""One-call convenience API — the counterpart of the reference's Python
bindings (`py_ddo/src/lib.rs:46-98`), whose entire surface is a single
`maximize(...)` returning a `Solution` record.

The reference needs pyo3 glue because its engine is Rust; here the whole
framework is Python-native, so this is a thin assembly helper over
`SequentialSolver` with the same knobs (lel/use_cache/dedup/width/timeout)
and the same result shape.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from ddo_tpu.core.heuristics import (
    FixedWidth,
    NbUnassignedWidth,
    NoCutoff,
    TimeBudget,
)
from ddo_tpu.core.problem import ModelBundle
from ddo_tpu.core.types import CutsetType
from ddo_tpu.search.cache import EmptyCache, SimpleCache
from ddo_tpu.search.fringe import NoDupFringe, SimpleFringe


@dataclasses.dataclass
class Solution:
    """py_ddo's Solution record (lib.rs:20-44)."""

    aborted: bool
    objective: Optional[int]
    upper_bound: int
    lower_bound: int
    assignment: Optional[List[int]]
    gap: float
    duration: float


def maximize(
    problem,
    relax,
    ranking,
    lel: bool = True,
    use_cache: bool = True,
    dedup: bool = True,
    width: Optional[int] = None,
    timeout: Optional[float] = None,
    batch: int = 1,
    dominance=None,
) -> Solution:
    """Solve `problem` to proved optimality (or until `timeout` seconds).

    Mirrors `py_ddo.maximize` (lib.rs:46-98): `lel` picks the
    last-exact-layer vs frontier cutset, `use_cache` the threshold cache,
    `dedup` the no-duplicate fringe, `width` a FixedWidth override
    (default: number of unassigned variables, lib.rs:138-146).  `batch` is
    this framework's extension: how many subproblems to compile per
    superstep.
    """
    from ddo_tpu.search.solver import SequentialSolver

    bundle = ModelBundle(problem, relax, ranking)
    solver = SequentialSolver(
        bundle,
        width_heu=FixedWidth(width) if width
        else NbUnassignedWidth(problem.nb_variables),
        cutset_type=CutsetType.LAST_EXACT_LAYER if lel else CutsetType.FRONTIER,
        cache=SimpleCache() if use_cache else EmptyCache(),
        cutoff=TimeBudget(timeout) if timeout is not None else NoCutoff(),
        fringe=NoDupFringe() if dedup else SimpleFringe(),
        dominance=dominance,
        batch=batch,
    )
    start = time.perf_counter()
    completion = solver.maximize()
    duration = time.perf_counter() - start

    assignment = None
    if solver.best_solution() is not None:
        vals, pset = solver.best_solution()
        assignment = [int(v) for v in vals]

    return Solution(
        aborted=not completion.is_exact,
        objective=solver.best_value(),
        upper_bound=solver.best_upper_bound(),
        lower_bound=solver.best_lower_bound(),
        assignment=assignment,
        gap=solver.gap(),
        duration=duration,
    )
