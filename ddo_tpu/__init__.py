"""ddo_tpu — accelerator branch-and-bound with decision diagrams.

A from-scratch JAX/XLA re-design of the capabilities of xgillard/ddo
(Rust, mounted read-only at /root/reference): solving discrete
optimization problems to proved optimality by compiling restricted and
relaxed Multi-valued Decision Diagrams (MDDs) over each open subproblem
and driving a best-first branch-and-bound over their exact cutsets.

Where the reference walks one node at a time through hash maps and trait
objects, this framework compiles *whole layers* as dense masked tensors
and *whole frontier batches* as one vmapped XLA program, sharding the
batch over a device mesh for multi-device scaling.

The solver alias matrix mirrors solver/mod.rs:29-47.
"""

from ddo_tpu.core.problem import (
    Dominance,
    ModelBundle,
    Problem,
    Relaxation,
    StateRanking,
)
from ddo_tpu.core.types import (
    Completion,
    CompilationType,
    CutsetType,
    Reason,
    SubProblem,
    Threshold,
    root_subproblem,
)
from ddo_tpu.core.heuristics import (
    Cutoff,
    DivBy,
    FixedWidth,
    NbUnassignedWidth,
    NoCutoff,
    TimeBudget,
    Times,
    WidthHeuristic,
)
from ddo_tpu.engine.mdd import BufferOverflow, CompiledDD, DDCompiler
from ddo_tpu.search.cache import Cache, EmptyCache, SimpleCache
from ddo_tpu.search.dominance import (
    DominanceChecker,
    EmptyDominanceChecker,
    SimpleDominanceChecker,
)
from ddo_tpu.search.fringe import (
    Fringe,
    MaxUB,
    NoDupFringe,
    SimpleFringe,
    SubProblemRanking,
)
from ddo_tpu.search.solver import (
    NativeSolver,
    ParallelSolver,
    SequentialSolver,
    SolverStats,
)
from ddo_tpu.search.device_loop import DeviceLoopSolver
from ddo_tpu.parallel.mesh import MeshCompiler, MeshSolver, make_mesh
from ddo_tpu.api import Solution, maximize

from ddo_tpu.utils.num import INF, NEG_INF

LAST_EXACT_LAYER = CutsetType.LAST_EXACT_LAYER
FRONTIER = CutsetType.FRONTIER


def _solver(batch, cache_cls, cutset):
    def make(bundle, **kw):
        kw.setdefault("cache", cache_cls())
        kw.setdefault("cutset_type", cutset)
        kw.setdefault("batch", batch)
        return SequentialSolver(bundle, **kw)

    return make


# Solver alias matrix (solver/mod.rs:29-47).  {Seq,Par} x {Caching,NoCaching}
# x {Lel, Fc, Pooled}.  The Pooled variants use the frontier-cutset engine
# (the reference pooled MDD is frontier-only, pooled.rs:537); the pooled
# MDD's defining long-arc behavior is engaged automatically whenever the
# model overrides `Problem.is_impacted_by` (see engine/mdd.py).
SeqNoCachingSolverLel = _solver(1, EmptyCache, LAST_EXACT_LAYER)
SeqNoCachingSolverFc = _solver(1, EmptyCache, FRONTIER)
SeqCachingSolverLel = _solver(1, SimpleCache, LAST_EXACT_LAYER)
SeqCachingSolverFc = _solver(1, SimpleCache, FRONTIER)
ParNoCachingSolverLel = _solver(16, EmptyCache, LAST_EXACT_LAYER)
ParNoCachingSolverFc = _solver(16, EmptyCache, FRONTIER)
ParCachingSolverLel = _solver(16, SimpleCache, LAST_EXACT_LAYER)
ParCachingSolverFc = _solver(16, SimpleCache, FRONTIER)
SeqCachingSolverPooled = SeqCachingSolverFc
SeqNoCachingSolverPooled = SeqNoCachingSolverFc
ParCachingSolverPooled = ParCachingSolverFc
ParNoCachingSolverPooled = ParNoCachingSolverFc

DefaultSolver = ParNoCachingSolverLel  # solver/mod.rs:29
DefaultCachingSolver = ParCachingSolverFc  # solver/mod.rs:30

__all__ = [n for n in dir() if not n.startswith("_")]
