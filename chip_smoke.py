"""Bring-up check: drive ddo_tpu's solve path once on an NVIDIA GPU.

    python3 chip_smoke.py           # one card: phases 1-5
    python3 chip_smoke.py --multi   # four cards: MeshSolver against one card

Every instance is generated here from a seed, so the script needs nothing
but the repository.  Phases, one line each:

  1. device   - JAX's default device must be a GPU; there is no fallback;
  2. parity   - one relaxed superstep (K=8 lanes, W=256, n=2000) compiled
                for the GPU and for the host CPU; every output is an integer
                or a bool and must be bit-equal (tolerance 0);
  3. kernel   - the benchmark's relaxed superstep (K=128, W=256, n=2000);
                exp/s is printed for information;
  4. proof    - SequentialSolver proves the generated n=2000 knapsack
                (Pisinger class 1, R=1000, h=1) at its DP optimum;
  5. devloop  - DeviceLoopSolver proves Golomb(7) = 25.

`--multi` runs only the pair MeshSolver over four GPUs / SequentialSolver
on one card for phase 4's instance and configuration.

The first line is the card's name and power limit (nvidia-smi).  The last
line of stdout is one JSON object, {"ok": true, "device": {...}}, printed
only when every phase passed; any failure raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# the shape of knapPI_1_2000_1000_1, the benchmark's headline instance
KP = dict(n=2000, R=1000, cls=1, h=1, seed=0)
GOLOMB_N, GOLOMB_LENGTH = 7, 25


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu(jax):
    """The default devices, which must be GPUs: no CPU fallback."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU, JAX's default device is "
            f"{devs[0].platform} ({devs[0].device_kind})"
        )
    return devs


def knapsack_bundle(n, R, cls, h, seed):
    from ddo_tpu import ModelBundle
    from ddo_tpu.models.knapsack import KPRanking, KPRelax, generate

    pb = generate(n, R, cls, h, seed=seed)
    return pb, ModelBundle(pb, KPRelax(pb), KPRanking())


def relaxed_superstep(bundle, K, W, widths=None):
    """(jitted fn, spec, dynamic args) of the benchmark's K-lane relaxed
    compilation from the root, one effective width per lane."""
    import ddo_tpu
    from ddo_tpu.core.types import CompilationType, root_subproblem
    from ddo_tpu.engine.mdd import DDCompiler, _compile_vjit

    compiler = DDCompiler(bundle, W, ddo_tpu.LAST_EXACT_LAYER)
    root = root_subproblem(bundle.problem)
    states, values, depths, ws, psets, actives = compiler._prep_batch(
        [root] * K, widths or [W] * K, pad_to=K
    )
    spec = compiler._specs[CompilationType.RELAXED]
    args = (bundle.datas, states, values, depths, -(10**9), ws, psets, actives)
    return _compile_vjit, spec, args


def compile_on(jax, fn, spec, args, device):
    """AOT-compile `fn` for `device`; returns (compiled, args there, s)."""
    args = jax.device_put(args, device)
    t0 = time.perf_counter()
    with jax.default_device(device):
        compiled = fn.lower(spec, *args).compile()
    return compiled, args, time.perf_counter() - t0


def leaves_equal(jax, a, b):
    """Names of the leaves that differ; integer/bool leaves only."""
    la, tree = jax.tree_util.tree_flatten_with_path(a)
    lb = jax.tree_util.tree_leaves(b)
    bad = []
    for (path, x), y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype.kind not in "biu":
            raise TypeError(f"non-integer output {jax.tree_util.keystr(path)}: {x.dtype}")
        if x.shape != y.shape or not np.array_equal(x, y):
            bad.append(jax.tree_util.keystr(path))
    return bad


def phase_parity(jax, bundle, optimum, K=8, W=256):
    """GPU vs CPU compile of one relaxed superstep, bit-equal."""
    fn, spec, args = relaxed_superstep(
        bundle, K, W, [max(1, W >> (k % 4)) for k in range(K)]
    )
    gpu, gargs, g_s = compile_on(jax, fn, spec, args, jax.devices()[0])
    cpu, cargs, c_s = compile_on(jax, fn, spec, args, jax.devices("cpu")[0])
    mem = gpu.memory_analysis()
    t0 = time.perf_counter()
    out_g = jax.block_until_ready(gpu(*gargs))
    g_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_c = jax.block_until_ready(cpu(*cargs))
    c_run = time.perf_counter() - t0
    bad = leaves_equal(jax, out_g, out_c)
    if bad:
        raise AssertionError(f"GPU and CPU outputs differ in {bad}")
    bound = int(np.max(np.asarray(out_g[0]["best_value"])))
    if bound < optimum:
        raise AssertionError(f"relaxed bound {bound} below the optimum {optimum}")
    n_leaves = len(jax.tree_util.tree_leaves(out_g))
    print(
        f"phase 2 parity: K={K} W={W} n={bundle.problem.nb_variables} "
        f"compile gpu {g_s:.3f}s cpu {c_s:.3f}s, run gpu {g_run:.3f}s "
        f"cpu {c_run:.3f}s; {n_leaves} integer outputs bit-equal; "
        f"relaxed bound {bound} >= optimum {optimum}"
    )
    print(
        "phase 2 memory_analysis (gpu): "
        f"argument={mem.argument_size_in_bytes} output={mem.output_size_in_bytes} "
        f"temp={mem.temp_size_in_bytes} alias={mem.alias_size_in_bytes} "
        f"code={mem.generated_code_size_in_bytes}"
    )


def phase_kernel(jax, bundle, optimum, K=128, W=256, reps=3):
    """The benchmark's relaxed superstep at full width: exp/s."""
    fn, spec, args = relaxed_superstep(bundle, K, W)
    compiled, args, c_s = compile_on(jax, fn, spec, args, jax.devices()[0])
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out, gbest, texp = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    expanded = int(texp)
    bound = int(np.max(np.asarray(out["best_value"])))
    if expanded <= 0 or bound < optimum:
        raise AssertionError(f"kernel: expanded={expanded} bound={bound} optimum={optimum}")
    dt = float(np.median(times))
    print(
        f"phase 3 kernel: K={K} W={W} n={bundle.problem.nb_variables} "
        f"compile {c_s:.3f}s, run median {dt:.4f}s of {[round(t, 4) for t in times]}, "
        f"{expanded} expansions, {expanded / dt:,.0f} exp/s"
    )


def solve_twice(make_solver, expect, label):
    """Cold (compiles included) and warm solve; both must prove `expect`."""
    times = []
    for _ in range(2):
        solver = make_solver()
        t0 = time.perf_counter()
        completion = solver.maximize()
        times.append(time.perf_counter() - t0)
        got = solver.best_value()
        if not (completion.is_exact and got == expect):
            raise AssertionError(
                f"{label}: got {got} (exact={completion.is_exact}), expected {expect}"
            )
    st = solver.stats
    return (
        f"cold {times[0]:.3f}s warm {times[1]:.3f}s, proved {expect}; "
        f"supersteps={st.supersteps} explored={solver.explored_count} "
        f"expanded={solver.expanded_nodes} device={st.restricted_s + st.relaxed_s:.3f}s "
        f"host={st.host_s:.3f}s"
    )


def knapsack_solver(pb, bundle, cls=None, **kw):
    """The benchmark's knapsack proof configuration."""
    import ddo_tpu
    from ddo_tpu import FixedWidth, SimpleCache, SimpleDominanceChecker
    from ddo_tpu.models.knapsack import KPDominance

    cls = cls or ddo_tpu.SequentialSolver
    return cls(
        bundle, width_heu=FixedWidth(2), batch=8, cache=SimpleCache(),
        cutset_type=ddo_tpu.FRONTIER,
        dominance=SimpleDominanceChecker(KPDominance(), pb.nb_variables), **kw,
    )


def phase_proof(pb, bundle, optimum):
    line = solve_twice(lambda: knapsack_solver(pb, bundle), optimum, "proof")
    print(f"phase 4 proof: SequentialSolver n={pb.nb_variables} DP optimum {optimum}: {line}")


def golomb_solver(n):
    import ddo_tpu
    from ddo_tpu import ModelBundle, SimpleCache
    from ddo_tpu.models.golomb import Golomb, GolombRanking, GolombRelax

    pb = Golomb(n)
    bundle = ModelBundle(pb, GolombRelax(pb), GolombRanking())
    return ddo_tpu.DeviceLoopSolver(
        bundle, width_heu=ddo_tpu.NbUnassignedWidth(pb.nb_variables),
        batch=64, cache=SimpleCache(), cutset_type=ddo_tpu.FRONTIER,
        chunk_steps=32,
    )


def phase_devloop(n, length):
    line = solve_twice(lambda: golomb_solver(n), -length, "devloop")
    print(f"phase 5 devloop: DeviceLoopSolver Golomb({n}) length {length}: {line}")


def phase_multi(jax, devs, pb, bundle, optimum, n_dev=4):
    """MeshSolver over `n_dev` cards against SequentialSolver on one."""
    from ddo_tpu.core.types import root_subproblem
    from ddo_tpu.parallel.mesh import MeshSolver, make_mesh

    if len(devs) < n_dev:
        raise SystemExit(f"--multi needs {n_dev} GPUs, JAX found {len(devs)}")
    mesh = make_mesh(devs[:n_dev])
    probe = knapsack_solver(pb, bundle, cls=MeshSolver, mesh=mesh)
    root = root_subproblem(pb)
    names = ("states", "values", "depths", "widths", "path_sets", "actives")
    lanes = probe.compiler._prep_batch([root] * probe.batch, [2] * probe.batch,
                                       pad_to=probe.batch)
    for name, arr in zip(names, lanes):
        for leaf in jax.tree_util.tree_leaves(arr):
            ids = sorted(d.id for d in leaf.sharding.device_set)
            print(f"multi lanes {name}{list(leaf.shape)}: devices {ids}")
            if len(ids) != n_dev:
                raise AssertionError(f"lane input {name} spans {ids}, not {n_dev} devices")
    mesh_line = solve_twice(
        lambda: knapsack_solver(pb, bundle, cls=MeshSolver, mesh=mesh),
        optimum, "mesh",
    )
    print(f"multi MeshSolver {n_dev} GPUs n={pb.nb_variables} DP optimum {optimum}: {mesh_line}")
    one_line = solve_twice(lambda: knapsack_solver(pb, bundle), optimum, "one card")
    print(f"multi SequentialSolver 1 GPU n={pb.nb_variables} DP optimum {optimum}: {one_line}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="only MeshSolver over 4 GPUs against one card")
    args = parser.parse_args(argv)

    import jax

    from ddo_tpu.models.knapsack import dp_optimum
    from ddo_tpu.utils.jax_setup import enable_compile_cache

    # phase 2 compiles for the host CPU too, which a GPU-only
    # JAX_PLATFORMS would leave uninitialized
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    enable_compile_cache()

    print(card_line(), flush=True)
    devs = require_gpu(jax)
    print(f"phase 1 device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}", flush=True)

    t0 = time.perf_counter()
    pb, bundle = knapsack_bundle(**KP)
    optimum = dp_optimum(pb)
    print(f"instance: Pisinger {KP} capacity={pb.capacity} DP optimum {optimum} "
          f"({time.perf_counter() - t0:.3f}s)", flush=True)

    if args.multi:
        phase_multi(jax, devs, pb, bundle, optimum)
    else:
        phase_parity(jax, bundle, optimum)
        phase_kernel(jax, bundle, optimum)
        phase_proof(pb, bundle, optimum)
        phase_devloop(GOLOMB_N, GOLOMB_LENGTH)
    sys.stdout.flush()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))


if __name__ == "__main__":
    main()
