"""Benchmark: engine throughput + end-to-end time-to-proved-optimal.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}
plus a human-readable table on stderr.

Headline metric: MDD node expansions per second while compiling relaxed
DDs (the hot loop of the whole framework, reference clean.rs:345-381) on
knapPI_1_2000_1000_1 (n=2000), K lanes x width W on one device.  The
`extra` dict carries the same rate for MISP (bitset states + long arcs)
and TSPTW (256-bit sets + time windows) kernel shapes, and a measured
time-to-proved-optimal table over shared reference instances (optima
asserted, so a wrong solver cannot "win" the bench).

Baseline (VERDICT r3 #7: per-family and MEASURED, not one constant):
the Rust reference publishes no throughput numbers (BASELINE.md) and no
Rust toolchain exists in this image, so `vs_baseline` divides by the
output of `ddo_tpu/native/ref_baseline.cpp` — a C++ single-core replica
of the reference's exact hot-loop shape per family (transition ->
FxHash -> flat-map dedup insert -> Arc alloc + edge/node pushes,
clean.rs:728-776), built with g++ -O2 and run on THIS host.  That is a
generous ceiling for the reference (it omits rub evaluation, squash
sorts, and cache/dominance filtering the real loop also pays), measured
fresh each bench run and recorded in `extra.ref_baseline`.
`extra.baseline_kind` documents all of this; the time-to-optimal rows
are measured absolute numbers tracked round-over-round as the primary
perf record.
"""

from ddo_tpu.utils.resources import resources_root as _res_root
import json
import os
import subprocess
import sys
import tempfile
import time

def measure_ref_baseline():
    """Build + run the C++ reference-hot-loop replica; per-family exp/s.
    A failed build or run fails the bench: there is no assumed rate."""
    src = os.path.join(os.path.dirname(__file__), "ddo_tpu/native/ref_baseline.cpp")
    exe = os.path.join(tempfile.mkdtemp(prefix="ddo_ref_"), "ref_baseline")
    subprocess.run(["g++", "-O2", "-march=native", "-o", exe, src],
                   check=True, capture_output=True, timeout=120)
    out = subprocess.run([exe, "20000000"], check=True,
                         capture_output=True, timeout=300)
    rates = json.loads(out.stdout)
    log(f"ref baseline (C++ hot-loop replica, this host): {rates}")
    return rates, "measured-cpp-hot-loop-replica"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def kernel_rate(bundle, n_label, K, W, cutset, reps=5):
    """Expansions/s of the jitted K-lane relaxed superstep alone."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ddo_tpu.core.types import CompilationType, root_subproblem
    from ddo_tpu.engine.mdd import DDCompiler, _compile_vjit

    compiler = DDCompiler(bundle, W, cutset)
    spec = compiler._specs[CompilationType.RELAXED]
    root = root_subproblem(bundle.problem)
    subs = [root] * K
    states = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *[s.state for s in subs]
    )
    values = jnp.asarray([s.value for s in subs], jnp.int32)
    depths = jnp.asarray([s.depth for s in subs], jnp.int32)
    ws = jnp.asarray([W] * K, jnp.int32)
    psets = jnp.asarray(np.stack([s.path_set for s in subs]))

    actives = jnp.ones((K,), bool)

    def run():
        out, _, _ = _compile_vjit(
            spec, bundle.datas, states, values, depths, -(10**9), ws, psets,
            actives,
        )
        jax.block_until_ready(out["expanded"])
        return out

    run()  # warm (jit compile)
    # best-of-3 timing groups: single-shot timings are noisy
    best_dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = run()
        best_dt = min(best_dt, (time.perf_counter() - t0) / reps)
    dt = best_dt
    expanded = int(np.sum(np.asarray(out["expanded"])))
    rate = expanded / dt
    log(f"  rate[{n_label}] K={K} W={W}: {rate:,.0f} exp/s "
        f"({expanded} exp / {dt*1e3:.1f} ms)")
    return rate


def time_to_optimal(label, make_solver, expect, warm_reps=3):
    """Measured cold (incl. one-time jit compile) and warm solve times;
    the proved optimum is asserted so a wrong solver cannot 'win'.

    Warm is repeated `warm_reps` times and reported as min + median + all
    reps, so a one-off host hiccup can't masquerade as a regression."""
    import statistics

    stats = {}

    def one(phase):
        solver = make_solver()
        t0 = time.perf_counter()
        completion = solver.maximize()
        dt = time.perf_counter() - t0
        got = solver.best_value()
        st = solver.stats
        log(f"  tto[{label}] {phase}: {dt:.3f}s  value={got} expect={expect} "
            f"exact={completion.is_exact} explored={solver.explored_count} "
            f"expanded={solver.expanded_nodes} supersteps={st.supersteps} "
            f"device={st.restricted_s + st.relaxed_s:.3f}s host={st.host_s:.3f}s")
        if not (completion.is_exact and got == expect):
            raise AssertionError(
                f"{label}: got {got} (exact={completion.is_exact}), "
                f"expected {expect}")
        # keep the last rep's phase breakdown (warm-state representative):
        # VERDICT r3 #3 — the host/device split per TTO row makes 'where do
        # the seconds go' visible round-over-round
        stats.update(
            supersteps=st.supersteps,
            explored=solver.explored_count,
            expanded=solver.expanded_nodes,
            device_s=round(st.restricted_s + st.relaxed_s, 3),
            host_s=round(st.host_s, 3),
        )
        return round(dt, 3)

    cold = one("cold")
    warms = [one(f"warm{i+1}") for i in range(warm_reps)]
    return {
        "cold_s": cold,
        "warm_s": min(warms),
        "warm_median_s": round(statistics.median(warms), 3),
        "warm_reps": warms,
        **stats,
    }


def main():
    from ddo_tpu.utils.jax_setup import enable_compile_cache

    enable_compile_cache()

    import ddo_tpu
    from ddo_tpu import FixedWidth, ModelBundle, SimpleCache, SimpleDominanceChecker

    R = _res_root()
    ref_rates, baseline_kind = measure_ref_baseline()
    extra = {
        "baseline_kind": baseline_kind + " (single-core ceiling of the "
        "reference's _branch_on loop on this host; see bench.py docstring "
        "and ddo_tpu/native/ref_baseline.cpp)",
        "ref_baseline": {k: round(v) for k, v in ref_rates.items()},
    }

    # ---------------- kernel throughput, three model families --------------
    log("kernel throughput (relaxed compile superstep):")
    from ddo_tpu.models.knapsack import KPRanking, KPRelax
    from ddo_tpu.models.knapsack import read_instance as kp_read

    kp = kp_read(f"{R}/knapsack/knapPI_1_2000_1000_1")
    kp_bundle = ModelBundle(kp, KPRelax(kp), KPRanking())
    rate_kp = kernel_rate(kp_bundle, "knapsack_n2000", 128, 256,
                          ddo_tpu.LAST_EXACT_LAYER)
    extra["knapsack_exp_per_sec"] = round(rate_kp)
    extra["knapsack_vs_ref"] = round(rate_kp / ref_rates["knapsack"], 3)

    from ddo_tpu.models.misp import MispRanking, MispRelax
    from ddo_tpu.models.misp import read_instance as misp_read

    mp = misp_read(f"{R}/misp/keller4.clq")
    mp_bundle = ModelBundle(mp, MispRelax(mp), MispRanking(mp))
    rate_mp = kernel_rate(mp_bundle, "misp_keller4", 64, 128,
                          ddo_tpu.LAST_EXACT_LAYER)
    extra["misp_exp_per_sec"] = round(rate_mp)
    extra["misp_vs_ref"] = round(rate_mp / ref_rates["misp"], 3)

    from ddo_tpu.models.tsptw import TsptwRanking, TsptwRelax
    from ddo_tpu.models.tsptw import read_instance as tw_read

    tw = tw_read(f"{R}/tsptw/SolomonPotvinBengio/rc_201.1.txt")
    tw_bundle = ModelBundle(tw, TsptwRelax(tw), TsptwRanking())
    rate_tw = kernel_rate(tw_bundle, "tsptw_rc201.1", 64, 128, ddo_tpu.FRONTIER)
    extra["tsptw_exp_per_sec"] = round(rate_tw)
    extra["tsptw_vs_ref"] = round(rate_tw / ref_rates["tsptw"], 3)

    # ---------------- measured end-to-end time-to-proved-optimal ----------
    log("time-to-proved-optimal (measured, optima asserted):")
    from ddo_tpu.models.knapsack import KPDominance

    tto = {}
    for name, opt in [("knapPI_1_500_1000_1", 28857),
                      ("knapPI_1_1000_1000_1", 54503),
                      ("knapPI_1_2000_1000_1", 110625)]:
        pb = kp_read(f"{R}/knapsack/{name}")
        bundle = ModelBundle(pb, KPRelax(pb), KPRanking())
        tto[name] = time_to_optimal(
            name,
            lambda: ddo_tpu.SequentialSolver(
                bundle, width_heu=FixedWidth(2), batch=8, cache=SimpleCache(),
                cutset_type=ddo_tpu.FRONTIER,
                dominance=SimpleDominanceChecker(KPDominance(), pb.nb_variables),
            ),
            opt,
        )

    cf = misp_read(f"{R}/misp/c-fat200-5.clq")
    cf_bundle = ModelBundle(cf, MispRelax(cf), MispRanking(cf))
    tto["misp_c-fat200-5"] = time_to_optimal(
        "misp_c-fat200-5",
        lambda: ddo_tpu.SequentialSolver(
            cf_bundle, width_heu=FixedWidth(16), batch=8,
            cutset_type=ddo_tpu.LAST_EXACT_LAYER,
        ),
        58,
    )

    from ddo_tpu.models.tsptw import TsptwDominance, TsptwWidth

    lg = tw_read(f"{R}/tsptw/Langevin/N20ft301.dat")
    lg_bundle = ModelBundle(lg, TsptwRelax(lg), TsptwRanking())
    tto["tsptw_N20ft301"] = time_to_optimal(
        "tsptw_N20ft301",
        lambda: ddo_tpu.SequentialSolver(
            lg_bundle, width_heu=TsptwWidth(lg.nb_variables, 1), batch=8,
            cache=SimpleCache(), cutset_type=ddo_tpu.FRONTIER,
            dominance=SimpleDominanceChecker(TsptwDominance(), lg.nb_variables),
            buffer_width=max(64, lg.nb_variables),
        ),
        -6616000,
    )

    # ----- one TTO row per additional family (VERDICT r3 #7: the failing
    # families' perf must be visible round-over-round, not just the easy
    # three).  Solver configs mirror tests/slow/test_reference_parity.py;
    # expected optima come from the reference's tests.rs tables.
    from ddo_tpu.models.max2sat import Max2SatRanking, Max2SatRelax
    from ddo_tpu.models.max2sat import read_instance as m2s_read

    m2 = m2s_read(f"{R}/max2sat/frb10-6-1.wcnf")
    m2_bundle = ModelBundle(m2, Max2SatRelax(m2), Max2SatRanking())
    tto["max2sat_frb10-6-1"] = time_to_optimal(
        "max2sat_frb10-6-1",
        lambda: ddo_tpu.DeviceLoopSolver(
            m2_bundle, width_heu=FixedWidth(8), batch=8, cache=SimpleCache(),
            chunk_steps=16,
        ),
        37037,
    )

    from ddo_tpu.models.sop import SopRanking, SopRelax, SopWidth
    from ddo_tpu.models.sop import read_instance as sop_read

    so = sop_read(f"{R}/sop/ESC07.sop")
    so_bundle = ModelBundle(so, SopRelax(so), SopRanking())
    tto["sop_ESC07"] = time_to_optimal(
        "sop_ESC07",
        lambda: ddo_tpu.SequentialSolver(
            so_bundle, width_heu=SopWidth(so.nb_variables, 1), batch=8,
            cache=SimpleCache(), cutset_type=ddo_tpu.FRONTIER,
            buffer_width=max(64, so.nb_jobs),
        ),
        -2125,  # tests.rs optimum 2125; solver maximizes the negation
    )

    from ddo_tpu.models.srflp import SrflpRanking, SrflpRelax, SrflpWidth
    from ddo_tpu.models.srflp import read_instance as srflp_read

    sf = srflp_read(f"{R}/srflp/Cl8")
    sf_bundle = ModelBundle(sf, SrflpRelax(sf), SrflpRanking())
    tto["srflp_Cl8"] = time_to_optimal(
        "srflp_Cl8",
        lambda: ddo_tpu.SequentialSolver(
            sf_bundle, width_heu=SrflpWidth(sf.nb_variables, 1), batch=8,
            cache=SimpleCache(), cutset_type=ddo_tpu.FRONTIER,
            buffer_width=max(64, sf.nb_variables),
        ),
        sf.root_value - 6295,  # tests.rs optimum 6295 = root_value - best
    )

    from ddo_tpu.models.talentsched import TalentSchedRanking, TalentSchedRelax
    from ddo_tpu.models.talentsched import read_instance as ts_read

    ts = ts_read(f"{R}/talentsched/concert")
    ts_bundle = ModelBundle(ts, TalentSchedRelax(ts), TalentSchedRanking())
    tto["talentsched_concert"] = time_to_optimal(
        "talentsched_concert",
        lambda: ddo_tpu.SequentialSolver(
            ts_bundle, width_heu=FixedWidth(100), batch=8, cache=SimpleCache(),
            cutset_type=ddo_tpu.FRONTIER,
        ),
        -111,
    )

    from ddo_tpu.models.golomb import Golomb, GolombRanking, GolombRelax

    go = Golomb(7)
    go_bundle = ModelBundle(go, GolombRelax(go), GolombRanking())
    tto["golomb7"] = time_to_optimal(
        "golomb7",
        lambda: ddo_tpu.DeviceLoopSolver(
            go_bundle, width_heu=ddo_tpu.NbUnassignedWidth(go.nb_variables),
            batch=64, cache=SimpleCache(), cutset_type=ddo_tpu.FRONTIER,
            chunk_steps=32,
        ),
        -25,
    )

    from ddo_tpu.models.alp import AlpDominance, AlpRanking, AlpRelax
    from ddo_tpu.models.alp import read_instance as alp_read

    al = alp_read(f"{R}/alp/alp_n25_r1_c2_std10_s0")
    al_bundle = ModelBundle(al, AlpRelax(al), AlpRanking())
    tto["alp_n25_r1_c2_std10_s0"] = time_to_optimal(
        "alp_n25_r1_c2_std10_s0",
        lambda: ddo_tpu.DeviceLoopSolver(
            al_bundle, width_heu=FixedWidth(64), batch=8, cache=SimpleCache(),
            cutset_type=ddo_tpu.FRONTIER,
            dominance=SimpleDominanceChecker(AlpDominance(), al.nb_variables),
            chunk_steps=16,
        ),
        -755,  # alp/tests.rs optimum 755
    )

    from ddo_tpu.models.psp import PspRanking, PspRelax
    from ddo_tpu.models.psp import read_instance as psp_read

    ps, _ = psp_read(f"{R}/psp/instancesWith5items/1")
    ps_bundle = ModelBundle(ps, PspRelax(ps), PspRanking())
    tto["psp_5items_1"] = time_to_optimal(
        "psp_5items_1",
        lambda: ddo_tpu.SequentialSolver(
            ps_bundle, width_heu=FixedWidth(250), batch=8, cache=SimpleCache(),
        ),
        -1377,  # psp/tests.rs optimum 1377
    )
    extra["time_to_optimal_s"] = tto

    print(
        json.dumps(
            {
                "metric": "mdd_node_expansions_per_sec",
                "value": round(rate_kp),
                "unit": "nodes/s",
                "vs_baseline": round(rate_kp / ref_rates["knapsack"], 3),
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
