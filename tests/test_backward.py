"""The fused backward pass under `jax.vmap`, as the engine's K-lane
superstep runs it, against one call per lane on random edge planes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddo_tpu.engine import backward as bwd
from ddo_tpu.utils.num import INF, NEG_INF


def _random_case(rng, n, W, D, K):
    C = W * D
    shp = lambda *s: (K,) + s
    ec = rng.integers(-1, W, shp(n, C)).astype(np.int32)
    eco = rng.integers(-20, 20, shp(n, C)).astype(np.int32)
    ev = rng.random(shp(n, C)) < 0.6
    val = rng.integers(-50, 50, shp(n, W)).astype(np.int32)
    rub = rng.integers(0, 60, shp(n, W)).astype(np.int32)
    cutf = rng.random(shp(n, W)) < 0.2
    exact = rng.random(shp(n, W)) < 0.5
    mask = rng.random(shp(n, W)) < 0.8
    vb_init = np.where(rng.random(shp(W)) < 0.5,
                       rng.integers(-5, 5, shp(W)), NEG_INF).astype(np.int32)
    th_init = np.where(rng.random(shp(W)) < 0.5,
                       rng.integers(-30, 30, shp(W)), INF).astype(np.int32)
    ep = np.where(rng.random(shp(n, W)) < 0.2,
                  rng.integers(-30, 30, shp(n, W)), INF).astype(np.int32)
    wlp = rng.random(shp(n, W)) < 0.15
    wlth = np.where(wlp, rng.integers(-30, 30, shp(n, W)), INF).astype(np.int32)
    best_known = rng.integers(-20, 40, K).astype(np.int32)
    args = [jnp.asarray(x) for x in
            (ec, eco, ev, val, rub, cutf, exact, mask, vb_init, th_init,
             best_known)]
    return args, [jnp.asarray(x) for x in (ep, wlp, wlth)]


@pytest.mark.parametrize("with_planes", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_vmapped_backward_matches_per_lane(seed, with_planes):
    rng = np.random.default_rng(200 + seed)
    K = 4
    args, planes = _random_case(rng, 6, 8, 3, K)
    extra = planes if with_planes else []
    got = jax.vmap(bwd.fused_backward)(*args, *extra)
    for k in range(K):
        lane = bwd.fused_backward(*(a[k] for a in args + extra))
        for g, r, name in zip(got, lane, ["vb", "mk", "th", "hs"]):
            np.testing.assert_array_equal(
                np.asarray(g[k]), np.asarray(r), err_msg=f"{name} lane {k}"
            )
