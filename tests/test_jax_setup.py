"""The persistent compile cache helper, run in a fresh interpreter each
time so the test process's own JAX config is never touched."""

import json
import os
import subprocess
import sys

from ddo_tpu.utils import jax_setup

PROBE = (
    "import json, jax; from ddo_tpu.utils.jax_setup import enable_compile_cache; "
    "got = enable_compile_cache(); "
    "print(json.dumps([got, jax.config.jax_compilation_cache_dir]))"
)


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", PROBE], capture_output=True, text=True,
        env=env, check=True, timeout=120, cwd=jax_setup.CHECKOUT,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_var_wins(tmp_path):
    assert _probe(str(tmp_path)) == [str(tmp_path), str(tmp_path)]


def test_default_is_inside_the_checkout():
    want = str(jax_setup.CHECKOUT / ".jax_cache")
    assert _probe(None) == [want, want]
    assert (jax_setup.CHECKOUT / "ddo_tpu" / "utils" / "jax_setup.py").is_file()
