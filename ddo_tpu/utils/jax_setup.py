"""Process-level JAX settings shared by the entry points.

`enable_compile_cache` is the one place that points JAX's persistent
compilation cache at a directory; the CLI, `bench.py`, `chip_smoke.py`
and the test suite's device mode call it before their first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: the checkout this package was imported from (ddo_tpu/utils/ -> root)
CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it by itself and
    nothing is changed.  Otherwise the cache lives in `<checkout>/.jax_cache`
    (listed in .gitignore), a fixed path so that reruns hit it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
