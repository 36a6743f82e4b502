"""Saturating integer arithmetic used throughout the DD engine.

The reference library (xgillard/ddo) computes all objective values with
64-bit `isize` and uses `isize::MAX` / `isize::MIN` as +inf / -inf sentinels
with `saturating_add` / `saturating_sub` everywhere (see
/root/reference/ddo/src/implementation/mdd/clean.rs:208,364,426-428,504-511).

The engine keeps everything in int32 (JAX's default integer width; int64
needs x64 mode and doubles every buffer).
To make `a + b` safe for any two representable values we pick the sentinels
at +/- 2**30 - 1 so that the sum of two saturated values still fits in int32
(2**31 - 2 < 2**31 - 1).  All additions of objective-valued quantities must
go through `sat_add` / `sat_sub` which clamp back into [NEG_INF, INF].
"""

import jax.numpy as jnp

VALUE_DTYPE = jnp.int32

#: +infinity sentinel for objective values (mirrors isize::MAX).
INF = (1 << 30) - 1
#: -infinity sentinel for objective values (mirrors isize::MIN).
NEG_INF = -INF


def sat_add(a, b):
    """Saturating addition over int32 objective values."""
    return jnp.clip(
        jnp.asarray(a, VALUE_DTYPE) + jnp.asarray(b, VALUE_DTYPE), NEG_INF, INF
    )


def sat_sub(a, b):
    """Saturating subtraction over int32 objective values."""
    return jnp.clip(
        jnp.asarray(a, VALUE_DTYPE) - jnp.asarray(b, VALUE_DTYPE), NEG_INF, INF
    )
