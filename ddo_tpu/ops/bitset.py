"""Fixed-width bitset primitives over int32 lane arrays.

Tensorized replacement for the reference's `BitSet`/`Set256`/`Set64`
state encodings (e.g. misp/main.rs:63, tsptw/state.rs:34-56): a set over
`n` elements is a `[ceil(n/32)]` uint32 array, so set algebra becomes
lane-wise vector ops and membership counting uses the hardware popcount.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32


def nb_lanes(n: int) -> int:
    return max(1, (n + 31) // 32)


def full_set(n: int) -> jnp.ndarray:
    """{0..n-1} as lanes."""
    lanes = nb_lanes(n)
    out = np.zeros(lanes, np.uint32)
    for v in range(n):
        out[v // 32] |= np.uint32(1) << np.uint32(v % 32)
    return jnp.asarray(out, U32)


def empty_set(n: int) -> jnp.ndarray:
    return jnp.zeros(nb_lanes(n), U32)


def singleton(n: int, v) -> jnp.ndarray:
    lanes = nb_lanes(n)
    lane = v // 32
    bit = jnp.asarray(1, U32) << jnp.asarray(v % 32, U32)
    return jnp.zeros(lanes, U32).at[lane].set(bit)


def contains(s, v):
    lane = v // 32
    return (s[lane] >> jnp.asarray(v % 32, U32)) & 1 > 0


def insert(s, v):
    lane = v // 32
    return s.at[lane].set(s[lane] | (jnp.asarray(1, U32) << jnp.asarray(v % 32, U32)))


def remove(s, v):
    lane = v // 32
    return s.at[lane].set(s[lane] & ~(jnp.asarray(1, U32) << jnp.asarray(v % 32, U32)))


def union(a, b):
    return a | b


def intersect(a, b):
    return a & b


def difference(a, b):
    return a & ~b


def count(s):
    """Set cardinality (hardware popcount per lane)."""
    return jnp.sum(jax.lax.population_count(s).astype(jnp.int32))


def to_bits(s, n: int):
    """Unpack lanes -> bool[n] membership vector."""
    lanes = s.shape[-1]
    shifts = jnp.arange(32, dtype=U32)
    bits = (s[..., :, None] >> shifts) & 1  # [..., lanes, 32]
    return bits.reshape(s.shape[:-1] + (lanes * 32,))[..., :n].astype(bool)


def from_bits(bits, n: int):
    """bool[n] membership -> lanes."""
    lanes = nb_lanes(n)
    padded = jnp.zeros(bits.shape[:-1] + (lanes * 32,), bool).at[..., :n].set(bits)
    grouped = padded.reshape(bits.shape[:-1] + (lanes, 32)).astype(U32)
    shifts = jnp.arange(32, dtype=U32)
    return jnp.sum(grouped << shifts, axis=-1, dtype=U32)


def or_reduce(lanes, axis=0):
    """Bitwise-OR reduction (set union over a batch of sets)."""
    return jax.lax.reduce(lanes, jnp.asarray(0, lanes.dtype), jax.lax.bitwise_or, (axis,))


def and_reduce(lanes, axis=0):
    """Bitwise-AND reduction (set intersection over a batch of sets)."""
    return jax.lax.reduce(
        lanes, jnp.asarray(0xFFFFFFFF, lanes.dtype), jax.lax.bitwise_and, (axis,)
    )


def weight_sum(s, weights_i32, n: int):
    """Sum of weights of the members (the MISP rough bound, misp/main.rs:191-193)."""
    bits = to_bits(s, n)
    return jnp.sum(jnp.where(bits, weights_i32, 0), dtype=jnp.int32)


def reverse_bits(s):
    """Bit-reverse a [L]-lane set over its FULL 32*L-bit space:
    result bit i == input bit (32*L - 1 - i).

    Classic mask-swap word reversal (5 steps) + lane-order flip — pure
    vectorized lane ops, no gathers.  Combined with `shift_right_var`
    this turns data-dependent window gathers (w[j] = x[p - j]) into a
    handful of vector ops: w = shift_right_var(reverse_bits(x), 32L-1-p)."""
    v = s.astype(U32)
    c = lambda x: jnp.asarray(x, U32)
    v = ((v >> 1) & c(0x55555555)) | ((v & c(0x55555555)) << 1)
    v = ((v >> 2) & c(0x33333333)) | ((v & c(0x33333333)) << 2)
    v = ((v >> 4) & c(0x0F0F0F0F)) | ((v & c(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & c(0x00FF00FF)) | ((v & c(0x00FF00FF)) << 8)
    v = (v >> 16) | (v << 16)
    return v[..., ::-1]


def shift_right_var(s, t):
    """Logical right shift of a [L]-lane set by a TRACED bit count
    t in [0, 32*L]: result bit i == input bit (i + t), zeros shifted in.

    Funnel shift over lanes with the lane offset k = t // 32 resolved by
    L+1 static selects per lane — fully vectorized (no dynamic slices or
    per-element gathers when vmapped over candidate batches)."""
    L = s.shape[-1]
    k = (t // 32).astype(jnp.int32)
    r = (t % 32).astype(U32)
    rc = (32 - (t % 32)).astype(U32) % 32
    zero = jnp.zeros(s.shape[:-1], U32)
    out = []
    for l in range(L):
        acc = zero
        for kk in range(L + 1):
            a = s[..., l + kk] if l + kk < L else zero
            b = s[..., l + kk + 1] if l + kk + 1 < L else zero
            val = (a >> r) | jnp.where(r == 0, jnp.zeros_like(b), b << rc)
            acc = jnp.where(k == kk, val, acc)
        out.append(acc)
    return jnp.stack(out, axis=-1)
