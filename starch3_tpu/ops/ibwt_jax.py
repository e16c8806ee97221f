"""Device inverse BWT: last column -> original block, no sequential walk.

The reference's decoder (bundled bzip2's decompress.c) and this
framework's host decoder (runtime.cpp dec_block) invert the BWT with an
n-step pointer chase over the LF mapping — inherently sequential.  The
device formulation replaces the walk with parallel primitives:

  1. LF mapping by one stable sort: sorting (last, idx) yields the
     permutation sigma with sigma[r] = row of the r-th smallest symbol
     occurrence, and LF[sigma[r]] = r — one sort + one scatter;
  2. list ranking by pointer jumping: freeze the start row (orig_ptr),
     then log2(n) rounds of d[i] += d[nxt[i]]; nxt[i] = nxt[nxt[i]]
     give every row's distance d[i] to the start along LF;
  3. placement: for an exactly periodic block the LF permutation splits
     into several cycles and the sequential walk simply loops the start
     cycle (length c) n/c times, so the output is periodic with period
     c.  Scatter the start cycle's symbols into a period table
     P[d] = last[i], then gather out[j] = P[(j - n + 1) mod c] — for a
     primitive block c == n and this degenerates to the single-cycle
     placement.

O(n log n) work instead of O(n) but fully parallel/vectorized — the
same trade the encode-side prefix doubling makes (ops/bwt_jax.py).
Fixed shapes: padded to n_max, true length as a scalar.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_BIG = np.int32(0x7FFFFFF0)


@functools.partial(jax.jit, static_argnames=("n_max",))
def ibwt_padded(last: jax.Array, orig_ptr: jax.Array, n: jax.Array, n_max: int):
    """Invert a BWT last column on device.

    Args:
      last: uint8[n_max] BWT last column (entries beyond ``n`` ignored)
      orig_ptr: int32 scalar, sorted position of rotation 0
      n: int32 scalar, true length
      n_max: static padded size
    Returns:
      out: uint8[n_max] original block bytes (valid prefix of length n)
    """
    from starch3_tpu.ops.bwt_jax import _unscatter

    idx = jnp.arange(n_max, dtype=jnp.int32)
    valid = idx < n
    # 1. LF via stable sort on the symbol (padding sorts to the tail);
    # the inverse permutation is another sort, not a scatter (bwt_jax)
    key = jnp.where(valid, last.astype(jnp.int32), _BIG)
    _, sigma = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
    lf = _unscatter(sigma, idx)

    # 2. pointer jumping with the start row frozen
    nxt = jnp.where(idx == orig_ptr, idx, lf)
    d = jnp.where(valid & (idx != orig_ptr), 1, 0)

    def body(state):
        d, nxt, k = state
        d2 = d + d[nxt]
        nxt2 = nxt[nxt]
        return d2, nxt2, k * 2

    def cond(state):
        _d, _nxt, k = state
        return k < n

    d, nxt, _ = jax.lax.while_loop(cond, body, (d, nxt, jnp.int32(1)))

    # 3. members of the start cycle converged onto the frozen start; the
    # output is that cycle's symbols tiled with period c
    member = valid & (nxt == orig_ptr)
    # c >= 1 for any in-range orig_ptr; the clamp keeps the mod below
    # well-defined on corrupt inputs (callers validate ptr/CRC host-side)
    c = jnp.maximum(member.sum().astype(jnp.int32), 1)
    period = jnp.zeros(n_max, jnp.uint8)
    period = period.at[jnp.where(member, d, n_max)].set(
        jnp.where(member, last, 0), mode="drop"
    )
    out = period[jnp.where(valid, jnp.mod(idx - n + 1, c), 0)]
    return jnp.where(valid, out, 0).astype(jnp.uint8)
