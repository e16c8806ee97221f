"""Device RLE2 / zero-run coding: MTF ranks -> bzip2 symbol stream.

Completes the on-device block pipeline (BWT -> MTF -> RLE2 here ->
Huffman costing in ops/huff_jax.py -> bit-pack in ops/bitpack_jax.py):
after this stage the only host work left is the 258-node Huffman length
heap (host by design — its observable tie-breaking is sequential) and
stream splicing.

Behavioral spec + host oracle: codec/mtf.py mtf_rle2_from_ranks — zero
runs become bijective-base-2 RUNA/RUNB digits (z+1's binary digits, MSB
dropped, LSB-first), rank j -> symbol j+1, EOB = n_in_use+1 appended.

Formulation (scatter-minimal: one scatter per digit plane would cost a
random-access pass each):

  every OUTPUT symbol is pinned to a distinct INPUT position.  A run of
  z zeros emits dig = bitlen(z+1)-1 <= z digits, so digit r of a run
  rides the run's r-th zero; a nonzero rank's symbol rides its own
  position; digits precede their symbol in both input and output order.
  Per-position quantities are two scans plus elementwise math:

    run_start  = inclusive cummax of nonzero positions   (last nz <= i)
    next_nz    = reverse cummin of nonzero positions      (first nz >= i)
    r          = i - run_start - 1        (zero's index within its run)
    z_total    = next_nz - run_start - 1  (the run's full length)
    dig        = 31 - clz(z_total + 1) - 0  (exact integer bit length)
    emit       = nonzero | (r < dig)
    value      = nonzero ? rank + 1 : (z_total + 1 >> r) & 1
    out_idx    = cumsum(emit) - 1

  and ONE scatter compacts (out_idx, value).  The EOB symbol needs no
  write at all: the output is padded with EOB, so slot m-1 already
  holds it.  RUNA/RUNB frequencies are two masked sums; only the
  rank histogram remains a scatter-add.

Outputs are padded to ``n_max + 2`` with the true length as a scalar.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_NEG1 = -1


@functools.partial(jax.jit, static_argnames=("n_max",))
def rle2_from_ranks_padded(
    ranks: jax.Array, n: jax.Array, n_in_use: jax.Array, n_max: int
):
    """RLE2-encode MTF ranks on device.

    Args:
      ranks: int32[n_max] MTF ranks (entries beyond ``n`` ignored)
      n: int32 scalar, true length
      n_in_use: int32 scalar, dense alphabet size (EOB = n_in_use + 1)
      n_max: static padded size
    Returns:
      syms: int32[n_max + 2] symbol stream (padded with EOB value beyond m)
      m: int32 scalar, true symbol count (EOB included)
      freq: int32[260] symbol histogram over the first m entries
    """
    idx = jnp.arange(n_max, dtype=jnp.int32)
    valid = idx < n
    nz = valid & (ranks != 0)

    # last nonzero at or before i (== strictly before for zero positions,
    # which are the only consumers); -1 when none
    run_start = jax.lax.cummax(jnp.where(nz, idx, _NEG1))
    # first nonzero at or after i; n when none (the tail run ends at the
    # virtual EOB chunk).  Reverse-scan as flip+cummin+flip: flips are
    # contiguous moves, cheaper than gathers.
    next_nz = jnp.flip(jax.lax.cummin(jnp.flip(jnp.where(nz, idx, n))))

    r = idx - run_start - 1  # zero's index within its run
    z_total = next_nz - run_start - 1  # the run's full zero count
    mval = z_total + 1
    # exact bit length via count-leading-zeros (float32 log2 can round
    # below an exact power of two); dig = bitlen(mval) - 1
    dig = 31 - jax.lax.clz(mval)

    digit = (mval >> jnp.maximum(r, 0)) & 1
    emit = valid & (nz | (r < dig))
    value = jnp.where(nz, ranks + 1, digit)

    ecount = jnp.cumsum(emit.astype(jnp.int32))
    out_idx = ecount - 1
    m = ecount[-1] + 1  # + EOB

    eob = n_in_use + 1
    # padding value IS the EOB symbol, so slot m-1 needs no write
    syms = jnp.full(n_max + 2, 0, dtype=jnp.int32) + eob
    syms = syms.at[jnp.where(emit, out_idx, n_max + 2)].set(
        jnp.where(emit, value, 0), mode="drop"
    )

    # frequencies: digits by two masked sums, ranks by one scatter-add
    zero_emit = emit & ~nz
    runa = jnp.sum(zero_emit & (digit == 0)).astype(jnp.int32)
    runb = jnp.sum(zero_emit & (digit == 1)).astype(jnp.int32)
    freq = jnp.zeros(260, dtype=jnp.int32)
    freq = freq.at[jnp.where(nz, ranks + 1, 260)].add(1, mode="drop")
    freq = freq.at[0].add(runa).at[1].add(runb)
    freq = freq.at[eob].add(1)
    return syms, m, freq
