"""Device-side Starch delta transform: numeric core + decimal sizing.

The encode direction is pure element-wise work (the reference's sequential
last_stop/last_coord_diff carries, starch3api.hpp:428-504, are just
shift-by-one reads in columnar form); the decode direction needs a real
prefix scan (stop_i = cumsum(delta_i + diff_i)) — both map directly onto
the VPU.  Decimal *lengths* are computed on device (fixed-bound threshold
sums) so the host only does final byte scatter; see transform/delta.py for
the host text assembly these feed.

DESIGN DECISION: the PRODUCTION encode transform stays on the host.  The transform is dominated by byte-granular work —
tokenizing "chr1\\t123\\t456" lines and emitting decimal text — which the
fused native parser does at ~190 MB/s on one core; the only
device-suited part (the integer subtractions) is a negligible slice.
Shipping raw text to the device to save the subtraction would ADD a
round trip on the path's scarcest resource (upload/download bandwidth)
and still leave tokenization and emission on the host.  These kernels
are therefore the *scan formulation* of the transform: they validate
the associative-scan decode math (tests/test_jax_ops.py), run under the
multi-chip dryrun, and stand ready for a hypothetical columnar-input
ingestion path (e.g. Parquet/Arrow coordinates already on device) where
the byte-granular argument inverts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dec_len_device(vals: jax.Array) -> jax.Array:
    """Decimal text length (sign included), element-wise.

    Thresholds stay within the input dtype's range (int32 coordinates
    cover the human genome; int64 works when jax_enable_x64 is on).
    """
    neg = (vals < 0).astype(vals.dtype)
    mag = jnp.abs(vals)
    max_digits = 19 if vals.dtype == jnp.int64 else 10
    ndig = jnp.ones_like(vals)
    for k in range(1, max_digits):
        ndig = ndig + (mag >= 10**k).astype(vals.dtype)
    return ndig + neg


@jax.jit
def transform_core(starts: jax.Array, stops: jax.Array):
    """Columnar encode core: (starts, stops) int64[n] ->
    (p_mask bool[n], coord_diff int64[n], deltas int64[n],
     p_lens int64[n], d_digit_lens int64[n], nonunique int64).
    """
    coord_diff = stops - starts
    prev_diff = jnp.concatenate([jnp.zeros((1,), coord_diff.dtype), coord_diff[:-1]])
    p_mask = coord_diff != prev_diff
    last_stop = jnp.concatenate([jnp.zeros((1,), stops.dtype), stops[:-1]])
    absolute = last_stop == 0
    deltas = jnp.where(absolute, starts, starts - last_stop)
    p_lens = jnp.where(p_mask, 2 + dec_len_device(coord_diff), 0)
    d_digit_lens = dec_len_device(deltas)
    return p_mask, coord_diff, deltas, p_lens, d_digit_lens, coord_diff.sum()


@jax.jit
def untransform_core(deltas: jax.Array, diffs: jax.Array):
    """Decode core: per-record (delta, filled diff) -> (starts, stops).

    stop_i = scan(+)(delta_i + diff_i); start_i = stop_i - diff_i.
    The scan is associative -> parallel prefix on device.
    """
    stops = jnp.cumsum(deltas + diffs)
    starts = stops - diffs
    return starts, stops


@jax.jit
def union_length_device(starts: jax.Array, stops: jax.Array) -> jax.Array:
    """Unique base count: union length of start-sorted half-open intervals
    via cummax of stops (the statistic the reference never computes,
    starch3api.hpp:61-62)."""
    running = jnp.concatenate(
        [starts[:1], jax.lax.cummax(stops, axis=0)[:-1]]
    )
    return jnp.maximum(stops - jnp.maximum(starts, running), 0).sum()
