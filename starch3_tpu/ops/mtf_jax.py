"""MTF ranks on device: a parallel last-occurrence formulation.

Same math as codec/mtf.py (derived there): the MTF rank of the symbol at
position i is the number of symbols whose most recent occurrence before
i is later than the current symbol's, with never-seen symbols ordered by
their initial list position through L0(t) = -1 - t.

The last-occurrence table is a cumulative max over one-hot position
matrices, taken in two levels so that no step is sequential in n:

  1. each row is reshaped to (tiles, TILE, width) and scanned inside
     every tile (a log-depth associative scan);
  2. each tile's maximum feeds an exclusive scan across tiles, seeded
     with L0 — the carry into every tile;
  3. last[i] = max(in-tile exclusive scan, carry of i's tile).

``width`` bounds the dense alphabet (16/32/64 for the narrow tiers, 256
for arbitrary bytes), so the work is O(n * width) elementwise integer
ops with no trip count that grows with n.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

TILE = 1024
WIDTHS = (16, 32, 64, 256)
# plain numpy scalar: a module-level jnp constant would be a device array
# created at import time
_NEG = np.int32(-(1 << 30))


def _cummax(x: jax.Array, axis: int) -> jax.Array:
    return jax.lax.associative_scan(jnp.maximum, x, axis=axis)


@functools.partial(jax.jit, static_argnames=("n_max", "width"))
def mtf_ranks(
    seqs: jax.Array, lens: jax.Array, n_max: int, width: int
) -> jax.Array:
    """Batched MTF ranks over dense-alphabet sequences.

    Args:
      seqs: int[B, n_max] symbols in [0, width) (entries past each row's
        length are ignored; padding is a suffix, so it never disturbs a
        valid position)
      lens: int32[B] true row lengths
      n_max: static padded row length
      width: static alphabet bound, one of ``WIDTHS``
    Returns:
      int32[B, n_max] ranks, zero past each row's length
    """
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}, got {width}")
    b = seqs.shape[0]
    n_tiles = -(-n_max // TILE)
    n_pad = n_tiles * TILE
    x = seqs.astype(jnp.int32)
    if n_pad != n_max:
        x = jnp.pad(x, ((0, 0), (0, n_pad - n_max)))
    x = x.reshape(b, n_tiles, TILE)
    sym = jnp.arange(width, dtype=jnp.int32)
    pos = jnp.arange(n_pad, dtype=jnp.int32).reshape(n_tiles, TILE)
    onehot = x[..., None] == sym
    occ = jnp.where(onehot, pos[None, :, :, None], _NEG)
    inc = _cummax(occ, axis=2)  # last occurrence at or before i, in-tile
    # carry into each tile: L0 folded with every earlier tile's maximum
    tile_max = _cummax(inc[:, :, -1, :], axis=1)
    carry = jnp.concatenate(
        [jnp.full((b, 1, width), _NEG, jnp.int32), tile_max[:, :-1]], axis=1
    )
    carry = jnp.maximum(carry, -1 - sym)
    excl = jnp.concatenate(
        [jnp.full((b, n_tiles, 1, width), _NEG, jnp.int32), inc[:, :, :-1]],
        axis=2,
    )
    last = jnp.maximum(excl, carry[:, :, None, :])
    own = jnp.max(jnp.where(onehot, last, _NEG), axis=-1)
    ranks = jnp.sum(last > own[..., None], axis=-1, dtype=jnp.int32)
    ranks = ranks.reshape(b, n_pad)[:, :n_max]
    idx = jnp.arange(n_max, dtype=jnp.int32)
    return jnp.where(idx[None, :] < lens[:, None], ranks, 0)
