"""Inverse MTF on device: tile-blocked permutation-scan decode.

Host behavioral spec: codec/mtf.mtf_rle2_decode (the MTF-list walk of the
reference's intended decoder; the reference bundles this logic inside
bzip2's decompress.c).  The sequential list walk is re-expressed for the
device around one observation: the step "emit list[r], move it to front"
changes the list by a *position-space* permutation p_r that depends only
on the rank r, never on the list contents:

    p_r(0) = r,  p_r(i) = i-1 for 1 <= i <= r,  p_r(i) = i for i > r
    list_{k+1} = list_k (.) p_{r_k}        ((.) = composition)

so a tile of T steps has a net permutation Q_t = p_{r_0} (.) ... (.)
p_{r_{T-1}} computable without knowing the incoming list, and tiles
compose associatively:

  - pass 1 (the only T-step scan, vmapped over all tiles at once):
    accumulate Q per tile; each step is a roll + one-element gather +
    select over a (n_tiles, 256) carry.  The emitted symbol's *position*
    in the tile-start list — front_k = Q^{(k)}[r_k] — falls out of the
    same step for free (it is the gathered front element).
  - pass 2: exclusive scan-compose of tile permutations into per-tile
    start states C_t (n_tiles steps over a (256,) carry).
  - decode: sym[t, k] = alphabet[C_t[front_{t,k}]] — pure gathers.

All shapes static; 256 = 2 lanes of 128.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_TILE = 512


@functools.partial(jax.jit, static_argnames=("n_max",))
def imtf_decode_padded(
    ranks: jax.Array, n: jax.Array, alphabet: jax.Array, n_max: int
) -> jax.Array:
    """Invert MTF ranks to byte values on device.

    Args:
      ranks: int32[n_max] MTF ranks (entries past ``n`` ignored)
      n: int32 scalar, true length
      alphabet: int32[256] initial list contents (dense position ->
        byte value; entries past the alphabet size never referenced by a
        valid stream)
      n_max: static padded size (multiple of the tile size)
    Returns:
      int32[n_max] decoded byte values (valid prefix of length n)
    """
    assert n_max % _TILE == 0
    n_tiles = n_max // _TILE
    pos_g = jnp.arange(n_max, dtype=jnp.int32)
    # rank 0 is the identity step (emit front, list unchanged), so padded
    # slots decode as no-ops; clamp for corruption-safety (CRC catches)
    r_all = jnp.clip(jnp.where(pos_g < n, ranks, 0), 0, 255)
    r_tiles = r_all.reshape(n_tiles, _TILE)

    pos = jnp.arange(256, dtype=jnp.int32)
    q0 = jnp.broadcast_to(pos, (n_tiles, 256)).astype(jnp.int32)

    def step(q, r_k):
        # q: (n_tiles, 256) permutation accumulators; r_k: (n_tiles,)
        front = jnp.take_along_axis(q, r_k[:, None], axis=1)  # Q[r]
        shifted = jnp.roll(q, 1, axis=1)  # shifted[x] = Q[x-1]
        q_new = jnp.where(
            pos[None, :] == 0,
            front,
            jnp.where(pos[None, :] <= r_k[:, None], shifted, q),
        )
        return q_new, front[:, 0]

    q_final, fronts = jax.lax.scan(step, q0, r_tiles.T)  # fronts: (T, n_tiles)

    # exclusive compose across tiles: C_{t+1} = C_t (.) Q_t
    def compose(c, q_t):
        return c[q_t], c

    _, c_pre = jax.lax.scan(compose, pos, q_final)  # (n_tiles, 256)

    # sym[t, k] = alphabet[C_t[front_{t,k}]]
    listpos = jnp.take_along_axis(c_pre, fronts.T, axis=1)  # (n_tiles, T)
    return alphabet[listpos].reshape(n_max).astype(jnp.int32)


def imtf_decode_jax(ranks_np: np.ndarray, in_use: np.ndarray) -> np.ndarray:
    """Host wrapper: MTF ranks + used-byte map -> byte values."""
    seq_syms = np.flatnonzero(in_use).astype(np.int32)
    alphabet = np.zeros(256, dtype=np.int32)
    alphabet[: seq_syms.size] = seq_syms
    n = ranks_np.size
    n_max = ((n + _TILE - 1) // _TILE) * _TILE
    padded = np.zeros(n_max, dtype=np.int32)
    padded[:n] = ranks_np
    out = imtf_decode_padded(
        jnp.asarray(padded), jnp.int32(n), jnp.asarray(alphabet), n_max
    )
    return np.asarray(out)[:n].astype(np.uint8)
