"""BWT rotation sort on device: prefix doubling over XLA sorts.

The reference's block sorter (bundled bzip2's blocksort.c, ~1100 lines of
cache-tuned sequential C) defines the required *behavior*: lexicographic
order of all cyclic rotations, with equal rotations left in decreasing
start-index order (codec/bwt.py documents the tie-break evidence).  The
device method is entirely different: prefix doubling — each round
sorts (rank_i, rank_{i+k mod n}) pairs with a fixed-shape two-key XLA
sort and densely reranks, doubling k until all ranks are distinct.  For a
900 kB block that is <= 20 rounds of n*log(n) device sort, all fixed
shapes, batched across blocks with vmap/pjit.

Padded formulation: arrays are padded to ``n_max``; padded slots carry
+inf-like keys so they sort to the tail and never mix with real ranks;
the true length ``n`` is a scalar operand (no dynamic shapes under jit).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# plain numpy scalar: a module-level jnp constant would be a device
# array created at import
_BIG = np.int32(0x7FFFFFF0)


def _unscatter(order: jax.Array, values: jax.Array) -> jax.Array:
    """``out[order[i]] = values[i]`` for a permutation ``order``.

    Expressed as a sort keyed on ``order`` instead of a random scatter,
    which can cost more than a full sort pass; whether it does on the
    GPU is not measured yet.
    """
    _, out = jax.lax.sort((order, values), num_keys=1, is_stable=False)
    return out


@functools.partial(jax.jit, static_argnames=("n_max", "init_bytes"))
def bwt_encode_padded(
    block: jax.Array, n: jax.Array, n_max: int, init_bytes: int = 1
):
    """Rotation-sort a padded block.

    Args:
      block: uint8[n_max] (contents beyond ``n`` ignored)
      n: int32 scalar, actual length (1 <= n <= n_max)
      n_max: static padded size
      init_bytes: 1 or 3 — bytes packed into the round-0 key.  3 folds
        ~1.6 doubling rounds into the initial rerank (the key stays a
        positive int32), at a larger one-time compile — a win wherever
        compiles amortize.
    Returns:
      last: uint8[n_max] BWT last column (valid prefix of length n)
      orig_ptr: int32 scalar, sorted position of rotation 0
    """
    if init_bytes not in (1, 3):
        raise ValueError("init_bytes must be 1 or 3")
    idx = jnp.arange(n_max, dtype=jnp.int32)
    valid = idx < n

    if init_bytes == 3:
        # cyclic 3-byte big-endian key: block[i]<<16|block[i+1]<<8|block[i+2]
        # — neighbor reads are cyclic shifts, expressed as rolls + select
        # (see round_body for why rolls beat gathers here)
        b32 = block.astype(jnp.int32)

        def _cyclic(shift):
            kk = jnp.where(shift >= n, shift - n, shift)
            kk = jnp.where(kk >= n, kk - n, kk)
            lo = jnp.roll(b32, -kk)
            hi = jnp.roll(b32, n - kk)
            return jnp.where(idx + kk < n, lo, hi)

        key = (
            (b32 << 16)
            | (jnp.where(valid, _cyclic(jnp.int32(1)), 0) << 8)
            | jnp.where(valid, _cyclic(jnp.int32(2)), 0)
        )
        raw = jnp.where(valid, key, _BIG + 1)
        # densify so ranks stay small ints, then the loop starts at k=3
        rs, order = jax.lax.sort((raw, idx), num_keys=1, is_stable=True)
        changed = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), (rs[1:] != rs[:-1]).astype(jnp.int32)]
        )
        dense = jnp.cumsum(changed)
        rank = _unscatter(order, dense)
        rank = jnp.where(valid, rank, _BIG + 1)
        k0 = jnp.int32(3)
        done0 = jnp.max(jnp.where(valid, rank, -1)) == n - 1
    else:
        # raw byte values (order-preserving; densified by round 1)
        rank = jnp.where(valid, block.astype(jnp.int32), _BIG + 1)
        k0 = jnp.int32(1)
        done0 = jnp.asarray(False)

    def round_body(state):
        rank, k, _done = state
        # rank[(idx + k) mod n] is a cyclic shift, not a random gather:
        # express it as two contiguous rolls + select instead of a random
        # gather.  The loop cond keeps k < 2n, so one
        # conditional subtract normalizes the shift below n.
        kk = jnp.where(k >= n, k - n, k)
        rolled_lo = jnp.roll(rank, -kk)      # rank[idx + kk]   (idx+kk < n)
        rolled_hi = jnp.roll(rank, n - kk)   # rank[idx + kk - n] (wrapped)
        rank2 = jnp.where(
            valid,
            jnp.where(idx + kk < n, rolled_lo, rolled_hi),
            _BIG + 1,
        )
        r1s, r2s, order = jax.lax.sort(
            (rank, rank2, idx), num_keys=2, is_stable=True
        )
        changed = jnp.concatenate(
            [
                jnp.zeros((1,), jnp.int32),
                ((r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1])).astype(jnp.int32),
            ]
        )
        new_rank_sorted = jnp.cumsum(changed)
        new_rank = _unscatter(order, new_rank_sorted)
        new_rank = jnp.where(valid, new_rank, _BIG + 1)
        # distinct when the max valid rank equals n-1
        done = jnp.max(jnp.where(valid, new_rank, -1)) == n - 1
        return new_rank, k * 2, done

    def cond(state):
        _rank, k, done = state
        return jnp.logical_and(jnp.logical_not(done), k < 2 * n)

    rank, _, _ = jax.lax.while_loop(cond, round_body, (rank, k0, done0))
    # final order: rank ascending, ties (equal rotations) by index
    # descending — the libbz2-observed order (codec/bwt.py)
    _, _, sa = jax.lax.sort((rank, -idx, idx), num_keys=2, is_stable=False)
    prev = jnp.where(sa > 0, sa - 1, n - 1)
    last = block[prev]
    orig_ptr = jnp.argmax(sa == 0).astype(jnp.int32)
    return last, orig_ptr


def bwt_encode_jax(block_np: np.ndarray, n_max: int | None = None):
    """Host-convenience wrapper mirroring codec.bwt.bwt_encode."""
    n = int(block_np.size)
    if n_max is None:
        n_max = n
    padded = np.zeros(n_max, dtype=np.uint8)
    padded[:n] = block_np
    last, ptr = bwt_encode_padded(jnp.asarray(padded), jnp.int32(n), n_max)
    return np.asarray(last)[:n], int(ptr)
