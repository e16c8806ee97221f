"""One-sort BWT fast path: packed multi-symbol keys + tie detection.

The cost model is blunt: one big `lax.sort` pass costs in proportion to
its rows and operands, everything that moves data randomly (gather,
scatter, searchsorted) costs several sort passes, and each extra jit
dispatch has a fixed floor.  Prefix doubling
(ops/bwt_jax.py) pays 2 sorts per round x O(log n) rounds; on real
Starch-transformed BED text that is wildly pessimistic, because the
text is near-unique at short context lengths.  Measured on the bench
corpus blocks (alphabet of 13 symbols: digits, newline, 'p', '-'):

    context m=14 symbols -> 0.04% of rotations still tied
    context m=24 symbols -> 0 tied (all 24 whole-genome blocks)

So the fast path sorts ALL rotations once, by their first m symbols
packed into 3-4 uint32 keys (m = 24 at 4 bits/symbol, 16 at 8 bits),
carrying the previous symbol as the only payload: when no two rotations
tie on the m-symbol prefix, the sorted payload IS the BWT last column,
and ``orig_ptr`` is a vectorized comparison count.  Blocks with ties
(periodic or highly repetitive inputs) are detected on device and
re-encoded through a proven exact path by the caller (host SA-IS, or
ops/bwt_jax.py prefix doubling) — correctness never rides the heuristic.

Reference behavior spec: the bundled bzip2's blocksort.c:1-1094 (the
reference's third-party tarball) — lexicographic order of all cyclic
rotations.  This file replaces its cache-tuned sequential method with a
single fixed-shape device sort.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# all-ones uint32: padded rows sort to the tail (plain numpy scalar — a
# module-level jnp constant would be a device array created at import)
_BIGU = np.uint32(0xFFFFFFFF)


def _cyclic_shift(seq: jax.Array, k: jax.Array, n: jax.Array, idx: jax.Array):
    """seq[(i + k) mod n] for 0 <= k < n over the valid prefix.

    Two contiguous rolls + a select instead of a random gather
    (ops/bwt_jax.py round_body carries the same note).
    """
    lo = jnp.roll(seq, -k)
    hi = jnp.roll(seq, n - k)
    return jnp.where(idx + k < n, lo, hi)


def key_params(bits: int) -> tuple[int, int]:
    """(n_keys, symbols_per_key) for a packed-prefix sort at ``bits``."""
    if bits == 4:
        return 3, 8  # 24 symbols of context
    if bits == 8:
        return 4, 4  # 16 symbols of context
    raise ValueError("bits must be 4 or 8")


@functools.partial(jax.jit, static_argnames=("n_max", "bits"))
def bwt_sort_fast(seq: jax.Array, n: jax.Array, n_max: int, bits: int = 4):
    """Sort all cyclic rotations by their packed m-symbol prefix.

    Args:
      seq: int32[n_max] dense symbols < 2**bits (entries past ``n`` are
        ignored; they may hold anything)
      n: int32 scalar, true length (1 <= n <= n_max)
      n_max: static padded size
      bits: static bits per symbol (4 when the dense alphabet fits 16
        symbols, else 8)
    Returns:
      last: int32[n_max] candidate BWT last column (dense symbols; valid
        prefix of length n, correct iff ties == 0)
      orig_ptr: int32 scalar, sorted position of rotation 0 (iff ties == 0)
      ties: int32 scalar, number of adjacent sorted rotations whose
        m-symbol prefixes collide (0 = the fast path is exact)
    """
    n_keys, spk = key_params(bits)

    idx = jnp.arange(n_max, dtype=jnp.int32)
    valid = idx < n
    seq = jnp.where(valid, seq, 0)

    def shift(arr, k_static):
        k = jnp.where(k_static >= n, jnp.int32(k_static) % jnp.maximum(n, 1),
                      jnp.int32(k_static))
        return _cyclic_shift(arr, k, n, idx)

    # shift-or doubling ladder: pack 2^j symbols per element in j steps
    # (p[i] <- p[i] << w | p[(i + 2^{j-1}) mod n]), then the later keys
    # are single cyclic shifts of the first — 5 cyclic shifts total
    # instead of one per symbol (24).  Key bytes are identical to the
    # per-symbol construction: MSB-first consecutive symbols.
    acc = seq.astype(jnp.uint32)
    w = bits
    while w * 2 <= spk * bits:
        acc = (acc << w) | shift(acc, w // bits).astype(jnp.uint32)
        w *= 2
    keys = [jnp.where(valid, acc, _BIGU)]
    for j in range(1, n_keys):
        keys.append(
            jnp.where(valid, shift(acc, j * spk).astype(jnp.uint32), _BIGU)
        )

    # previous symbol seq[(i - 1) mod n]: the BWT last-column payload
    nm1 = jnp.maximum(n - 1, 0)
    bp = _cyclic_shift(seq, nm1, n, idx)

    sorted_ops = jax.lax.sort((*keys, bp), num_keys=n_keys, is_stable=False)
    last = sorted_ops[-1]

    # adjacent prefix collisions among the valid prefix
    eq = jnp.ones(n_max - 1, dtype=bool)
    for ks in sorted_ops[:n_keys]:
        eq = eq & (ks[1:] == ks[:-1])
    eq = eq & (jnp.arange(n_max - 1, dtype=jnp.int32) < n - 1)
    ties = eq.sum().astype(jnp.int32)

    # orig_ptr as a comparison count: rotations strictly below rotation 0
    # in the packed-prefix order (exact when ties == 0; tie blocks are
    # discarded by the caller, so no claim is made there)
    lt = jnp.zeros(n_max, dtype=bool)
    ge = jnp.ones(n_max, dtype=bool)  # "equal so far" running flag
    for kk in keys:
        k0 = kk[0]
        lt = lt | (ge & (kk < k0))
        ge = ge & (kk == k0)
    orig_ptr = jnp.sum(lt & valid).astype(jnp.int32)
    return last, orig_ptr, ties


@functools.partial(jax.jit, static_argnames=("n_max",))
def bwt_sort_fast3(seq: jax.Array, n: jax.Array, n_max: int):
    """bits==4 one-sort BWT with THREE sort operands instead of four.

    The previous-symbol payload (4 bits) rides in key3's low nibble, so
    the packed prefix covers 23 symbols of context (8 + 8 + 7) and the
    sort moves 25% fewer bytes, with 0 ties across the whole bench
    corpus at >= 20 symbols of context.  Tie detection
    and the origin-pointer comparison mask the payload nibble out, so
    the correctness contract is identical to bwt_sort_fast: a tied
    block re-encodes exactly elsewhere.

    Args/returns: as bwt_sort_fast with bits=4 (seq values < 16).
    """
    idx = jnp.arange(n_max, dtype=jnp.int32)
    valid = idx < n
    seq = jnp.where(valid, seq, 0)

    def shift(arr, k_static):
        k = jnp.where(k_static >= n, jnp.int32(k_static) % jnp.maximum(n, 1),
                      jnp.int32(k_static))
        return _cyclic_shift(arr, k, n, idx)

    # shift-or doubling ladder: 8 symbols per uint32 in 3 doubling steps
    acc = seq.astype(jnp.uint32)
    w = 4
    while w * 2 <= 32:
        acc = (acc << w) | shift(acc, w // 4).astype(jnp.uint32)
        w *= 2
    nm1 = jnp.maximum(n - 1, 0)
    prev = _cyclic_shift(seq, nm1, n, idx).astype(jnp.uint32)
    key1 = jnp.where(valid, acc, _BIGU)
    key2 = jnp.where(valid, shift(acc, 8).astype(jnp.uint32), _BIGU)
    key3 = jnp.where(
        valid,
        (shift(acc, 16).astype(jnp.uint32) & jnp.uint32(0xFFFFFFF0)) | prev,
        _BIGU,
    )

    k1s, k2s, k3s = jax.lax.sort((key1, key2, key3), num_keys=3, is_stable=False)
    last = (k3s & 0xF).astype(jnp.int32)

    ar = jnp.arange(n_max - 1, dtype=jnp.int32)
    eq = (
        (k1s[1:] == k1s[:-1])
        & (k2s[1:] == k2s[:-1])
        & ((k3s[1:] >> 4) == (k3s[:-1] >> 4))
        & (ar < n - 1)
    )
    ties = eq.sum().astype(jnp.int32)

    c1, c2, c3 = key1[0], key2[0], key3[0] >> 4
    k3c = key3 >> 4
    lt = (key1 < c1) | ((key1 == c1) & ((key2 < c2) | ((key2 == c2) & (k3c < c3))))
    orig_ptr = jnp.sum(lt & valid).astype(jnp.int32)
    return last, orig_ptr, ties


@functools.partial(jax.jit, static_argnames=("n_max", "bits"))
def bwt_sort_fast_mid(seq: jax.Array, n: jax.Array, n_max: int, bits: int):
    """One-sort BWT for mid-width dense alphabets (17..64 symbols).

    bits==5 (alphabet <= 32): keys pack 6 symbols per uint32 (30 bits);
    4 sort operands give 23 symbols of context with the previous-symbol
    payload riding in the last key's low 5 bits (6+6+6+5 symbols).
    bits==6 (alphabet <= 64): 5 symbols per key; 5 operands give 24
    symbols of context (5+5+5+5+4) with a 6-bit payload.

    The context lengths are measured, not guessed: on the config-3
    bench corpus (transformed BED with id/score/strand remainders — a
    21-symbol alphabet) 16 symbols of context tie ~470 times per 650 kB
    block and 19 symbols ~25 times, while 23 symbols tie zero times
    (bench.py wide-corpus detail) — so the bits==8 tier's 16-symbol
    context would demote essentially every block to the host, and this
    tier is what makes mixed numeric+text blocks device-viable at all.

    Same contract as bwt_sort_fast3: returns (last, orig_ptr, ties);
    tie detection and the origin-pointer count mask the payload bits, and
    a tied block re-encodes exactly elsewhere.
    """
    if bits == 5:
        spk, n_ctx_keys = 6, 3
    elif bits == 6:
        spk, n_ctx_keys = 5, 4
    else:
        raise ValueError("bits must be 5 or 6")

    idx = jnp.arange(n_max, dtype=jnp.int32)
    valid = idx < n
    seq = jnp.where(valid, seq, 0)

    def shift(arr, k_static):
        k = jnp.where(k_static >= n, jnp.int32(k_static) % jnp.maximum(n, 1),
                      jnp.int32(k_static))
        return _cyclic_shift(arr, k, n, idx)

    # doubling accumulators: a_c[i] packs c consecutive symbols MSB-first
    a1 = seq.astype(jnp.uint32)
    a2 = (a1 << bits) | shift(a1, 1).astype(jnp.uint32)
    a4 = (a2 << (2 * bits)) | shift(a2, 2).astype(jnp.uint32)
    acc = {1: a1, 2: a2, 4: a4}

    def word(p, k):
        """Pack symbols seq[(i+p) .. (i+p+k)) (cyclic) MSB-first."""
        out = None
        for c in (4, 2, 1):
            while k >= c:
                part = acc[c] if p == 0 else shift(acc[c], p).astype(jnp.uint32)
                out = part if out is None else (out << (c * bits)) | part
                p += c
                k -= c
        return out

    nm1 = jnp.maximum(n - 1, 0)
    prev = _cyclic_shift(seq, nm1, n, idx).astype(jnp.uint32)

    # valid keys stay < 2^30 <= _BIGU, so padded rows sort to the tail
    keys = [
        jnp.where(valid, word(j * spk, spk), _BIGU) for j in range(n_ctx_keys)
    ]
    tail = (word(n_ctx_keys * spk, spk - 1) << bits) | prev
    keys.append(jnp.where(valid, tail, _BIGU))

    sorted_ops = jax.lax.sort(tuple(keys), num_keys=len(keys), is_stable=False)
    last = (sorted_ops[-1] & ((1 << bits) - 1)).astype(jnp.int32)

    ar = jnp.arange(n_max - 1, dtype=jnp.int32)
    eq = ar < n - 1
    for ks in sorted_ops[:-1]:
        eq = eq & (ks[1:] == ks[:-1])
    kt = sorted_ops[-1] >> bits
    eq = eq & (kt[1:] == kt[:-1])
    ties = eq.sum().astype(jnp.int32)

    cmp_keys = keys[:-1] + [keys[-1] >> bits]
    lt = jnp.zeros(n_max, dtype=bool)
    ge = jnp.ones(n_max, dtype=bool)
    for kk in cmp_keys:
        k0 = kk[0]
        lt = lt | (ge & (kk < k0))
        ge = ge & (kk == k0)
    orig_ptr = jnp.sum(lt & valid).astype(jnp.int32)
    return last, orig_ptr, ties


def bwt_fast_host(block_np: np.ndarray):
    """Host-convenience wrapper over raw bytes (tests): dense-remaps,
    picks the bit width, returns (last bytes, orig_ptr, ties)."""
    n = int(block_np.size)
    used = np.zeros(256, dtype=bool)
    used[np.unique(block_np)] = True
    u2s = np.cumsum(used) - 1
    seq = u2s[block_np].astype(np.int32)
    n_sym = int(used.sum())
    bits = 4 if n_sym <= 16 else 8
    n_max = max(128, 1 << (n - 1).bit_length())
    padded = np.zeros(n_max, dtype=np.int32)
    padded[:n] = seq
    last, ptr, ties = bwt_sort_fast(jnp.asarray(padded), jnp.int32(n), n_max, bits)
    s2u = np.flatnonzero(used).astype(np.uint8)
    return s2u[np.asarray(last)[:n]], int(ptr), int(ties)
