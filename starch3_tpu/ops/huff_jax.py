"""Huffman refinement on device: histogram + group costing as matmuls.

The per-iteration work of bzip2's table refinement (codec/huffman.py) is
dominated by group costing: cost[g, t] = sum_s hist[g, s] * len[t, s].
That is a (G x A) @ (A x T) integer matmul — XLA hands it to the GPU's
matrix path; all operands are exact int32, so no reduced-precision
float mode can change a result — plus an argmin and a selector-grouped
frequency reduction, also expressed as a matmul (onehot(selector).T @
hist).  The code-length construction itself (a
258-node heap) stays on the host: it is O(alphabet log alphabet) per
table and bit-exactness requires bzip2's precise heap discipline.

Shapes are padded: G_max groups, alphabet fixed at 258 (max nInUse+2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

ALPHA_MAX = 258
GROUP_SIZE = 50


@functools.partial(jax.jit, static_argnames=("g_max",))
def group_histograms(symbols: jax.Array, n_mtf: jax.Array, g_max: int) -> jax.Array:
    """hist[g, s] over 50-symbol groups; symbols int32[g_max*GROUP_SIZE]
    padded with ALPHA_MAX-1... padded entries masked by n_mtf."""
    idx = jnp.arange(symbols.size, dtype=jnp.int32)
    valid = idx < n_mtf
    # one-hot accumulate per group: reshape to (G, 50) then sum one-hots
    # (segment one-hots, an integer reduction)
    sym_g = symbols.reshape(g_max, GROUP_SIZE)
    valid_g = valid.reshape(g_max, GROUP_SIZE)
    onehot = jax.nn.one_hot(sym_g, ALPHA_MAX, dtype=jnp.int32) * valid_g[..., None]
    return onehot.sum(axis=1)


@functools.partial(jax.jit, static_argnames=("n_max",))
def group_hist_padded(syms: jax.Array, m: jax.Array, n_max: int) -> jax.Array:
    """hist[g, s] over 50-symbol groups of a padded RLE2 stream.

    Scatter-add formulation: the one-hot matmul (group_histograms above)
    materializes (G, 50, 258) — 24 GB at the 901k geometry — so the
    production path scatters into the flattened (G * 258) table instead.
    Entries at or past ``m`` are masked out.
    """
    g_max = (n_max + 2 + GROUP_SIZE - 1) // GROUP_SIZE
    idx = jnp.arange(n_max + 2, dtype=jnp.int32)
    valid = idx < m
    flat = (idx // GROUP_SIZE) * ALPHA_MAX + jnp.clip(syms, 0, ALPHA_MAX - 1)
    hist = jnp.zeros(g_max * ALPHA_MAX, dtype=jnp.int32)
    hist = hist.at[jnp.where(valid, flat, g_max * ALPHA_MAX)].add(
        1, mode="drop"
    )
    return hist.reshape(g_max, ALPHA_MAX)


@jax.jit
def cost_and_select(hist: jax.Array, lengths: jax.Array, n_groups_mask: jax.Array):
    """One refinement step on device.

    Args:
      hist: int32[G, ALPHA_MAX]
      lengths: int32[6, ALPHA_MAX] (rows >= n_groups padded with large)
      n_groups_mask: bool[6], True for real tables
    Returns:
      selectors int32[G] (first-minimum tie-break, as libbz2),
      rfreq int32[6, ALPHA_MAX] (selector-grouped sums)
    """
    cost = jnp.einsum(
        "ga,ta->gt", hist, lengths, preferred_element_type=jnp.int32
    )
    cost = jnp.where(n_groups_mask[None, :], cost, jnp.int32(1 << 30))
    selectors = jnp.argmin(cost, axis=1).astype(jnp.int32)
    onehot = jax.nn.one_hot(selectors, 6, dtype=jnp.int32)
    rfreq = jnp.einsum(
        "gt,ga->ta", onehot, hist, preferred_element_type=jnp.int32
    )
    return selectors, rfreq
