"""Device-side (JAX/XLA) kernels for the codec's hot stages.

Stage-to-device mapping (SURVEY.md §7 step 4):

  - ``bwt_fast``: the production BWT — one multi-operand XLA sort over
    packed prefix keys, with on-device tie detection.
  - ``bwt_jax``: BWT rotation sort as prefix doubling over XLA sorts —
    O(log n) rounds of fixed-shape multi-key sorts, the exact device
    replacement for the reference's sequential blocksort.c.
  - ``mtf_jax``: MTF ranks as a two-level parallel cummax over one-hot
    position tiles — the parallel reformulation of the inherently
    sequential move-to-front list.
  - ``huff_jax``: Huffman group costing as (groups x alphabet) histogram
    times (alphabet x tables) length matrices (integer matmuls).
  - ``transform_jax``: the delta transform's numeric core (diffs +
    associative scan) and fixed-width decimal text emission.

All kernels are fixed-shape (padded + masked) so XLA compiles them once
per block geometry; actual lengths travel as scalar operands.
"""
