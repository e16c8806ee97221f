"""Sharded block-encode pipeline: host segmentation -> device kernels ->
host bit assembly, with spare CPU cores stealing blocks.

Per-stream flow (the data-parallel rebuild of the reference's 4-thread
pipeline, SURVEY.md §2 parallelism table), production ("fast") mode for
the <=16-symbol alphabet transformed BED always has:

  host:    RLE1 segmentation into <= 900 kB blocks (sequential by
           nature, codec/rle1.py) + one native pass per block doing the
           dense remap AND the 2-symbols-per-byte upload pack
           (runtime.cpp s3_dense_pack4)
  device:  3-operand one-sort BWT (23 symbols of packed prefix context,
           payload in key3's low nibble, ops/bwt_fast.bwt_sort_fast3)
           -> width-16 MTF (ops/mtf_jax.mtf_ranks), one dispatch per
           batch, batch axis shard_map'd over the device mesh; the
           download is the nibble-packed MTF ranks (4 bits per input
           byte)
  host:    native RLE2 + Huffman refinement + bit emission per block
           (runtime.cpp s3_rle2_from_ranks + s3_encode_tail, GIL
           released, tail pool) and stream concatenation in block order
           (deterministic: partitioning is input-derived, never
           topology-derived)

Blocks are classified by alphabet size individually at feed time and
batched per class (one wide block never demotes its batch-mates):
17..64 distinct bytes take the mid-width tier (payload-in-key one-sort
BWT + width-32/64 MTF + 5/6-bit-packed rank download,
_jitted_fused_step_ranks_mid — the BASELINE config-3 remainder-column
path), and only >64 distinct bytes pay the generic bits==8 variant
(width-256 MTF + device RLE2, 16-bit symbol download).

With ``device_huffman`` the Huffman group costing (integer matmuls) and
coded-data bit packing also run on device (4 cost/select rounds
interleaved with host length heaps); the download shrinks to ~compressed
size — the right trade when devices outnumber host cores.

The device steps are compiled once per (n_max, bits) geometry bucket;
blocks are padded to fixed shapes, lengths travel as scalars.  Blocks
whose packed-prefix sort ties (detected on device) re-encode on the
host — output bytes never depend on the path taken.
"""

from __future__ import annotations

import functools
import time

import numpy as np

from starch3_tpu.codec.bitio import BitWriter
from starch3_tpu.codec.crc32 import combine_block_crc
from starch3_tpu.codec.encoder import (
    STREAM_END_MAGIC,
    write_block_from_device_syms,
    write_block_from_ranks,
)
from starch3_tpu.codec.rle1 import rle1_split_blocks

# padded device block size: fits any level-9 block (nblockMAX 899_981 + 4
# overshoot), multiple of the MTF tile (512)
N_MAX_BLOCK = 901_120


def _shard_step(step, mesh, n_in: int, n_out: int):
    """Wrap a batch-leading device step in shard_map over the block
    mesh: inputs/outputs all shard on their leading (batch) axis.  Inside
    shard_map every array is the device-local shard, so each device runs
    the whole step on its own blocks and XLA inserts no collectives
    (blocks never exchange state)."""
    if mesh is None:
        return step
    import jax
    from jax.sharding import PartitionSpec as P

    from starch3_tpu.parallel.mesh import BLOCK_AXIS

    spec = P(BLOCK_AXIS)
    return jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(spec,) * n_in,
        out_specs=spec if n_out == 1 else (spec,) * n_out,
        # no collectives anywhere in the codec steps (blocks never
        # exchange state), so the varying-axis type audit adds nothing
        check_vma=False,
    )


def _bwt_remap(block, n, n_max):
    """Device prologue per block: BWT -> used-byte map -> dense remap."""
    import jax.numpy as jnp

    from starch3_tpu.ops.bwt_jax import bwt_encode_padded

    last, ptr = bwt_encode_padded(block, n, n_max)
    idx = jnp.arange(n_max, dtype=jnp.int32)
    valid = idx < n
    used = jnp.zeros(256, jnp.int32).at[jnp.where(valid, last, 0)].max(
        valid.astype(jnp.int32)
    )
    u2s = jnp.cumsum(used) - 1  # dense remap (codec/mtf.py symbol_map)
    seq = jnp.where(valid, u2s[last], 0).astype(jnp.int32)
    return ptr, used, seq


@functools.lru_cache(maxsize=8)
def _jitted_fused_step(n_max: int, mesh=None):
    """BWT -> on-device dense symbol remap -> MTF, one dispatch per batch.

    Fusing keeps the 900 kB intermediate (BWT last column) in device
    memory instead of round-tripping it to the host between stages.
    """
    import jax
    import jax.numpy as jnp

    from starch3_tpu.ops.mtf_jax import mtf_ranks

    def pack_one(ptr, used, ranks):
        # MTF ranks are < 256: pack 4 per int32 so the host download is
        # 1 byte/rank (the BWT column itself never leaves the device)
        r4 = ranks.reshape(n_max // 4, 4).astype(jnp.uint32)
        packed = jax.lax.bitcast_convert_type(
            r4[:, 0] | (r4[:, 1] << 8) | (r4[:, 2] << 16) | (r4[:, 3] << 24),
            jnp.int32,
        )
        # single output array per block -> single host transfer per batch:
        # [orig_ptr, in_use[256], packed_ranks[n_max//4]]
        return jnp.concatenate([ptr[None], used, packed])

    def step(blocks, lens):
        ptrs, useds, seqs = jax.vmap(
            lambda b, n: _bwt_remap(b, n, n_max)
        )(blocks, lens)
        ranks = mtf_ranks(seqs, lens, n_max, 256)
        return jax.vmap(pack_one)(ptrs, useds, ranks)

    return jax.jit(_shard_step(step, mesh, 2, 1))


# The generic fast path runs as TWO chained jitted programs (BWT+MTF,
# then RLE2+pack) rather than one, so that each compiles on its own
# (the fused program's compile time is far larger); the split costs one
# extra dispatch per batch and keeps the ranks intermediate on device.


@functools.lru_cache(maxsize=8)
def _jitted_bwt_mtf_fast(n_max: int, bits: int, mesh=None):
    """One-sort BWT (ops/bwt_fast.py) -> MTF ranks.

    Rotations are sorted once by a packed multi-symbol prefix key
    instead of O(log n) doubling rounds; the per-block ``ties`` scalar
    lets the host re-encode the rare ambiguous blocks exactly.  Inputs
    are host-side dense-remapped symbols so the key pack width
    (``bits``) is static; with bits==4 they arrive 2 per byte.
    """
    import jax
    import jax.numpy as jnp

    from starch3_tpu.ops.bwt_fast import bwt_sort_fast
    from starch3_tpu.ops.mtf_jax import mtf_ranks

    def step(seqs, lens):
        if bits == 4:
            # inputs arrive 2 symbols per byte (see _dispatch_chunk)
            lo = (seqs & 0xF).astype(jnp.int32)
            hi = (seqs >> 4).astype(jnp.int32)
            seqs = jnp.stack([lo, hi], axis=-1).reshape(seqs.shape[0], n_max)
        lasts, ptrs, ties = jax.vmap(
            lambda s, n: bwt_sort_fast(s.astype(jnp.int32), n, n_max, bits)
        )(seqs, lens)
        # bits==4 implies a dense alphabet <= 16
        ranks = mtf_ranks(lasts, lens, n_max, 16 if bits == 4 else 256)
        return ptrs, ties, ranks

    return jax.jit(_shard_step(step, mesh, 2, 3))


@functools.lru_cache(maxsize=8)
def _jitted_fused_step_ranks4(n_max: int, mesh=None):
    """The bits==4 production step: 3-operand one-sort BWT (payload in
    key3's low nibble, ops/bwt_fast.bwt_sort_fast3) -> width-16 MTF
    (ops/mtf_jax.mtf_ranks) -> nibble-packed rank download.  RLE2 runs
    in the host tail (runtime.cpp s3_rle2_from_ranks, a single native
    pass off the critical path).  Download is 4 bits/input byte.

    Row format: [orig_ptr, ties, packed_ranks[n_max // 8]] int32.
    """
    import jax
    import jax.numpy as jnp

    from starch3_tpu.ops.bwt_fast import bwt_sort_fast3
    from starch3_tpu.ops.mtf_jax import mtf_ranks

    def step(seqs_packed, lens):
        b = seqs_packed.shape[0]
        lo = (seqs_packed & 0xF).astype(jnp.int32)
        hi = (seqs_packed >> 4).astype(jnp.int32)
        seqs = jnp.stack([lo, hi], axis=-1).reshape(b, n_max)
        lasts, ptrs, ties = jax.vmap(
            lambda s, n: bwt_sort_fast3(s, n, n_max)
        )(seqs, lens)
        # ranks are zero past each row's length, so nothing leaks into
        # neighbouring nibbles of the packed download
        ranks = mtf_ranks(lasts, lens, n_max, 16)
        r8 = ranks.reshape(b, n_max // 8, 8).astype(jnp.uint32)
        word = r8[..., 0]
        for k in range(1, 8):
            word = word | (r8[..., k] << (4 * k))
        packed = jax.lax.bitcast_convert_type(word, jnp.int32)
        return jnp.concatenate([ptrs[:, None], ties[:, None], packed], axis=1)

    return jax.jit(_shard_step(step, mesh, 2, 1))


@functools.lru_cache(maxsize=8)
def _jitted_fused_step_ranks_mid(n_max: int, bits: int, mesh=None):
    """The bits==5/6 mid-width production step (17..64-symbol dense
    alphabets, e.g. BED with id/score/strand remainder columns —
    BASELINE config 3; reference remainder passthrough
    starch3api.hpp:456-478): word-packed upload (30//bits symbols per
    uint32 word) -> one-sort BWT with the payload riding in the last
    key (ops/bwt_fast.bwt_sort_fast_mid, 23-24 symbols of context) ->
    width-32/64 MTF (ops/mtf_jax.mtf_ranks) -> bit-packed rank download
    (30//bits ranks per int32 word, i.e. 5-6 bits per input byte); RLE2
    + Huffman run in the native host tail exactly as in the bits==4 step.

    Row format: [orig_ptr, ties, packed_ranks[n_words]] int32.
    """
    import jax
    import jax.numpy as jnp

    from starch3_tpu.ops.bwt_fast import bwt_sort_fast_mid
    from starch3_tpu.ops.mtf_jax import mtf_ranks

    spw = 30 // bits  # symbols (and downloaded ranks) per uint32 word
    mask = (1 << bits) - 1
    n_words = (n_max + spw - 1) // spw
    width = 32 if bits == 5 else 64

    def step(words, lens):
        b = words.shape[0]
        w = jax.lax.bitcast_convert_type(words, jnp.uint32)
        syms = jnp.stack(
            [((w >> (bits * k)) & mask).astype(jnp.int32) for k in range(spw)],
            axis=-1,
        ).reshape(b, n_words * spw)[:, :n_max]
        lasts, ptrs, ties = jax.vmap(
            lambda s, n: bwt_sort_fast_mid(s, n, n_max, bits)
        )(syms, lens)
        # ranks are zero past each row's length, so nothing leaks into
        # neighbouring fields of the packed download
        ranks = mtf_ranks(lasts, lens, n_max, width)
        rp = jnp.concatenate(
            [ranks, jnp.zeros((b, n_words * spw - n_max), jnp.int32)], axis=1
        ).reshape(b, n_words, spw).astype(jnp.uint32)
        word = rp[..., 0]
        for k in range(1, spw):
            word = word | (rp[..., k] << (bits * k))
        packed = jax.lax.bitcast_convert_type(word, jnp.int32)
        return jnp.concatenate([ptrs[:, None], ties[:, None], packed], axis=1)

    return jax.jit(_shard_step(step, mesh, 2, 1))


@functools.lru_cache(maxsize=8)
def _jitted_rle2_pack(n_max: int, bits: int, mesh=None):
    """RLE2 + download packing over the BWT+MTF program's outputs.

    With a 4-bit alphabet every RLE2 symbol is <= n_in_use + 1 <= 17
    < 32, so 6 symbols fit a 5-bit-packed int32 word — 3x less transfer
    than the generic 2x16-bit pack.
    """
    import jax
    import jax.numpy as jnp

    from starch3_tpu.ops.rle2_jax import rle2_from_ranks_padded

    spw = 6 if bits == 4 else 2  # symbols per word
    sb = 5 if bits == 4 else 16  # bits per symbol
    n_words = (n_max + 2 + spw - 1) // spw

    def tail_one(ptr, ties, ranks, n, n_sym):
        syms, m, freq = rle2_from_ranks_padded(ranks, n, n_sym, n_max)
        sp = jnp.concatenate(
            [syms, jnp.zeros(n_words * spw - syms.size, jnp.int32)]
        )
        sp = sp.reshape(n_words, spw)
        packed = sp[:, 0]
        for k in range(1, spw):
            packed = packed | (sp[:, k] << (sb * k))
        return jnp.concatenate(
            [ptr[None], m[None], ties[None], freq, packed]
        )

    def step(ptrs, ties, ranks, lens, nsyms):
        return jax.vmap(tail_one)(ptrs, ties, ranks, lens, nsyms)

    return jax.jit(_shard_step(step, mesh, 5, 1))


def _jitted_fused_step_fast(n_max: int, bits: int, mesh=None):
    """The production fast step as the two chained programs above."""
    step_a = _jitted_bwt_mtf_fast(n_max, bits, mesh)
    step_b = _jitted_rle2_pack(n_max, bits, mesh)

    def step(seqs, lens, nsyms):
        ptrs, ties, ranks = step_a(seqs, lens)
        return step_b(ptrs, ties, ranks, lens, nsyms)

    return step


@functools.lru_cache(maxsize=8)
def _jitted_rle2_raw(n_max: int, mesh=None):
    """RLE2 for the device-Huffman tail: the symbol stream STAYS on
    device; only [ptr, m, ties] + freq go home."""
    import jax
    import jax.numpy as jnp

    from starch3_tpu.ops.rle2_jax import rle2_from_ranks_padded

    def step(ptrs, ties, ranks, lens, nsyms):
        syms, m, freq = jax.vmap(
            lambda r, n, a: rle2_from_ranks_padded(r, n, a, n_max)
        )(ranks, lens, nsyms)
        small = jnp.concatenate(
            [ptrs[:, None], m[:, None], ties[:, None], freq], axis=1
        )
        return small, syms

    return jax.jit(_shard_step(step, mesh, 5, 2))


def _jitted_fused_step_fast2(n_max: int, bits: int, mesh=None):
    """fast_huff's front half as the chained programs (see the split
    note above _jitted_bwt_mtf_fast)."""
    step_a = _jitted_bwt_mtf_fast(n_max, bits, mesh)
    step_b = _jitted_rle2_raw(n_max, mesh)

    def step(seqs, lens, nsyms):
        ptrs, ties, ranks = step_a(seqs, lens)
        return step_b(ptrs, ties, ranks, lens, nsyms)

    return step


@functools.lru_cache(maxsize=8)
def _jitted_group_hist(n_max: int):
    import jax

    from starch3_tpu.ops.huff_jax import group_hist_padded

    return jax.jit(
        jax.vmap(lambda s, m: group_hist_padded(s, m, n_max))
    )


@functools.lru_cache(maxsize=1)
def _jitted_cost_select():
    import jax

    from starch3_tpu.ops.huff_jax import cost_and_select

    return jax.jit(jax.vmap(cost_and_select))


def _emit_w_cap(n_max: int) -> int:
    # ~5.3 coded bits per input symbol of capacity; overflow is detected
    # via total_bits and falls back to the host encoder for that block
    return (n_max + 2) // 6 + 64


@functools.lru_cache(maxsize=64)
def _jitted_batch_head(nw: int):
    """First ``nw`` columns of a 2-D device array, on device — so the
    host download is the occupied prefix, not the padded capacity.  The
    emit words cap is ~5.3 bits/symbol (~601 kB/row at 901k) while real
    coded data is ~25-80 kB/row: fetching full rows made the download
    ~10x the useful bytes.  ``nw`` is bucketed by the callers so the
    number of distinct compiled slicers stays small."""
    import jax

    return jax.jit(lambda arr: jax.lax.slice_in_dim(arr, 0, nw, axis=1))


def _dl_bucket(n: int, cap: int, granularity: int = 8192) -> int:
    return min(cap, ((max(n, 1) + granularity - 1) // granularity) * granularity)


@functools.lru_cache(maxsize=8)
def _jitted_emit_coded(n_max: int):
    import jax

    from starch3_tpu.ops.bitpack_jax import emit_coded_padded

    w_cap = _emit_w_cap(n_max)
    return jax.jit(
        jax.vmap(
            lambda s, m, sel, lut: emit_coded_padded(s, m, sel, lut, n_max, w_cap)
        )
    )


@functools.lru_cache(maxsize=8)
def _jitted_fused_step_rle2(n_max: int, mesh=None):
    """BWT -> remap -> MTF -> RLE2, one dispatch per batch: the download
    is the coded symbol stream + frequencies (ops/rle2_jax.py), leaving
    only Huffman planning and bit emission on the host."""
    import jax
    import jax.numpy as jnp

    from starch3_tpu.ops.mtf_jax import mtf_ranks
    from starch3_tpu.ops.rle2_jax import rle2_from_ranks_padded

    n_pairs = (n_max + 2 + 1) // 2

    def tail_one(ptr, used, ranks, n):
        n_in_use = used.sum()
        syms, m, freq = rle2_from_ranks_padded(ranks, n, n_in_use, n_max)
        # symbols < 2^16: pack 2 per int32 word for the download
        sp = jnp.concatenate([syms, jnp.zeros(n_pairs * 2 - syms.size, jnp.int32)])
        sp = sp.reshape(n_pairs, 2)
        packed = sp[:, 0] | (sp[:, 1] << 16)
        return jnp.concatenate([ptr[None], m[None], used, freq, packed])

    def step(blocks, lens):
        ptrs, useds, seqs = jax.vmap(
            lambda b, n: _bwt_remap(b, n, n_max)
        )(blocks, lens)
        ranks = mtf_ranks(seqs, lens, n_max, 256)
        return jax.vmap(tail_one)(ptrs, useds, ranks, lens)

    return jax.jit(_shard_step(step, mesh, 2, 1))


def _unpack_results_rle2(out_d, b):
    out = np.asarray(out_d)  # one transfer for the whole batch
    res = []
    for i in range(b):
        row = out[i]
        ptr = int(row[0])
        m = int(row[1])
        used = row[2:258].astype(bool)
        freq = row[258:518]
        packed = row[518:]
        syms = np.empty(packed.size * 2, dtype=np.int32)
        syms[0::2] = packed & 0xFFFF
        syms[1::2] = (packed >> 16) & 0xFFFF
        res.append((used, ptr, syms[:m], freq))
    return res


def device_encode_blocks(
    block_datas: list[bytes], n_max: int = N_MAX_BLOCK, mesh=None
) -> list[tuple[np.ndarray, int, np.ndarray]]:
    """Run the device stages for a batch of post-RLE1 blocks.

    Returns per block: (in_use bool[256], orig_ptr, mtf ranks uint8).
    When ``mesh`` is given, the batch axis is sharded across its devices.
    """
    import jax
    import jax.numpy as jnp

    from starch3_tpu.parallel.mesh import block_sharding, pad_batch

    b = len(block_datas)
    if b == 0:
        return []
    n_dev = 1
    if mesh is not None:
        n_dev = mesh.devices.size
    b_pad = pad_batch(b, n_dev)
    lens = np.ones(b_pad, dtype=np.int32)
    batch = np.zeros((b_pad, n_max), dtype=np.uint8)
    for i, data in enumerate(block_datas):
        arr = np.frombuffer(data, dtype=np.uint8)
        if arr.size > n_max:
            raise ValueError(f"block {i} exceeds n_max ({arr.size} > {n_max})")
        batch[i, : arr.size] = arr
        lens[i] = arr.size

    if mesh is not None:
        sharding = block_sharding(mesh)
        batch_d = jax.device_put(jnp.asarray(batch), sharding)
        lens_d = jax.device_put(jnp.asarray(lens), sharding)
    else:
        batch_d = jnp.asarray(batch)
        lens_d = jnp.asarray(lens)

    out_d = _jitted_fused_step(n_max, mesh)(batch_d, lens_d)
    return _unpack_results(out_d, lens, b, n_max)


def _unpack_results(out_d, lens, b, n_max):
    out = np.asarray(out_d)  # one transfer for the whole batch
    ptrs = out[:, 0]
    used = out[:, 1:257].astype(bool)
    ranks = out[:, 257:].view(np.uint8).reshape(out.shape[0], n_max)
    return [
        (used[i], int(ptrs[i]), ranks[i, : lens[i]]) for i in range(b)
    ]


# geometry buckets: one compiled program per bucket, shared by every
# stream/chromosome (a per-input n_max would recompile per geometry).
# 448 kB sits between "small chromosome" and "full block": typical
# whole-genome per-chromosome transformed texts are 300-600 kB, and
# padding those to 901k would double the device work
_N_MAX_BUCKETS = (16_384, 131_072, 458_752, N_MAX_BLOCK)


def _split_classify(text: bytes, level: int):
    """RLE1-segment one stream and classify each block's alphabet so
    batches stay homogeneous — a single wide block never demotes its
    batch.  The distinct-byte count runs natively (one table store per
    byte, runtime.cpp s3_count_distinct; the NumPy bincount fallback
    was ~45% of the serial feed cost).  Pure function of the text: safe
    on the feed prefetch pool (the natives release the GIL)."""
    from starch3_tpu.runtime import count_distinct_native

    blocks = rle1_split_blocks(text, level)
    classes = []
    for blk in blocks:
        n_syms = count_distinct_native(blk.data)
        if n_syms is None:
            n_syms = int((np.bincount(
                np.frombuffer(blk.data, np.uint8), minlength=256
            ) > 0).sum())
        classes.append(_bits_class(n_syms))
    return blocks, classes


def _bits_class(n_syms: int) -> int:
    """Device-path alphabet class for a block with ``n_syms`` distinct
    bytes.  Blocks are classified individually at feed time and batched
    per class, so one wide block never demotes its batch-mates: 3-column
    BED rides bits==4, config-3 remainder-column BED (typically ~21
    symbols) rides bits==5, and only >64-symbol content pays the generic
    bits==8 path (whose 16-symbol sort context would tie ~470x per block
    on the config-3 corpus — see ops/bwt_fast.bwt_sort_fast_mid)."""
    if n_syms <= 16:
        return 4
    if n_syms <= 32:
        return 5
    if n_syms <= 64:
        return 6
    return 8


def _bucket_for(size: int) -> int:
    for b in _N_MAX_BUCKETS:
        if size <= b:
            return b
    raise ValueError(f"block size {size} exceeds {N_MAX_BLOCK}")


def encode_streams(
    texts: list[bytes],
    level: int = 9,
    mesh=None,
    batch_size: int = 3,
    device_rle2: bool = False,
    fast_bwt: bool = True,
    host_assist: bool | None = None,
    device_huffman: bool = False,
) -> list:  # list[codec.encoder.EncodedStream]
    """Compress many independent streams with one global device queue.

    All streams' blocks are flattened into shared batches (one geometry
    bucket per batch), dispatched software-pipelined, and reassembled per
    stream in order — so 24 chromosomes with one block each cost ~3
    device dispatches, not 24 (the cross-stream analogue of the
    reference's single-stream sequential loop).

    ``fast_bwt`` (default) sorts rotations once by packed prefix keys and
    re-encodes tie-flagged blocks on the host — output bytes are identical
    either way.  ``device_rle2`` only matters when ``fast_bwt`` is False.

    ``host_assist`` (default: on when the native runtime is built and no
    mesh is given) runs spare CPU cores as work stealers: the device
    claims batches from the front of each bucket's queue, host threads
    claim single blocks from the back, and they meet in the middle.
    Output bytes are identical regardless of the split, so the archive
    stays deterministic — this is throughput scheduling, not semantics.
    """
    return encode_streams_feed(
        iter(texts),
        level=level,
        mesh=mesh,
        batch_size=batch_size,
        device_rle2=device_rle2,
        fast_bwt=fast_bwt,
        host_assist=host_assist,
        device_huffman=device_huffman,
    )


def encode_streams_feed(
    text_iter,
    level: int = 9,
    mesh=None,
    batch_size: int = 3,
    device_rle2: bool = False,
    fast_bwt: bool = True,
    host_assist: bool | None = None,
    device_huffman: bool = False,
) -> list:  # list[codec.encoder.EncodedStream]
    """``encode_streams`` over a *stream* of texts: encoding begins while
    later texts are still being produced, so the device and the stealer
    cores are already encoding the first chromosomes while the parser is
    still tokenizing the last ones.  Output bytes are identical to the
    list form; only scheduling differs."""
    return list(
        encode_streams_iter(
            text_iter,
            level=level,
            mesh=mesh,
            batch_size=batch_size,
            device_rle2=device_rle2,
            fast_bwt=fast_bwt,
            host_assist=host_assist,
            device_huffman=device_huffman,
        )
    )


def _assemble_stream(blocks, results, si: int, level: int):
    """Concatenate one stream's finished block fragments in block order
    (deterministic: partitioning is input-derived, never topology- or
    schedule-derived).

    Production path (all results are prebuilt BitWriter fragments, the
    native lib present): ONE exact-size allocation, each fragment
    bit-spliced into place natively (runtime.cpp s3_append_shifted) —
    the growing-bytearray concat's realloc copies were the measured
    serial-assembly ceiling (docs/PERF.md "Orchestration ceiling").
    Legacy/device-tuple results take the incremental BitWriter path;
    bytes are identical either way (tested)."""
    resolved = []
    for bi in range(len(blocks)):
        res = results[(si, bi)]
        if hasattr(res, "result"):  # tail-pool future -> fragment
            res = res.result()
        resolved.append(res)
    from starch3_tpu.codec.encoder import EncodedStream

    if all(isinstance(r, BitWriter) for r in resolved):
        from starch3_tpu.runtime import append_shifted_at, get_lib

        if get_lib() is not None:
            total_bits = (
                32
                + sum(f.bit_length for f in resolved)
                + 48
                + 32
            )
            out = bytearray((total_bits + 7) // 8)
            out[0:3] = b"BZh"
            out[3] = 0x30 + level
            pos, acc, L = 4, 0, 0
            combined = 0
            offsets = []
            crcs = []
            ok = True
            for blk, f in zip(blocks, resolved):
                offsets.append(pos * 8 + L)
                crcs.append(blk.crc)
                combined = combine_block_crc(combined, blk.crc)
                src = f._out
                n = len(src)
                if n:
                    if L == 0:
                        out[pos : pos + n] = src
                        acc = src[-1]  # unused at L==0; keep well-defined
                    else:
                        acc = append_shifted_at(out, pos, src, L, acc)
                        if acc is None:
                            ok = False
                            break
                    pos += n
                if f._nbits:
                    acc = ((acc if L else 0) << f._nbits) | f._acc
                    L += f._nbits
                    if L >= 8:
                        L -= 8
                        out[pos] = (acc >> L) & 0xFF
                        pos += 1
                        acc &= (1 << L) - 1
            if ok:
                tail = BitWriter()
                tail._acc, tail._nbits = acc, L
                tail.write(STREAM_END_MAGIC, 48)
                tail.write(combined, 32)
                tb = tail.getvalue()
                out[pos : pos + len(tb)] = tb
                assert pos + len(tb) == len(out)
                return EncodedStream(
                    data=bytes(out),
                    block_bit_offsets=tuple(offsets),
                    block_crcs=tuple(crcs),
                    combined_crc=combined,
                )

    bw = BitWriter()
    bw.write_bytes_msb(b"BZh")
    bw.write(0x30 + level, 8)
    combined = 0
    offsets = []
    crcs = []
    for bi, blk in enumerate(blocks):
        res = resolved[bi]
        offsets.append(bw.bit_length)
        crcs.append(blk.crc)
        combined = combine_block_crc(combined, blk.crc)
        if isinstance(res, BitWriter):  # pre-built fragment
            bw.append_writer(res)
        elif len(res) == 4:  # device-RLE2: (used, ptr, symbols, freq)
            in_use, ptr, syms, freq = res
            write_block_from_device_syms(bw, blk.crc, ptr, syms, freq, in_use)
        else:
            in_use, ptr, ranks = res
            write_block_from_ranks(bw, blk.crc, ptr, ranks, in_use)
    bw.write(STREAM_END_MAGIC, 48)
    bw.write(combined, 32)
    return EncodedStream(
        data=bw.getvalue(),
        block_bit_offsets=tuple(offsets),
        block_crcs=tuple(crcs),
        combined_crc=combined,
    )


def encode_streams_iter(
    text_iter,
    level: int = 9,
    mesh=None,
    batch_size: int = 3,
    device_rle2: bool = False,
    fast_bwt: bool = True,
    host_assist: bool | None = None,
    device_huffman: bool = False,
    window_bytes: int = 256 << 20,
):
    """Incremental ``encode_streams``: a generator yielding each
    stream's EncodedStream IN FEED ORDER as soon as all its blocks are
    done, while later texts are still being fed and encoded.

    This is the constant-memory form the streaming archive writer
    (api.compress_bed_stream) consumes: the feeder runs on its own
    thread and blocks when more than ``window_bytes`` of block data is
    in flight (fed but not yet yielded), and a yielded stream's blocks
    and fragments are released immediately — so a 10 GB corpus holds a
    bounded window of work, yet the device queue never drains between
    chromosomes (flushing fixed windows through separate
    encode_streams calls would idle the device during every
    inter-window parse).

    Output bytes are identical to ``encode_streams``; only scheduling
    and memory behavior differ.
    """
    if fast_bwt:
        mode = "fast_huff" if device_huffman else "fast"
    else:
        mode = "rle2" if device_rle2 else "ranks"
    if host_assist is None:
        from starch3_tpu.runtime import get_lib

        host_assist = mesh is None and get_lib() is not None

    q = _BlockQueue()
    q.steal_holdback = batch_size
    q.device_low_water = batch_size * _PIPELINE_DEPTH
    q.window_bytes = window_bytes
    # seed per-class tier rates from this process's previous encodes
    # (capped sample credit: one fresh drain still re-rates quickly)
    q.class_rate.update(_class_rate_cache)
    q.class_samples.update(
        {b: _CLASS_MIN_SAMPLES for b in _class_rate_cache}
    )
    results: dict[tuple[int, int], tuple] = {}
    errors: list[BaseException] = []
    stealers = _start_host_stealers(q, results, errors, host_assist)
    # Tail reserve: once feeding is done and a bucket's queue is nearly
    # drained, the device stops claiming and the host stealers finish.
    # The device's per-batch latency (dispatch + download) would
    # otherwise make its last claim the whole corpus's straggler.  ~2
    # blocks per stealer core ends the race within one host
    # block-encode of optimal either way.
    reserve = _TAIL_RESERVE_PER_STEALER * len(stealers)
    driver = threading.Thread(
        target=_device_driver,
        args=(q, results, errors, mesh, mode, batch_size, reserve),
        name="s3device",
        daemon=True,
    )
    driver.start()

    def run_feed():
        """Feeder: the caller's iterator (typically the parser) runs
        serially here, but RLE1 segmentation + alphabet classing — the
        serial-feed bottleneck the orchestration-ceiling harness
        exposes (benchmarks/orchestration_ceiling.py) — run on a
        bounded prefetch pool, in order.  The split natives release the
        GIL, so feed throughput scales with cores on big hosts."""
        import collections
        import os
        from concurrent.futures import ThreadPoolExecutor

        width = max(2, min(8, os.cpu_count() or 2))
        try:
            with ThreadPoolExecutor(
                width, thread_name_prefix="s3split"
            ) as ex:
                futs: collections.deque = collections.deque()
                it = iter(text_iter)
                exhausted = False
                while True:
                    while not exhausted and len(futs) < width + 2:
                        try:
                            text = next(it)
                        except StopIteration:
                            exhausted = True
                            break
                        futs.append(ex.submit(_split_classify, text, level))
                    if not futs:
                        break
                    q.feed_blocks(*futs.popleft().result())
                    if errors or q.cancelled:
                        break
        except BaseException as e:  # surfaced by the generator below
            errors.append(e)
        finally:
            q.finish_feeding()

    feeder = threading.Thread(target=run_feed, name="s3feed", daemon=True)
    feeder.start()

    next_si = 0
    try:
        while True:
            blocks = None
            with q.cond:
                while True:
                    if errors:
                        raise errors[0]
                    if next_si < len(q.per_stream_blocks):
                        cand = q.per_stream_blocks[next_si]
                        # feed() appends a stream's blocks atomically,
                        # so the block list is final once visible
                        if all(
                            (next_si, bi) in results
                            for bi in range(len(cand))
                        ):
                            blocks = cand
                            break
                    elif not q.feeding:
                        break
                    q.cond.wait(0.05)
            if blocks is None:
                break
            enc = _assemble_stream(blocks, results, next_si, level)
            with q.cond:
                # release the yielded stream's memory and open the
                # feeder's backpressure window
                q.per_stream_blocks[next_si] = None
                q.inflight_bytes -= sum(len(b.data) for b in blocks)
                for bi in range(len(blocks)):
                    results.pop((next_si, bi), None)
                q.cond.notify_all()
            next_si += 1
            yield enc
        driver.join()
        for t in stealers:
            t.join()
        feeder.join()
        if errors:
            raise errors[0]
    finally:
        # early close/error: unblock and stop the feeder, then drain the
        # workers out before returning control (claimed work finishes
        # harmlessly; results for yielded streams were already dropped)
        with q.cond:
            q.cancelled = True
            q.cond.notify_all()
        q.finish_feeding()
        feeder.join()
        driver.join()
        for t in stealers:
            t.join()


import threading

# scheduler knobs (see encode_streams_feed): blocks held back for the
# stealer cores per stealer at the queue tail, and how many device
# batches stay in flight (a shallow pipeline shrinks the end-of-corpus
# straggler; not yet swept on the GPU)
_TAIL_RESERVE_PER_STEALER = 1
_PIPELINE_DEPTH = 2

# Rate-aware device demotion (see _device_driver): bench the device when
# its drain throughput EMA falls below this fraction of the stealers'
# aggregate, and re-probe with one batch this many seconds later.
_DEMOTE_FRACTION = 0.5
_DEMOTE_PROBE_S = 15.0
_DEMOTE_MIN_SAMPLES = 3
# per-class routing (claim loop): a class needs this many drain samples
# before its tier rate can veto device claims — fewer than the global
# demotion threshold because a single slow-tier batch (the generic
# bits==8 tier is the slowest device tier) is already informative
_CLASS_MIN_SAMPLES = 2
# a dispatched batch not transfer-ready after this long is abandoned:
# its blocks go back to the queue for the stealers and the device is
# benched (failure mode: a device or link that stops answering mid-
# encode — without this the encode hangs on blocks the device claimed
# but can never deliver).  Compile time never counts: see the dispatch
# in _device_driver.
_ABANDON_S = 30.0

# observability: cumulative scheduler events for this process (tests and
# the bench read these; encode results never depend on them).  The
# blocks_* counters say who finished each block: the device, the host
# after a device tie (or emit overflow), or a host encode (stealers and
# the driver's inline fallbacks).
scheduler_stats = {
    "demotions": 0,
    "repromotions": 0,
    "abandoned_batches": 0,
    "class_skips": 0,
    "blocks_device": 0,
    "blocks_tie_fallback": 0,
    "blocks_host": 0,
}
_stats_lock = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _stats_lock:
        scheduler_stats[key] += n

# process-lifetime per-class device tier rates (bits -> EMA bytes/s):
# a fresh encode's queue is seeded from the last encode's measurements,
# so per-class routing is effective from the first batch instead of
# re-learning each call (the tier rates are properties of the device
# and corpus class, not of one encode).  Scheduling only; the probe claims
# re-measure every _DEMOTE_PROBE_S regardless.
_class_rate_cache: dict[int, float] = {}


def _no_host_fallback() -> bool:
    """STARCH3_TPU_NO_HOST_FALLBACK=1 keeps device-only encodes pure:
    stuck batches are never abandoned to driver-inline host encodes and
    the final drain blocks on the device (for device-lane measurements
    that must never silently time host work).  Default off: a device
    that stops answering in a ``host_assist=False`` encode has its
    stuck batches abandoned to the driver thread instead of hanging."""
    import os

    return os.environ.get("STARCH3_TPU_NO_HOST_FALLBACK") == "1"


class _BlockQueue:
    """The shared two-ended block queue behind one encode call.

    Blocks arrive over time (``feed``, appended at the back) grouped
    into geometry buckets; the device driver claims batches from the
    FRONT of a bucket, host stealers claim single blocks from the BACK
    (the freshest — any unclaimed block is equivalent: output bytes are
    per-block deterministic), and they meet in the middle.  All state
    transitions happen under one condition variable — consumers sleep
    on it instead of polling."""

    def __init__(self):
        import collections

        self.cond = threading.Condition()
        # key: (geometry n_max, alphabet bits class)
        self.buckets: dict[tuple[int, int], "collections.deque"] = {}
        self._deque = collections.deque
        self.per_stream_blocks: list[list] = []
        self.feeding = True
        # blocks the device driver has claimed so far; until its
        # software pipeline is primed, stealers leave it first pick
        # (see _start_host_stealers)
        self.device_claimed = 0
        self.device_low_water = 0
        self.steal_holdback = 0  # blocks stealers leave while gated
        # incremental-assembly backpressure (encode_streams_iter):
        # bytes of block data fed but not yet yielded; feed() blocks
        # while over window_bytes (None = unbounded, the list forms)
        self.window_bytes: int | None = None
        self.inflight_bytes = 0
        self.feed_blocked = False  # feeder parked on the window
        self.cancelled = False
        # rate-aware demotion (see _device_driver): throughput EMAs let
        # the scheduler bench a device whose effective rate has
        # collapsed (sick device, degraded interconnect) instead of
        # letting its claimed batches straggle the whole corpus.
        # Scheduling only — archive bytes are claim-order invariant.
        self.n_stealers = 0
        self.live_stealers = 0  # still-running stealer threads
        self.stealer_rate = None  # EMA bytes/s per stealer core
        self.device_rate = None  # EMA bytes/s (drain-to-drain)
        self.device_rate_samples = 0
        self.device_demoted = False
        self.device_probe_at = 0.0  # monotonic time of next probe
        # per-alphabet-class device tier rates: a class whose measured
        # device rate trails the stealer aggregate is routed to the
        # host cores without benching the device (bits -> EMA bytes/s)
        self.class_rate: dict[int, float] = {}
        self.class_samples: dict[int, int] = {}
        self.class_probe_at: dict[int, float] = {}

    def active_feeding(self) -> bool:
        """True while more blocks may arrive SOON.  A window-blocked
        feeder cannot add blocks until a stream is yielded, so consumers
        must treat that state like end-of-feed (take partial batches,
        drop steal holdbacks) or the scheduler deadlocks: feeder waits
        on the window, device waits for a full batch, stealers hold
        back."""
        return self.feeding and not self.feed_blocked

    def feed(self, text: bytes, level: int) -> None:
        self.feed_blocks(*_split_classify(text, level))

    def feed_blocks(self, blocks: list, classes: list[int]) -> None:
        total = sum(len(blk.data) for blk in blocks)
        with self.cond:
            if self.window_bytes is not None:
                # backpressure: keep a bounded window of undelivered
                # work (never deadlocks: one stream may exceed the
                # window alone when nothing else is in flight, and
                # feed_blocked releases the workers' batch/holdback
                # gates while we sleep)
                while (
                    not self.cancelled
                    and self.inflight_bytes > 0
                    and self.inflight_bytes + total > self.window_bytes
                ):
                    if not self.feed_blocked:
                        self.feed_blocked = True
                        self.cond.notify_all()
                    self.cond.wait(0.05)
                self.feed_blocked = False
            self.inflight_bytes += total
            si = len(self.per_stream_blocks)
            self.per_stream_blocks.append(blocks)
            for bi, blk in enumerate(blocks):
                key = (_bucket_for(len(blk.data)), classes[bi])
                self.buckets.setdefault(key, self._deque()).append((si, bi))
            self.cond.notify_all()

    def finish_feeding(self) -> None:
        with self.cond:
            self.feeding = False
            self.cond.notify_all()

    def claim_priority(self, nm) -> tuple:
        """Device claim order across geometry buckets: unmeasured
        classes first (optimistic — one batch measures them), then by
        measured per-class device rate descending, then bigger
        geometry.  A plain bucket-key sort would prefer the WIDEST
        alphabet at equal geometry — i.e. the slowest tier (bits==8)
        ahead of the fastest (bits==4) — parking the device on its
        worst work while narrow blocks queue.  Scheduling only: bytes
        are claim-order invariant.  STARCH3_TPU_NO_CLASS_ROUTING=1
        restores the plain descending bucket-key order (for A/B)."""
        import os

        if isinstance(nm, tuple):
            n_max, bits_c = nm
            rate = self.class_rate.get(bits_c)
        else:
            n_max, bits_c = nm, 0
            rate = None
        if os.environ.get("STARCH3_TPU_NO_CLASS_ROUTING") == "1":
            return (-n_max, -bits_c)
        return (
            -(rate if rate is not None else float("inf")),
            -n_max,
            bits_c,
        )

    def class_gated(self, bits_c, now: float) -> bool:
        """True when the device should NOT claim from this alphabet
        class right now: its measured tier rate (per-class drain EMA)
        loses to the stealer aggregate — e.g. the bits==8 generic tier
        behind enough host cores — and the class's probe window hasn't
        opened.  Returning False when the
        window IS open also re-arms it: that claim is the class's
        probe, re-measuring the tier in case the corpus or link
        changed.  Caller holds ``self.cond``.  Scheduling only: bytes
        are claim-order invariant.  STARCH3_TPU_NO_CLASS_ROUTING=1
        disables the gate (kept for A/B measurement)."""
        if bits_c is None or self.n_stealers <= 0 or not self.stealer_rate:
            return False
        import os

        if os.environ.get("STARCH3_TPU_NO_CLASS_ROUTING") == "1":
            return False
        if self.class_samples.get(bits_c, 0) < _CLASS_MIN_SAMPLES:
            return False
        if self.class_rate.get(bits_c, 0.0) >= (
            _DEMOTE_FRACTION * self.stealer_rate * self.n_stealers
        ):
            return False
        if now < self.class_probe_at.get(bits_c, 0.0):
            return True
        self.class_probe_at[bits_c] = now + _DEMOTE_PROBE_S
        return False


def _start_host_stealers(q: _BlockQueue, results, errors, host_assist):
    """Host stealer threads: claim one block at a time from the back of
    the biggest-block bucket (one steal = one native block encode, so
    stealing big blocks moves the most bytes per claim)."""
    if not host_assist:
        return []
    import os

    from starch3_tpu.codec.encoder import encode_block_fragment

    def steal():
        with q.cond:
            q.live_stealers += 1
        registered = True
        try:
            while True:
                claim = None
                with q.cond:
                    while True:
                        # While blocks are still arriving and the device
                        # pipeline isn't primed, the device has first
                        # pick: it turns blocks around with a batch's
                        # dispatch latency, so it must claim EARLY or it
                        # idles through the whole corpus (the stealers
                        # would drain the queue faster than the feeder
                        # fills it and the device would get one late
                        # batch).  Stealers then only take blocks beyond
                        # one buildable batch.
                        hold_back = (
                            q.steal_holdback
                            if q.active_feeding()
                            and q.device_claimed < q.device_low_water
                            and not q.device_demoted
                            else 0
                        )
                        for nm in sorted(q.buckets, reverse=True):
                            dq = q.buckets[nm]
                            if len(dq) > hold_back:
                                claim = dq.pop()
                                break
                        if (
                            claim is not None
                            or not q.feeding
                            or errors
                            or q.cancelled
                        ):
                            if claim is None:
                                # exit decision: deregister INSIDE the same
                                # critical section, so _abandon_batch can
                                # never observe this thread as live after
                                # it has decided to stop consuming (it
                                # would re-enqueue blocks nobody revisits
                                # and the assembler would hang)
                                q.live_stealers -= 1
                                registered = False
                                q.cond.notify_all()
                            break
                        q.cond.wait(0.05 if not hold_back else 0.002)
                if claim is None:
                    return
                si, bi = claim
                blk = q.per_stream_blocks[si][bi]
                t0 = time.monotonic()
                results[(si, bi)] = encode_block_fragment(blk)
                dt = time.monotonic() - t0
                _count("blocks_host")
                with q.cond:  # wake the incremental assembler
                    if dt > 0:
                        r = len(blk.data) / dt
                        q.stealer_rate = (
                            r
                            if q.stealer_rate is None
                            else 0.7 * q.stealer_rate + 0.3 * r
                        )
                    q.cond.notify_all()
        except BaseException as e:  # surface in the caller
            errors.append(e)
        finally:
            with q.cond:
                if registered:  # abnormal exit (normal exits deregister
                    q.live_stealers -= 1  # in the claim loop, atomically)
                q.cond.notify_all()

    # every core can steal; the native encode releases the GIL and the
    # device driver thread mostly blocks on transfers
    n_workers = os.cpu_count() or 2
    q.n_stealers = n_workers
    threads = [
        threading.Thread(target=steal, name=f"s3steal{i}", daemon=True)
        for i in range(n_workers)
    ]
    for t in threads:
        t.start()
    return threads


def _abandon_batch(q, results, entry):
    """Take a stuck batch away from the device and bench it.  Blocks go
    back to the queue front for the stealers; if no stealer thread is
    still alive (they exit when the queue momentarily drains after
    feeding), the driver host-encodes them right here — either way the
    encode terminates.  The device handles are dropped; if the transfer
    ever completes the runtime frees them, and a later duplicate encode
    of a re-enqueued block is benign (per-block byte determinism)."""
    nm, (chunk, _handles), _nbytes, _t0 = entry
    with q.cond:
        q.device_demoted = True
        q.device_probe_at = time.monotonic() + _DEMOTE_PROBE_S
        scheduler_stats["demotions"] += 1
        scheduler_stats["abandoned_batches"] += 1
        inline = q.live_stealers == 0
        if not inline:
            dq = q.buckets.setdefault(nm, q._deque())
            for key in reversed(chunk):
                dq.appendleft(key)
        q.cond.notify_all()
    if inline:
        from starch3_tpu.codec.encoder import encode_block_fragment

        for si, bi in chunk:
            results[(si, bi)] = encode_block_fragment(
                q.per_stream_blocks[si][bi]
            )
        _count("blocks_host", len(chunk))
        with q.cond:
            q.cond.notify_all()


def _device_driver(q: _BlockQueue, results, errors, mesh, mode, batch_size, reserve):
    """The device side of the queue: claim fixed-size batches (padded —
    every dispatch reuses one compiled geometry), keep two in flight,
    and leave the post-feeding tail to the stealer cores (``reserve``).

    Rate-aware demotion: the driver tracks its drain-to-drain
    throughput; when stealers exist and the device's effective rate
    falls far below their aggregate (sick device, degraded link), it
    stops claiming so its in-flight batches can't straggle the corpus,
    then re-probes with a single batch every ``_DEMOTE_PROBE_S`` and
    resumes when the device recovers.  The same EMAs are kept per
    alphabet class: a tier whose device rate trails the stealers'
    aggregate (the generic bits==8 tier is the candidate) is routed to
    the hosts without benching the whole device.  Pure scheduling:
    bytes are claim-order invariant."""
    pending: list = []
    # completion clock for drain-to-drain rates; fast_huff finishers
    # call note_drain from their own threads, so all access happens
    # under q.cond (resets may store None directly: racing a reset with
    # a sample only skews one EMA interval)
    drain_clock = [None]
    fallback_ok = not _no_host_fallback()

    def note_drain(nbytes: int, bits=None) -> None:
        now = time.monotonic()
        with q.cond:
            prev = drain_clock[0]
            drain_clock[0] = now
            if prev is None or now <= prev:
                return
            r = nbytes / (now - prev)
            q.device_rate = (
                r if q.device_rate is None else 0.6 * q.device_rate + 0.4 * r
            )
            q.device_rate_samples += 1
            if bits is not None:
                cr = q.class_rate.get(bits)
                q.class_rate[bits] = r if cr is None else 0.6 * cr + 0.4 * r
                q.class_samples[bits] = q.class_samples.get(bits, 0) + 1
                _class_rate_cache[bits] = q.class_rate[bits]
            if (
                not q.device_demoted
                and q.n_stealers > 0
                and q.stealer_rate
                and q.device_rate_samples >= _DEMOTE_MIN_SAMPLES
                and q.device_rate
                < _DEMOTE_FRACTION * q.stealer_rate * q.n_stealers
            ):
                q.device_demoted = True
                q.device_probe_at = now + _DEMOTE_PROBE_S
                scheduler_stats["demotions"] += 1
                q.cond.notify_all()

    try:
        while True:
            chunk = None
            this_nm = None
            inline_claim = None
            with q.cond:
                while True:
                    if errors or q.cancelled:
                        return
                    probe_due = q.device_demoted and (
                        time.monotonic() >= q.device_probe_at
                    )
                    if q.device_demoted and not probe_due:
                        # benched: let the stealers own the queue; wake
                        # for the next probe or for shutdown — but first
                        # finish draining anything already in flight
                        if pending:
                            break
                        if not q.feeding and not any(
                            q.buckets[nm2] for nm2 in q.buckets
                        ):
                            break
                        if q.live_stealers == 0 and fallback_ok:
                            # device-only encode (host_assist=False) on a
                            # benched device: the driver itself becomes
                            # the stealer — full-host-speed progress
                            # between probes, instead of batch_size
                            # host-encoded blocks per probe period (the
                            # observed outages last hours; a dead link
                            # must never reduce throughput to the probe
                            # trickle, let alone hang the encode)
                            for nm2 in sorted(q.buckets, reverse=True):
                                if q.buckets[nm2]:
                                    inline_claim = q.buckets[nm2].pop()
                                    break
                            if inline_claim is not None:
                                break
                        q.cond.wait(0.1)
                        continue
                    for nm in sorted(
                        q.buckets, key=q.claim_priority
                    ):
                        dq = q.buckets[nm]
                        remaining = len(dq)
                        if remaining <= 0:
                            continue
                        bits_c = nm[1] if isinstance(nm, tuple) else None
                        if q.class_gated(bits_c, time.monotonic()):
                            # this tier loses to the stealer aggregate:
                            # leave its blocks to the host cores (one
                            # probe claim per period re-measures it)
                            scheduler_stats["class_skips"] += 1
                            continue
                        if q.active_feeding() and remaining < batch_size:
                            # wait for a full batch while blocks are
                            # still arriving (partial batches would
                            # waste padded device rows; a window-blocked
                            # feeder counts as not arriving)
                            continue
                        take = min(batch_size, remaining)
                        if (
                            not q.feeding
                            and reserve
                            and remaining - take < reserve
                        ):
                            continue  # leave the tail to the host cores
                        chunk = [dq.popleft() for _ in range(take)]
                        q.device_claimed += take
                        this_nm = nm
                        break
                    if chunk is not None or pending or not q.feeding:
                        break
                    q.cond.wait(0.005)
                if (
                    chunk is None
                    and inline_claim is None
                    and not pending
                    and not q.feeding
                ):
                    break  # queue fully claimed; stealers own the rest
                # a claim made while demoted is the recovery probe
                probing = chunk is not None and q.device_demoted
            if inline_claim is not None:
                from starch3_tpu.codec.encoder import encode_block_fragment

                si, bi = inline_claim
                results[(si, bi)] = encode_block_fragment(
                    q.per_stream_blocks[si][bi]
                )
                _count("blocks_host")
                with q.cond:
                    q.cond.notify_all()
                continue
            if chunk is None and not pending:
                # feed-starved: a drain-to-drain interval spanning this
                # idle gap would fake a low device rate — reset it
                drain_clock[0] = None
            if chunk is not None and probing:
                # Non-hostage recovery probe: dispatch the batch, then
                # immediately host-encode the SAME blocks inline so the
                # assembler never waits on a possibly-dead device (a
                # probe that held its blocks for _ABANDON_S would stall
                # every encode during an outage by that long).  The
                # device handles serve purely as a rate
                # signal: ready within the patience window -> measure
                # and maybe repromote; otherwise drop them.  The
                # duplicate encode is ~3 blocks of host work per probe
                # period and byte-identical by construction.
                datas = [
                    q.per_stream_blocks[si][bi].data for si, bi in chunk
                ]
                nbytes = sum(map(len, datas))
                t0 = time.monotonic()
                handles = _dispatch_chunk(
                    datas, this_nm, mesh, mode, pad_to=batch_size
                )[0]
                from starch3_tpu.codec.encoder import encode_block_fragment

                for si, bi in chunk:
                    results[(si, bi)] = encode_block_fragment(
                        q.per_stream_blocks[si][bi]
                    )
                _count("blocks_host", len(chunk))
                with q.cond:
                    q.cond.notify_all()
                while (
                    not _batch_ready(handles)
                    and time.monotonic() - t0 < _ABANDON_S
                    and not errors
                    and not q.cancelled
                ):
                    # device-only mode: keep host-encoding queued blocks
                    # while waiting on the probe — otherwise a dead device
                    # stalls this thread (the only worker) for the full
                    # patience window every probe period
                    probe_fill = None
                    if fallback_ok:
                        with q.cond:
                            if q.live_stealers == 0:
                                for nm2 in sorted(q.buckets, reverse=True):
                                    if q.buckets[nm2]:
                                        probe_fill = q.buckets[nm2].pop()
                                        break
                    if probe_fill is not None:
                        si2, bi2 = probe_fill
                        results[(si2, bi2)] = encode_block_fragment(
                            q.per_stream_blocks[si2][bi2]
                        )
                        _count("blocks_host")
                        with q.cond:
                            q.cond.notify_all()
                        continue
                    import time as _time

                    _time.sleep(0.01)
                dt = time.monotonic() - t0
                rate = nbytes / dt if dt > 0 else 0.0
                with q.cond:
                    if _batch_ready(handles) and (
                        not q.stealer_rate
                        or rate
                        >= _DEMOTE_FRACTION * q.stealer_rate * q.n_stealers
                    ):
                        q.device_demoted = False
                        q.device_rate = rate
                        q.device_rate_samples = 1
                        scheduler_stats["repromotions"] += 1
                    else:
                        q.device_probe_at = (
                            time.monotonic() + _DEMOTE_PROBE_S
                        )
                    q.cond.notify_all()
                del handles
                drain_clock[0] = None
                continue
            if chunk is not None:
                datas = [
                    q.per_stream_blocks[si][bi].data for si, bi in chunk
                ]
                # single-block corpora (BASELINE config 1: one small
                # chromosome = one block) get a b=1 geometry: padding to
                # batch_size would triple the upload, compute, AND
                # download of the only dispatch in the run.  Gated to
                # exactly-one-block corpora so multi-batch runs never
                # trip a second compiled geometry mid-stream.
                pad = batch_size
                if len(chunk) == 1 and not q.feeding:
                    with q.cond:
                        total = sum(
                            len(bs)
                            for bs in q.per_stream_blocks
                            if bs is not None
                        )
                    if total == 1:
                        pad = 1
                handles = _dispatch_chunk(datas, this_nm, mesh, mode, pad_to=pad)
                # the _ABANDON_S clock starts once dispatch returns: a cold
                # compile runs synchronously inside that call, so compile
                # time never reads as a stuck batch
                pending.append(
                    (
                        this_nm,
                        (chunk, handles),
                        sum(map(len, datas)),
                        time.monotonic(),
                    )
                )
                if len(pending) < _PIPELINE_DEPTH:
                    continue  # keep _PIPELINE_DEPTH batches in flight
            if pending:
                # Pipeline full (or nothing claimable): drain the oldest.
                # When there may still be claimable work soon, only block
                # on a batch whose transfer already landed — blocking on
                # an in-flight batch would stall the next dispatch for
                # the whole batch turnaround.  While over-full, poll
                # instead of blocking blind: a batch not transfer-ready
                # after _ABANDON_S goes back to the queue for the
                # stealers (mid-encode link outage: a blocking drain
                # would hang the whole encode on blocks only the device
                # holds).
                abandon_ok = q.n_stealers > 0 or fallback_ok
                while pending:
                    if errors or q.cancelled:
                        return
                    head = pending[0]
                    if _batch_ready(head[1][1][0]):
                        break
                    if (
                        abandon_ok
                        and time.monotonic() - head[3] > _ABANDON_S
                    ):
                        # stale at ANY depth: an under-full stuck head
                        # would otherwise never drain once the claim
                        # loop stops feeding new batches (demotion);
                        # with no stealers _abandon_batch host-encodes
                        # the blocks inline, so a mid-run link outage
                        # can't hang a device-only encode either
                        _abandon_batch(q, results, pending.pop(0))
                        drain_clock[0] = None
                        continue
                    if len(pending) < _PIPELINE_DEPTH:
                        break  # room to dispatch more; don't park here
                    if not abandon_ok:
                        break  # pure device, no fallback: blocking drain
                    import time as _time

                    _time.sleep(0.005)
                if pending and (
                    len(pending) >= _PIPELINE_DEPTH
                    or _batch_ready(pending[0][1][1][0])
                ):
                    nm0, item, nbytes, _t0 = pending.pop(0)
                    bits0 = nm0[1] if isinstance(nm0, tuple) else None
                    _drain_into(
                        results, q.per_stream_blocks, item, nm0, mode,
                        on_done=functools.partial(note_drain, nbytes, bits0),
                    )
                    with q.cond:  # wake the incremental assembler
                        q.cond.notify_all()
                elif chunk is None:
                    import time as _time

                    _time.sleep(0.002)  # nothing claimable, batch not ready
        abandon_ok = q.n_stealers > 0 or fallback_ok
        while pending:
            if errors or q.cancelled:
                return
            head = pending[0]
            if abandon_ok and not _batch_ready(head[1][1][0]):
                if time.monotonic() - head[3] > _ABANDON_S:
                    _abandon_batch(q, results, pending.pop(0))
                    continue
                import time as _time

                _time.sleep(0.005)
                continue
            nm0, item, nbytes, _t0 = pending.pop(0)
            bits0 = nm0[1] if isinstance(nm0, tuple) else None
            _drain_into(
                results, q.per_stream_blocks, item, nm0, mode,
                on_done=functools.partial(note_drain, nbytes, bits0),
            )
            with q.cond:
                q.cond.notify_all()
    except BaseException as e:  # surface in the caller
        errors.append(e)


def _batch_ready(out_d) -> bool:
    """True when a dispatched batch's host-bound arrays are ready to
    fetch without blocking (jax.Array.is_ready; conservatively True on
    backends without it, restoring blocking-drain behavior)."""
    handles = out_d if isinstance(out_d, tuple) else (out_d,)
    for h in handles:
        is_ready = getattr(h, "is_ready", None)
        if is_ready is not None:
            try:
                if not is_ready():
                    return False
            except Exception:
                return True
    return True


def _drain_into(results, per_stream_blocks, item, n_max, mode="ranks",
                on_done=None):
    """Move one dispatched batch's results into ``results``.  ``on_done``
    (the driver's drain-rate hook) fires when the batch's host results
    actually exist: at return for the synchronous modes, and from the
    finisher thread for fast_huff — measuring submit-to-submit there
    would overestimate the device under refinement backlog, weakening
    the demotion trigger in exactly the degraded-link case it targets."""
    if isinstance(n_max, tuple):  # queue bucket key: (geometry, bits class)
        n_max = n_max[0]
    chunk, (out_d, aux) = item
    if mode == "fast_huff":
        # Asynchronous drain: the fast_huff finisher makes 4 cost/select
        # device round trips plus the emit (host heap refinement between
        # each), so running it inline would serialize batch k's
        # refinement with batch k+2's dispatch.  Instead the finisher
        # runs on its own thread — its host-side waits (rfreq download,
        # native heaps) overlap the driver's next sort/MTF dispatch —
        # and per-block futures land in ``results`` immediately so the
        # assembler can wait on exactly the blocks it needs.  A 3-slot
        # semaphore bounds in-flight finishers (device arrays they hold
        # alive: the two running plus one queued), restoring the old
        # blocking behavior under backlog.
        from concurrent.futures import Future

        pool, slots = _huff_pool()
        slots.acquire()
        futs = {key: Future() for key in chunk}
        for key, f in futs.items():
            results[key] = f

        def finish():
            try:
                local: dict = {}
                _drain_fast_huff(
                    local, per_stream_blocks, chunk, out_d, aux, n_max
                )
            except BaseException as e:
                for f in futs.values():
                    f.set_exception(e)
            else:
                for key, f in futs.items():
                    f.set_result(local[key])
                if on_done is not None:
                    on_done()
            finally:
                slots.release()

        pool.submit(finish)
        return
    if mode == "fast" and aux.get("bits") in (4, 5, 6) and "lens" in aux:
        out = np.asarray(out_d)  # one transfer for the whole batch
        for i, ((si, bi), used) in enumerate(zip(chunk, aux["useds"])):
            if int(out[i, 1]) == 0:  # ties == 0
                results[(si, bi)] = _tail_pool().submit(
                    _fragment_from_ranks_row,
                    out[i], used, per_stream_blocks[si][bi].crc,
                    int(aux["lens"][i]), aux["bits"],
                )
                _count("blocks_device")
            else:
                from starch3_tpu.codec.encoder import encode_block_fragment

                results[(si, bi)] = encode_block_fragment(
                    per_stream_blocks[si][bi]
                )
                _count("blocks_tie_fallback")
        if on_done is not None:
            on_done()
        return
    if mode == "fast":
        out = np.asarray(out_d)  # one transfer for the whole batch
        for i, ((si, bi), used) in enumerate(zip(chunk, aux["useds"])):
            if int(out[i, 2]) == 0:  # ties == 0
                # symbol unpacking + the per-block tail (native Huffman
                # + serialization) run on a side executor so the drain
                # thread goes straight back to waiting on the device;
                # assembly resolves the futures in stream order
                results[(si, bi)] = _tail_pool().submit(
                    _fragment_from_row,
                    out[i], aux["bits"], used,
                    per_stream_blocks[si][bi].crc,
                )
                _count("blocks_device")
            else:
                # ambiguous prefix order: re-encode exactly on the host
                # (rare: periodic/highly repetitive blocks only)
                from starch3_tpu.codec.encoder import encode_block_fragment

                results[(si, bi)] = encode_block_fragment(
                    per_stream_blocks[si][bi]
                )
                _count("blocks_tie_fallback")
        if on_done is not None:
            on_done()
        return
    unpacked = (
        _unpack_results_rle2(out_d, aux["b"])
        if mode == "rle2"
        else _unpack_results(out_d, aux["lens"], aux["b"], n_max)
    )
    for (si, bi), res in zip(chunk, unpacked):
        results[(si, bi)] = res
    _count("blocks_device", len(chunk))
    if on_done is not None:
        on_done()


def _drain_fast_huff(results, per_stream_blocks, chunk, handles, aux, n_max):
    """Finish a fast_huff batch: 4 device cost/select refinement rounds
    interleaved with host code-length heaps (the only sequential part of
    bzip2's sendMTFValues, reference compress.c:239-600 via the bundled
    tarball), then one device bit-pack emit; the host writes only block
    headers and splices the packed words.  Any block with sort ties or
    an emit overflow falls back to the host encoder (bytes identical)."""
    from starch3_tpu.codec import huffman
    from starch3_tpu.codec.encoder import encode_block_fragment, write_block_header
    from starch3_tpu.ops.huff_jax import ALPHA_MAX, GROUP_SIZE

    small_d, syms_d, m_d, hist_d = handles
    b = aux["b"]
    small = np.asarray(small_d)
    ptrs = small[:, 0]
    ms = small[:, 1]
    ties = small[:, 2]
    freqs = small[:, 3:263]
    b_pad = small.shape[0]

    # host: initial tables + refinement bookkeeping (padded to 6 tables)
    lens = np.zeros((b_pad, 6, ALPHA_MAX), dtype=np.int32)
    masks = np.zeros((b_pad, 6), dtype=bool)
    n_groups = np.zeros(b_pad, dtype=np.int64)
    alphas = np.zeros(b_pad, dtype=np.int64)
    for i in range(b):
        used = aux["useds"][i]
        alpha = int(used.sum()) + 2
        m = int(ms[i])
        ng = huffman.n_groups_for(m)
        init = huffman.initial_lengths(freqs[i][:alpha].astype(np.int64), alpha, m)
        lens[i, :ng, :alpha] = init
        lens[i, :ng, alpha:] = huffman.GREATER_ICOST
        masks[i, :ng] = True
        n_groups[i] = ng
        alphas[i] = alpha
    masks[b:, 0] = True  # padding rows: keep argmin well-defined

    from starch3_tpu.runtime import refine_lengths_batch_native

    cost_select = _jitted_cost_select()
    sel_d = None
    for _ in range(huffman.N_ITERS):
        # numpy args go straight to the jitted call: jit stages them
        # itself, and an explicit jnp.asarray is a redundant host copy
        sel_d, rfreq_d = cost_select(hist_d, lens, masks)
        rfreq = np.asarray(rfreq_d)
        # one native call per iteration covers every (block, table) heap
        rfreq64 = np.ascontiguousarray(rfreq[:b], dtype=np.int64)
        if not refine_lengths_batch_native(rfreq64, n_groups[:b], alphas[:b], lens):
            for i in range(b):
                alpha = int(alphas[i])
                for t in range(int(n_groups[i])):
                    lens[i, t, :alpha] = huffman.make_code_lengths(
                        rfreq[i, t, :alpha].astype(np.int64), alpha
                    )

    # canonical codes -> packed (code << 5) | len LUT per block
    luts = np.zeros((b_pad, 6 * ALPHA_MAX), dtype=np.int32)
    for i in range(b):
        alpha = int(alphas[i])
        for t in range(int(n_groups[i])):
            codes = huffman.assign_codes(lens[i, t, :alpha].astype(np.int64))
            luts[i, t * ALPHA_MAX : t * ALPHA_MAX + alpha] = (
                codes.astype(np.int64) << 5
            ) | lens[i, t, :alpha]

    words_d, totals_d = _jitted_emit_coded(n_max)(syms_d, m_d, sel_d, luts)
    totals = np.asarray(totals_d)
    w_cap = _emit_w_cap(n_max)
    # bucketed-prefix downloads (see _jitted_batch_head): only the
    # occupied columns of sel (n_sel ~ m/50) and words (~coded size)
    # cross the link, not the padded caps
    n_sel_need = max((int(ms[i]) + GROUP_SIZE - 1) // GROUP_SIZE for i in range(b))
    sel = np.asarray(
        _jitted_batch_head(_dl_bucket(n_sel_need, sel_d.shape[1], 1024))(sel_d)
    )
    w_need = max(
        (min(int(totals[i]), 32 * w_cap) + 31) // 32 for i in range(b)
    )
    words = np.asarray(_jitted_batch_head(_dl_bucket(w_need, w_cap))(words_d))

    for i, (si, bi) in enumerate(chunk):
        m = int(ms[i])
        total = int(totals[i])
        if int(ties[i]) != 0 or total > 32 * w_cap:
            results[(si, bi)] = encode_block_fragment(per_stream_blocks[si][bi])
            _count("blocks_tie_fallback")
            continue
        _count("blocks_device")
        blk = per_stream_blocks[si][bi]
        n_sel = (m + GROUP_SIZE - 1) // GROUP_SIZE
        selectors = sel[i, :n_sel].astype(np.int64)
        alpha = int(alphas[i])
        ng = int(n_groups[i])
        # header serialization: one native call (selector MTF + unary +
        # delta-coded tables inside) — the Python BitWriter header was
        # 82% of this drain's host residue
        from starch3_tpu.runtime import (
            selector_mtf_native,
            write_block_header_native,
        )

        hdr = write_block_header_native(
            blk.crc, int(ptrs[i]), aux["useds"][i],
            lens[i, :ng, :alpha], selectors,
        )
        frag = BitWriter()
        if hdr is not None:
            hdr_bytes, hdr_acc, hdr_nbits = hdr
            frag._out += hdr_bytes
            frag._acc = hdr_acc
            frag._nbits = hdr_nbits
        else:
            # Python path (no native lib)
            sel_mtf = selector_mtf_native(selectors)
            if sel_mtf is None:
                pos = list(range(ng))
                sel_mtf = np.empty(n_sel, dtype=np.int64)
                for k, s in enumerate(selectors.tolist()):
                    j = pos.index(s)
                    sel_mtf[k] = j
                    pos.pop(j)
                    pos.insert(0, s)
            write_block_header(
                frag,
                blk.crc,
                int(ptrs[i]),
                aux["useds"][i],
                ng,
                lens[i, :ng, :alpha].astype(np.int64),
                sel_mtf,
            )
        # splice the device-packed words: whole bytes + a <8-bit tail
        raw = words[i, : (total + 31) // 32].astype(">u4").tobytes()
        full_bytes = total // 8
        tail_bits = total % 8
        dev = BitWriter()
        dev._out += raw[:full_bytes]
        if tail_bits:
            dev._acc = raw[full_bytes] >> (8 - tail_bits)
            dev._nbits = tail_bits
        frag.append_writer(dev)
        results[(si, bi)] = frag


_TAIL_POOL = None
_HUFF_POOL = None
_HUFF_SLOTS = None


def _tail_pool():
    """Shared executor for per-block tail encodes (the native entry
    releases the GIL, so these overlap device transfers).  Width
    defaults to 2; STARCH3_TPU_TAIL_WORKERS overrides it — both to scale
    up on big hosts and to throttle to 1 for the devices-outnumber-cores
    crossover experiment (bench.py --huff-worker)."""
    global _TAIL_POOL
    if _TAIL_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        width = max(1, int(os.environ.get("STARCH3_TPU_TAIL_WORKERS", "2") or 2))
        _TAIL_POOL = ThreadPoolExecutor(width, thread_name_prefix="s3tail")
    return _TAIL_POOL


def _huff_pool():
    """Finisher executor for fast_huff batches plus its in-flight bound
    (see _drain_into).  Two threads so consecutive batches' refinement
    round trips overlap — each finisher's 4 cost/select trips are
    inherently sequential (host heaps between device steps), so on
    high-latency links a second in-flight refinement doubles the
    dispatch-RTT throughput; results stay per-block deterministic."""
    global _HUFF_POOL, _HUFF_SLOTS
    if _HUFF_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _HUFF_POOL = ThreadPoolExecutor(2, thread_name_prefix="s3huff")
        _HUFF_SLOTS = threading.Semaphore(3)
    return _HUFF_POOL, _HUFF_SLOTS


def _unpack_ranks_row(row, n, bits=4):
    """MTF ranks uint8[n] from a packed-ranks result row [ptr, ties,
    packed ranks] — nibble-packed for bits==4 (_jitted_fused_step_ranks4),
    30//bits ranks per word for bits 5/6 (_jitted_fused_step_ranks_mid)."""
    if bits == 4:
        by = np.ascontiguousarray(row[2:], dtype="<i4").view(np.uint8)
        ranks = np.empty(by.size * 2, dtype=np.uint8)
        ranks[0::2] = by & 0xF
        ranks[1::2] = by >> 4
    else:
        spw = 30 // bits
        mask = (1 << bits) - 1
        packed = np.ascontiguousarray(row[2:], dtype="<i4").view(np.uint32)
        ranks = np.empty(packed.size * spw, dtype=np.uint8)
        for k in range(spw):
            ranks[k::spw] = (packed >> (bits * k)) & mask
    return ranks[:n]


def _fragment_from_ranks_row(row, used, crc, n, bits=4):
    """One block's bitstream fragment from a packed-ranks result row
    (_unpack_ranks_row).  RLE2 + Huffman + serialization run natively
    here (tail pool)."""
    from starch3_tpu.codec.encoder import write_block_from_device_syms
    from starch3_tpu.codec.mtf import mtf_rle2_from_ranks

    mtf = mtf_rle2_from_ranks(_unpack_ranks_row(row, n, bits), used)
    frag = BitWriter()
    write_block_from_device_syms(frag, crc, int(row[0]), mtf.symbols, mtf.freq, used)
    return frag


def _fragment_from_row(row, bits, used, crc):
    """One block's bitstream fragment from a packed result row:
    [ptr, m, ties, freq[260], packed syms] (see _jitted_fused_step_fast)."""
    from starch3_tpu.codec.encoder import write_block_from_device_syms

    ptr, m = int(row[0]), int(row[1])
    freq = row[3:263]
    packed = row[263:]
    spw, sb, mask = (6, 5, 31) if bits == 4 else (2, 16, 0xFFFF)
    syms = np.empty(packed.size * spw, dtype=np.int32)
    for k in range(spw):
        syms[k::spw] = (packed >> (sb * k)) & mask
    frag = BitWriter()
    write_block_from_device_syms(frag, crc, ptr, syms[:m], freq, used)
    return frag


def jax_bz2_compress(data: bytes, config=None, mesh=None, n_max: int | None = None) -> bytes:
    """bzip2-compatible compression with the heavy stages on device."""
    level = config.block_size_100k if config is not None else 9
    batch_size = getattr(config, "blocks_per_batch", 3) if config else 3
    return encode_streams(
        [data],
        level=level,
        mesh=mesh,
        batch_size=batch_size,
        device_rle2=getattr(config, "device_rle2", False),
        fast_bwt=getattr(config, "fast_bwt", True),
        device_huffman=getattr(config, "device_huffman", False),
    )[0].data


def _dispatch_chunk(block_datas, n_max, mesh, mode="ranks", pad_to=None):
    """Upload + launch one batch asynchronously; returns device handles.

    ``n_max`` is either a geometry int (legacy callers: the batch's bit
    width is then auto-detected batch-wide) or a ``(n_max, bits_class)``
    bucket key from the queue, in which case the batch is homogeneous
    and dispatches straight onto its class's compiled program.

    ``pad_to`` pads the batch axis to a fixed size so every dispatch in
    a run reuses ONE compiled program per (bucket, mode) — a partial
    final batch would otherwise compile a whole second geometry (seconds
    to minutes in a process whose persistent compilation cache is cold,
    see starch3_tpu/compile_cache.py)."""
    import jax
    import jax.numpy as jnp

    from starch3_tpu.parallel.mesh import block_sharding, pad_batch

    bits_class = None
    if isinstance(n_max, tuple):
        n_max, bits_class = n_max

    b = len(block_datas)
    n_dev = mesh.devices.size if mesh is not None else 1
    b_pad = pad_batch(max(b, pad_to or 0), n_dev)
    lens = np.ones(b_pad, dtype=np.int32)
    batch = np.zeros((b_pad, n_max), dtype=np.uint8)

    if mode == "fast" and bits_class in (5, 6):
        # mid-width tier: dense remap + word pack (30//bits symbols per
        # uint32), native single pass with a NumPy fallback
        from starch3_tpu.runtime import dense_pack_words_native

        spw = 30 // bits_class
        n_words = (n_max + spw - 1) // spw
        words = np.zeros((b_pad, n_words), dtype=np.uint32)
        useds = []
        for i, data in enumerate(block_datas):
            arr = np.frombuffer(data, dtype=np.uint8)
            if arr.size > n_max:
                raise ValueError(f"block {i} exceeds n_max ({arr.size} > {n_max})")
            lens[i] = arr.size
            res = dense_pack_words_native(arr, bits_class, words[i])
            if res is None:
                used = np.bincount(arr, minlength=256) > 0
                syms = (np.cumsum(used) - 1).astype(np.uint32)[arr]
                syms.resize(n_words * spw)
                sp = syms.reshape(n_words, spw)
                w = sp[:, 0].copy()
                for k in range(1, spw):
                    w |= sp[:, k] << (bits_class * k)
                words[i] = w
                useds.append(used)
            else:
                useds.append(res[1])
        arrays = _put_batch((words.view(np.int32), lens), mesh)
        out_d = _jitted_fused_step_ranks_mid(n_max, bits_class, mesh)(*arrays)
        _copy_to_host_async(out_d)
        return out_d, {"b": b, "useds": useds, "bits": bits_class, "lens": lens}

    if mode in ("fast", "fast_huff"):
        from starch3_tpu.runtime import dense_pack4_native

        nsyms = np.ones(b_pad, dtype=np.int32)
        useds = []
        # bits==4 prologue (optimistic when the class is unknown): one
        # native pass per block does the dense remap AND the
        # 2-symbols-per-byte upload pack (half the upload bytes); falls
        # back to the NumPy chain for
        # >16-symbol alphabets or without the native lib
        bits = 4 if bits_class in (None, 4) else 0
        if bits == 4:
            packed = np.zeros((b_pad, n_max // 2), dtype=np.uint8)
            for i, data in enumerate(block_datas):
                arr = np.frombuffer(data, dtype=np.uint8)
                if arr.size > n_max:
                    raise ValueError(f"block {i} exceeds n_max ({arr.size} > {n_max})")
                lens[i] = arr.size
                res = dense_pack4_native(arr, packed[i])
                if res is None or res[0] > 16:
                    bits = 0  # decide below on the generic path
                    break
                nsyms[i] = res[0]
                useds.append(res[1])
        if bits == 4:
            batch = packed
        else:
            nsyms = np.ones(b_pad, dtype=np.int32)
            useds = []
            for i, data in enumerate(block_datas):
                arr = np.frombuffer(data, dtype=np.uint8)
                used = np.bincount(arr, minlength=256) > 0
                u2s = (np.cumsum(used) - 1).astype(np.uint8)
                batch[i, : arr.size] = u2s[arr]
                lens[i] = arr.size
                nsyms[i] = int(used.sum())
                useds.append(used)
            # key pack width: 4 bits buys 23 symbols of sort context
            # (dense alphabet <= 16, the common case for transformed
            # BED), 8 bits handles any byte content at 16 symbols
            bits = 4 if nsyms[:b].max() <= 16 else 8
            if bits == 4:
                batch = batch[:, 0::2] | (batch[:, 1::2] << 4)
        arrays = _put_batch((batch, lens, nsyms), mesh)
        if mode == "fast_huff":
            small_d, syms_d = _jitted_fused_step_fast2(n_max, bits, mesh)(
                *arrays
            )
            # group histograms launch immediately so they overlap the
            # next batch's upload; m rides along on device
            m_d = small_d[:, 1]
            hist_d = _jitted_group_hist(n_max)(syms_d, m_d)
            _copy_to_host_async(small_d)
            return (small_d, syms_d, m_d, hist_d), {"b": b, "useds": useds}
        if bits == 4:
            # 3-operand sort + width-16 MTF; RLE2 is host-native on the
            # downloaded nibble-packed ranks
            out_d = _jitted_fused_step_ranks4(n_max, mesh)(
                arrays[0], arrays[1]
            )
            _copy_to_host_async(out_d)
            return out_d, {"b": b, "useds": useds, "bits": 4, "lens": lens}
        out_d = _jitted_fused_step_fast(n_max, bits, mesh)(*arrays)
        # start the D2H transfer now: the drain's np.asarray would
        # otherwise block the driver thread for the whole batch
        # turnaround (compute + download), stalling the next dispatch
        _copy_to_host_async(out_d)
        return out_d, {"b": b, "useds": useds, "bits": bits}

    for i, data in enumerate(block_datas):
        arr = np.frombuffer(data, dtype=np.uint8)
        if arr.size > n_max:
            raise ValueError(f"block {i} exceeds n_max ({arr.size} > {n_max})")
        batch[i, : arr.size] = arr
        lens[i] = arr.size
    batch_d, lens_d = _put_batch((batch, lens), mesh)
    step = (
        _jitted_fused_step_rle2(n_max, mesh)
        if mode == "rle2"
        else _jitted_fused_step(n_max, mesh)
    )
    out_d = step(batch_d, lens_d)
    _copy_to_host_async(out_d)
    return out_d, {"b": b, "lens": lens}


def _copy_to_host_async(arr) -> None:
    """Enqueue the device->host copy behind the computation that
    produces ``arr`` (PJRT orders it after the producing program), so a
    later np.asarray finds the bytes already on their way."""
    try:
        arr.copy_to_host_async()
    except Exception:
        pass  # backend without async copies: the drain fetch blocks


def _put_batch(arrays, mesh):
    """Upload a tuple of batch-leading arrays, sharded when meshed."""
    import jax
    import jax.numpy as jnp

    from starch3_tpu.parallel.mesh import block_sharding

    if mesh is not None:
        sharding = block_sharding(mesh)
        return tuple(jax.device_put(jnp.asarray(a), sharding) for a in arrays)
    return tuple(jnp.asarray(a) for a in arrays)


# ---------------------------------------------------------------------------
# Device decode: the mirror pipeline.  Host walks each stream's bit
# stream down to Huffman-decoded symbols (codec/decoder.read_block_symbols
# — bit positions are inherently sequential), the device runs
# irle2 -> imtf -> ibwt batched over all streams' blocks, the host
# finishes with RLE1 inversion + CRC verification.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _jitted_device_decode_step(n_max: int):
    import jax
    import jax.numpy as jnp

    from starch3_tpu.ops.ibwt_jax import ibwt_padded
    from starch3_tpu.ops.imtf_jax import imtf_decode_padded
    from starch3_tpu.ops.irle2_jax import irle2_decode_padded

    def one(syms, m, alphabet, ptr):
        ranks, n = irle2_decode_padded(syms, m, n_max, n_max)
        n_c = jnp.minimum(n, n_max)  # corrupt streams: host re-validates n
        byts = imtf_decode_padded(ranks, n_c, alphabet, n_max)
        block = ibwt_padded(byts.astype(jnp.uint8), ptr, n_c, n_max)
        return block, n

    def step(syms_b, m_b, alpha_b, ptr_b):
        return jax.vmap(one)(syms_b, m_b, alpha_b, ptr_b)

    return jax.jit(step)


def _rle2_decoded_len(syms: np.ndarray) -> int:
    """Decoded byte count of an RLE2 symbol stream (EOB stripped) — the
    host-side twin of the contribution sum in ops/irle2_jax.py; used to
    pick the geometry bucket and validate before dispatch."""
    if syms.size == 0:
        return 0
    is_run = syms <= 1
    t = np.arange(syms.size, dtype=np.int64)
    starts = is_run & np.concatenate([[True], ~is_run[:-1]])
    start_pos = np.maximum.accumulate(np.where(starts, t, -1))
    k = np.minimum(t - start_pos, 21)
    contrib = np.where(is_run, (syms.astype(np.int64) + 1) << k, 1)
    return int(contrib.sum())


def decode_streams(
    stream_datas: list[bytes], mesh=None, batch_size: int = 8
) -> list[bytes]:
    """Decompress many bzip2 streams with one global device queue.

    The decode mirror of encode_streams: all streams' blocks share
    geometry-bucketed batches with two-deep software pipelining;
    output bytes are identical to the host decoder's (FormatError on any
    corruption, including CRC mismatches).
    """
    from starch3_tpu.codec.bitio import BitReader
    from starch3_tpu.codec.decoder import BLOCK_MAGIC, read_block_symbols
    from starch3_tpu.codec.rle1 import rle1_decode
    from starch3_tpu.errors import FormatError

    per_stream: list[tuple[list, int]] = []  # ([block dicts], stored_crc)
    flat: list[tuple[int, int]] = []
    for si, stream in enumerate(stream_datas):
        if len(stream) < 4 or stream[:3] != b"BZh":
            raise FormatError("bzip2: bad stream header")
        level = stream[3] - 0x30
        if not 1 <= level <= 9:
            raise FormatError("bzip2: bad block-size digit")
        max_block = 100_000 * level + 64
        from starch3_tpu.runtime import read_block_symbols_native

        br = BitReader(stream)
        br.read(32)
        blocks = []
        while True:
            magic_pos = br.bit_pos
            magic = br.read(48)
            if magic == STREAM_END_MAGIC:
                stored = br.read(32)
                break
            if magic != BLOCK_MAGIC:
                raise FormatError("bzip2: bad block magic")
            # the per-symbol Huffman walk is the host-sequential half of
            # device decode; the native entry is ~40x the Python bit loop
            try:
                native = read_block_symbols_native(stream, magic_pos, level)
            except ValueError as e:
                raise FormatError(str(e)) from None
            if native is not None:
                crc, ptr, in_use, symbols, next_pos, randomised = native
                br._pos = next_pos
            else:
                crc, ptr, in_use, symbols, randomised = read_block_symbols(br)
            n_exp = _rle2_decoded_len(np.asarray(symbols))
            if not 0 < n_exp <= max_block or ptr >= n_exp:
                raise FormatError("bzip2: bad block geometry")
            flat.append((si, len(blocks)))
            blocks.append(
                (crc, ptr, in_use, np.asarray(symbols), n_exp, randomised)
            )
        per_stream.append((blocks, stored))

    by_bucket: dict[int, list[tuple[int, int]]] = {}
    for si, bi in flat:
        by_bucket.setdefault(
            _bucket_for(per_stream[si][0][bi][4]), []
        ).append((si, bi))

    decoded: dict[tuple[int, int], bytes] = {}
    for n_max, items in by_bucket.items():
        pending = []
        for lo in range(0, len(items), batch_size):
            chunk = items[lo : lo + batch_size]
            pending.append(
                (chunk, _dispatch_decode_chunk(
                    [per_stream[si][0][bi] for si, bi in chunk], n_max, mesh
                ))
            )
            if len(pending) > 1:
                _drain_decode(decoded, per_stream, pending.pop(0))
        while pending:
            _drain_decode(decoded, per_stream, pending.pop(0))

    out = []
    for si, (blocks, stored) in enumerate(per_stream):
        combined = 0
        parts = []
        for bi, (crc, *_rest) in enumerate(blocks):
            data = rle1_decode(decoded[(si, bi)])
            from starch3_tpu.codec.crc32 import crc32_bytes

            if crc32_bytes(data) != crc:
                raise FormatError("bzip2: block CRC mismatch")
            combined = combine_block_crc(combined, crc)
            parts.append(data)
        if combined != stored:
            raise FormatError("bzip2: stream CRC mismatch")
        out.append(b"".join(parts))
    return out


def _dispatch_decode_chunk(block_metas, n_max, mesh):
    import jax
    import jax.numpy as jnp

    from starch3_tpu.parallel.mesh import block_sharding, pad_batch

    b = len(block_metas)
    n_dev = mesh.devices.size if mesh is not None else 1
    b_pad = pad_batch(b, n_dev)
    syms = np.zeros((b_pad, n_max), dtype=np.int32)
    ms = np.zeros(b_pad, dtype=np.int32)
    alphas = np.zeros((b_pad, 256), dtype=np.int32)
    ptrs = np.zeros(b_pad, dtype=np.int32)
    for i, (_crc, ptr, in_use, symbols, _n_exp, _rand) in enumerate(block_metas):
        syms[i, : symbols.size] = symbols
        ms[i] = symbols.size
        seq = np.flatnonzero(in_use)
        alphas[i, : seq.size] = seq
        ptrs[i] = ptr
    arrays = (syms, ms, alphas, ptrs)
    if mesh is not None:
        sharding = block_sharding(mesh)
        arrays = tuple(
            jax.device_put(jnp.asarray(a), sharding) for a in arrays
        )
    else:
        arrays = tuple(jnp.asarray(a) for a in arrays)
    blocks_d, n_d = _jitted_device_decode_step(n_max)(*arrays)
    return blocks_d, n_d, b


def _drain_decode(decoded, per_stream, item):
    from starch3_tpu.errors import FormatError

    chunk, (blocks_d, n_d, b) = item
    blocks = np.asarray(blocks_d)
    ns = np.asarray(n_d)
    for (si, bi), i in zip(chunk, range(b)):
        n_exp = per_stream[si][0][bi][4]
        if int(ns[i]) != n_exp:
            raise FormatError("bzip2: inconsistent block expansion")
        out_block = blocks[i, :n_exp]
        if per_stream[si][0][bi][5]:  # legacy randomised block
            from starch3_tpu.codec.randtable import derandomize

            out_block = derandomize(out_block)
        decoded[(si, bi)] = out_block.tobytes()
