#!/usr/bin/env python3
"""Smoke run of the --jax encode/decode path on NVIDIA GPUs.

Drives the device path once, at full block width, through the entry
points a user calls, and checks every result exactly against the host
codec and libbz2.  Every phase raises on a failed check, and nothing
here catches it, so any failure exits non-zero with no result line.

  device       card, JAX version, compile cache, native host tier
  kernels      each tier's device step (bits 4/5/6/8, device Huffman)
               compiled at n_max=901,120 and run on real transformed
               blocks: BWT vs codec/bwt.py, MTF vs codec/mtf.py, and the
               finished block bits vs the host encoder
  encode       BASELINE config 2 (whole-genome BED3) through the CLI's
               --jax: archive == host path, streams == bz2.compress(., 9)
  corpora      config 3 (bits 5/6) and a >64-symbol BED (bits 8), same
  device-only  encode_streams(host_assist=False), plain and with device
               Huffman: the device must finish blocks, with no demotion
               and no abandoned batch after warm-up
  decode       --decode --jax, --decode --chrom=chr21, --list, and the
               device decode chain
  gpu tests    the gpu-marked tests, in this process

Usage (from the repository root, one process per card):

    python3 chip_smoke.py              # every phase above, on one GPU
    python3 chip_smoke.py --devices 4  # only the 4-GPU mesh encode/decode

The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import bz2
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import bench
from starch3_tpu.compile_cache import use_compile_cache

N_MAX = 901_120
BATCH = 3


class SmokeError(AssertionError):
    """A check of the smoke run failed."""


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------- corpora


def make_wide_alphabet_bed(n_lines: int = 80_000, seed: int = 8) -> bytes:
    """One chromosome of BED whose remainder column is random printable
    text: >64 distinct bytes, so its blocks take the bits==8 tier, and
    ~4 MB of transformed text, i.e. several full 900 kB blocks."""
    rng = np.random.default_rng(seed)
    starts = 10_000 + np.cumsum(rng.integers(1, 2000, n_lines))
    stops = starts + rng.integers(20, 500, n_lines)
    names = rng.integers(33, 127, (n_lines, 40), dtype=np.uint8)
    return b"".join(
        b"chr7\t%d\t%d\t%s\n" % (s, e, nm.tobytes())
        for s, e, nm in zip(starts.tolist(), stops.tolist(), names)
    )


def transformed_texts(bed: bytes) -> list[bytes]:
    from starch3_tpu.api import _parse_transform

    return [tf.text for tf in _parse_transform(bed)]


def full_blocks(texts: list[bytes], bits: int, count: int) -> list:
    """``count`` real RLE1 blocks of the given alphabet class, cut from
    the concatenated transformed texts (so they are full-size)."""
    from starch3_tpu.codec.rle1 import rle1_split_blocks
    from starch3_tpu.parallel.pipeline import _bits_class

    blocks = [
        b for b in rle1_split_blocks(b"".join(texts), 9)
        if _bits_class(len(set(b.data))) == bits
    ]
    check(len(blocks) >= count, f"corpus has {len(blocks)} bits=={bits} blocks")
    return blocks[:count]


# ---------------------------------------------------------------- device


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def phase_device(require_gpu: bool = True) -> dict:
    """Fails unless JAX's first device is a GPU (when ``require_gpu``)
    and the native host tier built; prints what the run ran on."""
    import jax

    from starch3_tpu.runtime import get_lib

    devs = jax.devices()
    d = devs[0]
    if require_gpu:
        check(d.platform == "gpu", f"JAX found no GPU (first device: {d.platform})")
        print(nvidia_smi_line(), flush=True)
    log("device", f"platform {d.platform}, device_kind {d.device_kind!r}, "
        f"{len(devs)} device(s), jax {jax.__version__}")
    log("device", f"compile cache: {use_compile_cache()}")
    check(get_lib() is not None, "native runtime did not build (no host tier)")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


# ---------------------------------------------------------------- kernels


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: none"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{k.replace('_size_in_bytes', '')}={getattr(ma, k)}"
        for k in keys if hasattr(ma, k)
    )


def _aot(tier: str, name: str, jitted, *specs) -> None:
    import jax

    specs = [jax.ShapeDtypeStruct(s, d) for s, d in specs]
    t0 = time.perf_counter()
    compiled = jitted.lower(*specs).compile()
    log("kernels", f"{tier} {name}: compile {time.perf_counter() - t0:.2f} s; "
        + _memory_line(compiled))


def _dense(blocks, n_max):
    """The dense inputs (int32[B, n_max]), their lengths, and per block
    the host references: dense BWT last column and pointer
    (codec/bwt.py) and MTF ranks (codec/mtf.py)."""
    from starch3_tpu.codec.bwt import bwt_best
    from starch3_tpu.codec.mtf import mtf_ranks, symbol_map

    b = len(blocks)
    dense = np.zeros((b, n_max), np.int32)
    lens = np.zeros(b, np.int32)
    refs = []
    for i, blk in enumerate(blocks):
        arr = np.frombuffer(blk.data, np.uint8)
        _, u2s, n_in = symbol_map(arr)
        dense[i, : arr.size] = u2s[arr]
        lens[i] = arr.size
        last, ptr = bwt_best(arr)
        dlast = u2s[last].astype(np.int32)
        refs.append((dlast, ptr, mtf_ranks(dlast, n_in)))
    return dense, lens, refs


def _check_sort(tier, sort_fn, dense, lens, refs, n_max):
    import jax
    import jax.numpy as jnp

    lasts, ptrs, ties = jax.jit(jax.vmap(sort_fn))(jnp.asarray(dense), jnp.asarray(lens))
    lasts, ptrs, ties = map(np.asarray, (lasts, ptrs, ties))
    for i, (dlast, ptr, _) in enumerate(refs):
        check(int(ties[i]) == 0, f"{tier}: block {i} sort ties")
        check(np.array_equal(lasts[i, : lens[i]], dlast), f"{tier}: block {i} BWT last column")
        check(int(ptrs[i]) == ptr, f"{tier}: block {i} BWT pointer")


def _run_tier(tier, blocks, mode, bits_class, n_max, batch):
    """Production dispatch + drain of one batch, then the warm time of
    the dispatch; returns the device rows, their aux and the per-block
    fragments."""
    import jax

    from starch3_tpu.parallel import pipeline

    datas = [b.data for b in blocks]
    key = (n_max, bits_class)
    out_d, aux = pipeline._dispatch_chunk(datas, key, None, mode, pad_to=batch)
    per_stream = [blocks]
    chunk = [(0, i) for i in range(len(blocks))]
    results: dict = {}
    pipeline._drain_into(results, per_stream, (chunk, (out_d, aux)), key, mode)
    frags = [results[k] for k in chunk]
    frags = [f.result() if hasattr(f, "result") else f for f in frags]
    reps, t0 = 3, time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(pipeline._dispatch_chunk(datas, key, None, mode, pad_to=batch)[0])
    dt = (time.perf_counter() - t0) / reps
    nbytes = sum(map(len, datas))
    log("kernels", f"{tier} device step: {dt * 1e3:.2f} ms per batch of "
        f"{len(blocks)} ({nbytes / dt / 1e6:.1f} MB/s of block bytes)")
    return out_d, aux, frags


def _check_frags(tier, blocks, frags):
    from starch3_tpu.codec.encoder import encode_block_fragment

    for i, (blk, f) in enumerate(zip(blocks, frags)):
        want = encode_block_fragment(blk)
        check((f.getvalue(), f.bit_length) == (want.getvalue(), want.bit_length),
              f"{tier}: block {i} bits differ from the host encoder")


def phase_kernels(corpora: dict, n_max: int = N_MAX, batch: int = BATCH) -> None:
    """Every tier's device step at ``n_max``: compile (seconds and
    memory analysis), run one batch of real transformed blocks, and
    compare exactly with the host codec."""
    import jax
    import jax.numpy as jnp

    from starch3_tpu.ops import bwt_fast
    from starch3_tpu.ops.mtf_jax import mtf_ranks
    from starch3_tpu.parallel import pipeline

    i32, u8 = jnp.int32, jnp.uint8
    for tier, bits in (("bits4", 4), ("bits5", 5), ("bits6", 6), ("bits8", 8), ("huff", 4)):
        blocks = full_blocks(corpora[bits], bits, batch)
        dense, lens, refs = _dense(blocks, n_max)
        if tier == "bits4":
            _aot(tier, "ranks4 step", pipeline._jitted_fused_step_ranks4(n_max),
                 ((batch, n_max // 2), u8), ((batch,), i32))
            sort_fn = lambda s, n: bwt_fast.bwt_sort_fast3(s, n, n_max)  # noqa: E731
        elif tier in ("bits5", "bits6"):
            n_words = -(-n_max // (30 // bits))
            _aot(tier, "mid step", pipeline._jitted_fused_step_ranks_mid(n_max, bits),
                 ((batch, n_words), i32), ((batch,), i32))
            sort_fn = lambda s, n, b=bits: bwt_fast.bwt_sort_fast_mid(s, n, n_max, b)  # noqa: E731
        else:
            up = (batch, n_max // 2) if bits == 4 else (batch, n_max)
            _aot(tier, "bwt+mtf step", pipeline._jitted_bwt_mtf_fast(n_max, bits),
                 (up, u8), ((batch,), i32))
            tail = (pipeline._jitted_rle2_raw(n_max) if tier == "huff"
                    else pipeline._jitted_rle2_pack(n_max, bits))
            _aot(tier, "rle2 step", tail, ((batch,), i32), ((batch,), i32),
                 ((batch, n_max), i32), ((batch,), i32), ((batch,), i32))
            sort_fn = lambda s, n, b=bits: bwt_fast.bwt_sort_fast(s, n, n_max, b)  # noqa: E731
        _check_sort(tier, sort_fn, dense, lens, refs, n_max)
        width = {4: 16, 5: 32, 6: 64, 8: 256}[bits]
        dlasts = np.zeros_like(dense)
        for i, (dlast, _, _) in enumerate(refs):
            dlasts[i, : lens[i]] = dlast
        got = np.asarray(mtf_ranks(jnp.asarray(dlasts), jnp.asarray(lens), n_max, width))
        mode = "fast_huff" if tier == "huff" else "fast"
        out_d, aux, frags = _run_tier(tier, blocks, mode, bits, n_max, batch)
        if bits in (4, 5, 6) and mode == "fast":
            out = np.asarray(out_d)
            for i, (_, ptr, ranks) in enumerate(refs):
                row_ranks = pipeline._unpack_ranks_row(out[i], int(lens[i]), bits)
                check(np.array_equal(row_ranks, ranks), f"{tier}: block {i} step ranks")
                check(int(out[i, 0]) == ptr, f"{tier}: block {i} step pointer")
        else:
            up = (dense[:, 0::2] | (dense[:, 1::2] << 4)) if bits == 4 else dense
            ptrs, _, step_ranks = pipeline._jitted_bwt_mtf_fast(n_max, bits)(
                jnp.asarray(up.astype(np.uint8)), jnp.asarray(lens))
            step_ranks, ptrs = np.asarray(step_ranks), np.asarray(ptrs)
            for i, (_, ptr, ranks) in enumerate(refs):
                check(np.array_equal(step_ranks[i, : lens[i]], ranks), f"{tier}: block {i} step ranks")
                check(int(ptrs[i]) == ptr, f"{tier}: block {i} step pointer")
        for i, (_, _, ranks) in enumerate(refs):
            check(np.array_equal(got[i, : lens[i]], ranks), f"{tier}: block {i} MTF ranks")
        _check_frags(tier, blocks, frags)
        log("kernels", f"{tier}: {len(blocks)} blocks of "
            f"{[len(b.data) for b in blocks]} bytes exact (BWT, MTF, block bits)")


# ---------------------------------------------------------------- encode


def _encode_cli(bed: bytes, tmp: str, name: str) -> tuple[bytes, float]:
    from starch3_tpu.cli import main as cli_main

    src = os.path.join(tmp, name + ".bed")
    dst = os.path.join(tmp, name + ".starch")
    with open(src, "wb") as f:
        f.write(bed)
    t0 = time.perf_counter()
    rc = cli_main(["--jax", "--output", dst, src])
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli --jax encode of {name} exited {rc}")
    with open(dst, "rb") as f:
        return f.read(), dt


def encode_and_compare(phase: str, name: str, bed: bytes, tmp: str) -> bytes:
    """CLI --jax encode (twice: cold, then warm) == host path, and every
    stream == bz2.compress(text, 9)."""
    from starch3_tpu.api import compress_bed_bytes
    from starch3_tpu.config import EncodeConfig
    from starch3_tpu.format.archive import StarchReader
    from starch3_tpu.parallel.pipeline import scheduler_stats

    archive, cold = _encode_cli(bed, tmp, name)
    before = dict(scheduler_stats)
    archive2, warm = _encode_cli(bed, tmp, name)
    blocks = {k: scheduler_stats[k] - before[k] for k in scheduler_stats}
    check(archive2 == archive, f"{name}: two --jax encodes differ")
    host = compress_bed_bytes(bed, EncodeConfig(use_jax=False))
    check(archive == host, f"{name}: --jax archive != host-path archive")
    reader = StarchReader.from_bytes(archive)
    texts = transformed_texts(bed)
    check(len(reader.metadata.streams) == len(texts), f"{name}: stream count")
    for meta, text in zip(reader.metadata.streams, texts):
        check(reader.stream_bytes(meta.chromosome) == bz2.compress(text, 9),
              f"{name}: {meta.chromosome} stream != bz2.compress(text, 9)")
    log(phase, f"{name}: {len(bed)} B BED -> {len(archive)} B archive; "
        f"cli --jax cold {cold:.2f} s, warm {warm:.2f} s "
        f"({len(bed) / warm / 1e6:.1f} MB/s of BED); == host path, "
        f"{len(texts)} streams == libbz2; warm-run scheduler {blocks}")
    return archive


# ---------------------------------------------------------------- device-only


def phase_device_only(texts: list[bytes]) -> None:
    """Pure-device lane: no stealers, no host fallback.  The device must
    finish blocks; after a warm-up encode no demotion or abandoned batch
    may occur."""
    from starch3_tpu.parallel import pipeline

    want = [bz2.compress(t, 9) for t in texts]
    prev = os.environ.get("STARCH3_TPU_NO_HOST_FALLBACK")
    os.environ["STARCH3_TPU_NO_HOST_FALLBACK"] = "1"
    try:
        for label, kw in (("fast", {}), ("device_huffman", {"device_huffman": True})):
            pipeline.encode_streams(texts, host_assist=False, **kw)  # warm-up
            before = dict(pipeline.scheduler_stats)
            t0 = time.perf_counter()
            got = pipeline.encode_streams(texts, host_assist=False, **kw)
            dt = time.perf_counter() - t0
            delta = {k: pipeline.scheduler_stats[k] - before[k] for k in before}
            check([s.data for s in got] == want, f"device-only {label}: streams != libbz2")
            log("device-only", f"{label}: {sum(map(len, texts)) / dt / 1e6:.1f} MB/s "
                f"of transformed text ({dt:.2f} s); scheduler {delta}")
            check(delta["blocks_device"] > 0, f"device-only {label}: device finished no block")
            check(delta["demotions"] == 0 and delta["abandoned_batches"] == 0,
                  f"device-only {label}: demotion or abandoned batch after warm-up")
    finally:
        if prev is None:
            os.environ.pop("STARCH3_TPU_NO_HOST_FALLBACK", None)
        else:
            os.environ["STARCH3_TPU_NO_HOST_FALLBACK"] = prev


# ---------------------------------------------------------------- decode


def phase_decode(bed: bytes, archive: bytes, tmp: str, chrom: str = "chr21") -> None:
    from starch3_tpu.api import decompress_starch_bytes
    from starch3_tpu.cli import main as cli_main

    arc = os.path.join(tmp, "decode.starch")
    out = os.path.join(tmp, "decode.bed")
    with open(arc, "wb") as f:
        f.write(archive)
    with contextlib.redirect_stderr(io.StringIO()):
        check(cli_main(["--decode", "--jax", "--output", out, arc]) == 0, "--decode --jax failed")
    with open(out, "rb") as f:
        check(f.read() == bed, "--decode --jax output != input")
    check(cli_main(["--decode", f"--chrom={chrom}", "--output", out, arc]) == 0, "--chrom failed")
    prefix = chrom.encode() + b"\t"
    want = b"".join(ln for ln in bed.splitlines(keepends=True) if ln.startswith(prefix))
    with open(out, "rb") as f:
        check(f.read() == want, f"--chrom={chrom} output != its lines")
    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        check(cli_main(["--list", arc]) == 0, "--list failed")
    rows = listing.getvalue().strip().splitlines()
    n_chroms = len({ln.split(b"\t", 1)[0] for ln in bed.splitlines()})
    check(len(rows) == n_chroms + 1, f"--list printed {len(rows)} lines")
    t0 = time.perf_counter()
    check(decompress_starch_bytes(archive, use_jax=True) == bed, "device decode != input")
    log("decode", f"--decode --jax, --chrom={chrom}, --list exact; device decode "
        f"chain {time.perf_counter() - t0:.2f} s (cold)")


# ---------------------------------------------------------------- gpu tests


def phase_gpu_tests() -> None:
    """The gpu-marked tests, in this process (which already holds the
    card; a second process could not reserve its memory)."""
    import pytest

    os.environ["STARCH3_TEST_GPU"] = "1"
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(root, "tests", "test_gpu.py")])
    check(rc == 0, f"gpu tests exited {rc}")


# ---------------------------------------------------------------- 4 devices


def phase_mesh(texts: list[bytes], n_devices: int) -> None:
    """encode_streams / decode_streams over a 1-D mesh of ``n_devices``:
    byte-equal to libbz2 and to the input, output sharded over all."""
    from starch3_tpu.parallel import pipeline
    from starch3_tpu.parallel.mesh import make_block_mesh

    mesh = make_block_mesh(n_devices)
    check(mesh.devices.size == n_devices, f"mesh has {mesh.devices.size} devices")
    datas = [t for t in texts if len(t) <= pipeline._N_MAX_BUCKETS[2]][:n_devices]
    out_d, _ = pipeline._dispatch_chunk(
        datas, (pipeline._bucket_for(max(map(len, datas))), 4), mesh, "fast",
        pad_to=n_devices)
    check(len(out_d.sharding.device_set) == n_devices,
          f"step output spans {len(out_d.sharding.device_set)} devices")
    want = [bz2.compress(t, 9) for t in texts]
    pipeline.encode_streams(texts[:n_devices], mesh=mesh, host_assist=False)  # warm-up
    t0 = time.perf_counter()
    got = [s.data for s in pipeline.encode_streams(texts, mesh=mesh, host_assist=False)]
    dt = time.perf_counter() - t0
    check(got == want, "mesh encode: streams != libbz2")
    t1 = time.perf_counter()
    back = pipeline.decode_streams(got, mesh=mesh)
    dt_dec = time.perf_counter() - t1
    check(back == texts, "mesh decode: output != input")
    log("mesh", f"{n_devices} devices: encode {len(texts)} streams "
        f"{sum(map(len, texts)) / dt / 1e6:.1f} MB/s of transformed text "
        f"({dt:.2f} s), decode {dt_dec:.2f} s; == libbz2 and input; "
        f"step output sharded over {n_devices} devices")


# ---------------------------------------------------------------- main


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_devices = 1
    if argv[:1] == ["--devices"] and len(argv) == 2:
        n_devices = int(argv[1])
    elif argv:
        print(__doc__, file=sys.stderr)
        return 2
    use_compile_cache()
    device = phase_device()
    if n_devices > 1:
        check(device["count"] >= n_devices, f"need {n_devices} GPUs, found {device['count']}")
        phase_mesh(transformed_texts(bench.make_genome_bed()), n_devices)
        print(json.dumps({"ok": True, "device": device}))
        return 0
    t0 = time.perf_counter()
    bed2 = bench.make_genome_bed()
    bed3 = bench.make_genome_bed_wide()
    bed8 = make_wide_alphabet_bed()
    texts2 = transformed_texts(bed2)
    corpora = {
        4: texts2,
        5: transformed_texts(bed3),
        6: transformed_texts(bench.make_genome_bed_bits6(n_per=4000)),
        8: transformed_texts(bed8),
    }
    log("corpora", f"generated in {time.perf_counter() - t0:.1f} s")
    phase_kernels(corpora)
    with tempfile.TemporaryDirectory() as tmp:
        archive2 = encode_and_compare("encode", "config2", bed2, tmp)
        encode_and_compare("corpora", "config3", bed3, tmp)
        encode_and_compare("corpora", "bits8", bed8, tmp)
        phase_device_only(texts2)
        phase_decode(bed2, archive2, tmp)
    phase_gpu_tests()
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
