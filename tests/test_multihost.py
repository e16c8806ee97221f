"""Multi-host integration: separate OS processes, manifest handoff,
host-0 assembly (SURVEY.md §4 "multi-host tests without a cluster").

Each "host" is a real subprocess encoding its chromosome share and
persisting streams + manifest to a shared directory; the assembler then
builds the archive in input order.  Asserts the full multi-process
archive is byte-identical to the single-process one.
"""

import json
import subprocess
import sys

from starch3_tpu.api import compress_bed_bytes, decompress_starch_bytes

from tests.conftest import make_bed_text

WORKER = r"""
import sys, json, os, hashlib
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from starch3_tpu.bed.parser import parse_bed
from starch3_tpu.parallel.distributed import encode_corpus_multihost

host_id, n_hosts, bed_path, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
bed = open(bed_path, "rb").read()
blocks = parse_bed(bed)
results = encode_corpus_multihost(blocks, num_hosts=n_hosts, host_id=host_id)
manifest = {{}}
for chrom, (stream, stats) in results.items():
    path = os.path.join(out_dir, f"{{chrom}}.stream")
    open(path, "wb").write(stream)
    manifest[chrom] = {{"path": path, "stats": stats}}
open(os.path.join(out_dir, f"host{{host_id}}.json"), "w").write(json.dumps(manifest))
"""


def test_two_process_encode_matches_single(tmp_path, rng):
    bed = make_bed_text(rng, n=1200, chroms=("chr1", "chr2", "chr3", "chr4", "chrM"))
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo="/root/repo"))

    n_hosts = 2
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(h), str(n_hosts), str(bed_path), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for h in range(n_hosts)
    ]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()

    # host-0 assembly: gather manifests, order by input
    from starch3_tpu.bed.parser import parse_bed
    from starch3_tpu.parallel.assemble import assemble_ordered

    order = [b.chrom for b in parse_bed(bed)]
    results = {}
    for h in range(n_hosts):
        manifest = json.loads((tmp_path / f"host{h}.json").read_text())
        for chrom, entry in manifest.items():
            stream = open(entry["path"], "rb").read()
            results[chrom] = (stream, entry["stats"])
    assert set(results) == set(order)
    archive = assemble_ordered(order, results)

    assert archive == compress_bed_bytes(bed)
    assert decompress_starch_bytes(archive) == bed


JAX_WORKER = r"""
import sys, os
sys.path.insert(0, {repo!r})
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
host_id, n_hosts, port, bed_path, out_dir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
import jax
# the config knob as well as the env var: it wins over whatever
# platform the environment would pick
jax.config.update("jax_platforms", "cpu")
# CPU backend only becomes multi-process with a cross-host collectives
# impl; gloo is the jaxlib-bundled one
jax.config.update("jax_cpu_collectives_implementation", "gloo")
from starch3_tpu.parallel.distributed import (
    initialize_distributed, compress_bed_bytes_multihost)
initialize_distributed(f"127.0.0.1:{{port}}", n_hosts, host_id)
assert jax.process_count() == n_hosts
from starch3_tpu.parallel.mesh import make_block_mesh
from starch3_tpu.config import EncodeConfig
mesh = make_block_mesh(devices=jax.local_devices())
bed = open(bed_path, "rb").read()
archive = compress_bed_bytes_multihost(
    bed, EncodeConfig(use_jax=True), mesh=mesh)
open(os.path.join(out_dir, f"archive{{host_id}}.starch"), "wb").write(archive)
"""


def test_two_process_jax_distributed_gather(tmp_path, rng):
    """Real jax.distributed runtime: 2 processes x 4 virtual CPU devices,
    each encoding its chromosome share over its local mesh, per-stream
    bytes gathered with multihost_utils.process_allgather (the DCN path).
    Every process must end up with the identical, single-process-equal
    archive."""
    import socket

    bed = make_bed_text(rng, n=900, chroms=("chr1", "chr2", "chr3", "chrX"))
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    worker = tmp_path / "jworker.py"
    worker.write_text(JAX_WORKER.format(repo="/root/repo"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    n_hosts = 2
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(h), str(n_hosts), str(port),
             str(bed_path), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for h in range(n_hosts)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-3000:]

    single = compress_bed_bytes(bed)
    for h in range(n_hosts):
        archive = (tmp_path / f"archive{h}.starch").read_bytes()
        assert archive == single, f"host {h} archive differs"
    assert decompress_starch_bytes(single) == bed


def test_cli_multihost_manifest_dir(tmp_path, rng):
    """CLI-level multi-host invocation (no JAX runtime): one CLI process
    per host with --manifest-dir as the transport; host 0's stdout is the
    archive and matches the single-process CLI byte-for-byte."""
    bed = make_bed_text(rng, n=700, chroms=("chr1", "chr2", "chr3", "chr9", "chrM"))
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    mdir = tmp_path / "manifest"

    def run(host_id):
        return subprocess.Popen(
            [sys.executable, "-m", "starch3_tpu.cli",
             f"--num-hosts=2", f"--host-id={host_id}",
             f"--manifest-dir={mdir}", str(bed_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env={**__import__("os").environ, "PYTHONPATH": "/root/repo",
                 "JAX_PLATFORMS": "cpu"},
        )

    procs = [run(0), run(1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-3000:]
        outs.append(out)

    single = subprocess.run(
        [sys.executable, "-m", "starch3_tpu.cli", str(bed_path)],
        capture_output=True,
        env={**__import__("os").environ, "PYTHONPATH": "/root/repo",
             "JAX_PLATFORMS": "cpu"},
    )
    assert single.returncode == 0, single.stderr.decode()[-2000:]
    assert outs[0] == single.stdout  # host 0 writes the archive
    assert outs[1] == b""            # host 1 writes nothing
    assert decompress_starch_bytes(outs[0]) == bed


CRASH_WORKER = r"""
import sys, os
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
host_id, n_hosts, bed_path, mdir, crash_after = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]))
import starch3_tpu.api as api
calls = {{"n": 0}}
orig = api._compress_stream_ex
def counting(text, config, workers=None):
    if calls["n"] >= crash_after >= 0:
        os._exit(9)   # simulated mid-corpus crash: no cleanup, no flush
    calls["n"] += 1
    return orig(text, config, workers)
api._compress_stream_ex = counting  # distributed.py imports it at call time
import starch3_tpu.parallel.distributed as D
from starch3_tpu.bed.parser import parse_bed
bed = open(bed_path, "rb").read()
blocks = parse_bed(bed)
D.encode_corpus_multihost(blocks, num_hosts=n_hosts, host_id=host_id,
                          manifest_dir=mdir)
sys.stdout.write(str(calls["n"]))
"""


def test_interrupted_encode_resumes_from_manifest(tmp_path, rng):
    """Kill a worker mid-corpus (hard exit after 2 streams), rerun it,
    and assert the resume re-encodes ONLY the missing chromosomes and the
    final archive is byte-identical to the uninterrupted one."""
    chroms = ("chr1", "chr2", "chr3", "chr4", "chr5", "chr6")
    bed = make_bed_text(rng, n=900, chroms=chroms)
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    mdir = str(tmp_path / "manifest")
    worker = tmp_path / "cworker.py"
    worker.write_text(CRASH_WORKER.format(repo="/root/repo"))

    # single worker owns all 6 chromosomes; crashes after 2
    p = subprocess.run(
        [sys.executable, str(worker), "0", "1", str(bed_path), mdir, "2"],
        capture_output=True, timeout=120,
    )
    assert p.returncode == 9, p.stderr.decode()[-2000:]

    # resume: no crash (-1); must encode exactly the 4 missing chromosomes
    p = subprocess.run(
        [sys.executable, str(worker), "0", "1", str(bed_path), mdir, "-1"],
        capture_output=True, timeout=120,
    )
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert p.stdout.decode() == str(len(chroms) - 2), p.stdout

    from starch3_tpu.bed.parser import parse_bed
    from starch3_tpu.parallel.assemble import assemble_ordered
    from starch3_tpu.parallel.distributed import gather_results_manifest

    order = [b.chrom for b in parse_bed(bed)]
    results = gather_results_manifest(mdir, order, num_hosts=1, timeout_s=5)
    archive = assemble_ordered(order, results)
    assert archive == compress_bed_bytes(bed)
    assert decompress_starch_bytes(archive) == bed


SKEW_WORKER = r"""
import sys, os, json, tracemalloc
sys.path.insert(0, {repo!r})
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
host_id, n_hosts, port, bed_path, out_dir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
from starch3_tpu.parallel.distributed import (
    initialize_distributed, encode_corpus_multihost, gather_results_jax)
from starch3_tpu.bed.parser import parse_bed
initialize_distributed(f"127.0.0.1:{{port}}", n_hosts, host_id)
bed = open(bed_path, "rb").read()
blocks = parse_bed(bed)
order = [b.chrom for b in blocks]
results = encode_corpus_multihost(blocks, num_hosts=n_hosts, host_id=host_id)
gather_results_jax(results, order)  # warm-up: collective compile/trace
tracemalloc.start()
gathered = gather_results_jax(results, order)
_, peak = tracemalloc.get_traced_memory()
tracemalloc.stop()
total = sum(len(s) for s, _ in gathered.values())
from starch3_tpu.parallel.assemble import assemble_ordered
archive = assemble_ordered(order, gathered)
open(os.path.join(out_dir, f"skew{{host_id}}.starch"), "wb").write(archive)
open(os.path.join(out_dir, f"skew{{host_id}}.json"), "w").write(
    json.dumps({{"peak": peak, "total_streams": total}}))
"""


def test_gather_memory_bounded_with_skewed_streams(tmp_path, rng):
    """Deliberately skewed shares (one huge chromosome, several tiny
    ones): the ragged size-prefixed gather's python-side peak must stay
    O(archive), never the dense [n_chroms, max_stream, n_hosts] grid
    (round-2 transport: ~n_chroms x max x hosts; here that dense bound
    would be >= 6 x 2 x max_stream >> the asserted cap)."""
    import socket

    # chr1 dominates: ~50x the other chromosomes' stream sizes
    big = make_bed_text(rng, n=20000, chroms=("chr1",))
    small = make_bed_text(rng, n=400, chroms=("chr2", "chr3", "chr4", "chr5", "chrM"))
    bed = big + small
    bed_path = tmp_path / "in.bed"
    bed_path.write_bytes(bed)
    worker = tmp_path / "sworker.py"
    worker.write_text(SKEW_WORKER.format(repo="/root/repo"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    n_hosts = 2
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(h), str(n_hosts), str(port),
             str(bed_path), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for h in range(n_hosts)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-3000:]

    single = compress_bed_bytes(bed)
    stats = []
    for h in range(n_hosts):
        assert (tmp_path / f"skew{h}.starch").read_bytes() == single
        stats.append(json.loads((tmp_path / f"skew{h}.json").read_text()))
    for st in stats:
        # ragged transport: payload grid (hosts x max host payload) plus
        # the reassembled per-stream copies — comfortably O(archive).
        # Allow generous slack for allgather temporaries; the dense grid
        # this replaced would exceed this bound by an order of magnitude.
        assert st["peak"] < 8 * st["total_streams"] + (1 << 20), st


def test_device_huffman_forwarded_multihost(rng):
    """encode_corpus_multihost must forward device_huffman to the
    pipeline (round-2 dropped it) and stay byte-identical."""
    from starch3_tpu.bed.parser import parse_bed
    from starch3_tpu.config import EncodeConfig
    from starch3_tpu.parallel.assemble import assemble_ordered
    from starch3_tpu.parallel.distributed import encode_corpus_multihost

    bed = make_bed_text(rng, n=900, chroms=("chr1", "chr2"))
    blocks = parse_bed(bed)
    results = encode_corpus_multihost(
        blocks,
        config=EncodeConfig(use_jax=True, device_huffman=True),
        num_hosts=1,
        host_id=0,
    )
    order = [b.chrom for b in blocks]
    archive = assemble_ordered(order, {c: results[c] for c in order})
    assert archive == compress_bed_bytes(bed)
