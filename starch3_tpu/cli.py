"""Command-line interface, compatible with the reference ``starch3``.

Reference surface (reference src/starch3.cpp:72-274):
    starch3 [--note="foo bar baz"] [--bzip2 | --gzip] [input] > output
    -n/--note, -b/--bzip2, -g/--gzip, -h/--help, -v/--version
    - exactly one codec may be selected (src/starch3.cpp:159-163), bzip2
      is the default (:164-166);
    - input from a named file or stdin; a TTY stdin with no file is an
      error (starch3api.hpp:890-905, exit ENODATA);
    - archive goes to stdout (starch3api.hpp:765-769).

Fixed vs the reference (SURVEY.md §3.5): ``--version`` works (the
reference maps it to an unhandled 'w' and silently ignores it); gzip is
implemented instead of exiting ENOSYS.

Extensions (this framework is a full codec, not an encode-only scaffold):
    --decode/-d       archive -> BED on stdout
    --list            print the metadata table
    --output/-o FILE  write to a file instead of stdout
    --jax             run the heavy codec stages on the JAX backend
"""

from __future__ import annotations

import os
import stat
import sys

from starch3_tpu._version import __version__
from starch3_tpu.config import CompressionMethod, EncodeConfig
from starch3_tpu.errors import InputUnavailableError, OptionError, StarchError

PROG = "starch3-tpu"
AUTHORS = "starch3-tpu authors"

USAGE = f"""\
{PROG}
  version: {__version__}

  Usage:

  $ {PROG} [--note="foo bar baz"] [--bzip2 | --gzip] [input] > output

  Compresses sorted BED input into a Starch v2-style archive: magic bytes,
  independent per-chromosome compressed streams, JSON metadata, footer.
  Input is a named file or standard input; the archive goes to standard
  output (or --output FILE).

  Decode / inspect:

  --decode | -d           decompress an archive back to BED
  --decode --chrom=NAME   extract one chromosome (random access via the
                          metadata byte-offset index)
  --list                  print the per-chromosome metadata table

  Process Flags:

  --note="foo bar baz"    Append note to archive metadata (optional)
  --bzip2 | -b            Use bzip2 backend (default)
  --gzip | -g             Use gzip backend
  --gzip-level=N          gzip compression level 1..9 (default 6)
  --gzip-segment=BYTES    bytes of transformed text per gzip member;
                          larger streams split into independent members
                          indexed in metadata (default 4194304; 0 = one
                          member per stream)
  --output=FILE | -o      Write to FILE instead of stdout
  --jax                   Run the BWT and MTF stages on the JAX device
                          (a GPU); bytes identical either way
  --device-huffman        With --jax: run Huffman costing + bit packing
                          on device too (for hosts where devices
                          outnumber cores; bytes identical either way)
  --help | -h             Show this usage message
  --version | -v          Show binary version

  Multi-host (run one process per host; archives are byte-identical for
  any host count):

  --coordinator=HOST:PORT JAX distributed coordinator (host 0's address)
  --num-hosts=N           total number of processes
  --host-id=I             this process's id (0-based)
  --manifest-dir=DIR      shared directory transport / resume manifest
                          (without it, streams gather over the JAX
                          runtime's DCN collectives)
"""


def _parse_args(argv: list[str]) -> dict:
    opts = {
        "note": "",
        "method": None,
        "decode": False,
        "list": False,
        "output": None,
        "jax": False,
        "device_huffman": False,
        "chrom": None,
        "input": None,
        "coordinator": None,
        "num_hosts": None,
        "host_id": None,
        "manifest_dir": None,
        "gzip_level": None,
        "gzip_segment": None,
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("--help", "-h", "-?"):
            print(USAGE)
            raise SystemExit(0)
        if a in ("--version", "-v"):
            print(f"{PROG}: {__version__}")
            raise SystemExit(0)
        if a in ("--decode", "-d"):
            opts["decode"] = True
        elif a.startswith("--chrom="):
            opts["chrom"] = a[len("--chrom=") :]
        elif a == "--chrom":
            i += 1
            if i >= len(argv):
                raise OptionError("--chrom requires a value")
            opts["chrom"] = argv[i]
        elif a == "--list":
            opts["list"] = True
        elif a == "--jax":
            opts["jax"] = True
        elif a == "--device-huffman":
            opts["device_huffman"] = True
        elif a.startswith("--platform="):
            # explicit JAX platform choice (must run before backend init)
            plat = a[len("--platform=") :]
            import jax

            jax.config.update("jax_platforms", plat)
        elif a.startswith("--gzip-level="):
            lv = _int_opt(a[len("--gzip-level=") :], "--gzip-level")
            if not 1 <= lv <= 9:
                raise OptionError("--gzip-level must be 1..9")
            opts["gzip_level"] = lv
        elif a.startswith("--gzip-segment="):
            seg = _int_opt(a[len("--gzip-segment=") :], "--gzip-segment")
            if seg < 0:
                raise OptionError("--gzip-segment must be >= 0")
            opts["gzip_segment"] = seg
        elif a.startswith("--coordinator="):
            opts["coordinator"] = a[len("--coordinator=") :]
        elif a.startswith("--num-hosts="):
            opts["num_hosts"] = _int_opt(a[len("--num-hosts=") :], "--num-hosts")
        elif a.startswith("--host-id="):
            opts["host_id"] = _int_opt(a[len("--host-id=") :], "--host-id")
        elif a.startswith("--manifest-dir="):
            opts["manifest_dir"] = a[len("--manifest-dir=") :]
        elif a in ("--bzip2", "-b"):
            _set_method(opts, CompressionMethod.BZIP2)
        elif a in ("--gzip", "-g"):
            _set_method(opts, CompressionMethod.GZIP)
        elif a.startswith("--note="):
            opts["note"] = a[len("--note=") :]
        elif a in ("--note", "-n"):
            i += 1
            if i >= len(argv):
                raise OptionError("--note requires a value")
            opts["note"] = argv[i]
        elif a.startswith("--output="):
            opts["output"] = a[len("--output=") :]
        elif a in ("--output", "-o"):
            i += 1
            if i >= len(argv):
                raise OptionError("--output requires a value")
            opts["output"] = argv[i]
        elif a.startswith("-") and a != "-":
            raise OptionError(f"unknown option {a!r}")
        else:
            if opts["input"] is not None:
                raise OptionError("multiple input files given")
            opts["input"] = a
        i += 1
    return opts


def _int_opt(value: str, name: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise OptionError(f"{name} requires an integer value") from None


def _require_piped_stdin() -> None:
    """Refuse a TTY stdin, as the reference does (starch3api.hpp:890-905)."""
    mode = os.fstat(sys.stdin.fileno()).st_mode
    if not (stat.S_ISFIFO(mode) or stat.S_ISREG(mode)):
        raise InputUnavailableError(
            "no input stream available: pipe data in or name a file"
        )


def _set_method(opts: dict, m: CompressionMethod) -> None:
    if opts["method"] is not None and opts["method"] is not m:
        # the reference treats two codec flags as a fatal usage error
        # (src/starch3.cpp:159-163)
        raise OptionError("only one compression method may be selected")
    opts["method"] = m


def _read_input(path: str | None) -> bytes:
    if path is None or path == "-":
        _require_piped_stdin()
        return sys.stdin.buffer.read()
    if not os.path.exists(path):
        raise InputUnavailableError(f"input file {path!r} does not exist")
    with open(path, "rb") as f:
        return f.read()


def _stream_to_sink(output: str | None, produce) -> None:
    """Run a streaming producer into --output atomically (temp file +
    rename, so a failure never truncates an existing file) or stdout."""
    if not output:
        produce(sys.stdout.buffer)
        return
    tmp = output + ".tmp"
    try:
        with open(tmp, "wb") as f:
            produce(f)
        os.replace(tmp, output)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts = _parse_args(argv)
        if opts["jax"]:
            from starch3_tpu.compile_cache import use_compile_cache

            use_compile_cache()
        if opts["chrom"] and not opts["decode"]:
            raise OptionError("--chrom requires --decode")
        encode = not (opts["decode"] or opts["list"])
        if encode and (opts["num_hosts"] or 0) > 1:
            # multi-host encode: every process runs this same command
            # with its own --host-id; host 0 writes the archive
            from starch3_tpu.parallel.distributed import (
                compress_bed_bytes_multihost,
                initialize_distributed,
            )

            initialize_distributed(
                opts["coordinator"], opts["num_hosts"], opts["host_id"]
            )
            data = _read_input(opts["input"])
            config = EncodeConfig(
                note=opts["note"],
                method=opts["method"] or CompressionMethod.default(),
                use_jax=opts["jax"],
                device_huffman=opts["device_huffman"],
                gzip_level=opts["gzip_level"] or 6,
                **(
                    {"gzip_segment_bytes": opts["gzip_segment"]}
                    if opts["gzip_segment"] is not None
                    else {}
                ),
            )
            archive = compress_bed_bytes_multihost(
                data,
                config,
                num_hosts=opts["num_hosts"],
                host_id=opts["host_id"] or 0,
                manifest_dir=opts["manifest_dir"],
            )
            if (opts["host_id"] or 0) == 0:
                if opts["output"]:
                    with open(opts["output"], "wb") as f:
                        f.write(archive)
                else:
                    sys.stdout.buffer.write(archive)
            return 0
        if encode:
            # every encode streams chunk-by-chunk (constant memory in the
            # corpus size) straight to the sink — named files AND pipes
            # (the reference's producer is O(1)-memory on stdin too,
            # starch3api.hpp:158-199)
            from starch3_tpu.api import compress_bed_file, compress_bed_stream

            config = EncodeConfig(
                note=opts["note"],
                method=opts["method"] or CompressionMethod.default(),
                use_jax=opts["jax"],
                device_huffman=opts["device_huffman"],
                gzip_level=opts["gzip_level"] or 6,
                **(
                    {"gzip_segment_bytes": opts["gzip_segment"]}
                    if opts["gzip_segment"] is not None
                    else {}
                ),
            )
            if opts["input"] in (None, "-"):
                _require_piped_stdin()
                _stream_to_sink(
                    opts["output"],
                    lambda f: compress_bed_stream(sys.stdin.buffer, f, config),
                )
                return 0
            if not os.path.exists(opts["input"]):
                raise InputUnavailableError(
                    f"input file {opts['input']!r} does not exist"
                )
            _stream_to_sink(
                opts["output"], lambda f: compress_bed_file(opts["input"], f, config)
            )
            return 0
        if opts["decode"] and opts["jax"]:
            # Device decode exists (api.decompress_starch_bytes(use_jax=True))
            # but is measured far slower than the block-parallel native
            # decoder (docs/PERF.md "device decode"); the CLI always takes
            # the fast path and says so rather than silently degrading.
            print(
                "starch3: note: --jax applies to encode; decode uses the "
                "native block-parallel path (faster on all measured "
                "hardware)",
                file=sys.stderr,
            )
            opts["jax"] = False
        if (
            opts["decode"]
            and not opts["chrom"]
            and not opts["jax"]  # device decode runs via the bytes path
            and opts["input"] not in (None, "-")
        ):
            # named-file decode: windowed parallel streams written in order
            from starch3_tpu.api import decompress_starch_file

            if not os.path.exists(opts["input"]):
                raise InputUnavailableError(
                    f"input file {opts['input']!r} does not exist"
                )
            _stream_to_sink(
                opts["output"], lambda f: decompress_starch_file(opts["input"], f)
            )
            return 0
        data = _read_input(opts["input"])
        if opts["list"]:
            from starch3_tpu.api import list_chromosomes

            rows = list_chromosomes(data)
            cols = [
                "chromosome", "lineCount", "size", "uncompressedSize",
                "nonUniqueBaseCount", "uniqueBaseCount",
            ]
            print("\t".join(cols))
            for r in rows:
                print("\t".join(str(r[c]) for c in cols))
            return 0
        # only decode reaches here (encode and --list returned above)
        if opts["chrom"]:
            from starch3_tpu.api import extract_chromosome

            out = extract_chromosome(data, opts["chrom"])
        else:
            from starch3_tpu.api import decompress_starch_bytes

            out = decompress_starch_bytes(data, use_jax=opts["jax"])
        if opts["output"]:
            with open(opts["output"], "wb") as f:
                f.write(out)
        else:
            sys.stdout.buffer.write(out)
        return 0
    except StarchError as e:
        print(f"Error: {e}", file=sys.stderr)
        return e.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
