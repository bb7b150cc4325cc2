"""Command-line interface.

Flag-for-flag parity with the reference CLI contract
(/root/reference/README.md:36-59 and src/main.cpp:26-51): mandatory -file,
one of -c/-d; optional -kmer-size, -abundance, -nb-cores, -lossless,
-seq-only, -noheader, -noqual, -verbose; -version/-v banner. GNU-style
single-dash long options are accepted exactly like the reference (GATB
OptionsParser grammar), plus the same flags with double dashes.
"""

from __future__ import annotations

import argparse
import json
import sys

import leon_tpu
from leon_tpu.config import LeonConfig


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="leon-tpu",
        description="leon-tpu: accelerator-native reference-free FASTA/FASTQ "
        "compressor (Leon-class: probabilistic de Bruijn graph in a Bloom filter)",
        add_help=False,
    )
    p.add_argument("-file", "--file", dest="file", help="input file (FASTA/FASTQ, optionally .gz)")
    p.add_argument("-c", "--compress", dest="compress", action="store_true", help="compress")
    p.add_argument("-d", "--decompress", dest="decompress", action="store_true", help="decompress")
    p.add_argument("-kmer-size", "--kmer-size", dest="kmer_size", type=int, default=31, help="k-mer size (default 31)")
    p.add_argument("-abundance", "--abundance", dest="abundance", type=int, default=None,
                   help="minimal abundance threshold for solid k-mers (default: automatic)")
    p.add_argument("-nb-cores", "--nb-cores", dest="nb_cores", type=int, default=0,
                   help="number of host cores (0 = all; device work is unaffected)")
    p.add_argument("-lossless", "--lossless", action="store_true", help="lossless quality compression")
    p.add_argument("-seq-only", "--seq-only", dest="seq_only", action="store_true",
                   help="store DNA sequence only (no header, no quality; decompress to FASTA)")
    p.add_argument("-noheader", "--noheader", action="store_true", help="do not store headers")
    p.add_argument("-noqual", "--noqual", action="store_true", help="do not store qualities")
    p.add_argument("-verbose", "--verbose", dest="verbose", type=int, default=1, help="verbosity level")
    p.add_argument("-test-file", "--test-file", dest="test_file", action="store_true",
                   help="after -c: decompress and diff against the input (reference INSTALL:22)")
    p.add_argument("-version", "-v", "--version", action="store_true", dest="version", help="version banner")
    p.add_argument("-h", "--help", action="help", help="show this help")
    return p


def main(argv: list[str] | None = None) -> int:
    from leon_tpu.utils import compile_cache

    # The reference is a single precompiled binary whose users pay no
    # warmup (/root/reference/src/main.cpp:44); the persistent XLA cache
    # is the JAX equivalent. JAX_PLATFORMS=cpu is the one backend switch.
    compile_cache.enable()
    args = _build_parser().parse_args(argv)

    if args.version:
        from leon_tpu.io import container as _c

        print(f"* leon-tpu version {leon_tpu.__version__} (container format v{_c.VERSION})")
        import jax

        print(f"* jax {jax.__version__}; devices: {[d.device_kind for d in jax.devices()]}")
        return 0

    if not args.file or args.compress == args.decompress:
        print("error: -file and exactly one of -c / -d are required", file=sys.stderr)
        return 1

    from leon_tpu import pipeline

    try:
        return _run(args)
    except (OSError, ValueError) as e:
        # reference behavior: catch and print, no traceback
        # (/root/reference/src/main.cpp:46-49)
        print(f"EXCEPTION: {e}", file=sys.stderr)
        return 1


def _run(args) -> int:
    from leon_tpu import pipeline

    cfg = LeonConfig(
        kmer_size=args.kmer_size,
        abundance=args.abundance,
        lossless=args.lossless,
        seq_only=args.seq_only,
        noheader=args.noheader,
        noqual=args.noqual,
        nb_cores=args.nb_cores or None,
        verbose=args.verbose,
    )
    if args.compress:
        stats = pipeline.compress(args.file, cfg=cfg)
        if args.verbose:
            print(json.dumps(stats, indent=2))
        if args.test_file:
            dstats = pipeline.decompress(stats["output"], cfg=cfg)
            ok, kind = roundtrip_ok(cfg, args.file, dstats["output"])
            print(f"* round-trip ({kind}-exact): {'OK' if ok else 'FAILED'}")
            return 0 if ok else 2
    else:
        stats = pipeline.decompress(args.file, cfg=cfg)
        if args.verbose:
            print(json.dumps(stats, indent=2))
    return 0


def roundtrip_ok(cfg: LeonConfig, src: str, decoded: str) -> tuple[bool, str]:
    """The -test-file oracle: byte-exact where the mode keeps every byte
    (lossless FASTQ, or FASTA with headers), else sequence-exact.
    Returns (ok, "byte" | "sequence")."""
    full = not (cfg.seq_only or cfg.noheader or cfg.noqual) and (
        cfg.lossless or _is_fasta(src)
    )
    if full:
        return _files_equal(src, decoded), "byte"
    return _seqs_equal(src, decoded), "sequence"


def _rd(p: str) -> bytes:
    import gzip

    from leon_tpu.io import bank

    out = []
    for m in bank.album_paths(p):  # composite banks: oracle is the concat
        if m.endswith(".gz"):
            with gzip.open(m, "rb") as f:
                out.append(f.read())
        else:
            with open(m, "rb") as f:
                out.append(f.read())
    return b"".join(out)


def _is_fasta(p: str) -> bool:
    from leon_tpu.io import bank

    return bank.sniff_format(p) == bank.FASTA


def _files_equal(a: str, b: str) -> bool:
    return _rd(a) == _rd(b)


def _seqs_equal(a: str, b: str) -> bool:
    """DNA-only oracle for modes that drop headers/qualities by design."""
    from leon_tpu.io import bank

    def seqs(p):
        return [s for blk in bank.read_blocks(p, 1 << 16) for s in blk.seqs]

    return seqs(a) == seqs(b)


if __name__ == "__main__":
    raise SystemExit(main())
