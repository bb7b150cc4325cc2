"""CLI surface tests (reference contract: /root/reference/README.md:36-59
and src/main.cpp error handling)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


def run_cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "leon_tpu.cli", *args],
        env=ENV, capture_output=True, timeout=timeout,
    )


def test_version_banner():
    r = run_cli("-version")
    assert r.returncode == 0
    assert b"leon-tpu version" in r.stdout


def test_flag_validation():
    r = run_cli("-c")
    assert r.returncode == 1
    r = run_cli("-file", "x", "-c", "-d")
    assert r.returncode == 1


def test_missing_input_clean_error():
    r = run_cli("-file", "/nonexistent.fastq", "-c")
    assert r.returncode == 1
    assert b"EXCEPTION:" in r.stderr
    assert b"Traceback" not in r.stderr


def test_compress_decompress_testfile(tmp_path, rng):
    BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
    contig = rng.integers(0, 4, 400, dtype=np.uint8)
    src = tmp_path / "c.fasta"
    with open(src, "wb") as f:
        for i in range(60):
            st = int(rng.integers(0, 300))
            f.write(b">r%d\n%s\n" % (i, BASES[contig[st : st + 80]].tobytes()))
    r = run_cli("-file", str(src), "-c", "-kmer-size", "21", "-test-file", timeout=560)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert b"round-trip (byte-exact): OK" in r.stdout
    assert (tmp_path / "c.fasta.leon").exists()

    r = run_cli("-file", str(tmp_path / "c.fasta.leon"), "-d", timeout=560)
    assert r.returncode == 0
    assert open(tmp_path / "c.fasta.d", "rb").read() == open(src, "rb").read()
