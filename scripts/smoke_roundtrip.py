"""CPU round-trip smoke: byte-exact FASTA and lossless FASTQ on tiny
inputs, over 8 virtual CPU devices. Run from the repo root:
python scripts/smoke_roundtrip.py"""
import os, sys, tempfile
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from leon_tpu import pipeline
from leon_tpu.config import LeonConfig
from leon_tpu.utils import compile_cache

compile_cache.enable()

rng = np.random.default_rng(7)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

def make_fasta(path, n=150, contig_len=500, lmin=60, lmax=100):
    contig = rng.integers(0, 4, contig_len, dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n):
            ln = int(rng.integers(lmin, lmax + 1))
            st = int(rng.integers(0, contig_len - ln))
            r = contig[st : st + ln].copy()
            mut = rng.random(ln) < 0.01
            r[mut] = (r[mut] + rng.integers(1, 4, mut.sum())) & 3
            if rng.random() < 0.5:
                r = (3 - r)[::-1]
            f.write(b">read%d some description %d\n" % (i, st))
            f.write(BASES[r].tobytes() + b"\n")

def make_fastq(path, n=150, contig_len=500, lmin=60, lmax=100):
    contig = rng.integers(0, 4, contig_len, dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n):
            ln = int(rng.integers(lmin, lmax + 1))
            st = int(rng.integers(0, contig_len - ln))
            r = contig[st : st + ln].copy()
            mut = rng.random(ln) < 0.01
            r[mut] = (r[mut] + rng.integers(1, 4, mut.sum())) & 3
            s = BASES[r].tobytes()
            if i % 17 == 0:  # sprinkle Ns
                s = s[:5] + b"N" + s[6:]
            q = (rng.integers(33, 74, ln).astype(np.uint8)).tobytes()
            f.write(b"@SRR000.%d %d/1\n" % (i, i))
            f.write(s + b"\n+\n" + q + b"\n")

workdir = tempfile.mkdtemp(prefix="leonsmoke")
fa = os.path.join(workdir, "toy.fasta")
fq = os.path.join(workdir, "toy.fastq")
make_fasta(fa)
make_fastq(fq)

cfg = LeonConfig(batch_reads=64, reads_per_block=100)

print("=== FASTA round-trip ===")
st = pipeline.compress(fa, cfg=cfg)
print({kk: st[kk] for kk in ("n_reads", "n_anchored", "n_solid_kmers", "ratio", "output_bytes")})
print("streams:", st["stream_bytes"])
dd = pipeline.decompress(st["output"], cfg=cfg)
orig = open(fa, "rb").read(); dec = open(dd["output"], "rb").read()
print("FASTA byte-equal:", orig == dec)
if orig != dec:
    for i, (a, b) in enumerate(zip(orig, dec)):
        if a != b:
            print("first diff at", i, repr(orig[max(0,i-30):i+30]), "vs", repr(dec[max(0,i-30):i+30]))
            break
    print("len", len(orig), len(dec))
    sys.exit(1)

print("=== FASTQ lossless round-trip ===")
cfg2 = LeonConfig(batch_reads=64, reads_per_block=100, lossless=True)
st = pipeline.compress(fq, cfg=cfg2)
print({kk: st[kk] for kk in ("n_reads", "n_anchored", "ratio")})
print("streams:", st["stream_bytes"])
dd = pipeline.decompress(st["output"], cfg=cfg2)
orig = open(fq, "rb").read(); dec = open(dd["output"], "rb").read()
print("FASTQ byte-equal:", orig == dec)
if orig != dec:
    for i, (a, b) in enumerate(zip(orig, dec)):
        if a != b:
            print("first diff at", i, repr(orig[max(0,i-30):i+30]), "vs", repr(dec[max(0,i-30):i+30]))
            break
    print("len", len(orig), len(dec))
    sys.exit(1)
print("SMOKE OK")
