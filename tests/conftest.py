"""Test environment: force the CPU backend with 8 virtual devices so the
multi-device sharding paths are exercised without accelerator hardware
(SURVEY.md §4.3: N-host runs must byte-match 1-host runs)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from leon_tpu.utils import compile_cache  # noqa: E402

# Persistent compile cache: the walk/count kernels take minutes to compile on
# CPU; cache them across test runs.
compile_cache.enable()


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


def random_reads(rng, n, lmin=40, lmax=150, contig_len=1000, err=0.01, seed_contig=None):
    """Simulated reads from a random contig (the toy.fasta generation model:
    /root/reference/data/toy.fasta headers record er=0.01 fwd/rev reads)."""
    contig = seed_contig if seed_contig is not None else rng.integers(0, 4, contig_len, dtype=np.uint8)
    reads = []
    for _ in range(n):
        ln = int(rng.integers(lmin, lmax + 1))
        start = int(rng.integers(0, max(1, contig_len - ln)))
        r = contig[start : start + ln].copy()
        mut = rng.random(r.shape) < err
        r[mut] = (r[mut] + rng.integers(1, 4, mut.sum())) & 3
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        reads.append(r)
    return reads


@pytest.fixture
def sim_reads(rng):
    return random_reads(rng, 120, lmin=60, lmax=100, contig_len=400)
