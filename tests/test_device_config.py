"""Device-dependent configuration and the no-fallback rule: the compile
cache location, per-backend lane choice, count_spill_rows derived from
the device's memory, and device failures that propagate instead of
changing the archive."""

import os
import threading

import jax
import numpy as np
import pytest

from leon_tpu import config, pipeline
from leon_tpu.config import LeonConfig
from leon_tpu.utils import compile_cache

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _fasta(path, rng, n=400, contig_len=3000, ln=100):
    contig = rng.integers(0, 4, contig_len, dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n):
            st = int(rng.integers(0, contig_len - ln))
            f.write(b">r%d\n%s\n" % (i, BASES[contig[st : st + ln]].tobytes()))
    return str(path)


class _FakeDevice:
    device_kind = "fake accelerator"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _fake_backend(monkeypatch, backend, stats):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jax, "local_devices", lambda: [_FakeDevice(stats)])


# --- compile cache -----------------------------------------------------------


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")


def test_compile_cache_default_inside_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir() == os.path.join(repo, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")


def test_compile_cache_enable_sets_jax(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "c"))
    try:
        assert compile_cache.enable() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert os.path.isdir(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


# --- resolved(): lanes and spill rows ------------------------------------------


@pytest.mark.parametrize("backend,want", [
    ("gpu", config.ACCEL_BATCH_READS), ("cpu", config.CPU_BATCH_READS)])
def test_resolved_lanes_per_backend(monkeypatch, backend, want):
    _fake_backend(monkeypatch, backend, {"bytes_limit": 80 << 30})
    assert LeonConfig().resolved().batch_reads == want


def test_resolved_keeps_explicit_values(monkeypatch):
    _fake_backend(monkeypatch, "gpu", None)  # never consulted
    cfg = LeonConfig(batch_reads=128, count_spill_rows=4096).resolved()
    assert (cfg.batch_reads, cfg.count_spill_rows) == (128, 4096)


def test_resolved_spill_rows_from_memory(monkeypatch):
    lim = 60 << 30
    _fake_backend(monkeypatch, "gpu", {"bytes_limit": lim})
    cfg = LeonConfig().resolved()
    slab, mf = cfg.count_slab_kmers, cfg.count_merge_factor
    rows = cfg.count_spill_rows
    assert rows == config.spill_rows_for(lim, slab, mf)
    assert rows % slab == 0
    # the worst merge input fits half the device at the stated row cost
    assert (rows + (mf + 1) * slab) * config.MERGE_BYTES_PER_ROW <= lim // 2
    assert (rows + slab + (mf + 1) * slab) * config.MERGE_BYTES_PER_ROW > lim // 2


def test_spill_rows_floor_is_one_slab():
    assert config.spill_rows_for(1 << 20, 1 << 25, 4) == 1 << 25


def test_resolved_cpu_keeps_constant(monkeypatch):
    _fake_backend(monkeypatch, "cpu", None)
    assert LeonConfig().resolved().count_spill_rows == config.CPU_SPILL_ROWS


def test_resolved_accelerator_without_memory_stats_fails(monkeypatch):
    _fake_backend(monkeypatch, "gpu", None)
    with pytest.raises(RuntimeError, match="memory"):
        LeonConfig().resolved()


def test_derived_spill_rows_archive_unchanged(tmp_path, rng, monkeypatch):
    """A fake device small enough that the derived count_spill_rows spills
    every merged run writes the byte-identical archive to the CPU
    constant (which never spills here)."""
    src = _fasta(tmp_path / "s.fasta", rng)
    common = dict(batch_reads=64, reads_per_block=128, count_slab_kmers=4096)
    ref = str(tmp_path / "const.leon")
    pipeline.compress(src, ref, cfg=LeonConfig(
        count_spill_rows=config.CPU_SPILL_ROWS, **common))
    # bytes_limit for which spill_rows_for gives exactly one slab
    lim = 2 * config.MERGE_BYTES_PER_ROW * 6 * 4096
    _fake_backend(monkeypatch, "gpu", {"bytes_limit": lim})
    cfg = LeonConfig(**common)
    assert cfg.resolved().count_spill_rows == 4096
    out = str(tmp_path / "derived.leon")
    pipeline.compress(src, out, cfg=cfg)
    assert open(out, "rb").read() == open(ref, "rb").read()


# --- no fallback that hides the device ----------------------------------------


def test_device_count_failure_propagates(tmp_path, rng, monkeypatch):
    from leon_tpu.ops import kmer as K

    def boom(*a, **kw):
        raise RuntimeError("device count failed")

    monkeypatch.setattr(K, "kmer_scan_packed", boom)
    src = _fasta(tmp_path / "f.fasta", rng, n=60)
    with pytest.raises(RuntimeError, match="device count failed"):
        pipeline.compress(src, str(tmp_path / "f.leon"),
                          cfg=LeonConfig(batch_reads=64, reads_per_block=64))


def _compress_single(src, out, cfg):
    pipeline.compress(src, out, cfg=cfg)


def _compress_distributed(src, out, cfg):
    from leon_tpu.parallel import distributed

    distributed.compress_distributed(src, out, cfg=cfg)


@pytest.mark.parametrize("driver", [_compress_single, _compress_distributed],
                         ids=["pipeline", "distributed"])
@pytest.mark.parametrize("builder,device_max", [
    ("build_np_payload", 0), ("drain_build", 1 << 30)], ids=["host", "device"])
def test_unitig_build_failure_propagates(tmp_path, rng, monkeypatch, driver,
                                         builder, device_max):
    """A failed unitig build, on the host thread or in the device drain,
    raises from either compress driver; it never turns into a BLOOM
    section."""
    from leon_tpu.ops import unitig

    def boom(*a, **kw):
        raise RuntimeError("unitig build failed")

    monkeypatch.setattr(unitig, builder, boom)
    src = _fasta(tmp_path / "u.fasta", rng, n=120)
    cfg = LeonConfig(batch_reads=64, reads_per_block=64,
                     unitig_device_max_kmers=device_max)
    with pytest.raises(RuntimeError, match="unitig build failed"):
        driver(src, str(tmp_path / "u.leon"), cfg)


@pytest.mark.parametrize("device_max", [0, 1 << 30], ids=["host", "device"])
def test_unitig_builders_write_one_archive(tmp_path, rng, device_max):
    """Both drivers take the section decision from one helper: with the
    host or the device builder they write the same UNITIGS archive."""
    src = _fasta(tmp_path / "s.fasta", rng)
    cfg = LeonConfig(batch_reads=64, reads_per_block=128,
                     unitig_device_max_kmers=device_max)
    a, b = str(tmp_path / "a.leon"), str(tmp_path / "b.leon")
    st = pipeline.compress(src, a, cfg=cfg)
    assert st["unitig_bytes"] > 0
    _compress_distributed(src, b, cfg)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_decode_failure_joins_writer(tmp_path, rng, monkeypatch):
    """An exception mid-decode propagates, and the writer thread has
    stopped by then (the pool is shut down before the file closes)."""
    src = _fasta(tmp_path / "w.fasta", rng, n=200)
    cfg = LeonConfig(batch_reads=64, reads_per_block=50)
    st = pipeline.compress(src, cfg=cfg)
    calls = {"n": 0}
    real = pipeline._assemble_block_seqs

    def flaky(db, dispatched):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("assemble failed")
        return real(db, dispatched)

    monkeypatch.setattr(pipeline, "_assemble_block_seqs", flaky)
    with pytest.raises(RuntimeError, match="assemble failed"):
        pipeline.decompress(st["output"], cfg=cfg)
    assert not any(t.name.startswith("leon-dwr") and t.is_alive()
                   for t in threading.enumerate())


def test_placer_rejects_uneven_explicit_mesh():
    with pytest.raises(ValueError, match="mesh_devices"):
        pipeline._Placer(LeonConfig(batch_reads=100, mesh_devices=8))
    # automatic device count: an uneven split stays on one device
    assert pipeline._Placer(LeonConfig(batch_reads=100)).mesh is None
