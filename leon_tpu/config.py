"""Run configuration.

Mirrors the reference CLI contract (/root/reference/README.md:38-59):
mandatory -file plus -c/-d; optional -nb-cores, -kmer-size (default 31),
-abundance (default auto), -lossless, -seq-only, -noheader, -noqual.
Unlike the reference (compile-time KSIZE_LIST, CMakeLists.txt:42), k is a
runtime parameter here: any k <= 255 needs no recompilation (255 because
META stores k as u8; tested to k=95).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# Device batch lanes per backend (LeonConfig.batch_reads=None). Archives
# do not depend on the width. On an accelerator 65536 lanes needs the
# fewest launches; a sweep of 8192..65536 lanes found no end-to-end
# difference (CHANGES.md), so the choice rests on launch count alone.
ACCEL_BATCH_READS = 65536
CPU_BATCH_READS = 8192
# count_spill_rows where the device reports no memory size (the CPU
# backend, whose "device memory" is host RAM).
CPU_SPILL_ROWS = 64 << 20
# Bytes of device memory per row alive in the worst-case count merge: a
# row is 12 B of keys+count at k<=31, and the sort holds its inputs, its
# outputs and scratch at once (x2.5).
MERGE_BYTES_PER_ROW = 30


def spill_rows_for(bytes_limit: int, slab_kmers: int, merge_factor: int) -> int:
    """count_spill_rows for a device with `bytes_limit` bytes: the worst
    merge input is (spill + merge_factor slabs + one pending slab) rows,
    held to half the device's memory (the other half keeps the Bloom
    filter, the in-flight walk chunks and the solid run). Rounded down to
    a whole slab, never below one slab."""
    rows = bytes_limit // 2 // MERGE_BYTES_PER_ROW - (merge_factor + 1) * slab_kmers
    return max(slab_kmers, rows // slab_kmers * slab_kmers)


@dataclasses.dataclass(eq=True)
class LeonConfig:
    # Reference-parity knobs
    kmer_size: int = 31
    abundance: Optional[int] = None  # None = automatic from count histogram
    lossless: bool = False           # qualities: lossy (default) vs lossless
    seq_only: bool = False           # = noheader + noqual, decompress to FASTA
    noheader: bool = False
    noqual: bool = False
    nb_cores: Optional[int] = None   # host-side worker threads (entropy/IO)

    # leon_tpu-specific knobs (all recorded in the container where they
    # affect decoding; see FORMAT.md)
    # None = auto from the measured coverage histogram (bloom.auto_params):
    # the stored filter dominates DNA-mode archives and the end-to-end
    # optimum tracks coverage — bits/kmer ~= mean solid-kmer coverage,
    # clipped to [4, 24], H in {2,3,4}. Set explicitly to pin.
    bloom_bits_per_kmer: Optional[float] = None
    bloom_hashes: Optional[int] = None
    seed: int = 0x1234ABCD
    # parallel-decode unit; also the granularity at which block-finish
    # host work overlaps the next block's device walks (and decode's
    # depth-2 block pipeline). One full accelerator chunk per block, so a
    # block's walks go out as few, large launches. Untuned on H100.
    reads_per_block: int = 65536
    # device batch lanes. None = per backend (resolved()): ACCEL_BATCH_READS
    # on an accelerator, CPU_BATCH_READS on the CPU (shorter XLA-CPU scans
    # measured faster; tests stay quick). Archives are batch-invariant
    # (tested), so the choice never changes output bytes.
    batch_reads: Optional[int] = None
    max_device_len: int = 2048       # longer reads take the raw host path
    # slab size for the streaming device counter (ops/count.py): the
    # multiset is sorted+compacted in fixed slabs of this many k-mers, so
    # peak HBM is one slab + the distinct set, independent of input size
    count_slab_kmers: int = 1 << 25
    # distinct-run merge trigger: merge accumulated runs when they exceed
    # (last merged size + merge_factor * slab) entries
    count_merge_factor: int = 4
    # device runs larger than this many rows spill to host RAM (the DSK
    # temp-disk analog): device memory stays bounded at ~spill +
    # merge_factor*slab rows of sort transient no matter how large the
    # distinct set grows (genome-scale inputs). Spilled and unspilled runs
    # produce byte-identical archives (tested). None = derived from the
    # device's memory in resolved() (spill_rows_for); CPU_SPILL_ROWS where
    # the device reports no memory size (the CPU backend).
    count_spill_rows: Optional[int] = None
    # inputs larger than this stream through both passes (re-parsed per
    # pass, constant memory — the device analog of the reference's
    # disk-streaming design, README.md:13); smaller inputs are held in RAM
    stream_threshold_bytes: int = 1 << 30
    # single-process multi-chip: number of local devices to spread batch
    # lanes over (a 1-D jax.sharding.Mesh). None = all visible devices;
    # 1 = force single-device. Archives are byte-identical at any value.
    mesh_devices: Optional[int] = None
    # compacted-event D2H capacities (per read, averaged over a chunk);
    # chunks that overflow retry at escalated caps (WalkCaps raises the
    # caps used for every later dispatch), then the dense transfer.
    # Measured event rates on the 25x 1%-error bench corpus: ~1 err/read
    # and ~2.2 bif/read (Bloom FPs on the 4 candidate probes). Caps are
    # CHUNK-TOTAL budgets (cap = per_read x lanes): err keeps ~4x headroom
    # on the u16 errgap plane, the largest compact-buffer D2H plane; the
    # bif plane is 2-bit packed (16x smaller per slot), so bif keeps
    # 8/read. Untuned on H100.
    event_cap_per_read: int = 4
    bif_cap_per_read: int = 8
    # device-side pipelining depth: chunks dispatched ahead of the host
    # consuming their results (keeps the device busy across each chunk's
    # D2H and host unpack). Untuned on H100.
    max_inflight_chunks: int = 32
    # store the solid k-mer set as unitigs (ops/unitig.py) instead of the
    # raw Bloom bitset whenever the unitig payload is smaller — typically
    # 5-10x — and let the decoder rebuild the bit-identical filter. The
    # gate applies to the SOLID count (the build compacts the distinct run
    # to its solid rows first; error singletons never enter it, so
    # chr-scale runs whose distinct set is error-dominated still qualify).
    # It bounds the builder's working set: the native host builder holds
    # the solid rows plus its hash table and chain arrays in host RAM, and
    # the device builder needs ≈ 56 B per solid k-mer at k<=31 (words+rc
    # 16, succ/outc/nxt/prev 2x16, doubling carries 24 with one gather
    # transient) -> 128M solid ≈ 7 GB of device memory beside the Bloom
    # filter and the distinct run. The value is part of the archive
    # contract (it decides the section), so it is a constant, not derived
    # from the device. Past the gate the BLOOM section is written.
    unitig_sections: bool = True
    unitig_max_kmers: int = 128 << 20
    # largest solid set the DEVICE builder takes. Default 0 = the native
    # HOST builder always runs instead, on a background thread overlapped
    # with the encode stage: the device build is serial device work the
    # walk chunks queue behind, while the host thread hides under the
    # encode stage and the solid rows ship via async D2H. Raising this
    # re-enables the device builder (byte-identical payloads, tested).
    # Which builder to keep is open until both are measured on the H100.
    unitig_device_max_kmers: int = 0
    # when set, wrap compress/decompress in a jax.profiler trace written
    # here (the device analog of GATB TimeInfo/Progress tracing,
    # SURVEY.md §5.1)
    profile_dir: Optional[str] = None
    # when set, the count-phase result (abundance cutoff + Bloom bitset)
    # persists here and a matching re-run skips pass 1 entirely — the
    # natural restart midpoint (SURVEY.md §5.4: DSK's solid-kmer set)
    checkpoint: Optional[str] = None
    verbose: int = 1

    def resolved(self) -> "LeonConfig":
        """Concrete copy with device-dependent fields filled in (the
        pipeline entry points call this once; jitted code never sees
        None). An accelerator that reports no memory size is an error:
        no size is assumed for an unknown device."""
        if self.batch_reads is not None and self.count_spill_rows is not None:
            return self
        import jax

        dev = jax.local_devices()[0]
        on_cpu = jax.default_backend() == "cpu"
        out = self
        if self.batch_reads is None:
            out = dataclasses.replace(
                out, batch_reads=CPU_BATCH_READS if on_cpu else ACCEL_BATCH_READS)
        if self.count_spill_rows is None:
            stats = dev.memory_stats()
            if stats is None or "bytes_limit" not in stats:
                if not on_cpu:
                    raise RuntimeError(
                        f"device {dev.device_kind!r} reports no memory size "
                        "(memory_stats); set count_spill_rows explicitly")
                rows = CPU_SPILL_ROWS
            else:
                rows = spill_rows_for(int(stats["bytes_limit"]),
                                      self.count_slab_kmers,
                                      self.count_merge_factor)
            out = dataclasses.replace(out, count_spill_rows=rows)
        return out

    def __post_init__(self) -> None:
        # the reference supports k up to 256 but only via recompilation with
        # KSIZE_LIST (/root/reference/README.md:69-81); here any k <= 255 is
        # a runtime parameter (255 because META stores k as u8)
        if not (1 <= self.kmer_size <= 255):
            raise ValueError(f"kmer-size must be in [1, 255], got {self.kmer_size}")
        if self.abundance is not None and self.abundance < 1:
            raise ValueError("abundance must be >= 1")
        if self.bloom_hashes is not None and not (1 <= self.bloom_hashes <= 8):
            raise ValueError("bloom hashes must be in [1, 8]")
        if self.seq_only:
            self.noheader = True
            self.noqual = True
