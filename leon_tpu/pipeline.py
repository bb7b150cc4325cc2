"""Compression / decompression drivers.

Device-native re-design of the reference Leon orchestrator ([R] gatb-core
tools/compression/Leon.cpp, executeCompression/executeDecompression;
pipeline shape documented in SURVEY.md §3.2-3.3):

  compress:   parse -> device k-mer count -> abundance cutoff -> Bloom ->
              device anchor+walk encode -> stream assembly -> container
  decompress: container -> Bloom + dict -> device re-walk -> reassembly

The reference runs per-read encoders over Dispatcher threads; here every
read is a device lane and blocks of reads are device sub-batches. Blocks
are the parallel-decode unit, exactly like the reference's ordered
Dispatcher blocks (SURVEY.md §2.4 "DP" row).
"""

from __future__ import annotations

import os
import sys
import time
from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from leon_tpu.codecs import blocks as blockcodec
from leon_tpu.codecs import headers as hcodec
from leon_tpu.config import LeonConfig
from leon_tpu.io import bank, container
from leon_tpu.ops import bloom, count
from leon_tpu.ops import kmer as K
from leon_tpu.utils.trace import span, span_add, span_reset, span_totals, tr


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _pad_bitset_dev(bitset: np.ndarray, n_words: int):
    """Upload an exact-size bitset padded to the alloc-grid shape
    (bloom.alloc_words): exact n_words rides the kernels as traced data,
    so the padded SHAPE is all that keys XLA recompilation."""
    import jax.numpy as jnp

    return jnp.asarray(np.pad(bitset, (0, bloom.alloc_words(n_words) - bitset.size)))


def _progress(cfg: LeonConfig, stage: str, done: int, total: int) -> None:
    """Reference-style progress line ([R] GATB Progress bars, SURVEY.md §5.1)."""
    if cfg.verbose >= 1 and total > 1 and sys.stderr.isatty():
        pct = 100.0 * done / total
        print(f"\r[{stage}] {done}/{total} ({pct:.0f}%)", end="" if done < total else "\n",
              file=sys.stderr)


def _bucket_len(maxlen: int, k: int) -> int:
    """Padded chunk width for a given max segment length. The walk/scan
    kernels cost one scan step per column, so bucket granularity is a
    direct kernel-time multiplier: the old power-of-two grid padded 100 bp
    reads to L=128 (walk ME = 97 steps for 69 real ones, +40% kernel
    time). Fine 8-column grid up to 128 (the short-read sweet spot; a few
    extra cached XLA shapes), 1/8-octave beyond."""
    need = max(maxlen, k + 1)
    if need <= 128:
        return -(-need // 8) * 8
    step = max(16, 1 << (need.bit_length() - 4))
    return -(-need // step) * step


@dataclass
class Chunk:
    """One device sub-batch of SEGMENTS (FORMAT.md §2 "Segmentation").

    `codes`/`dev_len` are padded to cfg.batch_reads lanes (full chunks) or
    to the _lane_bucket grid (tail/small-input chunks) — a bounded set of
    device shapes; the seg_* arrays cover only the n true segments. `packed`
    is the 2-bit H2D form (kmer.pack_codes_np): sequences ship packed and
    unpack on device — 4x fewer host-to-device bytes.
    It is computed lazily: the encode pass never packs when the count
    pass's device-resident copy is reused.
    """

    codes: np.ndarray      # (B_pad, L) uint8, exceptions substituted, zero-padded
    dev_len: np.ndarray    # (B_pad,) int32 — 0 for pad lanes
    L: int                 # bucketed width
    n: int                 # true segments in this chunk
    seg_read: np.ndarray   # (n,)
    seg_off: np.ndarray    # (n,)
    seg_len: np.ndarray    # (n,)
    _packed: Optional[np.ndarray] = None

    @property
    def packed(self) -> np.ndarray:  # (B_pad, ceil(L/16)) uint32
        if self._packed is None:
            self._packed = K.pack_codes_np(self.codes)
        return self._packed


def _lane_bucket(m: int, B: int) -> int:
    """Padded lane count for a chunk of m true rows: full chunks stay at
    B; partial (tail / small-input) chunks pad to a 1/8-octave grid with
    floor 4096 instead of all the way to B — bounded distinct XLA shapes
    (the decode side shares the same grid) without charging a 50k-read
    CLI run a full 65536-lane walk. Grid points are multiples of 4096, so
    mesh lane-sharding (power-of-two device counts) always divides."""
    if m >= B:
        return B
    n = max(4096, m)
    gran = max(4096, 1 << max(0, (n - 1).bit_length() - 3))
    return min(B, -(-n // gran) * gran)


def chunk_block(prep: blockcodec.BlockPrep, cfg: LeonConfig, k: int) -> Iterator[Chunk]:
    B = cfg.batch_reads
    total = prep.n_segs
    flat = prep.flat_codes
    from leon_tpu.utils import ragged

    starts_all = (prep.read_start[prep.seg_read] + prep.seg_off).astype(np.int64)
    for s in range(0, total, B):
        so = prep.seg_off[s : s + B]
        sl = prep.seg_len[s : s + B]
        m = sl.shape[0]
        Lb = _bucket_len(int(sl.max()) if m else 0, k)
        codes = np.zeros((_lane_bucket(m, B), Lb), dtype=np.uint8)
        if flat.size:
            # copy each segment's sl[i] bytes into its zeroed row (no
            # index materialization, no tail masking)
            ragged.move(codes.reshape(-1), np.arange(m, dtype=np.int64) * Lb,
                        flat, starts_all[s : s + B], sl)
        dev_pad = np.zeros(codes.shape[0], dtype=np.int32)
        dev_pad[:m] = sl
        yield Chunk(
            codes=codes, dev_len=dev_pad, L=Lb, n=m,
            seg_read=prep.seg_read[s : s + B], seg_off=so, seg_len=sl,
        )


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


_CKPT_VERSION = 4  # counts Bloom layout + key fields; bump with FORMAT §4


def _ckpt_key(cfg: LeonConfig, k: int, input_path: str, lossy_quals: bool) -> tuple:
    try:
        size = bank.total_size(input_path)
    except OSError:
        size = -1
    # lossy_quals is part of the key: the auto Bloom sizing differs per
    # qual mode (bloom.auto_params), so a lossless-mode checkpoint must
    # not leak a lean filter into a lossy-mode run
    return (_CKPT_VERSION, k, cfg.seed, cfg.bloom_hashes,
            cfg.bloom_bits_per_kmer, cfg.abundance, cfg.max_device_len,
            lossy_quals, cfg.unitig_sections,
            os.path.basename(input_path), size)


_CKPT_MAGIC = b"LEONCKPT"


def _load_count_checkpoint(cfg: LeonConfig, k: int, input_path: str,
                           lossy_quals: bool):
    """Checkpoint format: magic | u32 json_len | json header | raw bitset
    bytes. Plain JSON + raw arrays — no pickle, so a hostile checkpoint
    file cannot execute code (it is at worst rejected)."""
    if not cfg.checkpoint or not os.path.exists(cfg.checkpoint):
        return None
    import json

    try:
        with open(cfg.checkpoint, "rb") as f:
            if f.read(8) != _CKPT_MAGIC:
                return None
            jlen = int.from_bytes(f.read(4), "little")
            if jlen > 1 << 20:
                return None
            d = json.loads(f.read(jlen))
            if d.get("key") != list(_ckpt_key(cfg, k, input_path, lossy_quals)):
                return None
            raw = f.read(int(d["bitset_bytes"]))
            if len(raw) != int(d["bitset_bytes"]):
                return None
            uni = None
            ub = int(d.get("unitig_bytes", 0))
            if ub:
                uni = f.read(ub)
                if len(uni) != ub:
                    return None
        bitset = np.frombuffer(raw, dtype="<u4")
        return (bitset, int(d["n_words"]), int(d["cutoff"]), int(d["n_solid"]),
                int(d["n_hashes"]), uni)
    except Exception:
        return None


def _save_count_checkpoint(cfg: LeonConfig, k: int, input_path: str, lossy_quals: bool,
                           bitset, n_words, cutoff, n_solid, n_hashes,
                           unitig_payload: Optional[bytes] = None):
    import json

    raw = bitset.astype("<u4").tobytes()
    hdr = json.dumps(
        {
            "key": list(_ckpt_key(cfg, k, input_path, lossy_quals)),
            "bitset_bytes": len(raw),
            "n_words": int(n_words), "cutoff": int(cutoff),
            "n_solid": int(n_solid), "n_hashes": int(n_hashes),
            # the RESOLVED section decision rides along so a resumed run
            # writes the byte-identical archive (0 = BLOOM section)
            "unitig_bytes": len(unitig_payload) if unitig_payload else 0,
        }
    ).encode()
    tmp = cfg.checkpoint + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_CKPT_MAGIC)
        f.write(len(hdr).to_bytes(4, "little"))
        f.write(hdr)
        f.write(raw)
        if unitig_payload:
            f.write(unitig_payload)
    os.replace(tmp, cfg.checkpoint)


def unitig_eligible(n_solid: int, cfg: LeonConfig) -> bool:
    """Whether a solid set of n_solid k-mers gets a UNITIGS build at all
    (the size rule then decides between UNITIGS and BLOOM)."""
    return bool(cfg.unitig_sections) and 0 < n_solid <= cfg.unitig_max_kmers


def start_unitig_build(solidset, n_solid: int, cutoff: int, k: int,
                       cfg: LeonConfig):
    """Start the UNITIGS payload build for a counted solid set, or return
    None when there is none or it is not unitig_eligible. `solidset` is
    the 4-tuple of DeviceCounter.finalize(want_solid=True): (device
    words, device counts, distinct count, host (words, counts) or None).

    Sets above cfg.unitig_device_max_kmers (every set, by default) build
    on a host thread with the byte-identical native builder, so the build
    runs UNDER the encode stage; a device-resident run is first compacted
    to its solid rows on device and its D2H started here. Smaller sets
    dispatch the device build now, ahead of any walk chunk in the device
    FIFO. Either way the result is taken by finish_unitig_build, the one
    place the section is decided."""
    if solidset is None or not unitig_eligible(n_solid, cfg):
        return None
    from leon_tpu.ops import unitig as _unitig

    if n_solid <= cfg.unitig_device_max_kmers and solidset[0] is not None:
        with span("count.unitig_dispatch"):
            infl = _unitig.dispatch_build(solidset[0], solidset[1], cutoff, k,
                                          solidset[2], n_solid=n_solid)
        tr("count.unitig.dispatched")
        return ("infl", infl)
    host_pair, dev_words = solidset[3], None
    if host_pair is None:
        # rows [0, n_solid) of the compacted run are solid by
        # construction, so counts never ship: the host side synthesizes
        # counts = cutoff (the builder only tests counts >= cutoff)
        dev_words, _ = count.compact_solid(
            solidset[0], solidset[1], np.int32(cutoff),
            count._bucket_size(max(1, n_solid)),
        )
        dev_words.copy_to_host_async()
    out: list = []

    def _host_build(hp=host_pair, nu=solidset[2]):
        # a failure is stored and re-raised by finish_unitig_build: it
        # never turns into a BLOOM section
        try:
            if hp is None:
                with span("unitig.thread_d2h"):
                    w = np.asarray(dev_words)[:n_solid]
                hp = (np.ascontiguousarray(w), np.full(n_solid, cutoff, np.int32))
            # nthreads=3 leaves one core for the encode loop's
            # drain/frame work this thread overlaps
            with span("unitig.thread_build"):
                out.append((_unitig.build_np_payload(hp[0], hp[1], cutoff, k,
                                                     nu, nthreads=3), hp[0]))
        except BaseException as e:
            out.append(e)

    import threading

    thread = threading.Thread(target=_host_build, daemon=True)
    thread.start()
    return ("thread", thread, out)


def finish_unitig_build(build, n_words: int):
    """Wait for a start_unitig_build and apply the FROZEN section-choice
    rule: UNITIGS is written iff the raw payload is smaller than the raw
    bitset (4*n_words bytes). Returns (raw payload or None = write BLOOM,
    the DICT enumeration source: ("infl", in-flight build) or ("host",
    sorted solid rows) or None). A failed build or drain raises."""
    if build is None:
        return None, None
    if build[0] == "infl":
        from leon_tpu.ops import unitig as _unitig

        with span("tail.unitig_drain"):
            payload = _unitig.drain_build(build[1])
        src = build
    else:
        _, thread, out = build
        with span("tail.unitig_join"):
            thread.join()
        if isinstance(out[0], BaseException):
            raise out[0]
        payload, rows = out[0]
        src = ("host", rows)
    if payload is not None and len(payload) < 4 * n_words:
        return payload, src
    return None, None


def frame_bloom(bitset: np.ndarray) -> bytes:
    """Entropy-frame the Bloom bitset for the container. o1 beats
    zlib/rANS ~2.5% on the sparse bitset (bit correlations within bytes);
    only tried under 128 MB — the adaptive coder is the slowest method and
    the win does not justify minutes at genome scale. Every writer
    (single-process and distributed) must use this one helper: the framed
    bytes are part of the shard-invariance contract."""
    from leon_tpu.codecs import frames as _f

    return _f.frame(bitset.astype("<u4").tobytes(),
                    try_o1=bitset.nbytes < (128 << 20))


class _Placer:
    """Places device batches: single-device passthrough, or lane-sharded
    over a flat 1-D mesh of local devices (the product wiring of
    parallel/mesh.py — reference analog: Dispatcher threads, SURVEY.md
    §2.4 DP row). The jitted kernels are sharding-polymorphic; XLA inserts
    the collectives (cross-lane cumsums in event compaction, the count
    sort) over the device interconnect.

    mesh_devices=None spreads over every visible device when batch_reads
    divides evenly and stays on one device otherwise; an explicit
    mesh_devices > 1 that does not divide batch_reads is an error."""

    def __init__(self, cfg: LeonConfig):
        import jax

        n = len(jax.devices()) if cfg.mesh_devices is None else cfg.mesh_devices
        if cfg.mesh_devices is not None and n > 1 and cfg.batch_reads % n:
            raise ValueError(
                f"batch_reads={cfg.batch_reads} does not split evenly over "
                f"mesh_devices={n}")
        self.mesh = None
        self.n = max(1, n)
        if n > 1 and cfg.batch_reads % n == 0:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from leon_tpu.parallel import mesh as pmesh

            self.mesh = pmesh.make_mesh(n)
            self._s2 = NamedSharding(self.mesh, P("d", None))
            self._s1 = NamedSharding(self.mesh, P("d"))
            self._rep = NamedSharding(self.mesh, P())
            self._put = jax.device_put

    def batch2(self, arr):
        return self._put(arr, self._s2) if self.mesh else arr

    def batch1(self, arr):
        return self._put(arr, self._s1) if self.mesh else arr

    def replicated(self, arr):
        return self._put(arr, self._rep) if self.mesh else arr


def _count_pass_device(preps: list, cfg: LeonConfig, k: int, H: int, seed: int,
                       placer: Optional[_Placer] = None,
                       dev_cache: Optional[dict] = None,
                       lossy_quals: bool = False):
    """Device-resident k-mer counting + Bloom build (reference: DSK
    SortingCount + BloomBuilder, SURVEY.md §3.2 steps 2-3). K-mers stream
    through fixed device-memory slabs (sorted + compacted to distinct runs
    on device — the device analog of DSK's disk partitions); the Bloom
    filter is built on device from the merged run. Host traffic: one
    scalar per slab plus one 256-entry histogram.

    dev_cache (non-stream mode): the packed code arrays uploaded here stay
    on device keyed by chunk index, so the encode pass re-uses them — each
    base crosses to the device once, 2-bit packed.
    Returns (bitset device array, n_words, cutoff, n_solid)."""
    import jax.numpy as jnp

    counter = count.DeviceCounter(
        k, slab_kmers=cfg.count_slab_kmers, merge_factor=cfg.count_merge_factor,
        spill_rows=cfg.count_spill_rows,
    )
    n_total = len(preps) if hasattr(preps, "__len__") else 0
    ci = 0
    for ib, prep in enumerate(preps):
        for ch in chunk_block(prep, cfg, k):
            ci += 1
            if ch.L < k + 1 or not (ch.dev_len >= k).any():
                continue
            tr(f"count.chunk{ci}.ready")
            with span("count.pack_h2d"):
                packed, dlen = ch.packed, ch.dev_len
                if placer is not None:
                    packed, dlen = placer.batch2(packed), placer.batch1(dlen)
                packed = jnp.asarray(packed)
                if dev_cache is not None:
                    dev_cache[ci - 1] = packed
            tr(f"count.chunk{ci}.h2d")
            with span("count.dispatch"):
                canon, _, valid = K.kmer_scan_packed(packed, dlen, k, ch.L)
                counter.add(canon, valid)
            tr(f"count.chunk{ci}.added")
        if n_total:
            _progress(cfg, "count", ib + 1, n_total)
    tr("count.finalize.begin")
    with span("count.finalize"):
        bitset, n_words, cutoff, n_solid, _hist, H_used, solidset = counter.finalize(
            cfg.abundance, cfg.bloom_bits_per_kmer, H, seed, lossy_quals,
            want_solid=True, device_max=cfg.unitig_device_max_kmers,
            unitig_max=cfg.unitig_max_kmers if cfg.unitig_sections else 0,
        )
    tr("count.finalize.end")
    return bitset, n_words, cutoff, n_solid, H_used, solidset


class WalkCaps:
    """Mutable per-run event-capacity state. A chunk that overflows its
    compact-layout caps escalates the per-read caps used by EVERY later
    dispatch (one XLA recompile at the new bucket, cached thereafter), so
    a workload whose event rate beats the config default pays ONE retry
    round-trip instead of one per chunk — r2's flat 4x retry was 90% of
    the encode stage on the bench corpus."""

    def __init__(self, cfg: LeonConfig):
        self.err_pr = cfg.event_cap_per_read
        self.bif_pr = cfg.bif_cap_per_read

    def escalate(self, total_err: int, total_bif: int, n: int) -> None:
        """Grow per-read caps (power-of-2 steps) until the observed chunk
        totals fit with ~25% headroom."""
        need_err = -(-5 * total_err // (4 * max(1, n)))
        need_bif = -(-5 * total_bif // (4 * max(1, n)))
        while self.err_pr < need_err:
            self.err_pr *= 2
        while self.bif_pr < need_bif:
            self.bif_pr *= 2


def dispatch_walk_chunk(ch: Chunk, packed_d, dlen_d, bitset_j, k: int, H: int,
                        n_words: int, seed: int, cfg: LeonConfig, with_conf: bool,
                        caps: Optional[WalkCaps] = None):
    """Dispatch one chunk's compact walk encode (async D2H started).
    Returns the in-flight handle for drain_walk_chunk."""
    from leon_tpu.ops import walk

    B = ch.codes.shape[0]
    err_pr = caps.err_pr if caps is not None else cfg.event_cap_per_read
    bif_pr = caps.bif_pr if caps is not None else cfg.bif_cap_per_read
    cap_err = ((err_pr * B) + 7) // 8 * 8
    cap_bif = ((bif_pr * B) + 7) // 8 * 8
    buf = walk.encode_batch_compact_packed(
        packed_d, dlen_d, bitset_j, k, H, np.uint32(n_words), seed,
        cap_err, cap_bif, with_conf, ch.L,
    )
    buf.copy_to_host_async()
    return (buf, cap_err, cap_bif, packed_d, dlen_d)


def drain_walk_chunk(ch: Chunk, inflight, bitset_j, k: int, H: int,
                     n_words: int, seed: int, with_conf: bool,
                     caps: Optional[WalkCaps] = None) -> Optional[dict]:
    """Drain one dispatched compact walk: D2H sync, unpack, capacity retry
    (escalated caps), dense-layout fallback. Returns the enc dict, or None
    when the chunk was never dispatched (all-short lanes)."""
    from leon_tpu.ops import walk

    if inflight is None:
        return None
    buf, cap_err, cap_bif, packed_d, dlen_d = inflight
    B = ch.codes.shape[0]
    with span("enc.drain_wait"):
        buf_h = np.asarray(buf)
    with span("enc.unpack"):
        enc = walk.unpack_compact(
            buf_h, ch.n, B, ch.L, cap_err, cap_bif, with_conf=with_conf, k=k,
        )
    if enc is None:
        # event capacity overflow: retry once at escalated caps (future
        # dispatches inherit them) before falling back to the dense layout
        total_err = int(buf_h[0]) | (int(buf_h[1]) << 16)
        total_bif = int(buf_h[2]) | (int(buf_h[3]) << 16)
        if caps is not None:
            caps.escalate(total_err, total_bif, B)
            err_pr, bif_pr = caps.err_pr, caps.bif_pr
        else:
            err_pr = 4 * (cap_err // B + 1)
            bif_pr = 4 * (cap_bif // B + 1)
        cap_err2 = max(((err_pr * B) + 7) // 8 * 8, ((total_err + 7) // 8) * 8)
        cap_bif2 = max(((bif_pr * B) + 7) // 8 * 8, ((total_bif + 7) // 8) * 8)
        with span("enc.cap_retry"):
            buf2 = walk.encode_batch_compact_packed(
                packed_d, dlen_d, bitset_j, k, H, np.uint32(n_words), seed,
                cap_err2, cap_bif2, with_conf, ch.L,
            )
            enc = walk.unpack_compact(
                np.asarray(buf2), ch.n, B, ch.L, cap_err2, cap_bif2,
                with_conf=with_conf, k=k,
            )
    if enc is None:
        with span("enc.dense_fallback"):
            enc_j = walk.encode_batch(ch.codes, ch.dev_len, bitset_j, k, H,
                                      np.uint32(n_words), seed)
            enc = {kk: np.asarray(v)[: ch.n] for kk, v in enc_j.items()}
    return enc


def compress(input_path: str, output_path: Optional[str] = None, cfg: Optional[LeonConfig] = None) -> dict:
    cfg = (cfg or LeonConfig()).resolved()
    if cfg.profile_dir:
        import dataclasses as _dc

        import jax

        with jax.profiler.trace(cfg.profile_dir):
            return compress(
                input_path, output_path, _dc.replace(cfg, profile_dir=None)
            )
    try:
        return _compress_impl(input_path, output_path, cfg, None)
    except bank.IrregularInput:
        # the optimistically-chosen array parser hit irregular structure
        # mid-file (its per-block checks enforce the same predicates as
        # full validation): restart with the tolerant parser. The parser
        # CHOICE ends up identical to the old whole-file upfront
        # validation without charging every regular input a full extra
        # scan.
        return _compress_impl(input_path, output_path, cfg, False)


def _compress_impl(input_path: str, output_path: Optional[str],
                   cfg: LeonConfig, parser_hint: Optional[bool]) -> dict:
    import jax.numpy as jnp

    span_reset()
    t0 = time.time()
    if output_path is None:
        # composite banks: name the archive after the first member
        first = bank.album_paths(input_path)[0]
        base = first[:-3] if first.endswith(".gz") else first
        output_path = base + ".leon"

    k = cfg.kmer_size
    W = K.words_for_k(k)
    fmt = bank.sniff_format(input_path)
    file_size = bank.total_size(input_path)
    stream_mode = file_size > cfg.stream_threshold_bytes

    header_mode = 0 if cfg.noheader else 1
    if fmt == bank.FASTA or cfg.noqual:
        qual_mode = container.QUAL_NONE
    else:
        qual_mode = container.QUAL_LOSSLESS if cfg.lossless else container.QUAL_LOSSY
    out_fmt = bank.FASTA if (fmt == bank.FASTQ and cfg.seq_only) else fmt
    seq_only_conv = fmt == bank.FASTQ and cfg.seq_only

    def conv(b):
        if not seq_only_conv:
            return b
        if isinstance(b, bank.ArrayBlock):
            return b.to_seq_only_fasta()
        return bank.SeqBlock(
            bank.FASTA, b.headers, b.seqs,
            line_lens=[[len(s)] if len(s) else [] for s in b.seqs],
        )

    # choose the parser ONCE (both passes must agree): vectorized array
    # parser for regular structure, tolerant per-line parser otherwise
    # (blank filler lines etc.). The validator is a streaming line scan.
    tr("parse.begin")
    use_array_parser = (bank.validate_arrays(input_path, prefix_bytes=8 << 20)
                        if parser_hint is None else parser_hint)
    tr("parse.validated")

    def raw_blocks():
        if use_array_parser:
            yield from bank.read_blocks_arrays(input_path, cfg.reads_per_block)
        else:
            yield from bank.read_blocks(input_path, cfg.reads_per_block)

    def timed_bp():
        """Parse + prep blocks with the host time attributed to the
        parse.inline span (parse now runs INSIDE the count pass so it
        overlaps the device's count compute instead of preceding it)."""
        it = raw_blocks()
        while True:
            t = time.time()
            b = next(it, None)
            if b is None:
                span_add("parse.inline", time.time() - t)
                return
            b = conv(b)
            p = blockcodec.prepare_block(b, cfg.max_device_len)
            span_add("parse.inline", time.time() - t)
            yield b, p

    n_reads = None
    final_nl = bank.final_newline(input_path)
    n_blocks = 0  # unknown until a pass completes
    if not stream_mode:
        # lazy parse WITH caching: pass 1 parses while the device counts
        # (host parse rides under device compute), pass 2 replays from RAM
        bp_cache: list = []
        cache_state = {"done": False}

        def iter_bp():
            yield from bp_cache
            if cache_state["done"]:
                return
            skip = len(bp_cache)  # re-entry after an abandoned pass
            for i, bp in enumerate(timed_bp()):
                if i >= skip:
                    bp_cache.append(bp)
                    yield bp
            cache_state["done"] = True
            nonlocal n_blocks
            n_blocks = len(bp_cache)
    else:
        # streaming: re-parse per pass, constant memory (the reference's
        # disk-streaming design, README.md:13)
        def iter_bp():
            yield from timed_bp()

    t_parse = time.time() - t0

    # --- pass 1: k-mer counting + solidity threshold + Bloom build ---
    t1 = time.time()
    H = cfg.bloom_hashes
    seed = cfg.seed
    ck = _load_count_checkpoint(cfg, k, input_path,
                                qual_mode == container.QUAL_LOSSY)
    tally = {"reads": 0}

    def iter_preps():
        tally["reads"] = 0
        for b, p in iter_bp():
            tally["reads"] += b.n_reads
            yield p

    placer = _Placer(cfg)
    dev_cache: Optional[dict] = {} if not stream_mode else None
    unitig_payload: Optional[bytes] = None  # decided raw payload (or None)
    unitig_build = None  # start_unitig_build handle, taken by the tail
    # DICT v2 enumeration source (cheapest available, see tail.dict):
    # ("infl", _Inflight) device run | ("host", solid rows) | None -> spell
    unitig_solid_src = None
    if ck is not None:
        bitset, n_words, cutoff, n_solid, H, unitig_payload = ck
        bitset_j = _pad_bitset_dev(bitset, n_words)
    else:
        # a device failure raises: there is no host-count fallback
        bitset_j, n_words, cutoff, n_solid, H, solidset = _count_pass_device(
            iter_preps(), cfg, k, H, seed, placer, dev_cache,
            lossy_quals=qual_mode == container.QUAL_LOSSY,
        )
        bitset = None  # transferred lazily for the container
        # gate on the SOLID count: the build compacts the run to its solid
        # rows first, so error-singleton-dominated distinct sets (the
        # chr-scale norm) do not disqualify the section. Started before
        # any walk chunk is dispatched, so it rides under the walk stage.
        unitig_build = start_unitig_build(solidset, n_solid, cutoff, k, cfg)
    if ck is None and cfg.checkpoint:
        # the section decision is part of the checkpoint (a resumed run
        # must write the byte-identical archive), so resolve it now
        unitig_payload, unitig_solid_src = finish_unitig_build(unitig_build,
                                                               n_words)
        unitig_build = None
        if bitset is None:
            bitset = np.asarray(bitset_j)[:n_words]
        _save_count_checkpoint(cfg, k, input_path,
                               qual_mode == container.QUAL_LOSSY,
                               bitset, n_words, cutoff, n_solid, H,
                               unitig_payload)
    if n_reads is None:
        if ck is not None:
            # checkpoint skipped pass 1: count records with a parse-only pass
            n_reads = sum(
                b.n_reads for b in bank.read_blocks(input_path, cfg.reads_per_block)
            )
        else:
            n_reads = tally["reads"]
    t_count = time.time() - t1
    t_bloom = 0.0

    meta = container.Meta(
        k=k, fmt=out_fmt, qual_mode=qual_mode, header_mode=header_mode,
        n_hashes=H, final_newline=final_nl, n_words=n_words,
        seed=seed, n_reads=n_reads, abundance=cutoff,
        seglen=cfg.max_device_len,
        orig_ext=b"fasta" if out_fmt == bank.FASTA else b"fastq",
    )

    # --- pass 2: anchor + walk encode, stream assembly ---
    # Pipelined: while the device walks ahead (up to max_inflight_chunks),
    # the host drains packed results (one async D2H per chunk), assembles
    # the container streams and appends finished blocks to the writer.
    t1 = time.time()
    tr("enc.bloom_d2h.begin")
    if bitset is None:
        if placer.mesh is None and (unitig_build is not None
                                    or unitig_payload is not None):
            # the UNITIGS section replaces the bitset (5-10x smaller D2H
            # already in flight, or being built by the host thread above
            # the device cap — the chr-scale norm, where the full-bitset
            # transfer would compete with every per-chunk drain of the
            # encode stage); the bitset only crosses to the host when
            # the size rule picks BLOOM, synchronously at section-write
            # time. (mesh runs still materialize it below for replication)
            pass
        elif placer.mesh is None:
            # single device: start the bitset D2H now but
            # write the BLOOM section AFTER the encode loop, so the
            # transfer rides under the walk dispatches (readers dispatch
            # on section tags, FORMAT.md §1 — order is free)
            bitset_j.copy_to_host_async()
        else:
            # device bitset is padded to the alloc grid; the container
            # stores the exact n_words prefix (FORMAT.md §4 exact sizing)
            bitset = np.asarray(bitset_j)[:n_words]
    if placer.mesh is not None:
        bitset_j = placer.replicated(
            np.pad(bitset, (0, bloom.alloc_words(n_words) - n_words))
        )
    tr("enc.bloom_d2h.end")
    writer = container.Writer(output_path)
    writer.section(container.TAG_META, meta.pack())
    # the BLOOM section is written after the BLOCK sections in every mode
    # (mesh runs materialize the bitset early for replication, but the
    # section order must not depend on mesh_devices: archives are
    # byte-identical at any device count)
    tr("enc.bloom_framed")

    adict = blockcodec.AnchorDict(W)
    n_blocks_done = 0
    stream_sizes: dict[int, int] = {}
    n_anchored = 0

    with_conf = meta.qual_mode == container.QUAL_LOSSY

    # Block framing runs on background workers, committed IN ORDER: the
    # stream resolution (anchor-dict state) stays on this thread, but the
    # entropy coding — the encode-stage majority at chr scale (span
    # enc.frame_bg) — is a pure function of the
    # resolved streams, so blocks frame concurrently on the -nb-cores
    # pool while the device walks ahead. Archives are byte-identical
    # under any scheduling (ordered commit; framing is deterministic).
    from concurrent.futures import ThreadPoolExecutor

    n_frame_workers = max(1, cfg.nb_cores or (os.cpu_count() or 1))
    frame_pool = ThreadPoolExecutor(max_workers=n_frame_workers,
                                    thread_name_prefix="leon-blk")
    commit_q: deque = deque()  # (future, n_reads) in block order

    def _frame_job(todo, nr):
        t = time.time()
        res = blockcodec.assemble_block(todo, nr, use_pool=False)
        span_add("enc.frame_bg", time.time() - t)
        return res

    def _commit(limit: int) -> None:
        # write finished blocks in order; block on the oldest while more
        # than `limit` are pending (0 = drain everything)
        nonlocal n_blocks_done
        while commit_q and (commit_q[0][0].done() or len(commit_q) > limit):
            fut, nr = commit_q.popleft()
            with span("enc.commit_wait"):
                payload, sizes = fut.result()
            with span("enc.write"):
                writer.block(payload, nr)
            n_blocks_done += 1
            for sid, sz in sizes.items():
                stream_sizes[sid] = stream_sizes.get(sid, 0) + sz

    def process(item):
        nonlocal n_anchored
        be, ch, inflight = item
        if ch is None:  # block finished
            with span("enc.finish"):
                todo = be.finish_streams()
            commit_q.append(
                (frame_pool.submit(_frame_job, todo, be.block.n_reads),
                 be.block.n_reads)
            )
            _commit(max(4, 2 * n_frame_workers))
            return
        enc = drain_walk_chunk(ch, inflight, bitset_j, k, H, n_words, seed,
                               with_conf, caps=walk_caps)
        if enc is not None:
            n_anchored += int(enc["anchored"].sum())
        with span("enc.subbatch"):
            be.add_subbatch(
                blockcodec.SubbatchData(
                    codes=ch.codes, seg_len=ch.seg_len, seg_read=ch.seg_read,
                    seg_off=ch.seg_off, n=ch.n, enc=enc,
                )
            )

    pending: deque = deque()
    walk_caps = WalkCaps(cfg)
    ci = 0
    for block, prep in iter_bp():
        be = blockcodec.BlockEncoder(cfg, meta, adict, block, prep)
        for ch in chunk_block(prep, cfg, k):
            ci += 1
            inflight = None
            if ch.L >= k + 1 and (ch.dev_len >= k).any():
                tr(f"enc.chunk{ci}.ready")
                packed_d = dev_cache.pop(ci - 1, None) if dev_cache is not None else None
                if packed_d is None:
                    with span("enc.pack_h2d"):
                        packed_d = placer.batch2(ch.packed) if placer.mesh else jnp.asarray(ch.packed)
                dlen_d = placer.batch1(ch.dev_len)
                with span("enc.dispatch"):
                    inflight = dispatch_walk_chunk(
                        ch, packed_d, dlen_d, bitset_j, k, H, n_words, seed,
                        cfg, with_conf, caps=walk_caps
                    )
                tr(f"enc.chunk{ci}.dispatched")
            pending.append((be, ch, inflight))
            while len(pending) > cfg.max_inflight_chunks:
                process(pending.popleft())
        pending.append((be, None, None))
        if n_blocks:
            _progress(cfg, "encode", n_blocks_done + 1, n_blocks)
    while pending:
        process(pending.popleft())
    _commit(0)
    frame_pool.shutdown(wait=False)
    t_encode = time.time() - t1

    tr("enc.bloom_late_d2h.begin")
    if unitig_build is not None:
        unitig_payload, unitig_solid_src = finish_unitig_build(unitig_build,
                                                               n_words)
        unitig_build = None
    if unitig_payload is not None:
        from leon_tpu.codecs import frames as _frames

        with span("tail.unitig_frame"):
            writer.section(container.TAG_UNITIGS, _frames.frame(unitig_payload))
    else:
        if bitset is None:
            bitset = np.asarray(bitset_j)[:n_words]
        with span("tail.bloom_frame"):
            writer.section(container.TAG_BLOOM, frame_bloom(bitset))
    tr("enc.bloom_late_d2h.end")
    with span("tail.dict"):
        dict_payload = None
        if unitig_payload is not None and len(adict):
            from leon_tpu.ops import unitig as _unitig

            # the build's (compacted) sorted run IS the enumeration —
            # identical to re-spelling the payload (frozen §4a contract)
            # but without the host spell+sort that dominated tail.dict
            if unitig_solid_src is not None and unitig_solid_src[0] == "infl":
                # lookup ON DEVICE: ship the ~100k dict keys up instead
                # of the whole solid run down
                hit, idx, ns = _unitig.solid_indices_dev(
                    unitig_solid_src[1], adict.words_array()
                )
                dict_payload = adict.payload_indexed(hit, idx, ns)
            elif unitig_solid_src is not None:
                dict_payload = adict.payload(unitig_solid_src[1])
            else:  # checkpoint resume: only the payload bytes exist
                dict_payload = adict.payload(
                    _unitig.solid_kmers_sorted(unitig_payload, k)
                )
        if dict_payload is None:
            dict_payload = adict.payload(None)
        writer.section(container.TAG_DICT, dict_payload)
    total = writer.close()
    in_bytes = bank.total_size(input_path)
    stats = {
        "input": input_path,
        "output": output_path,
        "n_reads": n_reads,
        "n_anchored": n_anchored,
        "n_solid_kmers": n_solid,
        "abundance": cutoff,
        "bloom_bytes": 4 * n_words,
        "unitig_bytes": len(unitig_payload) if unitig_payload else 0,
        "dict_entries": len(adict),
        "input_bytes": in_bytes,
        "output_bytes": total,
        "ratio": in_bytes / total if total else 0.0,
        "stream_bytes": {blockcodec_stream_name(s): v for s, v in sorted(stream_sizes.items())},
        "time_parse_s": round(t_parse, 3),
        "time_count_s": round(t_count, 3),
        "time_bloom_s": round(t_bloom, 3),
        "time_encode_s": round(t_encode, 3),
        "time_total_s": round(time.time() - t0, 3),
        # per-span host wall-clock (utils/trace.span): drain_wait is the
        # host waiting on the device and the D2H, everything else is host
        # work
        "span_s": span_totals(),
    }
    return stats


_STREAM_NAMES = {
    1: "flags", 2: "readlen", 3: "anchorpos", 4: "dictidx", 5: "nevt",
    6: "errpos", 7: "errnt", 8: "bif", 9: "rawseq", 10: "excn",
    11: "headers", 12: "quals", 13: "plusline", 14: "fastalines",
    15: "excgap", 16: "excbyte", 17: "quallines",
}


def blockcodec_stream_name(sid: int) -> str:
    return _STREAM_NAMES.get(sid, str(sid))


# ---------------------------------------------------------------------------
# Decompression
# ---------------------------------------------------------------------------


def _ragged_dst(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Destination indices for ragged copies: segment i occupies
    [starts[i], starts[i]+lens[i])."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    rep = np.repeat(starts.astype(np.int64), lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens, dtype=np.int64) - lens, lens
    )
    return rep + within


def _dispatch_block_decode(db: blockcodec.DecodedBlock, meta, dict_words: np.ndarray,
                           bitset_j, cfg: LeonConfig,
                           placer: Optional[_Placer] = None) -> list:
    """Dispatch every sub-batch's device re-walk (async D2H); returns the
    in-flight handles for _assemble_block_seqs. Splitting dispatch from
    drain lets block i+1's walks overlap block i's host assembly.

    With a multi-device placer the per-lane arrays are sharded over the
    mesh (flat event streams + bitset replicated) — the decode mirror of
    compress's lane sharding (reference analog: parallel block decode, [R]
    SURVEY.md §3.3 step 2). Output is byte-identical at any device count:
    the re-walk is a pure function of its lane."""
    from leon_tpu.ops import walk

    import jax.numpy as jnp

    k, H, seed = meta.k, meta.n_hashes, meta.seed
    n_words = np.uint32(meta.n_words)
    n_segs = db.seg_read.shape[0]

    # forward-orientation anchor words per anchored segment (vectorized)
    W = dict_words.shape[1] if dict_words.size else K.words_for_k(k)
    afwd_all = np.zeros((n_segs, W), dtype=np.uint32)
    anch_idx = np.flatnonzero(db.anchored)
    if anch_idx.size:
        words = dict_words[db.dictidx]
        rcw = K.revcomp_words_batch_np(words, k)
        ori = db.orient[anch_idx]
        afwd_all[anch_idx] = np.where(ori[:, None], rcw, words)

    # ONE packed per-lane matrix for the whole block (sliced per
    # sub-batch): [apos, anchored, dlen, nerr_r, nerr_l, nbif_r, nbif_l,
    # err_base(rel), bif_base(rel), afwd...] — the dispatch ships 4 H2D
    # arrays instead of 14 (every transfer has a fixed cost)
    scal_all = np.empty((n_segs, 9 + W), dtype=np.int32)
    scal_all[:, 0] = db.apos
    scal_all[:, 1] = db.anchored
    scal_all[:, 2] = np.where(db.anchored, db.seg_len, 0)
    scal_all[:, 3] = db.nerr_r
    scal_all[:, 4] = db.nerr_l
    scal_all[:, 5] = db.nbif_r
    scal_all[:, 6] = db.nbif_l
    scal_all[:, 7] = db.err_base[:n_segs]
    scal_all[:, 8] = db.bif_base[:n_segs]
    scal_all[:, 9:] = afwd_all.view(np.int32)

    B = cfg.batch_reads
    mesh_n = placer.n if placer is not None and placer.mesh is not None else 1
    dispatched = []
    for s in range(0, n_segs, B):
        e = min(n_segs, s + B)
        sl = db.seg_len[s:e]
        anch = db.anchored[s:e]
        if not anch.any():
            continue
        scal = scal_all[s:e].copy()
        e0 = int(db.err_base[s])
        e1 = int(db.err_base[e]) if e < n_segs else db.errgaps.size
        b0 = int(db.bif_base[s])
        b1 = int(db.bif_base[e]) if e < n_segs else db.bifs.size
        scal[:, 7] -= e0
        scal[:, 8] -= b0
        # pad lanes to the shared _lane_bucket grid (inactive lanes decode
        # to nothing; the assembled output only reads the real rows) — an
        # unpadded tail would compile one fresh XLA shape per odd size.
        # The 4096 grid also satisfies mesh divisibility.
        want = _lane_bucket(e - s, B)
        if mesh_n > 1 and want % mesh_n:
            want += mesh_n - want % mesh_n
        if want > e - s:
            pad = want - (e - s)
            sl = np.concatenate([sl, np.zeros(pad, sl.dtype)])
            anch = np.concatenate([anch, np.zeros(pad, bool)])
            scal = np.concatenate([scal, np.zeros((pad, scal.shape[1]), np.int32)])
        Lb = _bucket_len(int(sl[anch].max()), k)
        ME = max(1, Lb - k)

        # ship the FLAT event streams (padded to a static capacity bucket);
        # the device reconstructs the (B, ME) planes — 1-2 bytes/event
        # host-to-device instead of dense int32 planes
        def padded(flat, lo, hi):
            ln = hi - lo
            cap = 1 << max(10, (max(1, ln + ME) - 1).bit_length())
            out = np.zeros(cap, flat.dtype)
            out[:ln] = flat[lo:hi]
            return placer.replicated(out) if placer is not None and placer.mesh else out

        scal_d = placer.batch2(scal) if placer is not None and placer.mesh else jnp.asarray(scal)
        dec = walk.decode_batch_flat_packed(
            scal_d,
            padded(db.errgaps.astype(np.uint16), e0, e1),
            padded(db.errnts, e0, e1),
            padded(db.bifs, b0, b1),
            bitset_j, k, H, n_words, seed, Lb, W,
        )
        dec.copy_to_host_async()
        dispatched.append((s, anch, sl, Lb, dec))
    return dispatched


def _assemble_block_seqs(db: blockcodec.DecodedBlock, dispatched: list) -> tuple:
    """Drain the dispatched re-walks and build the block's flat ASCII
    sequence buffer (exceptions re-applied). All scatters are vectorized —
    no per-read Python. Returns (seq_bytes flat, read_start, lengths)."""
    from leon_tpu.ops import walk

    n_reads = db.n_reads
    lengths = db.lengths
    read_start = np.concatenate(([0], np.cumsum(lengths)[:-1])) if n_reads else np.zeros(0, np.int64)
    total = int(lengths.sum()) if n_reads else 0
    out_flat = np.zeros(total, dtype=np.uint8)
    seg_start = read_start[db.seg_read] + db.seg_off  # (n_segs,)

    from leon_tpu.utils import ragged

    for s, anch, sl, Lb, dec in dispatched:
        tr("dec.drain.begin")
        dec = walk.unpack_codes_u32_np(np.asarray(dec), Lb)
        tr("dec.drain.end")
        rows = np.flatnonzero(anch)
        lens = sl[rows]
        ragged.move(out_flat, seg_start[s:][rows],
                    np.ascontiguousarray(dec).reshape(-1), rows * Lb, lens)

    # raw segments from the 2-bit stream: unpack the whole stream once,
    # gather per-segment runs (segments are byte-aligned, FORMAT.md §6)
    raw_idx = np.flatnonzero(~db.anchored)
    if raw_idx.size:
        ln = db.seg_len[raw_idx]
        nb = (ln + 3) // 4
        codes_all = K.unpack_2bit_np(db.rawseq, 4 * len(db.rawseq))
        src_start = 4 * (np.cumsum(nb) - nb)
        ragged.move(out_flat, seg_start[raw_idx], codes_all, src_start, ln)

    tr("dec.asm.moved")
    seq_bytes = _BASES[out_flat]
    if db.exc_read.size:
        seq_bytes[read_start[db.exc_read] + db.exc_rel] = db.exc_bytes
    tr("dec.asm.bases")
    return seq_bytes, read_start, lengths


def decompress(input_path: str, output_path: Optional[str] = None, cfg: Optional[LeonConfig] = None) -> dict:
    import jax.numpy as jnp

    cfg = (cfg or LeonConfig()).resolved()
    span_reset()
    t0 = time.time()
    r = container.Reader(input_path)
    meta = r.meta
    if output_path is None:
        stem = input_path[:-5] if input_path.endswith(".leon") else input_path
        root, _dot, _ext = stem.rpartition(".")
        ext = meta.orig_ext.decode()
        output_path = (root if root else stem) + "." + ext + ".d"

    from leon_tpu.codecs import frames as _frames

    W = K.words_for_k(meta.k)
    uni_framed = r.unitigs_payload
    uni_raw = None
    canon_cache: list = []  # spelled unitig k-mers, shared by dict + rebuild

    def _get_canon():
        from leon_tpu.ops import unitig as _unitig

        if not canon_cache:
            canon_cache.append(_unitig.spell_canon(uni_raw, meta.k))
        return canon_cache[0]

    if uni_framed is not None:
        uni_raw, _ = _frames.unframe(uni_framed, 0)
    with span("dec.dict"):
        if r.version >= 5:
            from leon_tpu.ops import unitig as _unitig

            adict = blockcodec.AnchorDict.from_payload_v5(
                r.dict_payload, W,
                solid_provider=lambda: _unitig.solid_kmers_sorted(
                    uni_raw, meta.k, canon=_get_canon()
                ),
            )
        else:
            adict = blockcodec.AnchorDict.from_payload(r.dict_payload, W)
        dict_words = adict.words_array()
    if uni_raw is not None:
        # v4+ UNITIGS section: rebuild the encoder's bit-identical Bloom
        # filter from the stored solid-set unitigs (ops/unitig.py); the
        # spelled set is shared with the DICT enumeration above
        from leon_tpu.ops import unitig as _unitig

        with span("dec.rebuild_bitset"):
            bitset = _unitig.rebuild_bitset_np(
                uni_raw, meta.k, meta.n_words, meta.n_hashes, meta.seed,
                canon=canon_cache[0] if canon_cache else None,
            )
        canon_cache.clear()
    else:
        bloom_bytes, _ = _frames.unframe(r.bloom_payload, 0)
        bitset = np.frombuffer(bloom_bytes, dtype="<u4")
    placer = _Placer(cfg)
    if placer.mesh is not None:
        bitset_j = placer.replicated(
            np.pad(bitset, (0, bloom.alloc_words(bitset.size) - bitset.size))
        )
    else:
        bitset_j = _pad_bitset_dev(bitset, bitset.size)
    tr("dec.setup.end")

    read_index = 0
    # file writes ride a single background worker (ordered by submission,
    # so the output bytes are identical), overlapping the next block's
    # assembly
    from concurrent.futures import ThreadPoolExecutor

    wfuts: list = []

    def _write_job(args, kwargs):
        t = time.time()
        bank.write_records_arrays(*args, **kwargs)
        span_add("dec.write", time.time() - t)

    # the pool's exit joins the writer before the file closes, on errors
    # too (contexts exit in reverse order)
    with open(output_path, "wb") as out, \
            ThreadPoolExecutor(1, thread_name_prefix="leon-dwr") as wpool:
        def emit(db, dispatched, start_index):
            with span("dec.assemble"):
                seq_flat, _read_start, lengths = _assemble_block_seqs(db, dispatched)
            tr("dec.emit.assembled")
            with span("dec.headers"):
                if meta.header_mode:
                    headers = hcodec.decode(db.headers_payload or b"", db.n_reads)
                else:
                    headers = hcodec.synth(start_index, db.n_reads)
                hcat = b"".join(headers)
            hlens = np.fromiter((len(h) for h in headers), dtype=np.int64, count=len(headers))
            tr("dec.emit.headers")
            qcat = None
            if meta.fmt == bank.FASTQ and meta.qual_mode != container.QUAL_NONE:
                qcat = db.quals_concat or b""
            wfuts.append(wpool.submit(
                _write_job,
                (out, meta.fmt, hcat, hlens, seq_flat, lengths),
                dict(qcat=qcat, plus_lens=db.plus_lens, plus_cat=db.plus_cat,
                     fasta_nlines=db.fasta_nlines,
                     fasta_linelens=db.fasta_linelens,
                     qual_nlines=db.qual_nlines,
                     qual_linelens=db.qual_linelens),
            ))

        # depth-2 pipeline: block i+1's device re-walks dispatch before
        # block i's host assembly drains (reference decodes blocks in
        # parallel threads [R]; here the overlap axis is device vs host)
        pending: list = []
        for bi in range(r.n_blocks):
            with span("dec.parse_block"):
                db = blockcodec.parse_block(r.block(bi), meta)
            tr(f"dec.block{bi}.parsed")
            with span("dec.dispatch"):
                dispatched = _dispatch_block_decode(db, meta, dict_words, bitset_j,
                                                    cfg, placer=placer)
            tr(f"dec.block{bi}.dispatched")
            pending.append((db, dispatched, read_index))
            read_index += db.n_reads
            if len(pending) > 1:
                emit(*pending.pop(0))
                tr("dec.emit.end")
        while pending:
            emit(*pending.pop(0))
            tr("dec.emit.end")
        for f in wfuts:  # drain (and surface any write error) before close
            f.result()
    r.close()
    bank.finalize_file(output_path, meta.final_newline)
    return {
        "input": input_path,
        "output": output_path,
        "n_reads": read_index,
        "output_bytes": os.path.getsize(output_path),
        "time_total_s": round(time.time() - t0, 3),
        "span_s": span_totals(),
    }
