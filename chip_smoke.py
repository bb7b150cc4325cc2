"""On-chip smoke test: compress -> decompress on one GPU at E. coli scale.

Drives the main path once through the entry points users call
(pipeline.compress / pipeline.decompress and leon_tpu.cli.main) on a
realistic 2M-read FASTQ of an E. coli-sized genome, after checking each
device stage against its numpy reference at real widths.

Every device stage is integer arithmetic (u32 k-mer words, sorts, gathers,
scans, scatter-adds), so every tolerance below is EXACTLY ZERO: stage
outputs must be bit-identical to their references, round trips
byte-identical, and the GPU's archive byte-identical to the CPU's.

    python chip_smoke.py              # one GPU, phases 0-5
    python chip_smoke.py --multi-gpu  # four GPUs: multi-process and mesh

Exits non-zero, without a result line, when JAX finds no GPU, the native
library does not build, or any check fails. The last line of stdout is
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, ".smoke_data")  # git-ignored input/output cache

READ_LEN = 100
ECOLI_GENOME = 4_641_652      # E. coli K-12 MG1655 chromosome
MAIN_READS = 2_000_000        # ~43x coverage
K63_READS = 500_000
SEED = 7
SLAB_LANES = 65536            # one full walk chunk / count-slab chunk width
WORKER_TIMEOUT_S = 600        # --multi-gpu: 4-process compress deadline

# Phase 5: the seeded 50k-read input and its default-mode archive, both
# pinned on the CPU backend by tests/test_archive_digest.py.
DIGEST_READS = 50_000
DIGEST_GENOME = 200_000
DIGEST_SEED = 11
DIGEST_INPUT_SHA256 = "06da99042107f969af45f1e607c35f4362b94a4373436e2f17d8be8efcb7f8a8"
DIGEST_ARCHIVE_SHA256 = "8f71efbb7f3702eab12d0459fff4ebac5fd33d2f5e541ccbcb8489689cbb0139"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {what}")
    log(f"  ok: {what}")


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 22), b""):
            h.update(blk)
    return h.hexdigest()


def make_input(dirpath: str, n_reads: int, genome: int, seed: int) -> str:
    """scripts/gen_realistic.gen FASTQ (repeat-model genome, RTA3 headers,
    8-bin qualities with quality-driven substitutions), cached at a path
    keyed by its parameters."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import gen_realistic

    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(
        dirpath, f"real_g{genome}_r{n_reads}x{READ_LEN}_s{seed}.fastq")
    if not os.path.exists(path):
        tmp = path + ".tmp"
        gen_realistic.gen(tmp, n_reads, READ_LEN, genome, seed, legacy=False)
        os.replace(tmp, path)
    return path


def digest_archive(src: str, out: str) -> tuple[str, str]:
    """(input sha256, default-mode archive sha256) for phase 5."""
    from leon_tpu import pipeline
    from leon_tpu.config import LeonConfig

    pipeline.compress(src, out, cfg=LeonConfig(verbose=0))
    return sha256(src), sha256(out)


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


# ---------------------------------------------------------------------------
# Phase 2: device stages against their references at real widths
# ---------------------------------------------------------------------------


def stage_checks(src: str, cfg) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from leon_tpu import pipeline
    from leon_tpu.codecs import blocks as blockcodec
    from leon_tpu.io import bank, container
    from leon_tpu.ops import bloom, count
    from leon_tpu.ops import kmer as KM

    cfg = dataclasses.replace(cfg, batch_reads=SLAB_LANES,
                              reads_per_block=SLAB_LANES)
    k, seed = cfg.kmer_size, cfg.seed
    W = KM.words_for_k(k)
    t = time.time()
    blocks = list(bank.read_blocks_arrays(src, cfg.reads_per_block))
    preps = [blockcodec.prepare_block(b, cfg.max_device_len) for b in blocks]
    log(f"  parsed {sum(b.n_reads for b in blocks)} reads in {time.time() - t:.2f} s")

    # (a) one full count slab: device sort+count vs np.unique
    canons, valids, rows = [], [], 0
    for prep in preps:
        for ch in pipeline.chunk_block(prep, cfg, k):
            c, _, v = KM.kmer_scan_packed(jnp.asarray(ch.packed),
                                          jnp.asarray(ch.dev_len), k, ch.L)
            canons.append(c)
            valids.append(v)
            rows += c.shape[0] * c.shape[1]
            if rows >= cfg.count_slab_kmers:
                break
        if rows >= cfg.count_slab_kmers:
            break
    bucket = count._bucket_size(rows)
    times = []
    for _ in range(2):  # first call compiles
        t = time.time()
        skeys, boundary, cnts = jax.block_until_ready(
            count._fused_sort_count(tuple(canons), tuple(valids), bucket, k))
        times.append(time.time() - t)
    ma = count._fused_sort_count.lower(tuple(canons), tuple(valids), bucket,
                                       k).compile().memory_analysis()
    log(f"  slab sort+count: {rows} rows (bucket {bucket}, W={W}): "
        f"first call {times[0]:.3f} s, second {times[1]:.4f} s; "
        f"program temp {getattr(ma, 'temp_size_in_bytes', None)} B; "
        f"peak_bytes_in_use {peak_bytes(jax.local_devices()[0])}")
    idx = np.flatnonzero(np.asarray(boundary))
    dev_keys = np.stack([np.asarray(skeys[j])[idx] for j in range(W)], axis=1)
    dev_cnt = np.asarray(cnts)[idx]
    flat = np.concatenate([np.asarray(c).reshape(-1, W)[np.asarray(v).reshape(-1)]
                           for c, v in zip(canons, valids)])
    ref_keys, ref_cnt = np.unique(flat[:, ::-1], axis=0, return_counts=True)
    check(np.array_equal(dev_keys, ref_keys) and np.array_equal(dev_cnt, ref_cnt),
          f"slab sort+count == np.unique ({ref_keys.shape[0]} distinct of "
          f"{flat.shape[0]} valid k-mers)")
    del canons, valids, flat, skeys, boundary, cnts, dev_keys, ref_keys

    # (b) the production count pass over the whole input, then its Bloom
    # filter and solid compaction against numpy
    t = time.time()
    bitset_j, n_words, cutoff, n_solid, H, solidset = pipeline._count_pass_device(
        preps, cfg, k, None, seed, lossy_quals=True)
    jax.block_until_ready(bitset_j)
    log(f"  count pass: {time.time() - t:.2f} s, cutoff {cutoff}, "
        f"{n_solid} solid of {solidset[2]} distinct, n_words {n_words}, H {H}; "
        f"peak_bytes_in_use {peak_bytes(jax.local_devices()[0])}")
    words_d, cnt_d = solidset[0], solidset[1]
    words, cnt = np.asarray(words_d), np.asarray(cnt_d)
    solid_m = cnt >= cutoff
    ref_bits = bloom.build_np(words[solid_m], n_words, H, seed, k)
    dev_bits = np.asarray(bloom.build_device(words_d, cnt_d, jnp.int32(cutoff),
                                             n_words, H, seed, k))
    check(np.array_equal(dev_bits[:n_words], ref_bits)
          and not dev_bits[n_words:].any(),
          f"bloom.build_device == bloom.build_np ({n_words} words)")
    check(np.array_equal(np.asarray(bitset_j), dev_bits),
          "count pass bitset == bloom.build_device")
    out_size = count._bucket_size(max(1, n_solid))
    ow, oc = count.compact_solid(words_d, cnt_d, np.int32(cutoff), out_size)
    ow, oc = np.asarray(ow), np.asarray(oc)
    check(np.array_equal(ow[:n_solid], words[solid_m])
          and np.array_equal(oc[:n_solid], cnt[solid_m])
          and not ow[n_solid:].any() and not oc[n_solid:].any(),
          f"compact_solid == numpy mask ({n_solid} of {words.shape[0]} rows)")
    del words, cnt, ow, oc

    # (c) one full 65536-lane chunk: compact walk encode, then the flat
    # decode through the block codec must give back the chunk's bases
    prep, block = preps[0], blocks[0]
    ch = next(pipeline.chunk_block(prep, cfg, k))
    check(ch.codes.shape[0] == SLAB_LANES and ch.n == block.n_reads,
          f"walk chunk is one full {SLAB_LANES}-lane block")
    packed_d, dlen_d = jnp.asarray(ch.packed), jnp.asarray(ch.dev_len)
    caps = pipeline.WalkCaps(cfg)
    times = []
    for _ in range(2):  # first call compiles
        t = time.time()
        infl = pipeline.dispatch_walk_chunk(ch, packed_d, dlen_d, bitset_j, k, H,
                                            n_words, seed, cfg, False, caps=caps)
        jax.block_until_ready(infl[0])
        times.append(time.time() - t)
    enc = pipeline.drain_walk_chunk(ch, infl, bitset_j, k, H, n_words, seed,
                                    False, caps=caps)
    log(f"  walk encode chunk: first call {times[0]:.3f} s, second "
        f"{times[1]:.4f} s; anchored {int(enc['anchored'].sum())}/{ch.n}")
    meta = container.Meta(
        k=k, fmt=bank.FASTQ, qual_mode=container.QUAL_LOSSLESS, header_mode=1,
        n_hashes=H, final_newline=True, n_words=n_words, seed=seed,
        n_reads=block.n_reads, abundance=cutoff, seglen=cfg.max_device_len,
        orig_ext=b"fastq")
    adict = blockcodec.AnchorDict(W)
    be = blockcodec.BlockEncoder(cfg, meta, adict, block, prep)
    be.add_subbatch(blockcodec.SubbatchData(
        codes=ch.codes, seg_len=ch.seg_len, seg_read=ch.seg_read,
        seg_off=ch.seg_off, n=ch.n, enc=enc))
    payload, _ = blockcodec.assemble_block(be.finish_streams(), block.n_reads,
                                           use_pool=False)
    db = blockcodec.parse_block(payload, meta)
    t = time.time()
    disp = pipeline._dispatch_block_decode(db, meta, adict.words_array(),
                                           bitset_j, cfg)
    jax.block_until_ready([d[-1] for d in disp])
    log(f"  flat decode chunk (first call): {time.time() - t:.3f} s")
    seq, _, _ = pipeline._assemble_block_seqs(db, disp)
    check(np.array_equal(seq, np.asarray(block.seq_cat)),
          "flat decode reproduces the chunk's bases")


# ---------------------------------------------------------------------------
# Phase 3/4: the main path, end to end
# ---------------------------------------------------------------------------


def roundtrip(src: str, cfg, label: str, want: str) -> None:
    """compress -> decompress through the pipeline entry points; the
    oracle is the one -test-file uses (cli.roundtrip_ok)."""
    import jax

    from leon_tpu import pipeline
    from leon_tpu.cli import roundtrip_ok
    from leon_tpu.utils import devinfo

    out = os.path.join(DATA, label + ".leon")
    dec = out + ".d"
    t = time.time()
    st = pipeline.compress(src, out, cfg=cfg)
    tc = time.time() - t
    t = time.time()
    ds = pipeline.decompress(out, dec, cfg=cfg)
    td = time.time() - t
    ok, kind = roundtrip_ok(cfg, src, dec)
    n = st["n_reads"]
    log(f"  [{label}] {n} reads, ratio {st['ratio']:.4f} "
        f"({st['input_bytes']} -> {st['output_bytes']} B), "
        f"unitig section {st['unitig_bytes']} B, bloom {st['bloom_bytes']} B")
    log(f"  [{label}] compress {tc:.2f} s = {n / tc:.1f} reads/s; "
        f"decompress {td:.2f} s = {n / td:.1f} reads/s")
    log(f"  [{label}] span_s {json.dumps(st['span_s'])}")
    log(f"  [{label}] decompress_span_s {json.dumps(ds['span_s'])}")
    log(f"  [{label}] peak_bytes_in_use "
        f"{[peak_bytes(d) for d in jax.local_devices()]}; card {devinfo.card()}")
    check(ok and kind == want, f"[{label}] round trip {kind}-exact (want {want})")


def device_facts() -> None:
    """Phase 0: a GPU or nothing; print what the numbers below ran on."""
    import jax

    from leon_tpu.utils import devinfo

    devs = devinfo.require_gpu()
    log(f"card: {devinfo.card()}")
    log(f"jax {jax.__version__}; {devs[0].device_kind} x {len(jax.devices())}; "
        f"bytes_limit {devs[0].memory_stats()['bytes_limit']}")


def single_gpu(args) -> None:
    import jax

    from leon_tpu import native
    from leon_tpu.config import LeonConfig
    from leon_tpu.utils import compile_cache, devinfo

    device_facts()
    log(f"compile cache: {compile_cache.enable()}")
    log(f"native library loaded: {native.get_lib() is not None}")
    devinfo.require_native()
    cfg = LeonConfig(verbose=0).resolved()
    log(f"resolved: batch_reads {cfg.batch_reads}, "
        f"count_spill_rows {cfg.count_spill_rows}")

    # phase 1: inputs (generation is set-up, outside every timed region)
    t = time.time()
    src = make_input(DATA, args.reads, ECOLI_GENOME, SEED)
    src63 = make_input(DATA, K63_READS, ECOLI_GENOME, SEED + 1)
    src50 = make_input(DATA, DIGEST_READS, DIGEST_GENOME, DIGEST_SEED)
    log(f"phase 1: inputs ready in {time.time() - t:.1f} s: "
        f"{src} ({os.path.getsize(src)} B)")

    log("phase 2: device stages vs references (tolerance: zero)")
    stage_checks(src, cfg)

    log("phase 3: main path end to end")
    roundtrip(src, LeonConfig(lossless=True, verbose=0), "lossless", "byte")
    roundtrip(src, LeonConfig(verbose=0), "default", "sequence")
    from leon_tpu import cli

    cli_src = os.path.join(DATA, "cli_input.fastq")
    with open(src50, "rb") as fi, open(cli_src, "wb") as fo:
        fo.write(fi.read())
    rc = cli.main(["-file", cli_src, "-c", "-lossless", "-test-file",
                   "-verbose", "0"])
    check(rc == 0, "cli.main -c -lossless -test-file (50k reads)")

    log("phase 4: k=63 -abundance 3 -lossless")
    roundtrip(src63, LeonConfig(kmer_size=63, abundance=3, lossless=True,
                                verbose=0), "k63", "byte")

    log("phase 5: GPU archive == CPU-pinned archive")
    in_sha, ar_sha = digest_archive(src50, os.path.join(DATA, "digest.leon"))
    log(f"  input {in_sha}\n  archive {ar_sha}")
    check(in_sha == DIGEST_INPUT_SHA256, "input digest == pinned (generator)")
    check(ar_sha == DIGEST_ARCHIVE_SHA256, "archive digest == CPU-pinned")

    log(f"card: {devinfo.card()}")
    print(json.dumps({"ok": True, "device": devinfo.device_json(jax.devices())}))


# ---------------------------------------------------------------------------
# --multi-gpu: four processes with one card each, then a 4-device mesh
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_worker(pid: int, nproc: int, port: int, src: str, out: str) -> None:
    """One process of a jax.distributed run; its card is pinned by
    CUDA_VISIBLE_DEVICES, set by the parent."""
    from leon_tpu.config import LeonConfig
    from leon_tpu.parallel import distributed
    from leon_tpu.utils import compile_cache, devinfo

    compile_cache.enable()
    distributed.initialize(f"localhost:{port}", nproc, pid)
    devinfo.require_gpu()
    st = distributed.compress_distributed(src, out,
                                          cfg=LeonConfig(lossless=True, verbose=0))
    import jax

    log(f"worker {pid}: {st['n_blocks_local']} of {st['n_blocks']} blocks, "
        f"{st['time_total_s']} s, archive {st.get('output_bytes')} B, "
        f"traffic {json.dumps(st['traffic_bytes'])}, "
        f"peak_bytes_in_use {peak_bytes(jax.local_devices()[0])}")


def multi_gpu(args, n: int = 4) -> None:
    from leon_tpu.utils import devinfo

    log(f"card:\n{devinfo.card()}")
    # build the native library once, before the workers import it
    devinfo.require_native()
    src = make_input(DATA, args.reads, ECOLI_GENOME, SEED + 2)
    log(f"input: {src} ({os.path.getsize(src)} B)")

    # (a) n processes, one card each. The parent stays off the GPU until
    # every worker has exited: a JAX process reserves most of a card.
    out_n = os.path.join(DATA, f"dist{n}.leon")
    port = _free_port()
    procs = []
    t = time.time()
    for i in range(n):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(i))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             str(i), str(n), str(port), src, out_n], env=env))
    # one failed worker leaves the others waiting in a collective: stop
    # them all as soon as any exits non-zero, or at the deadline
    deadline = time.time() + WORKER_TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if time.time() > deadline or any(p.poll() for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.5)
    rcs = [p.wait() for p in procs]
    log(f"(a) {n}-process compress: {time.time() - t:.1f} s wall, rcs {rcs}")
    check(all(rc == 0 for rc in rcs), f"{n} distributed workers exited 0")

    import jax

    from leon_tpu import pipeline
    from leon_tpu.config import LeonConfig
    from leon_tpu.ops import count
    from leon_tpu.ops import kmer as KM
    from leon_tpu.parallel import distributed
    from leon_tpu.utils import compile_cache

    compile_cache.enable()
    devs = devinfo.require_gpu(n)
    log(f"jax {jax.__version__}; {devs[0].device_kind} x {len(jax.devices())}")
    out_1 = os.path.join(DATA, "dist1.leon")
    t = time.time()
    distributed.compress_distributed(
        src, out_1, cfg=LeonConfig(lossless=True, mesh_devices=1, verbose=0))
    log(f"(a) 1-process compress: {time.time() - t:.1f} s")
    check(filecmp.cmp(out_n, out_1, shallow=False),
          f"{n}-process archive == 1-process archive")

    # (b) the in-process mesh path (pipeline._Placer, parallel/mesh.py)
    for m in (n, 1):
        cfg = LeonConfig(lossless=True, mesh_devices=m, verbose=0)
        arch = os.path.join(DATA, f"mesh{m}.leon")
        t = time.time()
        st = pipeline.compress(src, arch, cfg=cfg)
        tc = time.time() - t
        t = time.time()
        pipeline.decompress(arch, arch + ".d", cfg=cfg)
        td = time.time() - t
        log(f"(b) mesh_devices={m}: compress {tc:.2f} s "
            f"({st['n_reads'] / tc:.1f} reads/s), decompress {td:.2f} s; "
            f"peak_bytes_in_use per card {[peak_bytes(d) for d in devs]}")
    a, b = os.path.join(DATA, f"mesh{n}.leon"), os.path.join(DATA, "mesh1.leon")
    check(filecmp.cmp(a, b, shallow=False), f"mesh {n} archive == mesh 1 archive")
    check(filecmp.cmp(a, out_1, shallow=False), "mesh archive == distributed archive")
    check(filecmp.cmp(a + ".d", b + ".d", shallow=False),
          f"mesh {n} decode == mesh 1 decode")
    check(filecmp.cmp(a + ".d", src, shallow=False), "mesh round trip byte-exact")

    # does the lane-sharded count sort gather every row to each card?
    import jax.numpy as jnp
    import numpy as np

    cfg = LeonConfig(lossless=True, mesh_devices=n).resolved()
    placer = pipeline._Placer(cfg)
    codes = np.zeros((cfg.batch_reads, 104), np.uint8)
    dlen = np.full(cfg.batch_reads, READ_LEN, np.int32)
    packed = placer.batch2(KM.pack_codes_np(codes))
    c, _, v = KM.kmer_scan_packed(packed, placer.batch1(dlen), 31, 104)
    rows = c.shape[0] * c.shape[1]
    hlo = count._fused_sort_count.lower((c,), (v,), count._bucket_size(rows),
                                        31).compile().as_text()
    out = count._fused_sort_count((c,), (v,), count._bucket_size(rows), 31)
    log(f"(b) count sort over a {n}-way lane-sharded chunk: input sharding "
        f"{c.sharding}, output sharding {out[0][0].sharding}, "
        f"all-gather ops in HLO {hlo.count('all-gather')}")

    log(f"card:\n{devinfo.card()}")
    print(json.dumps({"ok": True, "device": devinfo.device_json(jax.devices())}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="four cards: the multi-process and mesh phases only")
    ap.add_argument("--reads", type=int, default=MAIN_READS,
                    help=f"reads in the main input (default {MAIN_READS})")
    ap.add_argument("--dist-worker", nargs=5, metavar=("PID", "NPROC", "PORT",
                                                       "SRC", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dist_worker:
        pid, nproc, port, src, out = args.dist_worker
        dist_worker(int(pid), int(nproc), int(port), src, out)
    elif args.multi_gpu:
        multi_gpu(args)
    else:
        single_gpu(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
