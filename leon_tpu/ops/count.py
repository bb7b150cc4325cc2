"""Canonical k-mer counting and the solidity threshold.

Reference behavior: DSK disk-streaming sorting-count ([R] gatb-core
kmer/impl/SortingCountAlgorithm, /root/reference/README.md:13) with an
automatic abundance cutoff from the count histogram (README.md:54).

Device-resident, transfer-minimal shape: canonical k-mers
stream through fixed-size device-memory SLABS (DeviceCounter below); each slab is
sorted (`lax.sort` over W uint32 keys — no 64-bit anywhere), run-length
counted and compacted to its distinct set on device, and compacted runs
merge hierarchically. Host traffic per slab: one scalar (the distinct
count) plus, at finalize, the 256-entry count histogram (for the
abundance cutoff); the Bloom filter builds on device from the final
merged run. The disk-partition dance of DSK is replaced by bounded
device-memory slabs; multi-device sharding of the k-mer space comes via
the parallel/ layer.

count_batch is the per-batch reference the tests compare against;
merge_counts merges the host-spilled runs and the distributed exchange.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from leon_tpu.utils.trace import tr


def _next_boundary(boundary):
    """(n,) int32: for each row, the index of the NEXT boundary strictly
    after it (n when none). Reverse associative min-scan over marked
    positions — log-depth, no scatters."""
    n = boundary.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    marked = jnp.where(boundary, pos, n)
    revmin = lax.cummin(marked, axis=0, reverse=True)
    return jnp.concatenate([revmin[1:], jnp.full(1, n, jnp.int32)])


@partial(jax.jit, static_argnames=("k",))
def _sort_count_device(words_t: tuple, valid, k: int = 0):
    """words_t: tuple of W (N,) uint32 arrays, most-significant first.
    Returns sorted words (tuple), boundary mask, and per-position counts
    (count at first occurrence, 0 elsewhere). Invalid entries sort last.

    When k is given and not a multiple of 16, the top word of a real k-mer
    can never be all-ones (unused high bits are masked), so the all-ones
    sentinel doubles as the validity marker and the sort drops one
    operand (~1/3 less sort work)."""
    W = len(words_t)
    # force invalid entries to all-ones so they cluster at the end
    inv = ~valid
    keys = tuple(jnp.where(inv, jnp.uint32(0xFFFFFFFF), w) for w in words_t)
    if k and k % 16 != 0:
        sorted_ops = lax.sort(keys, num_keys=W)
        skeys = sorted_ops
        svalid = skeys[0] != jnp.uint32(0xFFFFFFFF)  # MSW all-ones = invalid
    else:
        sorted_ops = lax.sort(keys + (valid.astype(jnp.uint32),), num_keys=W)
        skeys, svalid = sorted_ops[:W], sorted_ops[W].astype(bool)
    n = skeys[0].shape[0]
    # boundary: any word differs from the previous position (invalids sort
    # to the end and are never boundaries; they contribute 0 to the sums)
    prev_ne = jnp.zeros(n, dtype=bool)
    for w in skeys:
        prev_ne = prev_ne | jnp.concatenate([jnp.ones(1, dtype=bool), w[1:] != w[:-1]])
    boundary = prev_ne & svalid
    # run length at boundary i = next boundary index - i (clamped to the
    # valid count). Scan arithmetic, NOT segment_sum: the reverse
    # min-scan is log-depth elementwise work with no scatter.
    nv = jnp.sum(svalid.astype(jnp.int32))  # invalids sort last: runs of
    # valid rows end at the next boundary or at nv, whichever is first
    counts = jnp.where(
        boundary,
        jnp.minimum(_next_boundary(boundary), nv) - jnp.arange(n, dtype=jnp.int32),
        0,
    )
    return skeys, boundary, counts


def count_batch(canon: np.ndarray | jnp.ndarray, valid) -> tuple[np.ndarray, np.ndarray]:
    """Count one batch of canonical k-mers on device.

    canon: (B, P, W) uint32, valid: (B, P) bool.
    Returns host arrays (unique (M, W) uint32, counts (M,) int64).
    """
    canon = jnp.asarray(canon)
    B, P, W = canon.shape
    flat = canon.reshape(-1, W)
    v = jnp.asarray(valid).reshape(-1)
    words_t = tuple(flat[:, W - 1 - j] for j in range(W))  # MSW first
    skeys, boundary, counts = _sort_count_device(words_t, v)
    boundary = np.asarray(boundary)
    counts = np.asarray(counts)
    idx = np.flatnonzero(boundary)
    uniq = np.stack([np.asarray(skeys[W - 1 - j])[idx] for j in range(W)], axis=1)
    return uniq, counts[idx].astype(np.int64)


def merge_counts(partials: list[tuple[np.ndarray, np.ndarray]]) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-batch (unique, counts) partials on host (sorted merge).

    Fast path: when every partial is itself sorted (the slab counter's
    spilled runs and the distributed exchange always are), a native
    streaming k-way merge (leon_native.cpp leon_merge_runs) replaces the
    global lexsort — the measured count.finalize majority at chr scale
    (340M distinct rows). Unsorted partials fall back to the lexsort."""
    if not partials:
        return np.zeros((0, 1), dtype=np.uint32), np.zeros(0, dtype=np.int64)
    nat = _merge_counts_native(partials)
    if nat is not None:
        return nat
    allk = np.concatenate([p[0] for p in partials], axis=0)
    allc = np.concatenate([p[1] for p in partials], axis=0)
    if allk.shape[0] == 0:
        return allk, allc
    W = allk.shape[1]
    # lexsort: most significant word = last key
    order = np.lexsort(tuple(allk[:, j] for j in range(W)))
    sk, sc = allk[order], allc[order]
    newgrp = np.ones(sk.shape[0], dtype=bool)
    newgrp[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    gid = np.cumsum(newgrp) - 1
    out_counts = np.zeros(int(gid[-1]) + 1, dtype=np.int64)
    np.add.at(out_counts, gid, sc)
    return sk[newgrp], out_counts


def _merge_counts_native(partials):
    """Native k-way merge of sorted (uniq, counts) runs; None when the
    native lib is unavailable or any run is not sorted/contiguous-ready."""
    import ctypes

    from leon_tpu import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "leon_merge_runs"):
        return None
    runs = [(k, c) for k, c in partials if k.shape[0] > 0]
    if not runs:
        k0 = partials[0][0]
        return (np.zeros((0, k0.shape[1]), np.uint32), np.zeros(0, np.int64))
    W = runs[0][0].shape[1]
    keys_c, cnts_c, ns = [], [], []
    for k, c in runs:
        if k.shape[1] != W:
            return None
        kk = np.ascontiguousarray(k, dtype=np.uint32)
        if not lib.leon_rows_sorted(kk.shape[0], W, kk.ctypes.data):
            return None
        keys_c.append(kk)
        cnts_c.append(np.ascontiguousarray(c, dtype=np.int64))
        ns.append(kk.shape[0])
    R = len(runs)
    total = int(sum(ns))
    out_k = np.empty((total, W), dtype=np.uint32)
    out_c = np.empty(total, dtype=np.int64)
    kp = (ctypes.c_void_p * R)(*[k.ctypes.data for k in keys_c])
    cp = (ctypes.c_void_p * R)(*[c.ctypes.data for c in cnts_c])
    ns_a = np.asarray(ns, dtype=np.int64)
    m = lib.leon_merge_runs(R, W, kp, cp, ns_a.ctypes.data,
                            out_k.ctypes.data, out_c.ctypes.data)
    return np.ascontiguousarray(out_k[:m]), out_c[:m]


def histogram(counts: np.ndarray, max_count: int = 255) -> np.ndarray:
    return np.bincount(np.minimum(counts, max_count), minlength=max_count + 1)


# ---------------------------------------------------------------------------
# Device-resident slab counting (the production path)
# ---------------------------------------------------------------------------
#
# The device re-design of DSK's bounded-memory partition dance
# (/root/reference/README.md:13 "disk streaming kmer counting"; SURVEY.md
# §3.4): instead of P disk partitions, the multiset streams through
# fixed-shape device-memory SLABS. Each full slab is sorted + run-length-counted on
# device and compacted to its distinct (kmer, count) run — typically 5-30x
# smaller than the raw slab at sequencing coverage — and runs are merged
# hierarchically (sort with count payload + segment-sum). Peak memory is
# slab_size + the distinct set, not the multiset, and every sort reuses a
# handful of bucketed compile shapes. Host traffic per slab: one scalar
# (the distinct count, to pick the compaction bucket).


@partial(jax.jit, static_argnames=("bucket", "k"))
def _fused_sort_count(chunks: tuple, valids: tuple, bucket: int, k: int):
    """Reshape+concat+pad+sort+count of a slab in one launch. chunks are
    (B, P, W) canonical-kmer arrays; pad entries are invalid."""
    W = chunks[0].shape[-1]
    flat = jnp.concatenate([c.reshape(-1, W) for c in chunks], axis=0)
    valid = jnp.concatenate([v.reshape(-1) for v in valids])
    n = flat.shape[0]
    if bucket > n:
        flat = jnp.concatenate([flat, jnp.zeros((bucket - n, W), jnp.uint32)], axis=0)
        valid = jnp.concatenate([valid, jnp.zeros(bucket - n, bool)])
    words_t = tuple(flat[:, W - 1 - j] for j in range(W))
    return _sort_count_device(words_t, valid, k)


@partial(jax.jit, static_argnames=("out_size",))
def _compact_run(skeys: tuple, boundary, counts, out_size: int):
    """Scatter the distinct entries (boundary positions) of a sorted slab
    into fixed-shape run arrays: keys (padded with all-ones = sorts-last
    sentinel) and int32 counts (0 = pad)."""
    dst = jnp.where(boundary, jnp.cumsum(boundary.astype(jnp.int32)) - 1, out_size)
    keys_out = tuple(
        jnp.full(out_size + 1, 0xFFFFFFFF, jnp.uint32).at[dst].set(w, mode="drop")[:out_size]
        for w in skeys
    )
    cnt = (
        jnp.zeros(out_size + 1, jnp.int32)
        .at[dst]
        .set(counts.astype(jnp.int32), mode="drop")[:out_size]
    )
    return keys_out, cnt


@jax.jit
def _merge_sorted_runs(words_t: tuple, counts):
    """Merge concatenated runs: sort by key with the counts as payload,
    segment-sum counts per distinct key. Pad entries carry count 0 and
    all-ones keys, so they either sort last or fold into a real group
    contributing nothing. Returns (sorted keys, boundary, summed counts)."""
    W = len(words_t)
    ops = lax.sort(tuple(words_t) + (counts,), num_keys=W)
    skeys, scnt = ops[:W], ops[W]
    n = skeys[0].shape[0]
    prev_ne = jnp.zeros(n, dtype=bool)
    for w in skeys:
        prev_ne = prev_ne | jnp.concatenate([jnp.ones(1, dtype=bool), w[1:] != w[:-1]])
    # Per-segment totals via prefix sums + ONE gather at the next-boundary
    # index (no segment_sum scatter, see _sort_count_device). The prefix
    # sum runs in u32 with wraparound:
    # each SEGMENT total fits u32, so E[next]-E[i] is exact mod 2^32 even
    # when the global count mass exceeds 2^31 (genome-scale merges).
    cu = scnt.astype(jnp.uint32)
    e_incl = jnp.cumsum(cu)
    e_excl = e_incl - cu
    nxt = _next_boundary(prev_ne)
    e_at_nxt = jnp.where(nxt >= n, e_incl[n - 1], e_excl[jnp.minimum(nxt, n - 1)])
    summed_u = e_at_nxt - e_excl
    summed = jnp.where(
        prev_ne, jnp.minimum(summed_u, jnp.uint32(0x7FFFFFFF)), jnp.uint32(0)
    ).astype(jnp.int32)
    boundary = prev_ne & (summed > 0)
    return skeys, boundary, summed


@jax.jit
def _hist_of_sorted(boundary, counts):
    """Count histogram: hist[c] = #distinct kmers with min(count, 255) ==
    c. Works on sorted multisets and (compacted or merged) runs alike —
    counts are nonzero exactly at distinct-kmer boundary positions."""
    cc = jnp.where(boundary, jnp.minimum(counts, 255), 0)
    hist = jnp.zeros(256, jnp.int32).at[cc].add(1, mode="drop")
    return hist.at[0].set(0)


def _bucket_size(n: int, floor: int = 1 << 12) -> int:
    """1/8-octave size buckets: few compile shapes, <=12.5% waste.
    Above 64M rows the grid coarsens to 1/4-octave (<=25% waste): each
    fresh giant shape costs a compile of the sort programs at that size,
    so fewer, reusable big shapes beat tighter padding there."""
    shift = 3 if n <= (64 << 20) else 2
    gran = max(floor, 1 << max(0, (n - 1).bit_length() - shift))
    return -(-n // gran) * gran


class DeviceCounter:
    """Streams canonical k-mers through fixed-size device slabs, maintaining
    compacted (distinct kmer, count) runs that merge hierarchically; the
    Bloom filter builds on device from the final merged run. Replaces both
    the reference's DSK disk partitions and round 1's one-shot whole-
    multiset sort (which capped device counting at ~48M k-mers)."""

    def __init__(self, k: int, slab_kmers: int = 1 << 25, merge_factor: int = 4,
                 spill_rows: int = 48 << 20):
        from leon_tpu.ops.kmer import words_for_k

        self.k = k
        self.W = words_for_k(k)
        self.slab = int(slab_kmers)
        self.merge_factor = int(merge_factor)
        self._pend: list = []     # device (n, W) uint32 chunks
        self._pend_valid: list = []
        self._pend_n = 0
        self._runs: list = []     # (keys_t MSW-first tuple, counts, bucket)
        self._runs_n = 0          # sum of run bucket sizes
        self._next_merge = self.merge_factor * self.slab
        self.n_total = 0
        # device memory is bounded: once a merged device run exceeds
        # spill_rows it moves to host RAM (the DSK temp-disk analog) and
        # device merging restarts empty — the device-side sort transient
        # stays O(spill + merge_factor*slab) rows no matter how large the
        # input is (config.spill_rows_for sizes it from the device).
        self.spill_rows = int(spill_rows)
        # spilled runs: resolved (uniq LSW-first np, counts np i64) pairs,
        # except the newest which may still be an in-flight device pair
        # (keys_t, cnt_c) whose async D2H resolves at the next spill/merge
        self._host_runs: list = []
        # deferred slab compaction: (skeys, boundary, counts, nu_dev) of
        # the last flushed slab, its distinct-count scalar still in an
        # async D2H — resolved lazily so the sync overlaps the next
        # chunks' H2D/scan dispatches instead of stalling the add() loop
        self._pending_compact = None

    def add(self, canon, valid) -> None:
        """canon (B, P, W) device array, valid (B, P) device bool. Chunks
        are kept 3D until a slab flushes — group-by-shape concat keeps the
        eager dispatch count per flush O(#shapes), not O(#chunks)."""
        B, P, W = canon.shape
        self._pend.append(canon)
        self._pend_valid.append(valid)
        self._pend_n += B * P
        self.n_total += B * P
        if self._pend_n >= self.slab:
            self._flush_slab()

    def _sorted_pending(self):
        """Sort+count the pending multiset (bucket-padded); returns
        (skeys MSW-first, boundary, counts) without any host sync.

        The concat/pad/reshape/sort chain runs as ONE fused jit (static
        chunk arity): one launch per slab instead of one per eager op."""
        pend, valids = self._pend, self._pend_valid
        self._pend, self._pend_valid, self._pend_n = [], [], 0
        n = sum(int(c.shape[0] * c.shape[1]) for c in pend)
        bucket = _bucket_size(n)
        return _fused_sort_count(tuple(pend), tuple(valids), bucket, self.k)

    def _flush_slab(self) -> None:
        if not self._pend:
            return
        self._resolve_compact()  # at most one slab outstanding
        skeys, boundary, counts = self._sorted_pending()
        nu_dev = jnp.sum(boundary, dtype=jnp.int32)
        try:
            nu_dev.copy_to_host_async()
        except AttributeError:  # non-jax array backends in tests
            pass
        self._pending_compact = (skeys, boundary, counts, nu_dev)

    def _resolve_compact(self) -> None:
        """Finish the deferred compaction of the last flushed slab (sync
        on its distinct-count scalar, scatter into a bucketed run)."""
        pc = self._pending_compact
        if pc is None:
            return
        self._pending_compact = None
        skeys, boundary, counts, nu_dev = pc
        nu = int(nu_dev)
        out_size = _bucket_size(max(1, nu))
        keys_c, cnt_c = _compact_run(skeys, boundary, counts, out_size)
        self._runs.append((keys_c, cnt_c, out_size))
        self._runs_n += out_size
        if self._runs_n >= self._next_merge and len(self._runs) > 1:
            self._merge_runs()

    def _concat_and_merge(self):
        """Concatenate all runs (bucket-padded) and merge-sort them;
        returns (sorted keys, boundary, summed counts) — no host sync."""
        W = self.W
        total = sum(b for _, _, b in self._runs)
        bucket = _bucket_size(total)
        keys_cat = []
        for j in range(W):
            parts = [r[0][j] for r in self._runs]
            if bucket > total:
                parts.append(jnp.full(bucket - total, 0xFFFFFFFF, jnp.uint32))
            keys_cat.append(jnp.concatenate(parts))
        cparts = [r[1] for r in self._runs]
        if bucket > total:
            cparts.append(jnp.zeros(bucket - total, jnp.int32))
        counts_cat = jnp.concatenate(cparts)
        skeys, boundary, summed = _merge_sorted_runs(tuple(keys_cat), counts_cat)
        return skeys, boundary, summed

    def _merge_runs(self) -> None:
        if len(self._runs) <= 1:
            if self._runs and self._runs[0][2] >= self.spill_rows:
                self._spill_run(*self._runs[0])
            return
        skeys, boundary, summed = self._concat_and_merge()
        nu = int(jnp.sum(boundary, dtype=jnp.int32))
        out_size = _bucket_size(max(1, nu))
        keys_c, cnt_c = _compact_run(skeys, boundary, summed, out_size)
        if out_size >= self.spill_rows:
            self._spill_run(keys_c, cnt_c, out_size)
        else:
            self._runs = [(keys_c, cnt_c, out_size)]
            self._runs_n = out_size
            self._next_merge = out_size + self.merge_factor * self.slab

    def _spill_run(self, keys_c, cnt_c, out_size: int) -> None:
        """Move a compacted device run to host RAM (trimmed lazily) and
        reset the device merge hierarchy. The D2H transfers START here
        (copy_to_host_async) but resolve at merge time: a chr-scale run
        spills ~0.5 GB per run, and the synchronous np.asarray form
        serialized every spill against the count loop (part of the 408 s
        count.dispatch span at 10M reads)."""
        for arr in (*keys_c, cnt_c):
            try:
                arr.copy_to_host_async()
            except AttributeError:  # non-jax arrays in tests
                pass
        # depth-1 deferral: resolve the PREVIOUS spill now (its async D2H
        # completed during the minutes of count compute since) so HBM
        # never holds more than one spilled run
        if self._host_runs and not isinstance(self._host_runs[-1][0], np.ndarray):
            self._host_runs[-1] = self._resolve_host_run(self._host_runs[-1])
        self._host_runs.append((keys_c, cnt_c))
        self._runs, self._runs_n = [], 0
        self._next_merge = self.merge_factor * self.slab

    @staticmethod
    def _resolve_host_run(run):
        """Materialize a spilled run: either already-host (uniq, counts)
        numpy pair or a deferred (keys_t, cnt_c) device pair."""
        a, b = run
        if isinstance(a, np.ndarray):
            return a, b
        keys_c, cnt_c = a, b
        W = len(keys_c)
        cnt = np.asarray(cnt_c)
        m = cnt > 0
        uniq = np.stack([np.asarray(keys_c[W - 1 - j]) for j in range(W)], axis=1)
        return np.ascontiguousarray(uniq[m]), cnt[m].astype(np.int64)

    def _final_sorted(self):
        """Finalize-time collapse: raw pending chunks (count-1 entries) +
        the deferred slab (uncompacted sorted, counts at boundaries) +
        compacted runs all concatenate into ONE merge sort — no per-source
        pre-sorts, no distinct-count syncs. Returns (skeys MSW-first,
        boundary, summed); consumes all device-side state."""
        pend, valids = self._pend, self._pend_valid
        self._pend, self._pend_valid, self._pend_n = [], [], 0
        pc, self._pending_compact = self._pending_compact, None
        runs, self._runs, self._runs_n = self._runs, [], 0
        W = self.W

        if not runs and pc is None:
            n = sum(int(c.shape[0] * c.shape[1]) for c in pend)
            bucket = _bucket_size(n)
            return _fused_sort_count(tuple(pend), tuple(valids), bucket, self.k)

        srcs = [(keys_t, cnt) for keys_t, cnt, _b in runs]
        if pc is not None:
            skeys, boundary, counts, nu_dev = pc
            nu = int(nu_dev)  # async-fetched at flush time: free by now
            out_size = _bucket_size(max(1, nu))
            if out_size <= skeys[0].shape[0] // 2:
                # compaction shrinks the merge sort enough to pay for
                # its scatter (typical at sequencing coverage)
                srcs.append(_compact_run(skeys, boundary, counts, out_size))
            else:
                srcs.append((skeys, counts))  # counts live at boundary rows
        if pend:
            flat = jnp.concatenate([c.reshape(-1, W) for c in pend], axis=0)
            v = jnp.concatenate([vv.reshape(-1) for vv in valids])
            srcs.append((tuple(flat[:, W - 1 - j] for j in range(W)),
                         v.astype(jnp.int32)))  # raw kmers count 1; pads 0
        total = sum(int(s[1].shape[0]) for s in srcs)
        bucket = _bucket_size(total)
        keys_cat = []
        for j in range(W):
            parts = [s[0][j] for s in srcs]
            if bucket > total:
                parts.append(jnp.full(bucket - total, 0xFFFFFFFF, jnp.uint32))
            keys_cat.append(jnp.concatenate(parts))
        cparts = [s[1] for s in srcs]
        if bucket > total:
            cparts.append(jnp.zeros(bucket - total, jnp.int32))
        counts_cat = jnp.concatenate(cparts)
        return _merge_sorted_runs(tuple(keys_cat), counts_cat)

    def _merged_run(self):
        """Collapse all pending slabs/runs to ONE compacted run on device;
        returns (keys_t MSW-first, counts, bucket) or None when empty."""
        self._flush_slab()
        self._resolve_compact()
        if not self._runs:
            return None
        if len(self._runs) > 1:
            self._merge_runs()
        # _merge_runs (or _resolve_compact's merge) SPILLS the collapsed
        # run to host RAM when it exceeds spill_rows, leaving _runs empty
        # — the genome-scale norm for distinct_run() callers (the
        # distributed exchange); the spilled run is in _host_runs
        return self._runs[0] if self._runs else None

    def _host_merged(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Collapse device runs + host-spilled runs to ONE host run
        (uniq LSW-first, counts i64), or None when empty."""
        r = (self._merged_run()
             if (self._pend or self._runs or self._pending_compact is not None)
             else None)
        parts = [self._resolve_host_run(x) for x in self._host_runs]
        self._host_runs = []
        if r is not None:
            keys_c, cnt_c, _b = r
            self._runs, self._runs_n = [], 0
            cnt = np.asarray(cnt_c)
            W = self.W
            uniq = np.stack([np.asarray(keys_c[W - 1 - j]) for j in range(W)], axis=1)
            m = cnt > 0
            parts.append((np.ascontiguousarray(uniq[m]), cnt[m].astype(np.int64)))
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        return merge_counts(parts)

    def distinct_run(self) -> tuple[np.ndarray, np.ndarray]:
        """Finalize accumulation to the compacted distinct multiset on the
        HOST: (uniq (M, W) uint32 LSW-first, counts (M,) int32), pad
        entries trimmed. This is the exchange unit for multi-host counting
        (parallel/distributed.py): 5-30x smaller than the raw multiset at
        sequencing coverage."""
        hm = self._host_merged()
        if hm is None:
            return np.zeros((0, self.W), np.uint32), np.zeros(0, np.int32)
        uniq, counts = hm
        return uniq, np.minimum(counts, np.iinfo(np.int32).max).astype(np.int32)

    def ingest_run(self, uniq: np.ndarray, counts: np.ndarray) -> None:
        """Feed a sorted distinct run (as produced by distinct_run, possibly
        from another process) back into the merge hierarchy. finalize()
        then computes the global cutoff/Bloom from the exact merged counts."""
        M = int(uniq.shape[0])
        if M == 0:
            return
        bucket = _bucket_size(M)
        W = self.W
        keys_t = []
        for j in range(W):
            col = np.full(bucket, 0xFFFFFFFF, np.uint32)
            col[:M] = uniq[:, W - 1 - j]  # MSW first
            keys_t.append(jnp.asarray(col))
        cnt = np.zeros(bucket, np.int32)
        cnt[:M] = counts
        self._runs.append((tuple(keys_t), jnp.asarray(cnt), bucket))
        self._runs_n += bucket

    def finalize(self, abundance, bits_per_kmer, H, seed: int,
                 lossy_quals: bool = False, want_solid: bool = False,
                 device_max: int = 1 << 62, unitig_max: int = 0):
        """Returns (bitset device array, n_words, cutoff, n_solid, hist, H).
        With want_solid=True a 7th element is appended: the device solid
        run (words (Mcap, W) LSW-first sorted ascending with 0xFFFFFFFF
        pads, counts (Mcap,) i32 with 0 pads, exact distinct count) — the
        input of the unitig section builder (ops/unitig.py) — or None when
        the counter is empty.

        bits_per_kmer/H may be None: auto-chosen from the measured
        coverage histogram (bloom.auto_params — the frozen rule).

        Launch discipline: one fused merge sort over raw pending chunks + the deferred slab
        + merged runs, one compaction, then histogram + Bloom build sized
        to the DISTINCT set. Host sync: the 256-entry histogram ONLY —
        the distinct count is its sum (hist[0] is forced to 0), so the
        compaction bucket derives from the same transfer."""
        from leon_tpu.ops import bloom

        if (not self._pend and not self._runs
                and self._pending_compact is None):
            hist = np.zeros(256, np.int64)
            cutoff = abundance if abundance is not None else 2
            if bits_per_kmer is None:
                bits_per_kmer = 16.0 if lossy_quals else 5.0
            if H is None:
                H = 4 if lossy_quals else 2
            n_words = bloom.choose_n_words(1, bits_per_kmer)
            bitset = jnp.zeros(bloom.alloc_words(n_words), jnp.uint32)
            if want_solid:
                return bitset, n_words, cutoff, 0, hist, H, None
            return bitset, n_words, cutoff, 0, hist, H

        if self._host_runs:
            # host-spilled path (inputs whose distinct set exceeds
            # spill_rows): k-way merge on host, histogram/cutoff on host,
            # Bloom built host-side (bit-identical to the device build —
            # same (word, bit) set) and uploaded once; the solid run is
            # uploaded only when the unitig section needs it
            return self._finalize_host(abundance, bits_per_kmer, H, seed,
                                       lossy_quals, want_solid, device_max,
                                       unitig_max)
        if (len(self._runs) == 1 and not self._pend
                and self._pending_compact is None):
            # already one compacted run — reuse it directly
            keys_c, cnt_c, _b = self._runs[0]
            self._runs, self._runs_n = [], 0
            hist = np.asarray(_hist_of_sorted(cnt_c > 0, cnt_c))
            tr("count.fin.hist_sync")
        else:
            skeys, boundary, summed = self._final_sorted()
            tr("count.fin.sort_dispatched")
            hist = np.asarray(_hist_of_sorted(boundary, summed))  # ONE sync
            nu = int(hist.sum())
            tr(f"count.fin.hist_sync nu={nu}")
            keys_c, cnt_c = _compact_run(skeys, boundary, summed,
                                         _bucket_size(max(1, nu)))
            tr("count.fin.compacted")
        cutoff = abundance if abundance is not None else auto_cutoff(hist)
        n_solid = int(hist[min(cutoff, 255):].sum())
        # stored_filter=False: the UNITIGS section will replace the
        # stored bitset, so bits_per_kmer costs HBM only (bloom.auto_params)
        auto_bpk, auto_h = bloom.auto_params(
            hist, cutoff, lossy_quals,
            stored_filter=not (0 < n_solid <= unitig_max))
        if bits_per_kmer is None:
            bits_per_kmer = auto_bpk
        if H is None:
            H = auto_h
        n_words = bloom.choose_n_words(max(1, n_solid), bits_per_kmer)
        W = self.W
        words = jnp.stack([keys_c[W - 1 - j] for j in range(W)], axis=-1)  # LSW-first
        bitset = bloom.build_device(words, cnt_c, jnp.int32(cutoff), n_words, H, seed, self.k)
        tr("count.fin.bloom_dispatched")
        import sys as _sys

        warn = bloom.saturation_warning(n_solid, n_words, bits_per_kmer)
        if warn:
            print(f"[leon-tpu] {warn}", file=_sys.stderr)
        if want_solid:
            return (bitset, n_words, cutoff, n_solid, hist, H,
                    (words, cnt_c, int(hist.sum()), None))
        return bitset, n_words, cutoff, n_solid, hist, H

    def _finalize_host(self, abundance, bits_per_kmer, H, seed: int,
                       lossy_quals: bool, want_solid: bool,
                       device_max: int = 1 << 62, unitig_max: int = 0):
        """finalize() for inputs that spilled runs to host RAM. Bounded
        device memory: the device never holds more than the solid run (uploaded for
        the Bloom/unitig builds) regardless of distinct-set size."""
        from leon_tpu.ops import bloom
        from leon_tpu.utils.trace import span

        with span("count.fin.host_merge"):
            uniq, counts = self._host_merged()
        hist = histogram(np.minimum(counts, np.iinfo(np.int64).max))
        cutoff = abundance if abundance is not None else auto_cutoff(hist)
        solid_m = counts >= cutoff
        n_solid = int(solid_m.sum())
        auto_bpk, auto_h = bloom.auto_params(
            hist, cutoff, lossy_quals,
            stored_filter=not (0 < n_solid <= unitig_max))
        if bits_per_kmer is None:
            bits_per_kmer = auto_bpk
        if H is None:
            H = auto_h
        n_words = bloom.choose_n_words(max(1, n_solid), bits_per_kmer)
        solid = np.ascontiguousarray(uniq[solid_m])
        with span("count.fin.bloom_np"):
            bitset_np = np.zeros(n_words, np.uint32)
            step = 16 << 20
            for s in range(0, n_solid, step):
                bitset_np |= bloom.build_np(solid[s : s + step], n_words, H,
                                            seed, self.k)
        with span("count.fin.upload"):
            bitset = jnp.asarray(
                np.pad(bitset_np, (0, bloom.alloc_words(n_words) - n_words))
            )
        import sys as _sys

        warn = bloom.saturation_warning(n_solid, n_words, bits_per_kmer)
        if warn:
            print(f"[leon-tpu] {warn}", file=_sys.stderr)
        if not want_solid:
            return bitset, n_words, cutoff, n_solid, hist, H
        nu_total = int(hist.sum())
        solidset = None
        if n_solid:
            counts_solid = np.minimum(
                counts[solid_m], np.iinfo(np.int32).max
            ).astype(np.int32)
            host_pair = (solid, counts_solid)
            # the device builder only takes sets it can compile for
            # (config.unitig_device_max_kmers); bigger sets build on host
            # from host_pair, so skip the (large) upload entirely
            if n_solid <= device_max:
                Mcap = _bucket_size(n_solid)
                wpad = np.full((Mcap, self.W), 0xFFFFFFFF, np.uint32)
                wpad[:n_solid] = solid
                cpad = np.zeros(Mcap, np.int32)
                cpad[:n_solid] = counts_solid
                solidset = (jnp.asarray(wpad), jnp.asarray(cpad), nu_total,
                            host_pair)
            else:
                solidset = (None, None, nu_total, host_pair)
        return bitset, n_words, cutoff, n_solid, hist, H, solidset


@partial(jax.jit, static_argnames=("out_size",))
def compact_solid(words, counts, cutoff, out_size: int):
    """Order-preserving device compaction of a padded distinct run to its
    rows with count >= cutoff — shrinks the solid-run D2H (the host
    unitig builder's input) ~2x at sequencing coverage. Returns
    ((out_size, W) u32, (out_size,) i32), zero-padded at the tail."""
    m = counts >= cutoff
    dst = jnp.where(m, jnp.cumsum(m.astype(jnp.int32)) - 1, out_size)
    ow = jnp.zeros((out_size + 1, words.shape[1]), jnp.uint32).at[dst].set(
        words, mode="drop")[:out_size]
    oc = jnp.zeros(out_size + 1, jnp.int32).at[dst].set(
        counts, mode="drop")[:out_size]
    return ow, oc


def range_boundaries(nproc: int, k: int, W: int) -> np.ndarray:
    """(nproc-1, W) u32 LSW-first key-space boundaries splitting the
    CANONICAL k-mer space into nproc ~equal ranges. Canonical =
    min(fwd, rc) of two ~uniform 2k-bit values, so P(C <= x) =
    1 - (1 - x/T)^2 with T = 2^(2k); the inverse CDF gives boundaries
    that balance ranges in expectation WITHOUT any data-dependent
    computation (shard-invariant by construction)."""
    import math

    T = 1 << (2 * k)
    out = np.zeros((max(0, nproc - 1), W), np.uint32)
    for i in range(1, nproc):
        x = int(T * (1.0 - math.sqrt(1.0 - i / nproc)))
        for j in range(W):
            out[i - 1, j] = (x >> (32 * j)) & 0xFFFFFFFF
    return out


def range_split(uniq: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Split positions of a sorted (M, W) distinct run at the given
    boundary keys: returns (nproc+1,) int64 offsets, range q =
    rows[off[q]:off[q+1]]."""
    M, W = uniq.shape
    dt = np.dtype([(f"w{j}", ">u4") for j in range(W - 1, -1, -1)])

    def rec(x):
        r = np.empty(x.shape[0], dtype=dt)
        for j in range(W):
            r[f"w{j}"] = x[:, j]
        return r

    offs = np.zeros(bounds.shape[0] + 2, np.int64)
    offs[-1] = M
    if M and bounds.shape[0]:
        offs[1:-1] = np.searchsorted(rec(np.ascontiguousarray(uniq)),
                                     rec(np.ascontiguousarray(bounds)))
    return offs


def auto_cutoff(hist: np.ndarray) -> int:
    """Automatic abundance threshold (reference: README.md:54 'default:
    automatic'). Frozen rule: locate the genomic coverage mode (the
    highest smoothed-histogram peak at count >= 4) and return the first
    count attaining the minimum of the valley before it — but only when
    the valley is a real separation (valley < peak/2). Low-coverage data
    whose error and genomic modes merge falls back to 2.

    The earlier first-rise rule (smallest c with hist[c] <= hist[c+1])
    fired on shot noise in the decreasing tail of merged-mode histograms
    and could return cutoffs that empty the solid set entirely."""
    n = hist.size
    if n < 6:
        return 2
    h = hist.astype(np.float64)
    p = 4 + int(np.argmax(h[4:]))
    if h[p] <= 0:
        return 2
    v_slice = h[2 : p + 1]
    vmin = v_slice.min()
    if vmin >= 0.5 * h[p]:
        return 2  # no valley: error and genomic modes merged (low coverage)
    c = 2 + int(np.argmin(v_slice))
    return min(c, 50)
