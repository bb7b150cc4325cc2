"""Batched de Bruijn graph API over the Bloom-filter membership structure.

The reference ships a full Graph façade ([R] gatb-core debruijn/impl/*:
Node/Edge iteration, successors, traversal; SURVEY.md §2.3) even though
Leon itself bypasses it and probes the Bloom filter directly. This module
is the batched equivalent: every query is BATCHED over (N, ...) k-mer
arrays and runs on device — nodes are not objects but rows. Node->index
maps (the reference uses a BooPHF MPHF) are served by `searchsorted` over
the sorted solid-kmer array instead — sorted arrays are the data-parallel
perfect-hash substitute (binary search vectorizes; an MPHF's dependent
random gathers do not).
"""

from __future__ import annotations

from dataclasses import dataclass


import jax
import jax.numpy as jnp
import numpy as np

from leon_tpu.ops import bloom
from leon_tpu.ops.kmer import U32, shl2, shr2_ins


@dataclass(frozen=True)
class DBG:
    """A probabilistic de Bruijn graph: nodes = canonical solid k-mers
    present in the Bloom bitset (false positives possible, like the
    reference's Bloom-backed graph).

    The graph uses CLASSIC (unblocked) Bloom addressing
    (bloom.build_np_classic / probe_classic), not the container's blocked
    v3 family: assembly-style traversal (walk/simple paths) stops at any
    apparent branch, so its false-positive sensitivity is categorically
    higher than the compressor's event-recording walk — an FP there costs
    a few output bytes, an FP here truncates a contig. Classic addressing
    pays H gathers per probe for ~5-10x lower FP at equal size."""

    bitset: jnp.ndarray  # (n_words,) uint32
    k: int
    n_hashes: int
    n_words: int
    seed: int

    # -- node queries ------------------------------------------------------

    def contains(self, kmers) -> jnp.ndarray:
        """(N, W) packed k-mer words (either strand) -> (N,) bool."""
        return bloom.probe_classic(self.bitset, jnp.asarray(kmers), self.n_hashes,
                                   self.n_words, self.seed, self.k)

    # -- edge queries ------------------------------------------------------

    def _neighbor_words(self, kmers, direction: str):
        """(N, W) -> (N, 4, W) neighbor k-mers (append/prepend base x)."""
        kmers = jnp.asarray(kmers)
        k = self.k
        if direction == "out":
            cands = [shl2(kmers, U32(x), k) for x in range(4)]
        else:
            cands = [shr2_ins(kmers, U32(x), k) for x in range(4)]
        return jnp.stack(cands, axis=1)

    def successors(self, kmers) -> jnp.ndarray:
        """(N, W) -> (N, 4) bool: which of the 4 forward extensions are
        present (strand-invariant membership)."""
        return self.contains(self._neighbor_words(kmers, "out").reshape(-1, kmers.shape[-1])).reshape(-1, 4)

    def predecessors(self, kmers) -> jnp.ndarray:
        return self.contains(self._neighbor_words(kmers, "in").reshape(-1, kmers.shape[-1])).reshape(-1, 4)

    def out_degree(self, kmers) -> jnp.ndarray:
        return self.successors(kmers).sum(axis=1)

    def in_degree(self, kmers) -> jnp.ndarray:
        return self.predecessors(kmers).sum(axis=1)

    def is_branching(self, kmers) -> jnp.ndarray:
        """Branching node: in-degree or out-degree != 1 (reference
        Graph::isBranching semantics)."""
        return (self.out_degree(kmers) != 1) | (self.in_degree(kmers) != 1)

    # -- traversal ---------------------------------------------------------

    def walk(self, kmers, max_steps: int):
        """Deterministic simple-path extension, batched over N start nodes:
        at each step follow the unique successor; stop at dead ends or
        bifurcations (reference Traversal 'simple' contig semantics).

        Returns (bases (N, max_steps) uint8, n_steps (N,) int32) where
        bases[i, :n_steps[i]] are the appended nucleotides.
        """
        kmers = jnp.asarray(kmers)

        def step(carry, _):
            cur, alive = carry
            succ = self.successors(cur)                      # (N, 4)
            deg = succ.sum(axis=1)
            uniq = jnp.argmax(succ, axis=1).astype(jnp.int32)
            go = alive & (deg == 1)
            nxt = shl2(cur, uniq.astype(U32), self.k)
            cur = jnp.where(go[:, None], nxt, cur)
            return (cur, go), (uniq.astype(jnp.uint8), go)

        (cur, _), (bases, gos) = jax.lax.scan(
            step, (kmers, jnp.ones(kmers.shape[0], bool)),
            None, length=max_steps,
        )
        bases = jnp.moveaxis(bases, 0, 1)
        gos = jnp.moveaxis(gos, 0, 1)
        return bases, gos.sum(axis=1).astype(jnp.int32)

    def _simple_step(self, cur, alive):
        """One unique-successor step for (M, W) nodes; returns
        (next (M, W), advanced (M,), base (M,) i32)."""
        succ = self.successors(cur)
        deg = succ.sum(axis=1)
        uniq = jnp.argmax(succ, axis=1).astype(jnp.int32)
        go = alive & (deg == 1)
        nxt = shl2(cur, uniq.astype(U32), self.k)
        return jnp.where(go[:, None], nxt, cur), go, uniq

    def traverse(self, kmers, max_steps: int, bubble_depth: int | None = None):
        """Branch-CROSSING traversal, batched over N start nodes — the
        batched analog of the reference's contig Traversal ([R] gatb-core
        debruijn/impl/Traversal.cpp MonumentTraversal; SURVEY.md §2.3):
        `walk` stops at every bifurcation, `traverse` additionally crosses
        bounded bubbles/tips.

        Policy (deterministic, documented delta vs the reference's
        majority-consensus rule): at an out-branching node each solid
        successor advances along its simple path for up to `bubble_depth`
        steps; branches that dead-end drop out (tip clipping). At the
        first depth where every surviving branch sits on the SAME node,
        the traversal emits the smallest-base surviving branch's path
        (lexicographic consensus) and continues from the converged node.
        No convergence within `bubble_depth` (or a dead end) stops the
        lane. Every outer step pays the full 4 x bubble_depth probe cost
        (no data-dependent control flow under jit).

        Returns (bases (N, max_steps*(bubble_depth+2)) uint8 padded,
        n_bases (N,) int32): bases[i, :n_bases[i]] extend the start node.
        """
        kmers = jnp.asarray(kmers)
        N, W = kmers.shape
        k = self.k
        # a SNP bubble's arms only reconverge once the variant base leaves
        # the k-mer window: k-1 steps after the branch, so the default
        # depth must reach it
        D = int(bubble_depth) if bubble_depth is not None else k + 1
        SLOTS = D + 2  # branch base + <= D+1 inner-step bases

        def outer(carry, _):
            cur, alive = carry
            succ = self.successors(cur)                    # (N, 4)
            deg = succ.sum(axis=1)
            uniq = jnp.argmax(succ, axis=1).astype(jnp.int32)
            simple = alive & (deg == 1)
            branching = alive & (deg >= 2)

            # --- bubble attempt from every lane (masked by `branching`)
            cand = jnp.stack([shl2(cur, U32(c), k) for c in range(4)])  # (4, N, W)
            calive = succ.T & branching[None, :]                        # (4, N)

            def bstep(bcarry, _):
                bc, ba = bcarry
                c2, go, uq = self._simple_step(bc.reshape(-1, W), ba.reshape(-1))
                c2 = c2.reshape(4, N, W)
                go = go.reshape(4, N)
                return (c2, go), (c2, go, uq.reshape(4, N).astype(jnp.uint8))

            _, (scur, salive, sbase) = jax.lax.scan(
                bstep, (cand, calive), None, length=D
            )  # (D, 4, N, W), (D, 4, N), (D, 4, N)

            n_alive = salive.sum(axis=1)                                # (D, N)
            first = jnp.argmax(salive, axis=1)                          # (D, N)
            ref = jnp.take_along_axis(
                scur, first[:, None, :, None], axis=1
            )                                                           # (D, 1, N, W)
            same = ((scur == ref) | ~salive[..., None]).all(axis=(1, 3))  # (D, N)
            conv = (n_alive >= 1) & same                                # (D, N)
            d_star = jnp.argmax(conv, axis=0).astype(jnp.int32)         # (N,)
            has_conv = conv.any(axis=0) & branching

            alive_sel = jnp.take_along_axis(
                salive, jnp.broadcast_to(d_star[None, None, :], (1, 4, N)), axis=0
            )[0]                                                        # (4, N)
            cbr = jnp.argmax(alive_sel, axis=0).astype(jnp.int32)       # (N,)
            # converged node: ref at (d_star, n)
            conv_node = jnp.take_along_axis(
                ref[:, 0], jnp.broadcast_to(d_star[None, :, None], (1, N, W)), axis=0
            )[0]                                                        # (N, W)

            # emitted slots for this outer step
            slots = jnp.zeros((N, SLOTS), jnp.uint8)
            n_emit = jnp.where(simple, 1, 0)
            slots = slots.at[:, 0].set(
                jnp.where(simple, uniq, jnp.where(has_conv, cbr, 0)).astype(jnp.uint8)
            )
            # inner-step bases of the chosen branch: sbase[d, cbr, n]
            chosen = jnp.take_along_axis(
                sbase, jnp.broadcast_to(cbr[None, None, :], (D, 1, N)), axis=1
            )[:, 0, :]                                                  # (D, N)
            dmask = jnp.arange(D, dtype=jnp.int32)[:, None] <= d_star[None, :]
            slots = slots.at[:, 1:D + 1].set(
                jnp.where(has_conv[None, :] & dmask, chosen, 0).T.astype(jnp.uint8)
            )
            n_emit = jnp.where(has_conv, d_star + 2, n_emit)

            nxt = jnp.where(
                simple[:, None], shl2(cur, uniq.astype(U32), k),
                jnp.where(has_conv[:, None], conv_node, cur),
            )
            alive2 = simple | has_conv
            return (nxt, alive2), (slots, n_emit.astype(jnp.int32))

        (_, _), (slots, n_emit) = jax.lax.scan(
            outer, (kmers, jnp.ones(N, bool)), None, length=max_steps
        )  # (S, N, SLOTS), (S, N)
        slots = jnp.moveaxis(slots, 0, 1)      # (N, S, SLOTS)
        n_emit = jnp.moveaxis(n_emit, 0, 1)    # (N, S)

        # compact the ragged per-step emissions into flat per-lane bases
        S = slots.shape[1]
        cap = S * SLOTS
        base_off = jnp.cumsum(n_emit, axis=1) - n_emit        # (N, S)
        j = jnp.arange(SLOTS, dtype=jnp.int32)[None, None, :]
        dst = jnp.where(
            j < n_emit[:, :, None], base_off[:, :, None] + j, cap
        ).reshape(N, -1)
        ar = jnp.arange(N)[:, None]
        out = jnp.zeros((N, cap + 1), jnp.uint8)
        out = out.at[ar, dst].set(slots.reshape(N, -1), mode="drop")
        return out[:, :cap], n_emit.sum(axis=1).astype(jnp.int32)


@dataclass(frozen=True)
class Graph:
    """Full graph façade: probabilistic membership (DBG) + the EXACT node
    set (NodeIndex) — the reference couples its Bloom-backed graph with an
    MPHF node map the same way ([R] gatb-core debruijn/impl/Graph.hpp,
    GraphUnitigs; SURVEY.md §2.3). Adds what the bare DBG cannot serve:
    whole-graph node/branching iteration and node->rank queries.

    Construction: `Graph.from_solid(solid_words, k)` — e.g. from
    `ops/count.py` distinct_run() rows filtered to the abundance cutoff,
    the same solid set the compressor inserts into its filter."""

    dbg: DBG
    index: NodeIndex

    @classmethod
    def from_solid(cls, solid_words: np.ndarray, k: int,
                   bits_per_kmer: float = 16.0, n_hashes: int = 4,
                   seed: int = 0) -> "Graph":
        n_words = bloom.choose_n_words(max(1, solid_words.shape[0]), bits_per_kmer)
        bits = jnp.asarray(bloom.build_np_classic(solid_words, n_words,
                                                  n_hashes, seed, k))
        return cls(
            dbg=DBG(bitset=bits, k=k, n_hashes=n_hashes, n_words=n_words,
                    seed=seed),
            index=NodeIndex.from_solid(solid_words),
        )

    @property
    def n_nodes(self) -> int:
        return len(self.index)

    def iter_nodes(self, batch: int = 1 << 15):
        """Whole-graph node iteration (reference Graph::iterator over all
        nodes): yields (m, W) uint32 canonical k-mer word batches in
        sorted node order. Exact — served from the NodeIndex array, not
        the Bloom filter."""
        words = self.index.sorted_words
        for s in range(0, words.shape[0], batch):
            yield words[s : s + batch]

    def iter_branching(self, batch: int = 1 << 15):
        """Branching-node iteration (reference Graph::iteratorBranching):
        yields (m, W) batches of nodes whose in- or out-degree != 1,
        membership judged by the probabilistic filter (like the
        reference's Bloom-backed branching iterator)."""
        for words in self.iter_nodes(batch):
            mask = np.asarray(self.dbg.is_branching(jnp.asarray(words)))
            if mask.any():
                yield words[mask]

    def node_rank(self, words: np.ndarray) -> np.ndarray:
        """(N, W) -> (N,) int64 dense node ids, -1 if absent — the MPHF
        query surface ([R] MPHFAlgorithm/BooPHF), exact here."""
        return self.index.lookup(words)

    def contigs(self, max_len: int, batch: int = 1 << 13):
        """Assemble simple-path contigs from every branching neighborhood
        seed (a practical whole-graph Traversal driver over iter_nodes;
        dedup by start node is the caller's concern). Yields
        (seeds (m, W), bases (m, max_len) uint8, n (m,)) per batch."""
        for words in self.iter_nodes(batch):
            w = jnp.asarray(words)
            bases, n = self.dbg.walk(w, max_len)
            yield words, np.asarray(bases), np.asarray(n)


@dataclass(frozen=True)
class NodeIndex:
    """Node -> dense index over the exact solid set (the reference wires a
    BooPHF MPHF here; sorted-array binary search is the batched
    equivalent). Built host-side from the sorted canonical solid k-mers."""

    sorted_words: np.ndarray  # (n, W) uint32, lexicographic by (MSW..LSW)

    @classmethod
    def from_solid(cls, solid_words: np.ndarray) -> "NodeIndex":
        W = solid_words.shape[1]
        order = np.lexsort(tuple(solid_words[:, j] for j in range(W)))
        return cls(np.ascontiguousarray(solid_words[order]))

    def _as_sortable(self, words: np.ndarray) -> np.ndarray:
        W = words.shape[1]
        dt = np.dtype([(f"w{j}", ">u4") for j in range(W - 1, -1, -1)])
        rec = np.empty(words.shape[0], dtype=dt)
        for j in range(W):
            rec[f"w{j}"] = words[:, j]
        return rec

    def lookup(self, words: np.ndarray) -> np.ndarray:
        """(N, W) -> (N,) int64 index into the solid set, -1 if absent."""
        hay = self._as_sortable(self.sorted_words)
        needles = self._as_sortable(words)
        idx = np.searchsorted(hay, needles)
        idx_c = np.clip(idx, 0, max(0, hay.shape[0] - 1))
        hit = hay.shape[0] > 0
        found = (hay[idx_c] == needles) if hit else np.zeros(len(needles), bool)
        return np.where(found, idx_c, -1)

    def __len__(self) -> int:
        return self.sorted_words.shape[0]
