"""Device mesh utilities: sharded Bloom build (OR-allreduce) and
data-parallel walk encoding.

Design per SURVEY.md §2.4: the only runtime parallelism in the reference is
data-parallel read blocks over threads; here the mesh axis "d" plays that
role across chips, and the Bloom filter (the shared read-only structure the
reference keeps in shared memory) is replicated in each device's memory,
built collectively: per-device partial filters, an all-to-all word-range
exchange and a local OR.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from leon_tpu.ops import bloom

U32 = jnp.uint32


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("d",))


def _bloom_words_local(words: jnp.ndarray, valid: jnp.ndarray, nw,
                       n_alloc: int, H: int, seed: int, k: int):
    """Scatter this shard's solid k-mers into a PACKED (n_alloc,) u32 word
    array: sort the (word, bit) probe pairs, drop duplicates, scatter-ADD
    the single-bit values — add over deduplicated bits equals bitwise OR
    (same trick as bloom.build_device), with no byte-per-bit scratch."""
    wi, bit = bloom.wordbit(words, H, nw, seed, jnp, k)  # (S, H)
    v = jnp.broadcast_to(valid[:, None], wi.shape)
    wif = jnp.where(v, wi.astype(U32), U32(n_alloc)).reshape(-1)
    bitf = jnp.where(v, bit, U32(0)).reshape(-1)
    swi, sbit = lax.sort((wif, bitf), num_keys=2)
    first = jnp.concatenate(
        [jnp.ones(1, bool), (swi[1:] != swi[:-1]) | (sbit[1:] != sbit[:-1])]
    )
    idx = jnp.where(first, swi, U32(n_alloc)).astype(jnp.int32)
    out = jnp.zeros(n_alloc + 1, U32).at[idx].add(U32(1) << sbit, mode="drop")
    return out[:n_alloc]


def sharded_bloom_build(mesh: Mesh, solid_words: np.ndarray, n_words: int, H: int, seed: int, k: int):
    """Build the replicated Bloom bitset collectively: shard the solid-kmer
    list over "d", build packed per-shard partial filters, merge with an
    all_to_all word-range exchange + local OR (each device reduces its own
    word range — reduce-scatter semantics, since XLA exposes no OR
    allreduce), then replicate. Returns a fully-replicated
    (alloc_words(n_words),) uint32 device array.

    Memory per device is ~2x the packed filter (partial + exchange
    transient) — no byte-per-bit scratch — and per-device traffic is ~1x
    the filter plus the replication gather, independent of device count.
    Capacity matches the single-device builder (bloom.MAX_WORDS)."""
    if n_words > bloom.MAX_WORDS:
        raise ValueError(f"n_words {n_words} > {bloom.MAX_WORDS}")
    aw = bloom.alloc_words(n_words)
    n = mesh.devices.size
    aw_pad = -(-aw // n) * n  # word space must split evenly over "d"
    S = solid_words.shape[0]
    W = solid_words.shape[1] if solid_words.ndim == 2 else 1
    pad = (-S) % max(n, 1)
    words = np.concatenate([solid_words, np.zeros((pad, W), np.uint32)], axis=0)
    valid = np.concatenate([np.ones(S, bool), np.zeros(pad, bool)])

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("d", None), P("d"), P()),
        out_specs=P("d"),
    )
    def build(w, v, nw):
        part = _bloom_words_local(w, v, nw, aw_pad, H, seed, k)
        t = part.reshape(n, aw_pad // n)
        if n > 1:
            # row j of the result on device d = device j's partial for
            # d's word range; OR them to own the merged range
            t = lax.all_to_all(t, "d", split_axis=0, concat_axis=0)
        merged = t[0]
        for i in range(1, n):
            merged = merged | t[i]
        return merged

    out = jax.jit(build)(words, valid, jnp.uint32(n_words))
    out = jax.device_put(out, NamedSharding(mesh, P()))  # replicate
    return out[:aw] if aw_pad != aw else out


def make_sharded_encoder(mesh: Mesh, k: int, H: int, n_words: int, seed: int):
    """jit-compiled data-parallel encode step: batch lanes sharded over "d",
    bitset replicated. Returns fn(codes (B,L), lengths (B,), bitset)."""
    from leon_tpu.ops import walk

    shard_b = NamedSharding(mesh, P("d"))
    shard_2d = NamedSharding(mesh, P("d", None))
    rep = NamedSharding(mesh, P())

    @partial(jax.jit, static_argnames=(), in_shardings=(shard_2d, shard_b, rep, rep))
    def step(codes, lengths, bitset, nw):
        return walk.encode_batch(codes, lengths, bitset, k, H, nw, seed)

    nw32 = jnp.uint32(n_words)
    return lambda codes, lengths, bitset: step(codes, lengths, bitset, nw32)


def make_sharded_counter(mesh: Mesh, k: int):
    """jit-compiled data-parallel k-mer scan: returns canonical kmers +
    validity, lanes sharded over "d" (host merges counts exactly)."""
    from leon_tpu.ops import kmer as K

    shard_b = NamedSharding(mesh, P("d"))
    shard_2d = NamedSharding(mesh, P("d", None))

    @partial(jax.jit, in_shardings=(shard_2d, shard_b))
    def step(codes, lengths):
        return K.kmer_scan(codes, lengths, k)

    return step
