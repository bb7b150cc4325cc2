"""Multiword 2-bit k-mer machinery (runtime k up to 255, no recompilation).

Design notes: k-mers are W = ceil(k/16) little-endian uint32 word vectors
(FORMAT.md §3) — no 64-bit integers anywhere, so every op lowers to native
32-bit integer lanes on any backend (the reference instead templates C++ LargeInt
over a compile-time KSIZE_LIST, /root/reference/CMakeLists.txt:42,
README.md:69-81).

All k-mers of a batch of reads are produced by a single `lax.scan` over base
columns (one rolling update per column, O(L) not O(L*k)), vectorized over
the read-lane dimension.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

U32 = jnp.uint32


def words_for_k(k: int) -> int:
    return (k + 15) // 16


def top_mask(k: int) -> int:
    """Mask for the most-significant word of a 2k-bit value in W words."""
    bits = 2 * k - 32 * ((2 * k - 1) // 32)
    return (1 << bits) - 1 if bits < 32 else 0xFFFFFFFF


def shl2(words, base, k: int):
    """(kmer << 2 | base) & mask(2k). words: (..., W) u32; base: (...) u32."""
    W = words.shape[-1]
    parts = []
    w0 = (words[..., 0] << 2) | base
    parts.append(w0)
    for j in range(1, W):
        parts.append((words[..., j] << 2) | (words[..., j - 1] >> 30))
    out = jnp.stack(parts, axis=-1)
    return out.at[..., W - 1].set(out[..., W - 1] & U32(top_mask(k)))


def shr2_ins(words, base, k: int):
    """(kmer >> 2) | (base << 2*(k-1)). Used for the rolling revcomp."""
    W = words.shape[-1]
    parts = []
    for j in range(W - 1):
        parts.append((words[..., j] >> 2) | (words[..., j + 1] << 30))
    parts.append(words[..., W - 1] >> 2)
    out = jnp.stack(parts, axis=-1)
    t = 2 * (k - 1)
    wi, bit = t // 32, t % 32
    return out.at[..., wi].set(out[..., wi] | (base << bit))


def lex_less(a, b):
    """a < b comparing W-word vectors as big integers (word 0 = LSW)."""
    W = a.shape[-1]
    less = jnp.zeros(a.shape[:-1], dtype=bool)
    eq = jnp.ones(a.shape[:-1], dtype=bool)
    for j in range(W - 1, -1, -1):
        less = less | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return less


def canonical(fwd, rc):
    """Returns (canon_words, is_rc). Palindromes keep forward, is_rc=False."""
    take_rc = lex_less(rc, fwd)
    canon = jnp.where(take_rc[..., None], rc, fwd)
    return canon, take_rc


def pack_codes_np(codes: np.ndarray) -> np.ndarray:
    """(B, L) u8 base codes -> (B, ceil(L/16)) u32, base j in bits 2j..2j+1
    of word j//16. The H2D transfer format: sequences ship 2-bit packed
    (4x fewer bytes) and unpack on device (shifts)."""
    B, L = codes.shape
    pad = (-L) % 16
    if pad:
        codes = np.concatenate([codes, np.zeros((B, pad), np.uint8)], axis=1)
    # pack 4 codes/byte in u8 (cheap strided ops), then reinterpret the
    # byte stream as little-endian u32: byte j//4 bit 2(j%4) == word bit 2j,
    # so the layout is bit-identical to the shift/sum formulation without
    # the (B, L/16, 16) u32 temporary (which measured 0.3 s per chunk)
    c = np.ascontiguousarray(codes)
    b = c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    return np.ascontiguousarray(b).view("<u4")


def unpack_codes_dev(packed, L: int):
    """Device inverse of pack_codes_np: (B, W16) u32 -> (B, L) u8."""
    B = packed.shape[0]
    j = (jnp.uint32(2) * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    c = (packed[:, :, None] >> j) & jnp.uint32(3)
    return c.reshape(B, -1)[:, :L].astype(jnp.uint8)


def _kmer_scan_impl(codes, lengths, k: int):
    B, L = codes.shape
    W = words_for_k(k)
    P = L - k + 1
    if P < 1:
        raise ValueError(f"batch width {L} < k {k}")
    cols = codes.T.astype(U32)  # (L, B)

    def step(state, b):
        fwd, rc = state
        fwd = shl2(fwd, b, k)
        rc = shr2_ins(rc, U32(3) - b, k)
        return (fwd, rc), (fwd, rc)

    init = (jnp.zeros((B, W), U32), jnp.zeros((B, W), U32))
    _, (fwds, rcs) = lax.scan(step, init, cols)
    # k-mer at position p is complete after consuming column p+k-1
    fwds = jnp.moveaxis(fwds[k - 1 :], 0, 1)  # (B, P, W)
    rcs = jnp.moveaxis(rcs[k - 1 :], 0, 1)
    canon, is_rc = canonical(fwds, rcs)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    return canon, is_rc, valid


@partial(jax.jit, static_argnames=("k",))
def kmer_scan(codes, lengths, k: int):
    """All k-mers of a read batch.

    codes: (B, L) uint8 base codes 0..3 (exceptions pre-substituted with 0).
    lengths: (B,) int32.
    Returns (canon (B, P, W) u32, is_rc (B, P) bool, valid (B, P) bool)
    with P = L - k + 1, position p covering bases [p, p+k).
    """
    return _kmer_scan_impl(codes, lengths, k)


@partial(jax.jit, static_argnames=("k", "L"))
def kmer_scan_packed(packed, lengths, k: int, L: int):
    """kmer_scan taking 2-bit packed codes (pack_codes_np layout) — 4x
    fewer H2D bytes."""
    return _kmer_scan_impl(unpack_codes_dev(packed, L), lengths, k)


# ---------------------------------------------------------------------------
# Host-side (numpy) mirrors for small/serial needs: dictionary packing,
# raw-read fallback, tests.
# ---------------------------------------------------------------------------

_CODE = np.full(256, 255, dtype=np.uint8)
_CODE[ord("A")] = 0
_CODE[ord("C")] = 1
_CODE[ord("G")] = 2
_CODE[ord("T")] = 3
_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_bases_np(seq: bytes) -> tuple[np.ndarray, np.ndarray]:
    """bytes -> (codes uint8 with exceptions as 0, exception_mask bool)."""
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _CODE[raw]
    exc = codes == 255
    codes = np.where(exc, 0, codes)
    return codes, exc


def kmer_words_np(codes: np.ndarray, k: int) -> np.ndarray:
    """Forward k-mer words (W,) u32 of codes[0:k]. Host scalar helper."""
    W = words_for_k(k)
    val = 0
    for i in range(k):
        val = (val << 2) | int(codes[i])
    words = np.zeros(W, dtype=np.uint32)
    for j in range(W):
        words[j] = (val >> (32 * j)) & 0xFFFFFFFF
    return words


def words_to_codes_np(words: np.ndarray, k: int) -> np.ndarray:
    """Inverse of kmer_words_np: (W,) u32 -> (k,) uint8 base codes."""
    val = 0
    for j in range(words.shape[-1] - 1, -1, -1):
        val = (val << 32) | int(words[j])
    out = np.empty(k, dtype=np.uint8)
    for i in range(k - 1, -1, -1):
        out[i] = val & 3
        val >>= 2
    return out


def revcomp_words_np(words: np.ndarray, k: int) -> np.ndarray:
    codes = words_to_codes_np(words, k)
    return kmer_words_np((3 - codes)[::-1], k)


def pack_codes_batch_np(win: np.ndarray, k: int) -> np.ndarray:
    """(B, k) base codes -> (B, W) u32 words (LSW first).

    shift%32 is even and <= 30, so a 2-bit base never crosses a word
    boundary and per-word sum == OR.
    """
    B = win.shape[0]
    W = words_for_k(k)
    # base i sits at bit 2*(k-1-i): reversing the window makes the layout
    # little-endian 2-bit order, so pack 4 codes/byte with u8 ops and view
    # the (zero-padded) byte rows as <u4 words — no u64 temporaries
    rev = np.ascontiguousarray(win[:, ::-1], dtype=np.uint8)
    pad = (-k) % 4
    if pad:
        rev = np.pad(rev, ((0, 0), (0, pad)))
    b = rev[:, 0::4] | (rev[:, 1::4] << 2) | (rev[:, 2::4] << 4) | (rev[:, 3::4] << 6)
    bpad = 4 * W - b.shape[1]
    if bpad:
        b = np.pad(b, ((0, 0), (0, bpad)))
    return np.ascontiguousarray(b).view("<u4")


def words_to_codes_batch_np(words: np.ndarray, k: int) -> np.ndarray:
    """(B, W) u32 -> (B, k) uint8 base codes (vectorized inverse)."""
    B = words.shape[0]
    out = np.empty((B, k), dtype=np.uint8)
    for i in range(k):
        t = 2 * (k - 1 - i)
        out[:, i] = (words[:, t // 32] >> np.uint32(t % 32)) & 3
    return out


def revcomp_words_batch_np(words: np.ndarray, k: int) -> np.ndarray:
    codes = words_to_codes_batch_np(words, k)
    return pack_codes_batch_np((3 - codes)[:, ::-1], k)


def kmer_words_batch_np(codes: np.ndarray, pos: np.ndarray, k: int):
    """Vectorized host extraction of the canonical k-mer at `pos` per read.

    codes: (B, L) uint8, pos: (B,) int. Returns (canon (B, W) u32,
    is_rc (B,) bool). Used to rebuild anchor dictionary entries on the host
    so the device never ships k-mer words (a D2H transfer per lookup saved).
    """
    B, L = codes.shape
    W = words_for_k(k)
    idx = np.clip(pos[:, None] + np.arange(k)[None, :], 0, L - 1)
    win = np.take_along_axis(codes, idx, axis=1)  # (B, k)
    fwd = pack_codes_batch_np(win, k)
    rc = pack_codes_batch_np((3 - win)[:, ::-1], k)
    # lexicographic big-int compare, MSW last
    less = np.zeros(B, dtype=bool)
    eq = np.ones(B, dtype=bool)
    for j in range(W - 1, -1, -1):
        less |= eq & (rc[:, j] < fwd[:, j])
        eq &= rc[:, j] == fwd[:, j]
    canon = np.where(less[:, None], rc, fwd)
    return canon, less


def pack_2bit_np(codes: np.ndarray) -> bytes:
    """2-bit pack a code vector, byte aligned (FORMAT.md stream 9)."""
    n = codes.shape[0]
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    c = codes.reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).astype(np.uint8).tobytes()


def unpack_2bit_np(buf: bytes, n: int) -> np.ndarray:
    b = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((b.size, 4), dtype=np.uint8)
    out[:, 0] = b & 3
    out[:, 1] = (b >> 2) & 3
    out[:, 2] = (b >> 4) & 3
    out[:, 3] = (b >> 6) & 3
    return out.reshape(-1)[:n]
