"""The .leon single-file container (FORMAT.md, normative).

Replacement of the reference's HDF5 Storage layer ([R] gatb-core
tools/storage/impl/*; /root/reference/README.md:88 "compressed file in single
.leon file (HDF5 format)"). Same role — one file holding metadata, the Bloom
filter, the anchor dictionary and independently decodable blocks — but a flat
sectioned binary layout instead of HDF5 (the round-trip oracle diffs the
decompressed FASTA/FASTQ, never the container:
/root/reference/scripts/simple_test.sh:62).

Both a streaming `Writer` (blocks appended as they finish; NSECT
backpatched) and a lazy `Reader` (sections indexed, block payloads read on
demand) are provided so neither direction needs the archive in RAM.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

from leon_tpu.utils import varint

MAGIC = b"LEONTPU1"
# v3: errnt carries rank among non-solid candidates (FORMAT.md §6)
# v4: the solid set may be stored as a UNITIGS section instead of BLOOM
#     (FORMAT.md §4a)
# v5: the DICT payload carries a leading u8 format tag; tag 1 stores each
#     anchor as an index into the solid set spelled by the UNITIGS
#     section (FORMAT.md §5). Readers accept v3-v5.
# v6: hash family v4 (single rolling chain, min/max blocked addressing —
# FORMAT.md §4). Archives v3-v5 used the two-chain family; their walk
# events cannot be decoded by this coder, so they are refused outright
# rather than mis-decoded (the version byte is checked before any stream).
VERSION = 6
_READ_VERSIONS = (6,)

TAG_META = 1
TAG_DICT = 2
TAG_BLOOM = 3
TAG_BLOCK = 4
TAG_INDEX = 5
TAG_UNITIGS = 6

QUAL_NONE = 0
QUAL_LOSSLESS = 1
QUAL_LOSSY = 2


@dataclass
class Meta:
    k: int
    fmt: int               # 0 FASTA, 1 FASTQ (bank.FASTA/FASTQ)
    qual_mode: int         # QUAL_*
    header_mode: int       # 0 none, 1 kept
    n_hashes: int
    final_newline: bool
    n_words: int           # Bloom bitset size in u32 words (exact, not 2^n)
    seed: int
    n_reads: int
    abundance: int
    seglen: int = 0  # long reads split into seglen segments (FORMAT.md §2)
    orig_ext: bytes = b"fasta"

    def pack(self) -> bytes:
        out = bytearray()
        out += struct.pack(
            "<8B",
            self.k,
            self.fmt,
            self.qual_mode,
            self.header_mode,
            self.n_hashes,
            1 if self.final_newline else 0,
            0,
            0,
        )
        out += struct.pack(
            "<IQIII", self.seed & 0xFFFFFFFF, self.n_reads, self.abundance,
            self.seglen, self.n_words,
        )
        varint.encode_one(len(self.orig_ext), out)
        out += self.orig_ext
        return bytes(out)

    @classmethod
    def unpack(cls, buf: bytes) -> "Meta":
        k, fmt, qual_mode, header_mode, n_hashes, flags, _r1, _r2 = struct.unpack_from("<8B", buf, 0)
        seed, n_reads, abundance, seglen, n_words = struct.unpack_from("<IQIII", buf, 8)
        n, pos = varint.decode_one(buf, 32)
        ext = buf[pos : pos + n]
        return cls(
            k=k, fmt=fmt, qual_mode=qual_mode, header_mode=header_mode,
            n_hashes=n_hashes, final_newline=bool(flags & 1),
            n_words=n_words, seed=seed, n_reads=n_reads,
            abundance=abundance, seglen=seglen, orig_ext=ext,
        )


@dataclass
class Container:
    meta: Meta
    dict_payload: bytes
    bloom_payload: bytes  # BLOOM payload, or UNITIGS payload if unitigs=True
    block_payloads: list[bytes] = field(default_factory=list)
    block_n_reads: list[int] = field(default_factory=list)
    unitigs: bool = False


class Writer:
    """Streaming container writer: sections append as they are produced;
    the fixed-width section count is backpatched on close."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        self.f.write(bytes([VERSION]))
        self._nsect_pos = self.f.tell()
        self.f.write(struct.pack("<I", 0))
        self.nsect = 0
        self.block_index: list[tuple[int, int]] = []  # (n_reads, offset)

    def section(self, tag: int, payload: bytes) -> None:
        out = bytearray([tag])
        varint.encode_one(len(payload), out)
        self.f.write(bytes(out))
        self.f.write(payload)
        self.f.write(struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF))
        self.nsect += 1

    def block(self, payload: bytes, n_reads: int) -> None:
        self.block_index.append((n_reads, self.f.tell()))
        self.section(TAG_BLOCK, payload)

    def close(self) -> int:
        idx = bytearray()
        for n, off in self.block_index:
            varint.encode_one(n, idx)
            varint.encode_one(off, idx)
        self.section(TAG_INDEX, bytes(idx))
        total = self.f.tell()
        self.f.seek(self._nsect_pos)
        self.f.write(struct.pack("<I", self.nsect))
        self.f.close()
        return total


def write(path: str, c: Container) -> int:
    """Write a fully-materialized container. Section order mirrors the
    streaming pipeline writer exactly (META, BLOCK*, BLOOM, DICT, INDEX):
    distributed archives must be byte-identical to single-process ones."""
    w = Writer(path)
    w.section(TAG_META, c.meta.pack())
    for payload, n in zip(c.block_payloads, c.block_n_reads):
        w.block(payload, n)
    w.section(TAG_UNITIGS if c.unitigs else TAG_BLOOM, c.bloom_payload)
    w.section(TAG_DICT, c.dict_payload)
    return w.close()


class Reader:
    """Lazy container reader: one pass indexes the sections; block
    payloads are read (and CRC-checked) on demand."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        head = self.f.read(13)
        if head[:8] != MAGIC:
            raise ValueError(f"{path}: not a LEONTPU container (bad magic)")
        if head[8] not in _READ_VERSIONS:
            hint = (" (written by an older leon-tpu with the v2/v3 hash "
                    "family; decompress with that version and re-compress)"
                    if 3 <= head[8] <= 5 else "")
            raise ValueError(
                f"{path}: unsupported container version {head[8]}{hint}")
        self.version = head[8]
        (nsect,) = struct.unpack_from("<I", head, 9)
        self.meta: Meta | None = None
        self._dict_span: tuple[int, int] | None = None
        self._bloom_span: tuple[int, int] | None = None
        self._unitigs_span: tuple[int, int] | None = None
        self._block_spans: list[tuple[int, int]] = []
        try:
            pos = 13
            for _ in range(nsect):
                self.f.seek(pos)
                hdr = self.f.read(11)  # tag + max varint(u64) length
                tag = hdr[0]
                plen, off = varint.decode_one(hdr, 1)
                start = pos + off
                if tag == TAG_META:
                    self.f.seek(start)
                    self.meta = Meta.unpack(self._checked(start, plen))
                elif tag == TAG_DICT:
                    self._dict_span = (start, plen)
                elif tag == TAG_BLOOM:
                    self._bloom_span = (start, plen)
                elif tag == TAG_UNITIGS:
                    self._unitigs_span = (start, plen)
                elif tag == TAG_BLOCK:
                    self._block_spans.append((start, plen))
                pos = start + plen + 4
        except (IndexError, struct.error) as e:
            raise ValueError(f"{path}: truncated or corrupt container ({e})") from e
        if self.meta is None:
            raise ValueError(f"{path}: missing META section")

    def _checked(self, start: int, plen: int) -> bytes:
        self.f.seek(start)
        payload = self.f.read(plen)
        crc_b = self.f.read(4)
        if len(payload) != plen or len(crc_b) != 4:
            raise ValueError(f"{self.path}: truncated or corrupt container (short section)")
        (crc,) = struct.unpack("<I", crc_b)
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{self.path}: CRC mismatch in section at {start}")
        return payload

    @property
    def dict_payload(self) -> bytes:
        if self._dict_span is None:
            return b""
        return self._checked(*self._dict_span)

    @property
    def bloom_payload(self) -> bytes:
        if self._bloom_span is None:
            return b""
        return self._checked(*self._bloom_span)

    @property
    def unitigs_payload(self) -> bytes | None:
        """UNITIGS section payload (framed), or None when the archive
        stores the raw BLOOM bitset instead."""
        if self._unitigs_span is None:
            return None
        return self._checked(*self._unitigs_span)

    @property
    def n_blocks(self) -> int:
        return len(self._block_spans)

    def block(self, i: int) -> bytes:
        return self._checked(*self._block_spans[i])

    def close(self) -> None:
        self.f.close()


def read(path: str) -> Container:
    """Materialize the whole container (small archives / tests)."""
    r = Reader(path)
    try:
        uni = r.unitigs_payload
        c = Container(
            meta=r.meta,
            dict_payload=r.dict_payload,
            bloom_payload=uni if uni is not None else r.bloom_payload,
            block_payloads=[r.block(i) for i in range(r.n_blocks)],
            block_n_reads=[],
            unitigs=uni is not None,
        )
    finally:
        r.close()
    return c
