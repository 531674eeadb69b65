"""Batched byte-plane topic tokenization (copy of
``bifromq_tpu/models/bytetok.py``; host half of the byte plane).

- :class:`TopicBytes` is the batch wire form the serving path hands the
  tokenizer: ONE contiguous ``uint8`` buffer of concatenated UTF-8
  topics plus an ``int32`` offsets vector. Level lists materialize only
  on the rare fallback paths (host oracle, overlay correction).
- :func:`topic_structure` derives every level boundary of the whole
  batch in vectorized numpy (separator scan + cumsum bookkeeping), with
  no per-row loop.
- :func:`hash_levels` computes BLAKE2b(digest_size=8, salt) over all
  single-block (≤128-byte) levels of the batch in one vectorized numpy
  pass, bit-exact with :func:`~bifromq_tpu_torch.models.automaton.level_hash`.
  Multi-block levels (>128 bytes) fall back to ``hashlib`` per level.
- :func:`tokenize_bytes` tokenizes a byte batch in pure numpy, end to
  end. The serving path's host tokenizer is the native one
  (``models/native_tok.py``), and the device path (``ops/tokenize.py``)
  ships the same bytes to the BLAKE2b CUDA kernel.

Little-endian byte order is assumed for the vectorized word loads; the
module guards and falls back to the per-level ``hashlib`` path on
big-endian hosts.
"""

from __future__ import annotations

import hashlib
import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import topic as topic_util

_SLASH = ord("/")
_DOLLAR = ord("$")
_EMPTY = -1

# BLAKE2b (RFC 7693) constants — shared with the plain device version
# (ops/tokenize.py) and mirrored in csrc/blake2b_levels.cu.
BLAKE2B_IV = np.array([
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179], dtype=np.uint64)

BLAKE2B_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)

# a level longer than one BLAKE2b block needs the multi-block loop —
# the vectorized single-block pass (and the device kernel) hand it to
# the hashlib reference instead (bounded-work-then-fallback, the same
# contract as the walk's overflow rows)
MAX_SINGLE_BLOCK_LEVEL = 128


@dataclass
class TopicBytes:
    """One publish batch as raw bytes: topic *i* is the UTF-8 slice
    ``data[offsets[i]:offsets[i+1]]``. The matcher, the numpy tokenizer
    and the device hash kernel all consume this form directly — it is
    built once per batch and never re-encoded.
    """

    data: np.ndarray       # [total_bytes] uint8
    offsets: np.ndarray    # [n + 1] int32, offsets[0] == 0

    def __len__(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def byte_lens(self) -> np.ndarray:
        return np.diff(self.offsets)

    def row_bytes(self, i: int) -> bytes:
        return self.data[self.offsets[i]:self.offsets[i + 1]].tobytes()

    def row_str(self, i: int) -> str:
        return self.row_bytes(i).decode("utf-8")

    def select(self, idx) -> "TopicBytes":
        """Row-subset batch (vectorized gather — the cache-miss and
        escalation sub-batches are built this way, never per-row)."""
        idx = np.asarray(idx, dtype=np.int64)
        lens = self.byte_lens[idx]
        offsets = np.zeros(idx.shape[0] + 1, dtype=np.int32)
        np.cumsum(lens, out=offsets[1:])
        total = int(offsets[-1])
        if total == 0:
            return TopicBytes(np.zeros(0, np.uint8), offsets)
        src = (np.repeat(self.offsets[:-1][idx].astype(np.int64), lens)
               + _intra_row_positions(lens))
        return TopicBytes(self.data[src], offsets)

    @staticmethod
    def from_topics(topics: Sequence) -> "TopicBytes":
        """Pack str / bytes / level-list rows into one contiguous buffer.

        Uniform str (or bytes) batches — the serving shape — pack with
        ONE C-level NUL-join + encode and a vectorized boundary scan
        (topics cannot contain NUL, [MQTT-4.7.3-1]; a batch that does
        anyway falls back to the per-row pack). Mixed/level-list rows
        take the per-row loop (legacy callers only)."""
        n = len(topics)
        if n:
            # uniform-type fast path: the join itself type-checks (a
            # mixed batch raises TypeError → per-row loop below), and
            # the separator count is validated from the scan we need
            # anyway — no extra per-row passes
            joined = None
            try:
                if type(topics[0]) is str:
                    joined = "\x00".join(topics).encode("utf-8")
                elif type(topics[0]) is bytes:
                    joined = b"\x00".join(topics)
            except TypeError:
                joined = None
            if joined is not None:
                raw = np.frombuffer(joined, dtype=np.uint8)
                sep = raw == 0
                sep_pos = np.nonzero(sep)[0]
                if sep_pos.size == n - 1:   # no NUL inside any topic
                    bounds = np.empty(n + 1, dtype=np.int64)
                    bounds[0] = -1
                    bounds[1:n] = sep_pos
                    bounds[n] = raw.size
                    offsets = np.zeros(n + 1, dtype=np.int32)
                    np.cumsum(np.diff(bounds) - 1, out=offsets[1:])
                    offsets[0] = 0
                    return TopicBytes(data=raw[~sep], offsets=offsets)
        enc: List[bytes] = []
        for t in topics:
            if isinstance(t, bytes):
                enc.append(t)
            elif isinstance(t, str):
                enc.append(t.encode("utf-8"))
            else:
                enc.append(topic_util.DELIMITER.join(t).encode("utf-8"))
        offsets = np.zeros(len(enc) + 1, dtype=np.int32)
        np.cumsum([len(b) for b in enc], out=offsets[1:])
        data = (np.frombuffer(b"".join(enc), dtype=np.uint8)
                if offsets[-1] else np.zeros(0, np.uint8))
        return TopicBytes(data=data, offsets=offsets)


def _intra_row_positions(lens: np.ndarray) -> np.ndarray:
    """[sum(lens)] position-within-row for a ragged layout (vectorized
    ``concat(arange(l) for l in lens)``)."""
    lens = lens.astype(np.int64, copy=False)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lens)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)


@dataclass
class TopicStructure:
    """Every level boundary of a :class:`TopicBytes` batch, flattened.

    ``lvl_*`` arrays have one entry per level across the whole batch, in
    row order; level *k* of the batch lives in row ``lvl_row[k]`` at
    in-row index ``lvl_idx[k]`` and spans
    ``data[lvl_start[k]:lvl_start[k] + lvl_len[k]]``.
    """

    n_levels: np.ndarray      # [n] int32 (every row has ≥1 level)
    sys_mask: np.ndarray      # [n] bool — first byte is '$'
    max_lvl_len: np.ndarray   # [n] int64 — longest level in the row
    lvl_row: np.ndarray       # [L] int64
    lvl_idx: np.ndarray       # [L] int64 — level index within its row
    lvl_start: np.ndarray     # [L] int64 — absolute into tb.data
    lvl_len: np.ndarray       # [L] int64


def topic_structure(tb: TopicBytes) -> TopicStructure:
    """Vectorized separator scan: no per-row Python, O(total bytes)."""
    offsets = tb.offsets.astype(np.int64, copy=False)
    lens = np.diff(offsets)
    n = lens.shape[0]
    data = tb.data
    sep_at = data == _SLASH
    sep_pos = np.nonzero(sep_at)[0]
    # row of each separator: offsets are sorted, so one searchsorted
    sep_row = np.searchsorted(offsets[1:], sep_pos, side="right")
    n_sep = np.bincount(sep_row, minlength=n).astype(np.int64)
    n_levels = (n_sep + 1).astype(np.int32)
    total_levels = int(n_sep.sum()) + n
    lvl_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_levels, out=lvl_off[1:])
    # level k's start/end: row-first level starts at the row offset and
    # the row-last ends at the row end; interior boundaries come from
    # the separators (end = sep position, next start = sep position + 1)
    lvl_start = np.empty(total_levels, dtype=np.int64)
    lvl_end = np.empty(total_levels, dtype=np.int64)
    lvl_start[lvl_off[:-1]] = offsets[:-1]
    lvl_end[lvl_off[1:] - 1] = offsets[1:]
    if sep_pos.size:
        sep_rank = _intra_row_positions(n_sep)
        slot = lvl_off[sep_row] + sep_rank
        lvl_end[slot] = sep_pos
        lvl_start[slot + 1] = sep_pos + 1
    lvl_len = lvl_end - lvl_start
    lvl_row = np.repeat(np.arange(n, dtype=np.int64), n_levels)
    lvl_idx = _intra_row_positions(n_levels.astype(np.int64))
    max_lvl_len = np.zeros(n, dtype=np.int64)
    np.maximum.at(max_lvl_len, lvl_row, lvl_len)
    sys_mask = np.zeros(n, dtype=bool)
    nonempty = lens > 0
    sys_mask[nonempty] = data[offsets[:-1][nonempty]] == _DOLLAR
    return TopicStructure(n_levels=n_levels, sys_mask=sys_mask,
                          max_lvl_len=max_lvl_len, lvl_row=lvl_row,
                          lvl_idx=lvl_idx, lvl_start=lvl_start,
                          lvl_len=lvl_len)


# --------------------------- vectorized BLAKE2b ----------------------------

def blake2b8_h0(salt: int) -> np.ndarray:
    """[8] uint64 initial state for blake2b(digest_size=8, salt=salt8) —
    IV xor the parameter block (digest_length=8, fanout=1, depth=1, the
    8-byte little-endian salt zero-padded to 16, exactly like hashlib
    pads). Depends only on the salt, so callers hoist it per batch."""
    param = np.zeros(64, dtype=np.uint8)
    param[0] = 8    # digest_length
    param[2] = 1    # fanout
    param[3] = 1    # depth
    param[32:40] = np.frombuffer(
        (salt & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"), dtype=np.uint8)
    return BLAKE2B_IV ^ param.view("<u8").astype(np.uint64)


def _rotr64(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint64(n)) | (x << np.uint64(64 - n))


def _blake2b8_single_block(blocks: np.ndarray, lens: np.ndarray,
                           h0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized final-block compression: ``blocks`` is [M, 128] uint8
    (zero-padded messages, each ≤128 bytes), ``lens`` [M] the true byte
    counts. Returns (h1, h2) int32 — the low/high 32-bit lanes of the
    8-byte digest, the exact ``level_hash`` split."""
    m_words = np.ascontiguousarray(blocks).view("<u8")   # [M, 16]
    m = [m_words[:, i].astype(np.uint64, copy=False) for i in range(16)]
    size = blocks.shape[0]
    v = [np.full(size, h0[i], dtype=np.uint64) for i in range(8)]
    v += [np.full(size, BLAKE2B_IV[i], dtype=np.uint64) for i in range(8)]
    v[12] ^= lens.astype(np.uint64, copy=False)     # t0 (single block)
    v[14] = ~v[14]                                  # final-block flag

    def g(a, b, c, d, x, y):
        v[a] = v[a] + v[b] + x
        v[d] = _rotr64(v[d] ^ v[a], 32)
        v[c] = v[c] + v[d]
        v[b] = _rotr64(v[b] ^ v[c], 24)
        v[a] = v[a] + v[b] + y
        v[d] = _rotr64(v[d] ^ v[a], 16)
        v[c] = v[c] + v[d]
        v[b] = _rotr64(v[b] ^ v[c], 63)

    for s in BLAKE2B_SIGMA:
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])

    h0_final = h0[0] ^ v[0] ^ v[8]
    h1 = (h0_final & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    h2 = (h0_final >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return h1, h2


def _hash_level_ref(level: bytes, salt: int) -> Tuple[int, int]:
    """The hashlib reference for one level (multi-block / big-endian
    fallback) — byte-identical to ``automaton.level_hash``."""
    d = hashlib.blake2b(level, digest_size=8,
                        salt=(salt & 0xFFFFFFFFFFFFFFFF).to_bytes(
                            8, "little")).digest()
    return (int.from_bytes(d[:4], "little", signed=True),
            int.from_bytes(d[4:], "little", signed=True))


def hash_levels(data: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                salt: int) -> Tuple[np.ndarray, np.ndarray]:
    """(h1, h2) int32 per level; ``starts``/``lens`` index into ``data``.

    Single-block levels (the entire realistic population) hash in one
    vectorized numpy pass; multi-block levels loop through hashlib."""
    total = starts.shape[0]
    h1 = np.zeros(total, dtype=np.int32)
    h2 = np.zeros(total, dtype=np.int32)
    if not total:
        return h1, h2
    short = lens <= MAX_SINGLE_BLOCK_LEVEL
    if sys.byteorder != "little":
        short = np.zeros_like(short)    # guard: word loads assume LE
    if short.any():
        idx = np.nonzero(short)[0]
        ls = lens[idx]
        blocks = np.zeros((idx.shape[0], 128), dtype=np.uint8)
        pos = _intra_row_positions(ls)
        rowk = np.repeat(np.arange(idx.shape[0], dtype=np.int64), ls)
        blocks[rowk, pos] = data[np.repeat(starts[idx], ls) + pos]
        h1[idx], h2[idx] = _blake2b8_single_block(blocks, ls,
                                                  blake2b8_h0(salt))
    for k in np.nonzero(~short)[0]:
        h1[k], h2[k] = _hash_level_ref(
            data[starts[k]:starts[k] + lens[k]].tobytes(), salt)
    return h1, h2


def tokenize_bytes(tb: TopicBytes, roots: Sequence[int], *,
                   max_levels: int, salt: int,
                   batch: Optional[int] = None,
                   structure: Optional[TopicStructure] = None):
    """Byte batch → padded probe arrays, pure numpy.

    Returns ``(tok_h1, tok_h2, lengths, roots, sys_mask)``: rows deeper
    than ``max_levels`` stay padding (length -1) for the caller's host
    fallback."""
    n = len(tb)
    b = batch or n
    assert b >= n
    width = max_levels + 1
    st = structure if structure is not None else topic_structure(tb)
    ok = st.n_levels <= max_levels
    lengths = np.full(b, _EMPTY, dtype=np.int32)
    rootv = np.full(b, _EMPTY, dtype=np.int32)
    sys_mask = np.zeros(b, dtype=bool)
    lengths[:n][ok] = st.n_levels[ok]
    rootv[:n][ok] = np.asarray(list(roots), dtype=np.int32)[ok]
    sys_mask[:n][ok] = st.sys_mask[ok]
    tok_h1 = np.zeros((b, width), dtype=np.int32)
    tok_h2 = np.zeros((b, width), dtype=np.int32)
    sel = ok[st.lvl_row]
    if sel.any():
        h1, h2 = hash_levels(tb.data, st.lvl_start[sel], st.lvl_len[sel],
                             salt)
        tok_h1[st.lvl_row[sel], st.lvl_idx[sel]] = h1
        tok_h2[st.lvl_row[sel], st.lvl_idx[sel]] = h2
    return tok_h1, tok_h2, lengths, rootv, sys_mask
