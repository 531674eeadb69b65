"""Device-side byte-level topic hashing (port of ``bifromq_tpu/ops/tokenize.py``).

The raw topic bytes ship to the device as one ``[B, MAX_BYTES]`` uint8
block plus the per-lane level boundaries (small int32 grids), and the
BLAKE2b kernel (``csrc/blake2b_levels.cu``) computes the probes' h1/h2
token lanes there: only bytes cross to the card.

The hash is BLAKE2b (RFC 7693) with digest_size=8 and the automaton salt,
bit-exact with ``automaton.level_hash``: one final-block compression per
level. A level longer than one 128-byte block is unsupported by
construction — the host marks such rows padding and they take the exact
oracle fallback.

``_hash_lanes`` is the plain PyTorch version: the reference's (lo, hi)
32-bit lane-pair arithmetic held in int64 tensors, so every add and shift
stays inside int64 without overflow. ``blake2b_levels`` is the kernel's
wrapper: it launches the kernel on CUDA tensors and runs ``_hash_lanes``
on CPU tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..models import bytetok
from ..models.automaton import TokenizedTopics
from ..utils import topic as topic_util
from ..utils.device import CudaKernel, check_cuda, ptr, stream_of, upload
from ..utils.env import env_int

_EMPTY = -1
_LEVEL_BLOCK = bytetok.MAX_SINGLE_BLOCK_LEVEL   # 128: one BLAKE2b block
_M32 = 0xFFFFFFFF

BLAKE2B = CudaKernel("blake2b_levels.cu", "blake2b_levels")


def tok_max_bytes() -> int:
    """Per-topic byte budget of the device path (``BIFROMQ_TOK_MAX_BYTES``,
    default 256; longer rows take the host path via the padding
    contract)."""
    return max(_LEVEL_BLOCK, env_int("BIFROMQ_TOK_MAX_BYTES", 256))


# ------------------- plain version: 64-bit as 32-bit lane pairs -------------

def _add64(alo, ahi, blo, bhi):
    lo = alo + blo
    return lo & _M32, (ahi + bhi + (lo >> 32)) & _M32


def _rotr64(lo, hi, n: int):
    if n == 32:
        return hi, lo
    if n < 32:
        return (((lo >> n) | (hi << (32 - n))) & _M32,
                ((hi >> n) | (lo << (32 - n))) & _M32)
    m = n - 32
    return (((hi >> m) | (lo << (32 - m))) & _M32,
            ((lo >> m) | (hi << (32 - m))) & _M32)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bit pattern held in int64 -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _hash_lanes(rows, starts, lens, nlv, h0):
    """The plain version of the kernel: one final-block BLAKE2b-8 per
    (row, lane).

    ``rows`` [B, MB] uint8 raw topic bytes; ``starts``/``lens`` [B, W]
    int32 level boundaries (relative to the row); ``nlv`` [B, 1] int32
    level counts (-1 for padding rows); ``h0`` [8] int64 salt-folded
    initial state (the uint64 bit patterns). Returns (h1, h2) [B, W]
    int32 with lanes past a row's level count zeroed."""
    b, mb = rows.shape
    w = starts.shape[1]
    dev = rows.device
    iota = torch.arange(_LEVEL_BLOCK, device=dev)
    gidx = (starts.long()[:, :, None] + iota).clamp(0, mb - 1)
    byte = rows.long().gather(1, gidx.reshape(b, -1)).reshape(
        b, w, _LEVEL_BLOCK)
    byte = torch.where(iota < lens.long()[:, :, None], byte, 0)
    # 16 message words as (lo, hi) pairs, little-endian
    wb = byte.reshape(b, w, 16, 8)
    shifts = torch.tensor([0, 8, 16, 24], device=dev)
    lo_w = (wb[..., :4] << shifts).sum(-1)
    hi_w = (wb[..., 4:] << shifts).sum(-1)
    m = [(lo_w[..., i], hi_w[..., i]) for i in range(16)]
    h0 = [int(x) & ((1 << 64) - 1) for x in h0.tolist()]
    iv = [int(x) for x in bytetok.BLAKE2B_IV]
    shape = (b, w)

    def full(x: int):
        return torch.full(shape, x, dtype=torch.int64, device=dev)

    v = [(full(x & _M32), full(x >> 32)) for x in h0]
    v += [(full(x & _M32), full(x >> 32)) for x in iv]
    t = lens.long() & _M32                          # t0 (levels <= 128B)
    v[12] = (v[12][0] ^ t, v[12][1])
    v[14] = (v[14][0] ^ _M32, v[14][1] ^ _M32)      # final-block flag

    def g(a, bb, c, d, x, y):
        v[a] = _add64(*_add64(*v[a], *v[bb]), *x)
        v[d] = _rotr64(v[d][0] ^ v[a][0], v[d][1] ^ v[a][1], 32)
        v[c] = _add64(*v[c], *v[d])
        v[bb] = _rotr64(v[bb][0] ^ v[c][0], v[bb][1] ^ v[c][1], 24)
        v[a] = _add64(*_add64(*v[a], *v[bb]), *y)
        v[d] = _rotr64(v[d][0] ^ v[a][0], v[d][1] ^ v[a][1], 16)
        v[c] = _add64(*v[c], *v[d])
        v[bb] = _rotr64(v[bb][0] ^ v[c][0], v[bb][1] ^ v[c][1], 63)

    for s in bytetok.BLAKE2B_SIGMA:
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])

    out_lo = (h0[0] & _M32) ^ v[0][0] ^ v[8][0]
    out_hi = (h0[0] >> 32) ^ v[0][1] ^ v[8][1]
    active = torch.arange(w, device=dev) < nlv.long()
    h1 = torch.where(active, _to_i32(out_lo), 0).to(torch.int32)
    h2 = torch.where(active, _to_i32(out_hi), 0).to(torch.int32)
    return h1, h2


def blake2b_levels(rows, starts, lens, nlv, h0):
    """The BLAKE2b kernel's wrapper (replaces the Pallas ``_build_pallas``
    call of ``bifromq_tpu/ops/tokenize.py``): same arguments and results
    as :func:`_hash_lanes`. CUDA tensors launch
    ``csrc/blake2b_levels.cu``; CPU tensors run ``_hash_lanes``."""
    if rows.device.type == "cpu":
        return _hash_lanes(rows, starts, lens, nlv, h0)
    b, mb = rows.shape
    w = starts.shape[1]
    check_cuda("rows", rows, torch.uint8, (b, mb))
    check_cuda("starts", starts, torch.int32, (b, w))
    check_cuda("lens", lens, torch.int32, (b, w))
    check_cuda("nlv", nlv, torch.int32, (b, 1))
    check_cuda("h0", h0, torch.int64, (8,))
    h1 = torch.empty((b, w), dtype=torch.int32, device=rows.device)
    h2 = torch.empty((b, w), dtype=torch.int32, device=rows.device)
    if b * w:
        BLAKE2B.launch(stream_of(rows), ptr(rows), ptr(starts), ptr(lens),
                       ptr(nlv), ptr(h0), ptr(h1), ptr(h2), b, mb, w)
    return h1, h2


def _h0(salt: int) -> np.ndarray:
    """The salt-folded BLAKE2b initial state as [8] int64 bit patterns."""
    return bytetok.blake2b8_h0(salt).view(np.int64)


def h0_tensor(salt: int, device) -> torch.Tensor:
    """:func:`_h0` on ``device``."""
    return upload([_h0(salt)], device)[0]


def hash_topics_device(rows, starts, lens, nlv, salt: int, *, device):
    """Upload the packed byte batch (one copy) and hash every level on
    the device. Returns (h1, h2) tensors [B, W] int32 on ``device``."""
    return blake2b_levels(*upload([rows, starts, lens, nlv, _h0(salt)],
                                  device))


class DeviceTokenized:
    """Host mirror of a device-tokenized probe batch.

    The hash lanes live ONLY on the device; the host keeps the cheap
    vectorized structure — lengths / roots / sys flags — plus the raw
    bytes, so the expansion stage never reads the device token arrays
    back. The rare paths that need host token rows (the escalation
    re-walk) re-tokenize just their rows via ``sub_batch``.
    """

    __slots__ = ("lengths", "roots", "sys_mask", "_tb", "_salt",
                 "_max_levels")

    def __init__(self, lengths, roots, sys_mask, tb, salt, max_levels):
        self.lengths = lengths
        self.roots = roots
        self.sys_mask = sys_mask
        self._tb = tb
        self._salt = salt
        self._max_levels = max_levels

    @property
    def batch(self) -> int:
        return self.lengths.shape[0]

    def sub_batch(self, rows: np.ndarray, batch: int) -> TokenizedTopics:
        """Host token rows for a row subset (escalation re-walk)."""
        from ..models.automaton import tokenize
        rows = np.asarray(rows, dtype=np.int64)
        return tokenize(self._tb.select(rows),
                        [int(r) for r in self.roots[rows]],
                        max_levels=self._max_levels, salt=self._salt,
                        batch=batch)


def _hashable_rows(tb, st, max_levels: int) -> np.ndarray:
    """Rows the kernel can hash: at most ``max_levels`` levels, at most
    ``tok_max_bytes()`` bytes, no level over one BLAKE2b block."""
    return ((st.n_levels <= max_levels)
            & (tb.byte_lens.astype(np.int64) <= tok_max_bytes())
            & (st.max_lvl_len <= _LEVEL_BLOCK))


def _pack_lanes(tb, st, ok: np.ndarray, batch: int, width: int):
    """The ``ok`` rows' bytes in a fixed ``[batch, tok_max_bytes()]``
    block and their level boundaries (relative to the row) in ``[batch,
    width]`` grids; other rows stay zero. Returns ``(rows, starts, lens,
    sel)``, ``sel`` marking the levels of the packed rows."""
    n = len(tb)
    byte_lens = tb.byte_lens.astype(np.int64)
    rows = np.zeros((batch, tok_max_bytes()), dtype=np.uint8)
    row_of = np.repeat(np.arange(n, dtype=np.int64), byte_lens)
    pos = bytetok._intra_row_positions(byte_lens)
    keep = ok[row_of]
    rows[row_of[keep], pos[keep]] = tb.data[keep]
    starts = np.zeros((batch, width), dtype=np.int32)
    lens_g = np.zeros((batch, width), dtype=np.int32)
    sel = ok[st.lvl_row]
    row_off = tb.offsets.astype(np.int64)[:-1]
    r_sel, i_sel = st.lvl_row[sel], st.lvl_idx[sel]
    starts[r_sel, i_sel] = \
        (st.lvl_start[sel] - row_off[r_sel]).astype(np.int32)
    lens_g[r_sel, i_sel] = st.lvl_len[sel].astype(np.int32)
    return rows, starts, lens_g, sel


def pack_topic_bytes(tb, roots: Sequence[int], *, max_levels: int,
                     batch: int):
    """Host half of :func:`device_tokenize`: pack + structure in
    vectorized numpy. Returns ``(lengths, roots, sys_mask, rows, starts,
    lens)``; rows the kernel cannot hash — longer than
    ``tok_max_bytes()``, a level over one BLAKE2b block, or deeper than
    ``max_levels`` — are marked padding (length -1)."""
    n = len(tb)
    b = batch
    assert b >= n
    st = bytetok.topic_structure(tb)
    ok = _hashable_rows(tb, st, max_levels)
    lengths = np.full(b, _EMPTY, dtype=np.int32)
    rootv = np.full(b, _EMPTY, dtype=np.int32)
    sys_mask = np.zeros(b, dtype=bool)
    lengths[:n][ok] = st.n_levels[ok]
    rootv[:n][ok] = np.fromiter(roots, dtype=np.int32, count=n)[ok]
    sys_mask[:n][ok] = st.sys_mask[ok]
    rows, starts, lens_g, _ = _pack_lanes(tb, st, ok, b, max_levels + 1)
    return lengths, rootv, sys_mask, rows, starts, lens_g


def device_tokenize(tb, roots: Sequence[int], *, max_levels: int,
                    salt: int, batch=None, device
                    ) -> Tuple[DeviceTokenized, "object"]:
    """The byte-plane device prep: pack + structure on host (vectorized
    numpy), hash on device. Returns ``(host_mirror, Probes)``."""
    from .match import Probes
    b = batch or len(tb)
    lengths, rootv, sys_mask, rows, starts, lens_g = pack_topic_bytes(
        tb, roots, max_levels=max_levels, batch=b)
    h1, h2 = hash_topics_device(rows, starts, lens_g, lengths.reshape(b, 1),
                                salt, device=device)
    dev_lengths, dev_roots, dev_sys = upload([lengths, rootv, sys_mask],
                                             device)
    probes = Probes(tok_h1=h1, tok_h2=h2, lengths=dev_lengths,
                    roots=dev_roots, sys_mask=dev_sys,
                    max_len=int(lengths.max(initial=-1)))
    mirror = DeviceTokenized(lengths=lengths, roots=rootv,
                             sys_mask=sys_mask, tb=tb, salt=salt,
                             max_levels=max_levels)
    return mirror, probes


class DeviceTokenizedFilters:
    """Host mirror of a device-tokenized FILTER probe batch: the lengths,
    roots and kind grid the scan needs on the host, while the literal
    lanes' hashes live only on the device (the split of
    :class:`DeviceTokenized`)."""

    __slots__ = ("lengths", "roots", "kinds")

    def __init__(self, lengths, roots, kinds):
        self.lengths = lengths
        self.roots = roots
        self.kinds = kinds

    @property
    def batch(self) -> int:
        return self.lengths.shape[0]


def pack_filter_bytes(filters, roots: Sequence[int], *, max_levels: int,
                      batch: int):
    """Host half of :func:`device_tokenize_filters`: pack, scan and
    classify in vectorized numpy. Returns ``(lengths, roots, kinds, rows,
    starts, lens)``; rows the kernel cannot hash are padding."""
    from ..models.automaton import level_kinds
    n = len(filters)
    b = batch
    assert b >= n
    tb = bytetok.TopicBytes.from_topics(
        [topic_util.DELIMITER.join(f) for f in filters])
    st = bytetok.topic_structure(tb)
    n_ref = np.fromiter((len(f) for f in filters), dtype=np.int64,
                        count=n)
    empty_rows = n_ref == 0
    resplit = (st.n_levels != n_ref) & ~empty_rows
    ok = _hashable_rows(tb, st, max_levels) & ~empty_rows & ~resplit
    lengths = np.full(b, _EMPTY, dtype=np.int32)
    rootv = np.full(b, _EMPTY, dtype=np.int32)
    roots_a = np.fromiter(roots, dtype=np.int32, count=n)
    lengths[:n][ok] = st.n_levels[ok]
    rootv[:n][ok] = roots_a[ok]
    lengths[:n][empty_rows] = 0
    rootv[:n][empty_rows] = roots_a[empty_rows]
    rows, starts, lens_g, sel = _pack_lanes(tb, st, ok, b, max_levels + 1)
    kinds = np.zeros((b, max_levels + 1), dtype=np.int32)
    kinds[st.lvl_row[sel], st.lvl_idx[sel]] = level_kinds(tb.data, st)[sel]
    return lengths, rootv, kinds, rows, starts, lens_g


def device_tokenize_filters(filters, roots: Sequence[int], *,
                            max_levels: int, salt: int, batch=None, device):
    """Retained FILTER tokenization with the hashing on the device.

    The host packs the joined filter bytes, scans the level boundaries
    and classifies the single-byte ``'+'`` / ``'#'`` lanes; the BLAKE2b
    kernel (K1) hashes every lane, and the wildcard lanes are masked to
    ``h1 == h2 == 0`` after it (only ``KIND_LIT`` lanes carry hashes, as
    in ``TokenizedFilters``). Rows the kernel cannot hash — deeper than
    ``max_levels``, longer than ``tok_max_bytes()``, a level over one
    BLAKE2b block, or a level that embeds the delimiter (the joined row
    would split differently) — are padding (length ``-1``) and the
    caller serves them on the host. An empty filter has length 0 and no
    lanes. Returns ``(host_mirror, FilterProbes)``."""
    from ..models.automaton import KIND_LIT
    from .retained import FilterProbes
    b = batch or len(filters)
    lengths, rootv, kinds, rows, starts, lens_g = pack_filter_bytes(
        filters, roots, max_levels=max_levels, batch=b)
    # one staged copy for the kernel's inputs and the probes' grids
    d_rows, d_starts, d_lens, d_lengths, d_h0, d_kinds, d_roots = upload(
        [rows, starts, lens_g, lengths, _h0(salt), kinds, rootv], device)
    h1, h2 = blake2b_levels(d_rows, d_starts, d_lens, d_lengths.view(b, 1),
                            d_h0)
    # inactive lanes are already zero (the kernel's active mask) and
    # carry kind 0 == KIND_LIT, so this strips the wildcard lanes only
    lit = d_kinds == KIND_LIT
    probes = FilterProbes(tok_h1=torch.where(lit, h1, 0),
                          tok_h2=torch.where(lit, h2, 0), tok_kind=d_kinds,
                          lengths=d_lengths, roots=d_roots,
                          max_len=int(lengths.max(initial=-1)))
    mirror = DeviceTokenizedFilters(lengths=lengths, roots=rootv,
                                    kinds=kinds)
    return mirror, probes
