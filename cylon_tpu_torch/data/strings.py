"""Device-native variable-length strings: (starts, lengths, words)
(counterpart of cylon_tpu.data.strings, bit-identical to it).

The layout is the JAX package's: every row's bytes start at a 4-byte
boundary of one dense word buffer (tail-padded with zero bytes), rows are
tightly packed (``starts == exclusive_cumsum(ceil(len / 4))``) or strided
(``starts[r] = r * K``), and every operation is a fixed set of
whole-tensor passes:

* per-row content identity is three independent 32-bit polynomial hashes
  computed with the prefix-sum range trick: word j of a row contributes
  ``g^p * mix(w_j)`` with p its offset in the row, so a row's hash is a
  difference of two prefix sums (one cumsum per hash);
* short rows (<= EXACT_KEY_WORDS words) key joins, groupbys and set ops
  on their raw words plus the byte length: byte-exact equality with no
  hashing;
* varlen takes of short rows (<= LANE_WORDS_MAX words) gather fixed word
  lanes into a strided layout; longer rows go through the packed-layout
  program (two scatters, two cumsums, three gathers).

torch has no uint32 arithmetic: words, lanes and hashes are int32 tensors
carrying the uint32 bits; the hash arithmetic runs in int64 holding
values in [0, 2^32), masked after every multiply (a 32 x 32-bit product
wraps int64, whose low 32 bits are still exact), and the prefix sums are
exact int64 sums taken modulo 2^32 at the end (exact while the buffer
holds fewer than 2^31 words).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..util import capacity as _capacity

# the 32-bit hash arithmetic of ops/hash.py, kept here as the JAX
# package's strings module keeps its own constants: column storage sits
# below the kernels and imports nothing of ops/
M32 = 0xFFFFFFFF
NULL_TAG = 0x9E3779B9


def u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int32, or any <= 4-byte container) -> int64 value."""
    if x.dtype == torch.int64:
        return x & M32
    return x.to(torch.int64) & ((1 << (8 * x.element_size())) - 1)


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 value in [0, 2^32) (or any int64, wrapped) -> int32 bits."""
    x = x & M32
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)

# ingest policy: dictionary-encode when the vocabulary is small (device
# codes sort faster and stay exact); otherwise varbytes
DICT_MAX_VOCAB = 1 << 14
DICT_MAX_RATIO = 0.5

# Table.sort prefix depth: varbytes sorts are exact up to this many words
# (4 bytes each); longer rows fall back to a host sort
SORT_PREFIX_WORDS = 16

# rows up to EXACT_KEY_WORDS words key on their raw words + length (byte
# exact); rows up to LANE_WORDS_MAX words gather and ride exchanges and
# join payloads as fixed word lanes (strided layout)
EXACT_KEY_WORDS = 5
LANE_WORDS_MAX = 8

# hash schemes (g multiplier, seed): g odd, three schemes for 96 id bits
_SCHEMES = ((31, 0x2545F491), (0x01000193, 0x85EBCA6B),
            (0x9E3779B1, 0xC2B2AE35))


def pair_k_words(a, b):
    """Shared lane count for two columns compared as a key pair, or None
    when lane pairing does not apply. Both sides of a key comparison must
    emit the same number of word lanes: every two-table key-building site
    goes through this."""
    if getattr(a, "is_varbytes", False) and getattr(b, "is_varbytes", False):
        return max(a.varbytes.max_words, b.varbytes.max_words)
    return None


def _nwords(lengths: torch.Tensor) -> torch.Tensor:
    return (lengths.to(torch.int64) + 3) >> 2


class VarBytes:
    """Word-aligned varlen byte storage (see the module docstring).

    words:   int32 [word_capacity] (uint32 bits), rows then zeros
    starts:  int32 [n], the word index of each row's first word
    lengths: int32 [n], byte length of each row
    max_words: int >= 1, the max ceil(len / 4) over rows (the sort prefix
               bound; kept through take and concat)
    total_words: words occupied (the packed prefix)
    shard_geom: None, or (rows_per_shard, words_per_shard) for a sharded
               column: each shard's starts are shard-relative, and
               ``eff_starts`` makes them global (the hash and take range
               sums ignore the gaps between shards)
    stride:  None (packed), or K for the strided layout in which global
             row r starts at word r * K

    The hash and lane memos live on the object that owns the buffers; the
    buffers are never written after construction.
    """

    def __init__(self, words, starts, lengths, max_words: int,
                 total_words: int, shard_geom=None, stride=None):
        self.words = words
        self.starts = starts
        self.lengths = lengths
        self.max_words = max(int(max_words), 1)
        self.total_words = int(total_words)
        self.shard_geom = shard_geom
        self.stride = stride
        self._hash_cache = None
        self._lane_cache = {}

    def __len__(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def nrows(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def device(self) -> torch.device:
        return self.words.device

    def eff_starts(self) -> torch.Tensor:
        """Starts as global word indices, int64."""
        s = self.starts.to(torch.int64)
        if self.shard_geom is None:
            return s
        rows, wstride = self.shard_geom
        sid = torch.arange(s.shape[0], device=s.device) // rows
        return s + sid * wstride

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------

    @staticmethod
    def from_host(values: Sequence, fill: bytes = b"",
                  device="cpu") -> "VarBytes":
        """Build from a sequence of str/bytes (None/NaN rows become
        ``fill``; validity is the owning Column's)."""
        enc = []
        for v in values:
            if v is None or (isinstance(v, float) and v != v):
                enc.append(fill)
            elif isinstance(v, bytes):
                enc.append(v)
            else:
                enc.append(str(v).encode("utf-8"))
        n = len(enc)
        lengths = np.fromiter((len(b) for b in enc), np.int32, n) \
            if n else np.zeros(0, np.int32)
        return VarBytes._from_packed(b"".join(enc), lengths, device=device)

    @staticmethod
    def from_arrow_buffers(offsets: np.ndarray, data: bytes,
                           device="cpu") -> "VarBytes":
        """Build from Arrow-style (offsets[n + 1], bytes)."""
        offsets = np.asarray(offsets)
        lengths = np.diff(offsets).astype(np.int32)
        lo = int(offsets[0]) if offsets.size else 0
        hi = int(offsets[-1]) if offsets.size else 0
        return VarBytes._from_packed(bytes(data[lo:hi]), lengths,
                                     src_offsets=offsets - lo,
                                     device=device)

    @staticmethod
    def _from_packed(src: bytes, lengths: np.ndarray,
                     src_offsets: Optional[np.ndarray] = None,
                     device="cpu") -> "VarBytes":
        """Contiguous source bytes -> the word-aligned packed layout, in
        numpy with no per-row Python."""
        lengths = np.asarray(lengths)
        n = lengths.shape[0]
        nw = (lengths.astype(np.int64) + 3) // 4
        starts = np.concatenate([[0], np.cumsum(nw)]).astype(np.int64)
        total_words = int(starts[-1])
        cap = _capacity(max(total_words, 1))
        out = np.zeros(cap * 4, np.uint8)
        sbuf = np.frombuffer(src, np.uint8)
        L = int(lengths[0]) if n else 0
        if n and len(sbuf) and src_offsets is None \
                and bool((lengths == L).all()):
            # one width: a reshape, no per-byte index arrays
            grid = out[:n * 4 * int(nw[0])].reshape(n, 4 * int(nw[0]))
            grid[:, :L] = sbuf[:n * L].reshape(n, L)
        elif len(sbuf):
            ln64 = lengths.astype(np.int64)
            if src_offsets is None:
                src_starts = np.concatenate([[0], np.cumsum(ln64)])[:-1]
            else:
                src_starts = np.asarray(src_offsets[:-1], np.int64)
            p = np.arange(int(ln64.sum())) - np.repeat(
                np.concatenate([[0], np.cumsum(ln64)])[:-1], ln64)
            dst = np.repeat(starts[:-1] * 4, ln64) + p
            out[dst] = sbuf[np.repeat(src_starts, ln64) + p]
        words = torch.from_numpy(out.view(np.int32)).to(device)
        return VarBytes(words,
                        torch.from_numpy(starts[:-1].astype(np.int32)).to(
                            device),
                        torch.from_numpy(lengths.astype(np.int32)).to(device),
                        int(nw.max()) if n else 1, total_words)

    def to_host(self, as_str: bool = True) -> np.ndarray:
        """Decode to a host object array of str (or bytes)."""
        raw = self.words.cpu().numpy().view(np.uint8).tobytes()
        starts = (self.eff_starts().to(torch.int64) * 4).cpu().tolist()
        lengths = self.lengths.cpu().tolist()
        rows = [raw[s:s + n] for s, n in zip(starts, lengths)]
        out = np.empty(len(rows), object)
        out[:] = [b.decode("utf-8", errors="replace") for b in rows] \
            if as_str else rows
        return out

    # ------------------------------------------------------------------
    # device passes
    # ------------------------------------------------------------------

    def raw_hashes(self) -> Tuple[torch.Tensor, ...]:
        """(h1, h2, h3) int32 bits of every row, memoized."""
        if self._hash_cache is None:
            self._hash_cache = _hash_rows(self.words, self.eff_starts(),
                                          self.lengths, self.max_words)
        return self._hash_cache

    def hash_keys(self, validity=None) -> Tuple[torch.Tensor, ...]:
        """(h1, h2, h3, len) int32 bits: the device identity of each row.
        Equal bytes give equal keys; unequal bytes collide only on a
        96-bit triple collision at equal length. ``validity`` forces null
        rows to a shared tag."""
        h1, h2, h3 = self.raw_hashes()
        ln = self.lengths
        if validity is not None:
            tag = NULL_TAG - (1 << 32)  # the tag's int32 bits
            h1 = torch.where(validity, h1, tag)
            h2 = torch.where(validity, h2, tag)
            h3 = torch.where(validity, h3, tag)
            ln = torch.where(validity, ln, 0)
        return h1, h2, h3, ln

    def word_lanes(self, k_lim: Optional[int] = None) -> list:
        """Rows as ``k_lim`` int32 lanes: lane k holds each row's word k,
        zero past the row's last word, so lane-tuple equality plus the
        length is byte equality. Strided layouts slice their buffer;
        packed ones gather once per lane (memoized)."""
        k_lim = int(self.max_words if k_lim is None else k_lim)
        cached = self._lane_cache.get(k_lim)
        if cached is not None:
            return list(cached)
        n = self.nrows
        nw = _nwords(self.lengths)
        K = self.stride
        if K is not None and int(self.words.shape[0]) >= n * K:
            grid = self.words[:n * K].view(n, K)
            lanes = [torch.where(k < nw, grid[:, k], 0) if k < K
                     else torch.zeros(n, dtype=torch.int32,
                                      device=self.device)
                     for k in range(k_lim)]
        else:
            wcap = int(self.words.shape[0])
            estarts = self.eff_starts()
            lanes = [torch.where(k < nw,
                                 self.words[(estarts + k).clamp(0, wcap - 1)],
                                 0)
                     for k in range(k_lim)]
        self._lane_cache[k_lim] = tuple(lanes)
        return lanes

    @staticmethod
    def from_lanes(lanes: Sequence[torch.Tensor], lengths: torch.Tensor,
                   world: Optional[int] = None) -> "VarBytes":
        """A strided VarBytes from word lanes and byte lengths (the join
        and take output path); words past each row's length are zeroed.
        ``world``: the rows are the flat layout of that many shards, and
        the starts are shard-relative."""
        K = max(len(lanes), 1)
        n = int(lengths.shape[0])
        dev = lengths.device
        nw = _nwords(lengths)
        masked = [torch.where(k < nw, l, 0) for k, l in enumerate(lanes)] \
            or [torch.zeros(n, dtype=torch.int32, device=dev)]
        flat = torch.stack(masked, 1).reshape(-1)
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        if world is not None and world > 1:
            rows = n // world
            vb = VarBytes(flat, (iota % rows) * K, lengths, K, n * K,
                          shard_geom=(rows, rows * K), stride=K)
        else:
            cap = _capacity(max(n * K, 1))
            if cap > n * K:
                flat = torch.cat([flat, torch.zeros(
                    cap - n * K, dtype=torch.int32, device=dev)])
            vb = VarBytes(flat, iota * K, lengths, K, n * K, stride=K)
        vb._lane_cache[K] = tuple(masked)
        return vb

    def take(self, indices) -> "VarBytes":
        """Varlen row gather; negative indices give empty rows (validity
        is the owning Column's). Short rows gather as lanes into a strided
        layout; longer rows through the packed-layout program with one
        capacity sync."""
        idx = torch.as_tensor(indices, device=self.device).to(torch.int64)
        if self.nrows == 0 or idx.shape[0] == 0:
            z = torch.zeros(idx.shape[0], dtype=torch.int32,
                            device=self.device)
            return VarBytes(torch.zeros(1, dtype=torch.int32,
                                        device=self.device), z, z, 1, 0)
        safe = idx.clamp(min=0)
        hit = idx >= 0
        if self.max_words <= LANE_WORDS_MAX:
            lanes = [l[safe] for l in self.word_lanes()]
            lens = torch.where(hit, self.lengths[safe], 0)
            return VarBytes.from_lanes(lanes, lens)
        nw = torch.where(hit, _nwords(self.lengths)[safe], 0)
        total = int(nw.sum())  # the capacity decision (one scalar sync)
        cap_w = _capacity(max(total, 1))
        words, starts, lens = _take_program(
            self.words, self.eff_starts(), self.lengths, idx, cap_w)
        return VarBytes(words, starts, lens, self.max_words, total)

    def sort_prefix_keys(self) -> list:
        """Lexicographic sort keys (int32 bits, compared unsigned):
        big-endian prefix words, then the byte length. Exact when
        max_words <= SORT_PREFIX_WORDS; longer rows need the host sort
        (``sortable_on_device``)."""
        k_lim = min(self.max_words, SORT_PREFIX_WORDS)
        keys = [_bswap32(w) for w in self.word_lanes(k_lim)]
        keys.append(self.lengths)
        return keys

    @property
    def sortable_on_device(self) -> bool:
        return self.max_words <= SORT_PREFIX_WORDS

    def equals_rows(self, other: "VarBytes") -> torch.Tensor:
        """Exact per-row byte equality against another VarBytes of the
        same row count (the verification behind ``join(exact=True)``)."""
        eq = self.lengths == other.lengths
        nw = _nwords(self.lengths)
        sa, sb = self.eff_starts(), other.eff_starts()
        ca, cb = self.words.shape[0], other.words.shape[0]
        for k in range(max(self.max_words, other.max_words)):
            wa = self.words[(sa + k).clamp(0, ca - 1)]
            wb = other.words[(sb + k).clamp(0, cb - 1)]
            eq = eq & ((k >= nw) | (wa == wb))
        return eq

    def equals_literal(self, value) -> torch.Tensor:
        """Exact per-row equality against one host literal."""
        b = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        lw = np.frombuffer(b + b"\0" * ((-len(b)) % 4), "<i4")
        eq = self.lengths == len(b)
        wcap = self.words.shape[0]
        estarts = self.eff_starts()
        for k, w in enumerate(lw):
            eq = eq & (self.words[(estarts + k).clamp(0, wcap - 1)]
                       == int(w))
        return eq

    def slice(self, start: int, stop: int) -> "VarBytes":
        n = self.nrows
        start = max(0, min(int(start), n))
        stop = max(start, min(int(stop), n))
        return self.take(torch.arange(start, stop, device=self.device))


def concat_varbytes(parts: Sequence[VarBytes]) -> VarBytes:
    """Concatenate into one packed-prefix buffer: each part's occupied
    prefix, starts shifted, padded to capacity."""
    total = sum(p.total_words for p in parts)
    cap = _capacity(max(total, 1))
    dev = parts[0].device
    bufs, starts, lens = [], [], []
    off = 0
    for p in parts:
        bufs.append(p.words[:p.total_words])
        starts.append(p.eff_starts() + off)
        lens.append(p.lengths)
        off += p.total_words
    if cap > total:
        bufs.append(torch.zeros(cap - total, dtype=torch.int32, device=dev))
    return VarBytes(torch.cat(bufs), torch.cat(starts).to(torch.int32),
                    torch.cat(lens), max(p.max_words for p in parts), total)


# ---------------------------------------------------------------------------
# whole-tensor internals
# ---------------------------------------------------------------------------


def _bswap32(w: torch.Tensor) -> torch.Tensor:
    """Byte-swapped int32 bits (compare the result unsigned)."""
    v = u32(w)
    return as_i32(((v & 0xFF) << 24) | ((v & 0xFF00) << 8)
                  | ((v >> 8) & 0xFF00) | (v >> 24))


def _mix(w: torch.Tensor, seed: int) -> torch.Tensor:
    """On int64 values in [0, 2^32)."""
    h = w ^ seed
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    return h ^ (h >> 13)


def _pow_vec(g: int, e: torch.Tensor, max_e: int) -> torch.Tensor:
    """g^e mod 2^32 elementwise (int64) by bit decomposition."""
    steps = max(int(max_e).bit_length(), 1)
    e = e.clamp(0, (1 << steps) - 1)
    out = torch.ones_like(e)
    acc = g
    for b in range(steps):
        out = torch.where(((e >> b) & 1) == 1, (out * acc) & M32, out)
        acc = (acc * acc) & M32
    return out


def _word_row_map(starts: torch.Tensor, nw: torch.Tensor, W: int):
    """(row, p) int64 for every word slot: the covering row and the
    slot's word offset in it. Needs strictly increasing starts over the
    non-empty rows. Empty rows scatter into spare slots of their own (one
    shared overflow slot would serialize the stores on the card) that are
    cut off."""
    n = starts.shape[0]
    dev = starts.device
    iota = torch.arange(n, device=dev)
    nz = nw > 0
    erank = torch.cumsum(nz.to(torch.int64), 0)
    nzrows = torch.zeros(2 * n, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(nz, erank - 1, n + iota), iota)[:n]
    mark = torch.zeros(W + n, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(nz, starts, W + iota), 1)[:W]
    ridx = torch.cumsum(mark, 0) - 1
    row = nzrows[ridx.clamp(0, max(n - 1, 0))]
    p = torch.arange(W, device=dev) - starts[row]
    return row, p


def _hash_rows(words: torch.Tensor, starts: torch.Tensor,
               lengths: torch.Tensor, max_words: int):
    """Three independent per-row 32-bit content hashes (int32 bits) by
    the prefix-sum range trick; ``starts`` are global word indices."""
    W = words.shape[0]
    n = starts.shape[0]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=words.device)
        return z, z, z
    starts = starts.to(torch.int64)
    nw = _nwords(lengths)
    _, p = _word_row_map(starts, nw, W)
    end = (starts + nw - 1).clamp(0, W - 1)
    prev = (starts - 1).clamp(0, W - 1)
    has = nw > 0
    wu = u32(words)
    lmix = (u32(lengths) * 0x9E3779B1) & M32
    out = []
    for g, seed in _SCHEMES:
        c = (_mix(wu, seed) * _pow_vec(g, p, max_words)) & M32
        P = torch.cumsum(c, 0)
        lo = torch.where(starts > 0, P[prev], 0)
        h = torch.where(has, (P[end] - lo) & M32, 0)
        h = h ^ lmix ^ seed
        h = h ^ (h >> 16)
        h = (h * 0x7FEB352D) & M32
        h = h ^ (h >> 15)
        h = (h * 0x846CA68B) & M32
        out.append(as_i32(h ^ (h >> 16)))
    return tuple(out)


def _take_program(words, starts, lengths, idx, cap_w: int):
    """The packed-layout varlen gather at word capacity ``cap_w``;
    ``starts`` are global word indices."""
    W_src = words.shape[0]
    safe = idx.clamp(min=0)
    hit = idx >= 0
    nw = torch.where(hit, _nwords(lengths)[safe], 0)
    lens = torch.where(hit, lengths[safe], 0)
    starts_out = torch.cumsum(nw, 0) - nw
    row, p = _word_row_map(starts_out, nw, cap_w)
    src_start = starts.to(torch.int64)[safe][row]
    w = words[(src_start + p).clamp(0, W_src - 1)]
    total = starts_out[-1] + nw[-1]
    valid = (torch.arange(cap_w, device=words.device) < total) \
        & (p < nw[row])
    return torch.where(valid, w, 0), starts_out.to(torch.int32), lens
