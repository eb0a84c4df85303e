"""The native host runtime (csrc/host/cylon_host.cpp) and its numpy
versions (counterpart of cylon_tpu.native).

The library is the engine's host half: row hashing and hash partition
for ingest placement, the multithreaded numeric CSV writer, Arrow
validity-bitmap pack and unpack, and the staging-buffer pool. It is built
at first use, never at import, with the host C++ compiler (``$CXX``, else
g++, c++ or clang++; ``-O3 -std=c++17 -shared -fPIC -pthread``) into
``cylon_tpu_torch/_build/libcylon_host-<hash>.so``, named by the hash of
the source and the flags, so an edited source rebuilds. Each process
compiles to a name of its own and renames the result into place, so
processes that build at once never load a half-written file. Bound with
ctypes (plain C ABI).

Placement computed here is bit-identical to the device's
``ops.hash.partition_targets``: varbytes keys hash their bytes exactly
as the device content hash h1 does (``np_varbytes_hash``), so a host
partition of string keys agrees with a device one.

Every entry point has a numpy version (``np_row_hash``,
``np_hash_partition``, ``np_pack_bitmap``, ``np_unpack_bitmap``; the CSV
writer's is pandas, in io/csv.py), which runs where no compiler exists
(``available()`` is False there) and is what the tests hold the library
against. Each call that the library serves adds one to ``CALLS[name]``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "host", "cylon_host.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# seconds this process spent compiling the library (0.0: loaded a build
# already in _build/), and the compiler's message of a failed build
BUILD_SECONDS: Optional[float] = None
BUILD_ERROR: Optional[str] = None

# calls served by the library since the last reset_calls()
CALLS: Dict[str, int] = {k: 0 for k in (
    "row_hash", "hash_partition", "pack_bitmap", "unpack_bitmap",
    "write_csv", "pool_alloc")}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


_NULL_TAG = np.uint32(0x9E3779B9)
# content-hash scheme 1 of data/strings.py
_VB_G1 = np.uint32(31)
_VB_S1 = np.uint32(0x2545F491)
_DTYPE_CODES = {np.dtype(np.int32): 0, np.dtype(np.int64): 1,
                np.dtype(np.float32): 2, np.dtype(np.float64): 3,
                np.dtype(np.uint32): 4, np.dtype(np.uint64): 5}
# dtypes the native CSV writer takes: callers check them before they
# fetch a table from the card
SUPPORTED_CSV_DTYPES = frozenset(_DTYPE_CODES)


def _compilers() -> List[str]:
    return [os.environ["CXX"]] if os.environ.get("CXX") else \
        ["g++", "c++", "clang++"]


def lib_path() -> str:
    """Where the library for this source, these flags and this compiler
    choice lives (or will)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(
            CXX_FLAGS + _compilers()).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libcylon_host-{digest}.so")


def _build(path: str) -> bool:
    """Compile the library to a name private to this process, then rename
    it into place. False when no compiler succeeds (BUILD_ERROR says
    why)."""
    global BUILD_SECONDS, BUILD_ERROR
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    errors = []
    t0 = time.perf_counter()
    for cxx in _compilers():
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                           capture_output=True, text=True, timeout=300)
            os.replace(tmp, path)
            BUILD_SECONDS = time.perf_counter() - t0
            return True
        except subprocess.CalledProcessError as e:
            errors.append(f"{cxx}: {e.stderr[-2000:]}")
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{cxx}: {e}")
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    BUILD_ERROR = "\n".join(errors)
    return False


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call of the process
    (None where it cannot be built)."""
    global _lib, _tried, BUILD_SECONDS, BUILD_ERROR
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if os.path.exists(path):
            BUILD_SECONDS = 0.0
        elif not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            BUILD_ERROR = str(e)
            return None
        P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.ct_version.restype = I32
        lib.ct_row_hash.argtypes = [ctypes.POINTER(P), ctypes.POINTER(I32),
                                    ctypes.POINTER(P), I32, I64, P, I32]
        lib.ct_partition_from_hash.argtypes = [P, I64, ctypes.c_uint32, P,
                                               P, I32]
        lib.ct_partition_order.argtypes = [P, I64, P, ctypes.c_uint32, P]
        lib.ct_pack_bitmap.argtypes = [P, I64, P]
        lib.ct_unpack_bitmap.argtypes = [P, I64, P]
        lib.ct_write_csv.restype = I64
        lib.ct_write_csv.argtypes = [
            ctypes.POINTER(P), ctypes.POINTER(I32), ctypes.POINTER(P), I32,
            I64, ctypes.POINTER(ctypes.c_char_p), ctypes.c_char,
            ctypes.c_char_p, I32]
        lib.ct_pool_alloc.restype = P
        lib.ct_pool_alloc.argtypes = [ctypes.c_size_t]
        lib.ct_pool_free.argtypes = [P, ctypes.c_size_t]
        lib.ct_pool_stats.argtypes = [P, P]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library loads (building it at the first call where a
    compiler exists)."""
    return _load() is not None


def _nthreads() -> int:
    return min(os.cpu_count() or 1, 16)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def np_ordered_bits(x: np.ndarray) -> np.ndarray:
    """Order-preserving unsigned bits of a host array (ops/order.py's
    ordered bits, as numpy unsigned values)."""
    x = np.asarray(x)
    dt = x.dtype
    if dt == np.bool_:
        return x.astype(np.uint32)
    if dt.kind == "u":
        return x
    if dt.kind in ("M", "m"):
        x = x.view(np.int64)
        dt = x.dtype
    u = np.dtype(f"u{dt.itemsize}")
    if dt.kind == "i":
        return x.view(u) ^ np.array(1 << (8 * dt.itemsize - 1), u)
    if dt.kind == "f":
        xz = np.ascontiguousarray(np.where(x == 0, np.zeros((), dt), x))
        bits = xz.view(u)
        sign = (bits >> (8 * dt.itemsize - 1)).astype(bool)
        allones = np.array(~np.uint64(0) >> np.uint64(64 - 8 * dt.itemsize),
                           u)
        signbit = np.array(np.uint64(1) << np.uint64(8 * dt.itemsize - 1), u)
        return np.where(sign, ~bits & allones, bits ^ signbit)
    raise TypeError(f"unorderable dtype {dt}")


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _fmix64(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(0xFF51AFD7ED558CCD)
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(0xC4CEB9FE1A85EC53)
    return h ^ (h >> np.uint64(33))


def np_varbytes_hash(values: Sequence) -> np.ndarray:
    """Per-row uint32 content hash of host str/bytes values: the numpy
    mirror of the device identity h1 (data/strings.py, scheme 1). None and
    NaN rows hash as empty; callers overlay the null tag."""
    enc: List[bytes] = []
    for v in values:
        if v is None or (isinstance(v, float) and v != v):
            enc.append(b"")
        elif isinstance(v, bytes):
            enc.append(v)
        else:
            enc.append(str(v).encode("utf-8"))
    n = len(enc)
    if n == 0:
        return np.zeros(0, np.uint32)
    lengths = np.fromiter((len(b) for b in enc), np.int64, n)
    nw = (lengths + 3) // 4
    starts = np.concatenate([[0], np.cumsum(nw)])
    total = int(starts[-1])
    buf = np.zeros(max(total, 1) * 4, np.uint8)
    if total:
        src = np.frombuffer(b"".join(enc), np.uint8)
        src_starts = np.concatenate([[0], np.cumsum(lengths)])[:-1]
        p = np.arange(int(lengths.sum())) - np.repeat(src_starts, lengths)
        buf[np.repeat(starts[:-1] * 4, lengths) + p] = src
    words = buf.view("<u4")
    with np.errstate(over="ignore"):  # uint32 wrap is the arithmetic
        h = words ^ _VB_S1
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        e = (np.arange(total, dtype=np.int64)
             - np.repeat(starts[:-1], nw)).astype(np.uint64)
        gp = np.ones(total, np.uint32)
        acc = np.full(1, _VB_G1)
        for b in range(max(int(nw.max()).bit_length(), 1)):
            gp = np.where((e >> np.uint64(b)) & np.uint64(1) == 1, gp * acc,
                          gp)
            acc = acc * acc
        P = np.cumsum(h[:total] * gp, dtype=np.uint32) if total \
            else np.zeros(0, np.uint32)
        end = np.clip(starts[1:] - 1, 0, max(total - 1, 0))
        prev = np.clip(starts[:-1] - 1, 0, max(total - 1, 0))
        hi = P[end] if total else np.zeros(n, np.uint32)
        lo = np.where(starts[:-1] > 0, P[prev] if total else np.uint32(0),
                      np.uint32(0))
        out = np.where(nw > 0, hi - lo, np.uint32(0)).astype(np.uint32)
        out = out ^ (lengths.astype(np.uint32) * np.uint32(0x9E3779B1)) \
            ^ _VB_S1
        out = out ^ (out >> np.uint32(16))
        out = out * np.uint32(0x7FEB352D)
        out = out ^ (out >> np.uint32(15))
        out = out * np.uint32(0x846CA68B)
        return out ^ (out >> np.uint32(16))


def _key_bits(cols, is_string) -> Tuple[List[np.ndarray], List[int]]:
    """Each key column's ordered bits, as contiguous uint32 or uint64, and
    its width in bytes: dictionary codes widen to uint32."""
    flags = is_string or [False] * len(cols)
    bits, widths = [], []
    for c, s in zip(cols, flags):
        b = np.asarray(c).astype(np.uint32) if s else np_ordered_bits(c)
        if b.dtype.itemsize == 8:
            bits.append(np.ascontiguousarray(b.view(np.uint64)))
            widths.append(8)
        else:
            bits.append(np.ascontiguousarray(b.astype(np.uint32, copy=False)))
            widths.append(4)
    return bits, widths


def np_row_hash(cols: Sequence[np.ndarray],
                valids: Sequence[Optional[np.ndarray]],
                is_string: Optional[Sequence[bool]] = None,
                prehashed: Optional[Sequence[bool]] = None) -> np.ndarray:
    """`row_hash` in numpy."""
    n = len(cols[0])
    pre = prehashed or [False] * len(cols)
    bits, widths = _key_bits(cols, is_string)
    h = np.zeros(n, np.uint32)
    with np.errstate(over="ignore"):
        for c, b, w, v, p in zip(cols, bits, widths, valids, pre):
            if p:
                hc = np.asarray(c, dtype=np.uint32)
            elif w == 8:
                m = _fmix64(b)
                hc = (m ^ (m >> np.uint64(32))).astype(np.uint32)
            else:
                hc = _fmix32(b)
            if v is not None:
                hc = np.where(np.asarray(v, dtype=bool), hc, _NULL_TAG)
            h = h * np.uint32(31) + hc
        return _fmix32(h)


def row_hash(cols: Sequence[np.ndarray],
             valids: Sequence[Optional[np.ndarray]],
             is_string: Optional[Sequence[bool]] = None,
             prehashed: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Combined per-row uint32 hash of host columns, the value
    ops/hash.hash_columns computes on the device. Dictionary strings pass
    their codes with ``is_string``; ``prehashed`` columns carry finalized
    uint32 row hashes (np_varbytes_hash) that enter the combine as they
    are, which the library cannot take: such keys hash in numpy."""
    n = len(cols[0])
    lib = _load()
    if lib is None or n == 0 or any(prehashed or ()):
        return np_row_hash(cols, valids, is_string, prehashed)
    bits, widths = _key_bits(cols, is_string)
    vmasks = [None if v is None else
              np.ascontiguousarray(np.asarray(v, dtype=np.uint8))
              for v in valids]
    nc = len(bits)
    out = np.empty(n, np.uint32)
    lib.ct_row_hash((ctypes.c_void_p * nc)(*[_ptr(b) for b in bits]),
                    (ctypes.c_int32 * nc)(*widths),
                    (ctypes.c_void_p * nc)(*[None if v is None else _ptr(v)
                                             for v in vmasks]),
                    nc, n, _ptr(out), _nthreads())
    CALLS["row_hash"] += 1
    return out


def np_hash_partition(cols: Sequence[np.ndarray],
                      valids: Sequence[Optional[np.ndarray]],
                      world: int, is_string: Optional[Sequence[bool]] = None,
                      prehashed: Optional[Sequence[bool]] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`hash_partition` in numpy."""
    h = np_row_hash(cols, valids, is_string, prehashed)
    targets = (h % np.uint32(world)).astype(np.int32)
    counts = np.bincount(targets, minlength=world).astype(np.int64)
    order = np.argsort(targets, kind="stable").astype(np.int64)
    return targets, counts, order


def hash_partition(cols: Sequence[np.ndarray],
                   valids: Sequence[Optional[np.ndarray]],
                   world: int, is_string: Optional[Sequence[bool]] = None,
                   prehashed: Optional[Sequence[bool]] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(targets int32 [n], counts int64 [world], order int64 [n]): the
    stable row permutation grouping rows by target, whose split at
    cumsum(counts) gives each target's rows."""
    n = len(cols[0])
    lib = _load()
    if lib is None or n == 0:
        return np_hash_partition(cols, valids, world, is_string, prehashed)
    h = row_hash(cols, valids, is_string, prehashed)
    targets = np.empty(n, np.int32)
    counts = np.zeros(world, np.int64)
    order = np.empty(n, np.int64)
    lib.ct_partition_from_hash(_ptr(h), n, world, _ptr(targets),
                               _ptr(counts), _nthreads())
    lib.ct_partition_order(_ptr(targets), n, _ptr(counts), world,
                           _ptr(order))
    CALLS["hash_partition"] += 1
    return targets, counts, order


def np_pack_bitmap(mask: np.ndarray) -> np.ndarray:
    """`pack_bitmap` in numpy."""
    return np.packbits(np.asarray(mask).astype(bool), bitorder="little")


def pack_bitmap(mask: np.ndarray) -> np.ndarray:
    """Byte mask -> Arrow LSB validity bitmap."""
    lib = _load()
    if lib is None:
        return np_pack_bitmap(mask)
    mask = np.ascontiguousarray(np.asarray(mask, dtype=np.uint8))
    bits = np.empty((len(mask) + 7) // 8, np.uint8)
    lib.ct_pack_bitmap(_ptr(mask), len(mask), _ptr(bits))
    CALLS["pack_bitmap"] += 1
    return bits


def np_unpack_bitmap(bits: np.ndarray, n: int) -> np.ndarray:
    """`unpack_bitmap` in numpy."""
    return np.unpackbits(np.asarray(bits, dtype=np.uint8), count=n,
                         bitorder="little").astype(bool)


def unpack_bitmap(bits: np.ndarray, n: int) -> np.ndarray:
    """Arrow LSB validity bitmap -> bool array of length n."""
    lib = _load()
    if lib is None:
        return np_unpack_bitmap(bits, n)
    bits = np.ascontiguousarray(np.asarray(bits, dtype=np.uint8))
    out = np.empty(n, np.uint8)
    lib.ct_unpack_bitmap(_ptr(bits), n, _ptr(out))
    CALLS["unpack_bitmap"] += 1
    return out.astype(bool)


def write_csv_numeric(cols: Sequence[np.ndarray],
                      valids: Sequence[Optional[np.ndarray]],
                      names: Sequence[str], path: str,
                      sep: str = ",") -> bool:
    """Write numeric columns as CSV with the library's multithreaded
    writer: the reference's bytes (``%d``/``%u`` integers, ``%.9g``
    float32, ``%.17g`` float64, NaN and null cells empty) except that an
    integral float ends in ``.0``, so it reads back as a float. False
    (the caller writes through pandas) where the library is missing, a
    dtype is not in SUPPORTED_CSV_DTYPES, the separator is not one ASCII
    byte, a name needs quoting, or the names do not match the
    columns."""
    lib = _load()
    if lib is None:
        return False
    if len(sep.encode("utf-8", "ignore")) != 1 or not sep.isascii():
        return False
    if any(sep in s or '"' in s or "\n" in s or "\r" in s for s in names):
        return False
    nc = len(cols)
    if len(names) != nc or len(valids) != nc:
        return False
    ccols = [np.ascontiguousarray(c) for c in cols]
    if any(c.dtype not in _DTYPE_CODES for c in ccols):
        return False
    vmasks = [None if v is None else
              np.ascontiguousarray(np.asarray(v, dtype=np.uint8))
              for v in valids]
    n = len(ccols[0]) if nc else 0
    r = lib.ct_write_csv(
        (ctypes.c_void_p * nc)(*[_ptr(c) for c in ccols]),
        (ctypes.c_int32 * nc)(*[_DTYPE_CODES[c.dtype] for c in ccols]),
        (ctypes.c_void_p * nc)(*[None if v is None else _ptr(v)
                                 for v in vmasks]),
        nc, n, (ctypes.c_char_p * nc)(*[x.encode("utf-8") for x in names]),
        sep.encode("ascii"), path.encode("utf-8"), _nthreads())
    CALLS["write_csv"] += 1
    return r >= 0


class _PooledArray(np.ndarray):
    """ndarray view over a pooled buffer; carries the pool address."""

    _ct_pool_addr: int = 0


class StagingPool:
    """Aligned host staging-buffer pool (the host-side MemoryPool analog,
    reference ctx/memory_pool.hpp:25-66): ``take(nbytes)`` returns a
    numpy uint8 view over a pooled 64-byte-aligned buffer, ``give``
    returns it for reuse. Without the library, ``take`` is np.empty."""

    def take(self, nbytes: int) -> Optional[np.ndarray]:
        lib = _load()
        if lib is None:
            return np.empty(nbytes, np.uint8)
        p = lib.ct_pool_alloc(ctypes.c_size_t(nbytes))
        if not p:
            return None
        CALLS["pool_alloc"] += 1
        buf = (ctypes.c_uint8 * nbytes).from_address(p)
        arr = np.frombuffer(buf, dtype=np.uint8).view(_PooledArray)
        arr._ct_pool_addr = p
        return arr

    def give(self, arr: np.ndarray) -> None:
        lib = _load()
        addr = getattr(arr, "_ct_pool_addr", 0)
        if lib is None or not addr:
            return
        lib.ct_pool_free(ctypes.c_void_p(addr), ctypes.c_size_t(arr.nbytes))

    def stats(self) -> Tuple[int, int]:
        """(bytes live, bytes free) over the process's pool."""
        lib = _load()
        if lib is None:
            return (0, 0)
        live, free = ctypes.c_int64(), ctypes.c_int64()
        lib.ct_pool_stats(ctypes.byref(live), ctypes.byref(free))
        return (live.value, free.value)
