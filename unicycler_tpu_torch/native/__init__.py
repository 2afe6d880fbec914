"""Host C++ helpers, built on demand with g++ and bound via ctypes: the
serial banded traceback walk, minimiser sketching, windowed seed search
and LIS chaining that sit between the device kernels and Python, and the
port's own batched passes: the polish round's votes (votes.cpp) and the
minimiser lookup of a read set (seedmap.cpp). The other
sources are copies of unicycler_tpu/native/*.cpp; the library is built
into this directory (git-ignored) at first use."""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIB = None
_BUILD_FAILED = False

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(_SRC_DIR, 'libunicycler_tpu_torch_native.so')
_HASH_PATH = os.path.join(_SRC_DIR, '.build_hash')
_SOURCES = ['cigar_decode.cpp', 'lis.cpp', 'seedmap.cpp', 'seedsearch.cpp',
            'sketch.cpp', 'votes.cpp']


def _source_hash():
    h = hashlib.sha256()
    for s in _SOURCES:
        with open(os.path.join(_SRC_DIR, s), 'rb') as f:
            h.update(f.read())
    return h.hexdigest()


def _build(src_hash):
    # build to a private name and rename: concurrent test workers may
    # build at once, and a reader must never load a half-written library
    tmp = '%s.%d.tmp' % (_SO_PATH, os.getpid())
    cmd = (['g++', '-O3', '-std=c++17', '-fPIC', '-shared', '-o', tmp]
           + [os.path.join(_SRC_DIR, s) for s in _SOURCES])
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO_PATH)
    with open(_HASH_PATH + '.%d.tmp' % os.getpid(), 'w') as f:
        f.write(src_hash)
    os.replace(_HASH_PATH + '.%d.tmp' % os.getpid(), _HASH_PATH)


def get_lib():
    """The native library, built lazily from the checked-in sources.
    Staleness is decided by a content hash of the sources (mtimes are not
    preserved by git, so a fresh clone could otherwise load a stale or
    wrong-platform binary). Returns None if no toolchain is available
    (callers fall back to Python decoders)."""
    global _LIB, _BUILD_FAILED
    if _LIB is not None:
        return _LIB
    if _BUILD_FAILED:
        return None
    try:
        src_hash = _source_hash()
        built_hash = None
        if os.path.exists(_SO_PATH) and os.path.exists(_HASH_PATH):
            with open(_HASH_PATH) as f:
                built_hash = f.read().strip()
        if built_hash != src_hash:
            _build(src_hash)
        lib = ctypes.CDLL(_SO_PATH)
    except (OSError, subprocess.CalledProcessError):
        _BUILD_FAILED = True
        return None

    lib.decode_banded_traceback.restype = ctypes.c_int
    lib.decode_banded_traceback.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.decode_full_traceback.restype = ctypes.c_int
    lib.decode_full_traceback.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.lis_indices.restype = ctypes.c_int64
    lib.lis_indices.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_void_p]
    lib.window_ranges_u64.restype = None
    lib.window_ranges_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int]
    lib.window_ranges_bounded.restype = None
    lib.window_ranges_bounded.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.sketch_minimizers.restype = ctypes.c_int64
    lib.sketch_minimizers.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.left_align_batch.restype = ctypes.c_int64
    lib.left_align_batch.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 13
    lib.vote_batch.restype = ctypes.c_int64
    lib.vote_batch.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 19
    lib.seedmap_build_table.restype = None
    lib.seedmap_build_table.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.seedmap_lookup.restype = ctypes.c_void_p
    lib.seedmap_lookup.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_int]
        + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
           ctypes.c_int, ctypes.c_void_p])
    lib.seedmap_fetch.restype = None
    lib.seedmap_fetch.argtypes = [ctypes.c_void_p] * 4
    _LIB = lib
    return _LIB


_OP_NAMES = {0: 'M', 1: 'I', 2: 'D'}

# Sentinel returned when a traceback walk leaves the band (corrupt path).
# Callers emit a zero-score degenerate alignment rather than keeping the
# forward score with an empty CIGAR (which would rank candidates on no
# path evidence).
BAND_ESCAPE = ('BAND_ESCAPE',)


def native_decode_banded(moves, c, end_i, end_j, free_start_s1,
                         free_start_s2):
    """Native banded traceback over nibble-plane packed moves
    ((n_rows, W/8) int32). Returns (cigar, start_i, start_j) or None if
    the native library is unavailable or the walk failed."""
    lib = get_lib()
    if lib is None:
        return None
    moves = np.ascontiguousarray(moves, dtype=np.int32)
    c = np.ascontiguousarray(c, dtype=np.int32)
    n_rows, w8 = moves.shape
    W = w8 * 8
    # A banded CIGAR can hold up to ~2 runs per row (an M/I entry plus a
    # D run), so size for that; undersizing silently sent every
    # high-indel alignment through the slow Python fallback (-2 path).
    max_ops = 2 * n_rows + 16
    out = np.empty(2 * max_ops, np.int32)
    si = ctypes.c_int32()
    sj = ctypes.c_int32()
    n = lib.decode_banded_traceback(
        moves.ctypes.data, c.ctypes.data, n_rows, W, int(end_i), int(end_j),
        int(free_start_s1), int(free_start_s2),
        out.ctypes.data, max_ops, ctypes.byref(si), ctypes.byref(sj))
    if n == -1:
        # Walk left the band (corrupt path) — signal band escape so the
        # caller emits a zero-score degenerate result, matching the tape
        # path's retry semantics.
        return BAND_ESCAPE
    if n < 0:
        return None
    cigar = [(int(out[2 * k]), _OP_NAMES[int(out[2 * k + 1])])
             for k in range(n - 1, -1, -1)]
    return (cigar, int(si.value), int(sj.value))


_N_SEARCH_THREADS = min(8, os.cpu_count() or 1)


def native_window_ranges(ck, qck, lo_add, hi_add):
    """Parallel (lo, hi) index ranges of each query k-mer's occurrences
    within a reference window, over the sorted composite index `ck`
    ((kmer << 32 | pos) uint64). Equivalent to two np.searchsorted calls;
    returns None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ck = np.ascontiguousarray(ck, dtype=np.uint64)
    qck = np.ascontiguousarray(qck, dtype=np.uint64)
    m = len(qck)
    lo = np.empty(m, np.int64)
    hi = np.empty(m, np.int64)
    lib.window_ranges_u64(ck.ctypes.data, len(ck), qck.ctypes.data, m,
                          int(lo_add), int(hi_add),
                          lo.ctypes.data, hi.ctypes.data,
                          _N_SEARCH_THREADS)
    return lo, hi


def native_window_ranges_bounded(ck, lo0, hi0, qck, lo_add, hi_add):
    """window_ranges within precomputed per-query occurrence bounds
    [lo0, hi0) — the cached-base-ranges fast path of
    collect_common_kmers. Returns None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ck = np.ascontiguousarray(ck, dtype=np.uint64)
    qck = np.ascontiguousarray(qck, dtype=np.uint64)
    lo0 = np.ascontiguousarray(lo0, dtype=np.int64)
    hi0 = np.ascontiguousarray(hi0, dtype=np.int64)
    m = len(qck)
    lo = np.empty(m, np.int64)
    hi = np.empty(m, np.int64)
    lib.window_ranges_bounded(ck.ctypes.data, lo0.ctypes.data,
                              hi0.ctypes.data, m,
                              int(lo_add), int(hi_add), qck.ctypes.data,
                              lo.ctypes.data, hi.ctypes.data,
                              _N_SEARCH_THREADS)
    return lo, hi


def native_sketch(codes, k, w):
    """Native (w,k)-minimiser sketch; returns (hashes uint64, pos int32,
    strand int8) or None if the library is unavailable or k >= 32.
    Semantics are pinned against ops/minimizer.sketch by
    tests/test_native_seed.py (fuzz) and tests/test_minimizer_batch.py."""
    lib = get_lib()
    if lib is None or k >= 32:
        # sketch.cpp's 2-bit rolling representation holds k bases in one
        # uint64 only for k <= 31; its revcomp shift is UB at k >= 32.
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n = len(codes)
    cap = max(1, n)
    out_hash = np.empty(cap, np.uint64)
    out_pos = np.empty(cap, np.int32)
    out_strand = np.empty(cap, np.int8)
    m = lib.sketch_minimizers(codes.ctypes.data, n, int(k), int(w),
                              out_hash.ctypes.data, out_pos.ctypes.data,
                              out_strand.ctypes.data)
    return out_hash[:m], out_pos[:m], out_strand[:m]


def native_seed_table(hashes):
    """The probe table of a sorted minimiser hash array: (table, bits),
    2 << bits uint64 words holding each distinct hash with the start and
    count of its run (exactly searchsorted's left and right bounds), at
    most half full. None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    n = len(hashes)
    if n >= 1 << 32:
        return None     # a run's start and count are held in 32 bits
    distinct = 1 + int(np.count_nonzero(hashes[1:] != hashes[:-1])) \
        if n else 0
    bits = max(1, (2 * distinct - 1).bit_length())
    table = np.empty(2 << bits, np.uint64)
    lib.seedmap_build_table(hashes.ctypes.data, n, table.ctypes.data, bits)
    return table, bits


def native_seedmap(joined, offsets, lengths, probe, k, w, radius,
                   min_hits):
    """Minimiser lookup of every read in one native pass (seedmap.cpp).
    `joined` holds the reads' int8 codes at `offsets` for `lengths`;
    `probe` is (table, bits, ref_ids int32, positions int32, strands
    int8) of the index. Returns (records (n, 9) int64: read index, ref
    id, reverse, read start, read end, ref start, ref end, hits, anchor
    offset; anchors_read int32; anchors_ref int32), or None if the
    library is unavailable or k >= 32."""
    lib = get_lib()
    if lib is None or k >= 32:
        return None
    table, bits, ref_ids, positions, strands = probe
    joined = np.ascontiguousarray(joined, dtype=np.int8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    counts = np.zeros(2, np.int64)
    handle = lib.seedmap_lookup(
        joined.ctypes.data, offsets.ctypes.data, lengths.ctypes.data,
        len(lengths), table.ctypes.data, int(bits), ref_ids.ctypes.data,
        positions.ctypes.data, strands.ctypes.data, int(k), int(w),
        int(radius), int(min_hits), _N_SEARCH_THREADS, counts.ctypes.data)
    try:
        out = (np.empty((int(counts[0]), 9), np.int64),
               np.empty(int(counts[1]), np.int32),
               np.empty(int(counts[1]), np.int32))
    except MemoryError:
        lib.seedmap_fetch(handle, None, None, None)     # only frees it
        raise
    lib.seedmap_fetch(handle, *(a.ctypes.data for a in out))
    return out


def native_lis(values):
    """Native longest-nondecreasing-subsequence indices, or None if the
    library is unavailable (callers fall back to the Python walk)."""
    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.int64)
    out = np.empty(len(values), np.int64)
    n = lib.lis_indices(values.ctypes.data, len(values), out.ctypes.data)
    return out[:n]


def native_decode_full(moves, end_i, end_j, free_start_s1, free_start_s2):
    """Native full-matrix traceback. Returns (cigar, start_i, start_j) or
    None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    moves = np.ascontiguousarray(moves, dtype=np.uint8)
    n_rows, m1 = moves.shape
    max_ops = n_rows + m1 + 16
    out = np.empty(2 * max_ops, np.int32)
    si = ctypes.c_int32()
    sj = ctypes.c_int32()
    n = lib.decode_full_traceback(
        moves.ctypes.data, n_rows, m1, int(end_i), int(end_j),
        int(free_start_s1), int(free_start_s2),
        out.ctypes.data, max_ops, ctypes.byref(si), ctypes.byref(sj))
    if n < 0:
        return None
    cigar = [(int(out[2 * k]), _OP_NAMES[int(out[2 * k + 1])])
             for k in range(n - 1, -1, -1)]
    return (cigar, int(si.value), int(sj.value))
