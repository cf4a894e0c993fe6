"""ctypes bindings of the port's host library (csrc/host/*.cpp, built by
kernels.build_host into build/ska_tpu_torch/libska_host.so).

The library is required: it is built at the first call that needs it,
and a failed build raises. Its functions are copies of the JAX
package's C++ host engine, so both packages read and write the same
.skf bytes and keep the same alignment rows.
"""

import ctypes

import numpy as np

from .. import kernels

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_LL = ctypes.c_longlong
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kernels.load_host()
        lib.ska_snappy_frame_decompress.restype = _LL
        lib.ska_snappy_frame_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, _u8p, ctypes.c_size_t]
        lib.ska_cbor_decode_uints.restype = _LL
        lib.ska_cbor_decode_uints.argtypes = [
            ctypes.c_char_p, _LL, _LL, _u64p, _u64p, ctypes.POINTER(_LL)]
        lib.ska_cbor_decode_u8.restype = _LL
        lib.ska_cbor_decode_u8.argtypes = [
            ctypes.c_char_p, _LL, _LL, _u8p, ctypes.POINTER(_LL)]
        lib.ska_merge_batches.restype = _LL
        lib.ska_merge_batches.argtypes = [
            _u64p, _i64p, _u8p, _i64p, _i64p, _LL, _LL,
            _u64p, _u8p, _i64p, _LL]
        lib.ska_filter_keep.restype = None
        lib.ska_filter_keep.argtypes = [
            _u8p, _LL, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, _LL,
            ctypes.c_int, ctypes.c_int, _u8p, _u8p]
        lib.ska_update_counts.restype = None
        lib.ska_update_counts.argtypes = [
            _u8p, _LL, ctypes.c_int, ctypes.c_int, _u8p, _i64p]
        lib.ska_host_save.restype = _LL
        lib.ska_host_save.argtypes = [
            ctypes.c_char_p, _u64p, _LL, ctypes.c_int, _u8p, _LL, _u64p,
            ctypes.c_char_p,  # NUL-separated names blob
            _LL, _LL, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p,  # version text
            _LL, _i64p]  # out: framing chunks, threads
        lib.ska_aln_write.restype = ctypes.c_int  # 0 ok, -2 allocation failure
        lib.ska_aln_write.argtypes = [
            _u8p, _i64p, ctypes.c_int64, _i32p, _i64p, _u8p, ctypes.c_int64,
            ctypes.c_int64, _u8p, ctypes.c_int, _i64p, ctypes.c_int64, _u8p]
        lib.ska_vcf_write.restype = ctypes.c_int64  # bytes, -1 no room, -2 allocation
        lib.ska_vcf_write.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, _u8p, _i64p, ctypes.c_int64,
            ctypes.c_char_p,  # NUL-separated contig names
            ctypes.c_int64, ctypes.c_int64, _u8p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        _LIB = lib
    return _LIB


def snappy_frame_decompress(data: bytes):
    """Whole-frame decode: sizes with a header-only pass, then CRC-checks
    and decompresses every chunk into one numpy buffer. Returns a
    read-only memoryview; raises ValueError on a malformed frame or a
    stored-checksum mismatch."""
    lib = _lib()
    total = lib.ska_snappy_frame_decompress(data, len(data), None, 0)
    if total < 0:
        raise ValueError("snappy: malformed frame - could not parse skf file")
    out = np.empty(int(total), dtype=np.uint8)
    got = lib.ska_snappy_frame_decompress(
        data, len(data), out.ctypes.data_as(_u8p), int(total))
    if got == -2:
        raise ValueError(
            "snappy: corrupt chunk (stored checksum mismatch) - "
            "could not parse skf file"
        )
    if got != total:
        raise ValueError("snappy: malformed frame - could not parse skf file")
    out.flags.writeable = False
    return memoryview(out)


def cbor_decode_uints(buf, pos: int, n: int):
    """Decode up to n CBOR uints/bignums starting at buf[pos].

    Returns (count, consumed_bytes, hi, lo): count < n means a non-uint
    item was hit and the caller decodes element-wise from there. hi is
    None when every decoded value fits u64 (the common case: k<=31
    keys, counts, variant bytes)."""
    lib = _lib()
    lo = np.empty(n, dtype=np.uint64)
    consumed = _LL(0)
    # zero-copy: base pointer + offset into the frame buffer
    base = np.frombuffer(buf, dtype=np.uint8)
    cnt = int(lib.ska_cbor_decode_uints(
        ctypes.c_char_p(base.ctypes.data + pos), len(buf) - pos, n, None,
        lo.ctypes.data_as(_u64p), ctypes.byref(consumed)))
    used = int(consumed.value)
    # stopped at a tag-2 bignum? re-enter from there with both limbs
    if cnt < n and pos + used < len(buf) and buf[pos + used] == 0xC2:
        hi = np.zeros(n, dtype=np.uint64)
        consumed2 = _LL(0)
        cnt += int(lib.ska_cbor_decode_uints(
            ctypes.c_char_p(base.ctypes.data + pos + used),
            len(buf) - pos - used, n - cnt,
            hi[cnt:].ctypes.data_as(_u64p), lo[cnt:].ctypes.data_as(_u64p),
            ctypes.byref(consumed2)))
        used += int(consumed2.value)
        return cnt, used, hi[:cnt], lo[:cnt]
    return cnt, used, None, lo[:cnt]


def cbor_decode_u8(buf, pos: int, n: int):
    """Decode up to n CBOR uints that all fit a byte into a uint8 array.
    Returns (count, consumed_bytes, out); count < n means some item was
    > 255 or not a uint, and the caller redoes the array with
    cbor_decode_uints."""
    out = np.empty(n, dtype=np.uint8)
    consumed = _LL(0)
    base = np.frombuffer(buf, dtype=np.uint8)
    cnt = int(_lib().ska_cbor_decode_u8(
        ctypes.c_char_p(base.ctypes.data + pos), len(buf) - pos, n,
        out.ctypes.data_as(_u8p), ctypes.byref(consumed)))
    return cnt, int(consumed.value), out


def merge_batches(keys_list, var_list):
    """B-way merge of per-batch (sorted keys (n_b, W), variants (n_b, S_b))
    into (union keys, variants, counts), csrc/host/merge_batches.cpp."""
    B = len(keys_list)
    W = keys_list[0].shape[1]
    keys_cat = np.ascontiguousarray(
        np.concatenate(keys_list, axis=0), dtype=np.uint64)
    n_off = np.zeros(B + 1, np.int64)
    v_off = np.zeros(B + 1, np.int64)
    col_off = np.zeros(B + 1, np.int64)
    flat = []
    for b in range(B):
        n_off[b + 1] = n_off[b] + len(keys_list[b])
        v_off[b + 1] = v_off[b] + var_list[b].size
        col_off[b + 1] = col_off[b] + var_list[b].shape[1]
        flat.append(np.ascontiguousarray(var_list[b], dtype=np.uint8).reshape(-1))
    var_cat = np.concatenate(flat) if flat else np.zeros(0, np.uint8)
    s_total = int(col_off[-1])
    cap = int(n_off[-1])
    out_keys = np.zeros((max(cap, 1), W), np.uint64)
    out_var = np.full((max(cap, 1), max(s_total, 1)), ord("-"), np.uint8)
    out_counts = np.zeros(max(cap, 1), np.int64)
    r = _lib().ska_merge_batches(
        keys_cat.ctypes.data_as(_u64p), n_off.ctypes.data_as(_i64p),
        var_cat.ctypes.data_as(_u8p), v_off.ctypes.data_as(_i64p),
        col_off.ctypes.data_as(_i64p), B, W,
        out_keys.ctypes.data_as(_u64p), out_var.ctypes.data_as(_u8p),
        out_counts.ctypes.data_as(_i64p), s_total)
    if r == -2:
        raise MemoryError("ska merge: union buffers exceeded available memory")
    return out_keys[:r], out_var[:r], out_counts[:r]


_FILTER_MODE = {"no-filter": 0, "no-const": 1, "no-ambig": 2,
                "no-ambig-or-const": 3}


def filter_keep(variants, counts, min_count, filter_type,
                ignore_const_gaps, is_ambig):
    """Single-pass site-filter keep mask (merge_ska_array.rs:289-402):
    keep[i] = counts[i] >= min_count and the filter_type predicate on
    row i. Returns a bool (n,) array; raises on an unknown filter."""
    mode = _FILTER_MODE.get(filter_type)
    if mode is None:
        raise ValueError(f"Unknown filter {filter_type}")
    var = np.ascontiguousarray(variants, dtype=np.uint8)
    n, S = var.shape
    c = np.ascontiguousarray(counts)
    if c.dtype == np.uint8:
        c_is64 = 0
    else:
        if c.dtype != np.int64:
            c = c.astype(np.int64)
        c_is64 = 1
    if c.shape[0] != n:
        raise ValueError("filter_keep: counts length mismatch")
    tab = np.ascontiguousarray(is_ambig, dtype=np.uint8)
    keep = np.empty(n, dtype=np.uint8)
    _lib().ska_filter_keep(
        var.ctypes.data_as(_u8p), n, S, c.ctypes.data_as(ctypes.c_void_p),
        c_is64, int(min_count), mode, 1 if ignore_const_gaps else 0,
        tab.ctypes.data_as(_u8p), keep.ctypes.data_as(_u8p))
    return keep.view(bool)


def update_counts(variants, drop_ambig, is_ambig):
    """Single-pass per-row non-missing recount
    (merge_ska_array.rs:139-163). Returns int64 (n,)."""
    var = np.ascontiguousarray(variants, dtype=np.uint8)
    n, S = var.shape
    tab = np.ascontiguousarray(is_ambig, dtype=np.uint8)
    out = np.empty(n, dtype=np.int64)
    _lib().ska_update_counts(
        var.ctypes.data_as(_u8p), n, S, 1 if drop_ambig else 0,
        tab.ctypes.data_as(_u8p), out.ctypes.data_as(_i64p))
    return out


def skf_save(path, keys, variants, counts, names, k, rc, ska_version):
    """The `.skf` writer (csrc/host/save.cpp ska_host_save): CBOR encode
    + snappy framing on SKA_THREADS threads. Returns (framing chunks,
    threads used, keys written as tag-2 bignums); raises when the writer
    declines."""
    keys_np = np.ascontiguousarray(keys, dtype=np.uint64)
    if keys_np.ndim == 1:
        keys_np = keys_np[:, None]
    n, W = keys_np.shape
    var = np.ascontiguousarray(variants, dtype=np.uint8)
    counts_np = np.ascontiguousarray(counts, dtype=np.uint64)
    if W not in (1, 2) or var.ndim != 2 or var.shape[0] != n \
            or counts_np.shape[0] != n:
        raise ValueError(
            f"skf save: keys {keys_np.shape}, variants {var.shape} and "
            f"counts {counts_np.shape} do not form one array")
    blob = b"\x00".join(str(nm).encode("utf-8") for nm in names)
    ver = str(ska_version).encode("utf-8")
    stats = np.zeros(3, dtype=np.int64)
    rcv = _lib().ska_host_save(
        path.encode(), keys_np.ctypes.data_as(_u64p), n, int(W),
        var.ctypes.data_as(_u8p), var.shape[1],
        counts_np.ctypes.data_as(_u64p), blob, len(blob), len(names),
        int(k), 1 if rc else 0, ver, len(ver), stats.ctypes.data_as(_i64p))
    if rcv != 0:
        raise OSError(f"skf save: could not write {path} (code {rcv})")
    return int(stats[0]), int(stats[1]), int(stats[2])


def aln_write(ref_concat, chrom_len, m_chrom, m_pos, bases, half,
              is_ambig_tbl, mask_ambig, repeat_coors):
    """One sample's pseudoalignment (the AlnWriter state machine,
    csrc/host/aln_write.cpp): a uint8 array as long as the reference.
    ctypes releases the GIL around the call, so samples may run in
    threads."""
    ref = np.ascontiguousarray(ref_concat, dtype=np.uint8)
    out = np.full(len(ref), ord("-"), dtype=np.uint8)
    chrom_len = np.ascontiguousarray(chrom_len, dtype=np.int64)
    m_chrom = np.ascontiguousarray(m_chrom, dtype=np.int32)
    m_pos = np.ascontiguousarray(m_pos, dtype=np.int64)
    bases = np.ascontiguousarray(bases, dtype=np.uint8)
    if not len(m_chrom) == len(m_pos) == len(bases):
        raise ValueError("aln_write: hit arrays differ in length")
    tab = np.ascontiguousarray(is_ambig_tbl, dtype=np.uint8)
    reps = np.ascontiguousarray(repeat_coors, dtype=np.int64)
    rc = _lib().ska_aln_write(
        ref.ctypes.data_as(_u8p), chrom_len.ctypes.data_as(_i64p),
        len(chrom_len), m_chrom.ctypes.data_as(_i32p),
        m_pos.ctypes.data_as(_i64p), bases.ctypes.data_as(_u8p), len(bases),
        half, tab.ctypes.data_as(_u8p), 1 if mask_ambig else 0,
        reps.ctypes.data_as(_i64p), len(reps), out.ctypes.data_as(_u8p))
    if rc == -2:
        raise MemoryError(
            "ska map: pseudoalignment buffers exceeded available memory")
    return out


VCF_BLOCK_BYTES = 64 << 20


def vcf_write(aln_mat, ref_concat, contig_start, contig_names,
              block_bytes=VCF_BLOCK_BYTES):
    """The VCF records of `ska map` (csrc/host/vcf_write.cpp): yields
    their text in blocks of whole records, at most block_bytes each (or
    one record, where a record is longer), so the whole VCF never sits
    in memory. aln_mat is the (samples, reference length) uint8
    pseudoalignment; contig_start each contig's first column in
    ref_concat."""
    aln = np.ascontiguousarray(aln_mat, dtype=np.uint8)
    ref = np.ascontiguousarray(ref_concat, dtype=np.uint8)
    starts = np.ascontiguousarray(contig_start, dtype=np.int64)
    if aln.ndim != 2 or aln.shape[1] != len(ref):
        raise ValueError(
            f"vcf_write: alignment {aln.shape} does not span the "
            f"reference's {len(ref)} bases")
    if len(starts) != len(contig_names):
        raise ValueError("vcf_write: contig starts and names differ in length")
    names = [str(nm).encode("utf-8") for nm in contig_names]
    if any(b"\x00" in nm for nm in names):
        raise ValueError("vcf_write: a contig name holds a NUL byte")
    blob = b"\x00".join(names)
    S, L = aln.shape
    # room for the longest record, as the writer bounds it
    cap = max(int(block_bytes), max(map(len, names), default=0) + 2 * S + 64)
    out = np.empty(cap, dtype=np.uint8)
    nxt = ctypes.c_int64(0)
    col = 0
    while col < L:
        n = _lib().ska_vcf_write(
            aln.ctypes.data_as(_u8p), S, L, ref.ctypes.data_as(_u8p),
            starts.ctypes.data_as(_i64p), len(names), blob, len(blob), col,
            out.ctypes.data_as(_u8p), cap, ctypes.byref(nxt))
        if n == -2:
            raise MemoryError("ska map: VCF buffers exceeded available memory")
        if n < 0:
            raise RuntimeError(f"vcf_write: no record fits at column {col}")
        col = nxt.value
        if n:
            yield str(out[:n], "utf-8")
