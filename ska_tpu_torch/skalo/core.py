"""C++ traversal core for `ska lo` (csrc/host/skalo_core.cpp); the port's
copy of ska_tpu/skalo/core.py.

Runs extremity detection, chain compaction and the bounded-depth bubble
DFS (reference src/skalo/{extremities,compaction,read_graph}.rs) over
flat edge arrays at native speed. Returns the kept paths as built_groups
of lazily built VariantInfo (entry iteration uses first-seen-as-source
discovery order, a fixed deterministic order).
"""

import ctypes
import logging
import time
from typing import Dict, Tuple

import numpy as np

from ..io.native import _lib as _host_lib
from .kmer_utils import LazySeq, decode_int
from .traverse import VariantInfo

log = logging.getLogger("ska_tpu_torch.skalo")

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    lib = _host_lib()
    if not hasattr(lib, "_skalo_bound"):
        lib.skalo_expand_run.restype = ctypes.c_void_p
        lib.skalo_expand_run.argtypes = [
            _u64p, _u64p, _u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.skalo_core_ks_fill.restype = None
        lib.skalo_core_ks_fill.argtypes = [ctypes.c_void_p, _u64p, _u64p, _u64p]
        for name in (
            "skalo_core_n_paths", "skalo_core_segs_len", "skalo_core_snps_len",
            "skalo_core_n_chains", "skalo_core_chain_codes_len",
            "skalo_core_n_edges", "skalo_core_ks_len", "skalo_core_ks_m",
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.skalo_core_fill_chains.restype = None
        lib.skalo_core_fill_chains.argtypes = [ctypes.c_void_p, _i64p, _u8p]
        lib.skalo_core_fill.restype = None
        lib.skalo_core_fill.argtypes = [
            ctypes.c_void_p,
            _u64p, _u64p, _u64p, _u64p,
            _i64p, _i64p, _i64p, _i32p, _i64p,
        ]
        lib.skalo_core_free.restype = None
        lib.skalo_core_free.argtypes = [ctypes.c_void_p]
        # bound eagerly: a stale library without these symbols must fail
        # loud here, not misdiagnose an OOM as "no entry node"
        lib.skalo_core_oom.restype = ctypes.c_int
        lib.skalo_core_oom.argtypes = []
        lib.skalo_core_narrow_limit.restype = ctypes.c_int64
        lib.skalo_core_narrow_limit.argtypes = []
        lib._skalo_bound = True
    return lib


class KmerSamplesArrays:
    """Sorted-array first-wins {full k-mer -> sample bitmask} map
    (kmer_samples semantics, input.rs:107-117) with dict-like access for
    indels.py and raw arrays for the C++ SNP stage."""

    def __init__(self, hi, lo, masks):
        # hi is None for the narrow export: len_kmer <= 31 keys fit 62
        # bits, so the high limb is all zeros and is never materialized
        self._hi = hi
        self.lo = lo
        self.masks = masks  # (G, M) uint64 limbs

    def hi_or_none(self):
        return self._hi

    def _find(self, key):
        h = (key >> 64) & 0xFFFFFFFFFFFFFFFF
        l = key & 0xFFFFFFFFFFFFFFFF
        if self._hi is None:
            if h:
                return -1
            i, j = 0, len(self.lo)
        else:
            i = np.searchsorted(self._hi, np.uint64(h), side="left")
            j = np.searchsorted(self._hi, np.uint64(h), side="right")
        k = i + np.searchsorted(self.lo[i:j], np.uint64(l))
        if (
            k < len(self.lo)
            and (h == 0 if self._hi is None else int(self._hi[k]) == h)
            and int(self.lo[k]) == l
        ):
            return int(k)
        return -1

    def __contains__(self, key):
        return self._find(key) >= 0

    def __getitem__(self, key):
        i = self._find(key)
        if i < 0:
            raise KeyError(key)
        m = 0
        for j in range(self.masks.shape[1] - 1, -1, -1):
            m = (m << 64) | int(self.masks[i, j])
        return m


class PathStore:
    """The traversal core's master buffers, addressed by path index: a
    path's sequence codes are entry(k_graph bases) + its segments' codes
    (seg >= 0: chain_codes[chain_off[seg]:chain_off[seg+1]]; seg < 0:
    the single code -(seg+1)) with the first segment element skipped
    (it duplicates the entry's last base); candidate SNPs are
    snps[soff[p] : soff[p+1]]. The C++ SNP stage (skalo_snps_run_paths)
    reads paths straight from them, and chain codes are stored once
    instead of once per path."""

    __slots__ = (
        "segs", "segs_off", "chain_off", "chain_codes",
        "ent_hi", "ent_lo", "snps", "soff",
    )

    def __init__(self, segs, segs_off, chain_off, chain_codes,
                 ent_hi, ent_lo, snps, soff):
        self.segs = segs
        self.segs_off = segs_off  # n+1, extended with len(segs)
        self.chain_off = chain_off
        self.chain_codes = chain_codes
        self.ent_hi = ent_hi
        self.ent_lo = ent_lo
        self.snps = snps
        self.soff = soff  # n+1, extended with len(snps)


class _Assembler:
    """Materializes VariantInfo objects on demand from the traversal
    core's master buffers (the SNP stage reads the buffers directly and
    never needs the objects)."""

    __slots__ = ("store", "plen", "k_graph", "head_cache")

    def __init__(self, store, plen, k_graph):
        self.store = store
        self.plen = plen
        self.k_graph = k_graph
        self.head_cache: Dict[int, str] = {}

    def make(self, i: int):
        st = self.store
        ent = (int(st.ent_hi[i]) << 64) | int(st.ent_lo[i])
        head = self.head_cache.get(ent)
        if head is None:
            head = decode_int(ent, self.k_graph)
            self.head_cache[ent] = head
        g0 = int(st.segs_off[i])
        g1 = int(st.segs_off[i + 1])
        s0 = int(st.soff[i])
        s1 = int(st.soff[i + 1])
        seq = LazySeq(head, parts=_SegParts(st, g0, g1), n=int(self.plen[i]))
        return VariantInfo(seq, st.snps[s0:s1].tolist(), idx=i)


class GroupPaths:
    """One variant group's paths as a lazy list of VariantInfo.

    Length queries (len, per-path sequence lengths, path indices for the
    bulk C++ SNP stage) create no object; iterating or popping
    materializes (and caches) the real list."""

    __slots__ = ("_asm", "indices", "_list")

    def __init__(self, asm, indices):
        self._asm = asm
        self.indices = indices  # np.int64 path rows, group append order
        self._list = None

    def __len__(self):
        return len(self._list) if self._list is not None else len(self.indices)

    @property
    def lengths(self):
        """Sequence length per path (len(head) + plen - 1), read by the
        indel split before any path is popped."""
        a = self._asm
        return (a.plen[self.indices] + a.k_graph - 1).tolist()

    @property
    def first_seq_len(self) -> int:
        if self._list is not None:
            return len(self._list[0].sequence)
        a = self._asm
        return int(a.plen[self.indices[0]]) + a.k_graph - 1

    def path_indices(self):
        """Master-buffer rows for the bulk SNP stage, in group order."""
        if self._list is not None:
            return [v.idx for v in self._list]
        return self.indices.tolist()

    def _materialize(self):
        if self._list is None:
            mk = self._asm.make
            self._list = [mk(int(i)) for i in self.indices]
        return self._list

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        if self._list is not None:
            return self._list[i]
        return self._asm.make(int(self.indices[i]))

    def pop(self, i):
        return self._materialize().pop(i)


_SINGLE_CODE = [np.array([c], np.uint8) for c in range(4)]


class _SegParts:
    """Lazy parts builder for LazySeq: materializes a path's code-part
    list from its segment descriptors only if the tail is read."""

    __slots__ = ("store", "s0", "s1")

    def __init__(self, store, s0, s1):
        self.store = store
        self.s0 = s0
        self.s1 = s1

    def __call__(self):
        st = self.store
        co = st.chain_off
        cc = st.chain_codes
        return [
            cc[co[s] : co[s + 1]] if s >= 0 else _SINGLE_CODE[-1 - s]
            for s in st.segs[self.s0 : self.s1].tolist()
        ]


def run_core(ska_array, config):
    """Graph + traversal via the C++ core (fused expansion: the array's
    keys and ascii variants go straight into skalo_expand_run, which
    does input.rs:18-125's expansion itself). Returns (len_kmer,
    sample_names, built_groups, kmer_samples, path_store)."""
    len_kmer = ska_array.k
    sample_names = list(ska_array.names)
    k_graph = len_kmer - 1

    keys = np.asarray(ska_array.keys, dtype=np.uint64)
    W = keys.shape[1]
    variants = np.ascontiguousarray(np.asarray(ska_array.variants), dtype=np.uint8)
    n, S = variants.shape
    klo = np.ascontiguousarray(keys[:, W - 1])
    khi = np.ascontiguousarray(keys[:, 0]) if W == 2 else None

    lib = _lib()
    _t0 = time.perf_counter()
    h = lib.skalo_expand_run(
        khi.ctypes.data_as(_u64p) if khi is not None else None,
        klo.ctypes.data_as(_u64p),
        variants.ctypes.data_as(_u8p),
        n, S, len_kmer, int(config.max_depth),
    )
    if not h:
        if lib.skalo_core_oom():
            # combinatorial bubble explosion (repeat-dense graph, high
            # max_depth): the kept-path buffers outgrew memory. The
            # reference's Vec growth aborts here; we fail recoverably.
            raise MemoryError(
                "ska lo: graph traversal exceeded available memory "
                "(try a smaller --max-depth or larger k)"
            )
        raise SystemExit(
            "Error: there is no entry node in this graph, hence no variant.\n"
        )
    try:
        log.info(
            "%d edges (graph walk: %.3fs)",
            lib.skalo_core_n_edges(h), time.perf_counter() - _t0,
        )
        _t0 = time.perf_counter()
        G = lib.skalo_core_ks_len(h)
        M = lib.skalo_core_ks_m(h)
        # narrow export: full k-mers fit 62 bits, the hi limb is all
        # zeros; the threshold comes from the C core so the two sides
        # cannot drift apart
        narrow_ks = len_kmer <= lib.skalo_core_narrow_limit()
        ks_hi = None if narrow_ks else np.empty(G, np.uint64)
        ks_lo = np.empty(G, np.uint64)
        ks_masks = np.empty((G, M), np.uint64)
        lib.skalo_core_ks_fill(
            h,
            ks_hi.ctypes.data_as(_u64p) if ks_hi is not None else None,
            ks_lo.ctypes.data_as(_u64p),
            ks_masks.ctypes.data_as(_u64p),
        )
        if lib.skalo_core_oom():
            raise MemoryError(
                "ska lo: kmer_samples export exceeded available memory"
            )
        kmer_samples = KmerSamplesArrays(ks_hi, ks_lo, ks_masks)
        log.info("kmer_samples export: %.3fs", time.perf_counter() - _t0)
        _t0 = time.perf_counter()
        n = lib.skalo_core_n_paths(h)
        nsegs = lib.skalo_core_segs_len(h)
        nsnps = lib.skalo_core_snps_len(h)
        nch = lib.skalo_core_n_chains(h)
        ncc = lib.skalo_core_chain_codes_len(h)
        ent_hi = np.empty(n, np.uint64)
        ent_lo = np.empty(n, np.uint64)
        ex_hi = np.empty(n, np.uint64)
        ex_lo = np.empty(n, np.uint64)
        plen = np.empty(n, np.int64)
        goff = np.empty(n, np.int64)
        soff = np.empty(n, np.int64)
        segs = np.empty(nsegs, np.int32)
        snps = np.empty(nsnps, np.int64)
        chain_off = np.empty(nch + 1, np.int64)
        chain_codes = np.empty(ncc, np.uint8)
        lib.skalo_core_fill(
            h,
            ent_hi.ctypes.data_as(_u64p), ent_lo.ctypes.data_as(_u64p),
            ex_hi.ctypes.data_as(_u64p), ex_lo.ctypes.data_as(_u64p),
            plen.ctypes.data_as(_i64p), goff.ctypes.data_as(_i64p),
            soff.ctypes.data_as(_i64p), segs.ctypes.data_as(_i32p),
            snps.ctypes.data_as(_i64p),
        )
        lib.skalo_core_fill_chains(
            h, chain_off.ctypes.data_as(_i64p),
            chain_codes.ctypes.data_as(_u8p),
        )
    finally:
        lib.skalo_core_free(h)
    log.info("C++ graph core: %.3fs", time.perf_counter() - _t0)

    _t0 = time.perf_counter()
    path_store = PathStore(
        segs,
        np.concatenate([goff, [nsegs]]).astype(np.int64),
        chain_off, chain_codes,
        ent_hi, ent_lo,
        snps,
        np.concatenate([soff, [nsnps]]).astype(np.int64),
    )
    # vectorized grouping by (entry, exit): lexsort with the path index
    # as minor key keeps members in append order, and groups enter the
    # dict in first-appearance order
    asm = _Assembler(path_store, plen, k_graph)
    built_groups: Dict[Tuple[int, int], GroupPaths] = {}
    if n:
        pidx = np.arange(n, dtype=np.int64)
        order = np.lexsort((pidx, ex_lo, ex_hi, ent_lo, ent_hi))
        eh, el = ent_hi[order], ent_lo[order]
        xh, xl = ex_hi[order], ex_lo[order]
        first = np.ones(n, bool)
        first[1:] = (
            (eh[1:] != eh[:-1]) | (el[1:] != el[:-1])
            | (xh[1:] != xh[:-1]) | (xl[1:] != xl[:-1])
        )
        starts = np.flatnonzero(first)
        counts = np.diff(np.concatenate([starts, [n]]))
        disc = np.argsort(order[starts], kind="stable")  # discovery order
        st_l = starts.tolist()
        cn_l = counts.tolist()
        for g in disc.tolist():
            st = st_l[g]
            ent = (int(eh[st]) << 64) | int(el[st])
            ex = (int(xh[st]) << 64) | int(xl[st])
            built_groups[(ent, ex)] = GroupPaths(
                asm, order[st : st + cn_l[g]]
            )
    log.info(
        "group assembly: %.3fs (%d paths)", time.perf_counter() - _t0, n
    )
    log.info("%d variant groups", len(built_groups))
    return len_kmer, sample_names, built_groups, kmer_samples, path_store
