"""Reference indexing and `ska map` (the port of ska_tpu/ref.py).

Counterpart of reference src/ska_ref.rs: the reference's split k-mers
are listed in positional order (parallel numpy arrays), extracted on the
device by ops/extract.py, and mapping is one lookup of those keys in the
sample array's sorted keys (ops/keys.py::lower_bound, on a card the
lookup kernel csrc/lower_bound.cu) in place of the per-k-mer hashmap
lookups of RefSka::map (ska_ref.rs:508-533). Both writers are in the
host library: the pseudoalignment's AlnWriter (csrc/host/aln_write.cpp)
and the VCF's records (csrc/host/vcf_write.cpp), where the JAX package
loops in Python over the VCF's columns.

Each step runs in a ``torch.profiler.record_function`` span, as the
build's do: ``ska::parse``, ``ska::scan`` (the extraction dispatches),
``ska::lookup`` (the keys to the device, the lookup, the hits back),
``ska::gather`` (the hit rows of the variants matrix, on the host),
``ska::pseudoalign``, then ``ska::vcf`` (the VCF's records) or
``ska::aln`` (the pseudoalignment's FASTA records).

In a process group (parallel.use_distributed) the lookup is cut into
key ranges over the ranks (parallel/postbuild.py::distributed_lookup).
The JAX package's native reference scan and its host binary-search
lookup have no counterpart here: the port's CPU route is the same
device code on CPU tensors.
"""

import os
from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from .array import SkaArray
from .constants import check_k
from .encoding import IS_AMBIGUOUS, RC_IUPAC
from .io import fastx, native
from .ops import extract as X
from .ops import keys as KD
from .ops import npkeys as K
from .parallel import use_distributed
from .parallel.postbuild import distributed_lookup
from .sample import _bucket, _max_chunk_bases
from .torchinit import get_device


class RefSka:
    """Split k-mers of a reference FASTA, in positional order."""

    def __init__(self, k: int, filename: str, rc: bool, ambig_mask: bool,
                 repeat_mask: bool, device=None):
        check_k(k)
        self.k = k
        self.ambig_mask = ambig_mask
        self.device = get_device(device)
        with record_function("ska::parse"):
            ff = fastx.read_fastx(filename)
        if ff.is_fastq:
            raise ValueError("Cannot create reference from FASTQ files")
        # chromosome name = first whitespace token (ska_ref.rs:208-212)
        self.chrom_names = [i.split()[0] for i in ff.ids]
        self.seq = [np.frombuffer(s, dtype=np.uint8) for s in ff.seqs]

        W = K.width_for_k(k)
        h = (k - 1) // 2
        kmers, poss, chroms, rcs = [], [], [], []
        cap = _max_chunk_bases()

        def dispatch(seq_np, valid_np, rl_np, pos0):
            """One padded extraction of a (1, Lp) batch. pos0 = (starts,
            base_pos, cids): record start offsets in the flat array, each
            record's position-0 coordinate within its chromosome, and its
            chrom id, recovered per emitted window by searchsorted."""
            Lp = _bucket(len(seq_np) + k + 1)
            rows = []
            for a, dt in ((seq_np, np.uint8), (valid_np, bool), (rl_np, bool)):
                x = np.zeros((1, Lp), dt)
                x[0, : len(a)] = a
                rows.append(torch.from_numpy(x).to(self.device))
            res = X.extract_windows(*rows, k, rc, W)
            idx_t = torch.nonzero(res["emit"][0]).squeeze(1)
            idx = idx_t.cpu().numpy()
            starts, base_pos, cids = pos0
            r = np.searchsorted(starts, idx, side="right") - 1
            kmers.append(KD.to_numpy_keys(res["key"][0][idx_t]))
            poss.append(idx.astype(np.int64) - starts[r] + base_pos[r] + h)
            chroms.append(cids[r].astype(np.int32))
            rcs.append(res["is_rc"][0][idx_t].cpu().numpy())

        # Small chromosomes batch into ONE flat multi-record dispatch
        # (records separated by 0 bytes, rec_last marking each record's
        # final base: the sample path's SeqBatch layout). Oversized
        # chromosomes extract in k-1-overlap slices. Dispatches run in
        # chromosome order, so the positional arrays concatenate already
        # (chrom, pos)-sorted.
        flat_parts = []  # (chrom_id, np.uint8 sequence)
        flat_bases = 0

        def flush_flat():
            nonlocal flat_bases
            if not flat_parts:
                return
            seq_np = np.frombuffer(
                b"\x00".join(bytes(s) for _, s in flat_parts), dtype=np.uint8
            )
            starts, cids = [], []
            cur = 0
            rl = np.zeros(len(seq_np), bool)
            for ci2, s2 in flat_parts:
                starts.append(cur)
                cids.append(ci2)
                if len(s2):
                    rl[cur + len(s2) - 1] = True
                cur += len(s2) + 1
            valid = ((seq_np & 0xF) != 14) & (seq_np != 0)
            dispatch(
                seq_np, valid, rl,
                (np.asarray(starts, np.int64),
                 np.zeros(len(starts), np.int64),
                 np.asarray(cids, np.int64)),
            )
            flat_parts.clear()
            flat_bases = 0

        with record_function("ska::scan"):
            for ci, s in enumerate(self.seq):
                L = len(s)
                if L + k + 1 <= cap:
                    if flat_parts and flat_bases + L + 1 + k + 1 > cap:
                        flush_flat()
                    flat_parts.append((ci, s))
                    flat_bases += L + 1
                    continue
                flush_flat()
                # slice [a, b+k-1) owns exactly the window starts in
                # [a, b), so positions concatenate without loss or
                # duplication
                step = min(L + 1, max(cap - (k - 1), 1))
                a = 0
                while a < L:
                    b = min(a + step, L)
                    # the chromosome-final window's emission consults the
                    # previous base (roll-only rule); never start a slice
                    # exactly on it
                    if b == L - k and b > 0 and (s[b - 1] & 0xF) != 14:
                        b += 1
                    end = min(b + k - 1, L)
                    n = end - a
                    seq = s[a:end]
                    valid = ((seq & 0xF) != 14) & (seq != 0)
                    rec_last = np.zeros(n, bool)
                    if end == L and L:
                        rec_last[n - 1] = True
                    dispatch(
                        seq, valid, rec_last,
                        (np.zeros(1, np.int64),
                         np.asarray([a], np.int64),
                         np.asarray([ci], np.int64)),
                    )
                    a = b
            flush_flat()

        self.kmers = np.concatenate(kmers) if kmers else np.zeros((0, W), np.uint64)
        self.pos = np.concatenate(poss) if poss else np.zeros(0, np.int64)
        self.chrom = np.concatenate(chroms) if chroms else np.zeros(0, np.int32)
        self.krc = np.concatenate(rcs) if rcs else np.zeros(0, bool)
        if self.kmers.shape[0] == 0:
            raise ValueError(f"{filename} has no valid sequence")
        self._repeat_spans(repeat_mask, W, h)

    def _repeat_spans(self, repeat_mask, W, h):
        # repeat spans (ska_ref.rs:261-298)
        self.repeat_coors = np.zeros(0, np.int64)
        if repeat_mask:
            from .array import _combine128

            flat = self.kmers[:, 0] if W == 1 else _combine128(self.kmers)
            _, inv, counts = np.unique(flat, return_inverse=True, return_counts=True)
            rep_idx = np.nonzero(counts[inv] > 1)[0]
            if len(rep_idx):
                # chrom_offset quirk (ska_ref.rs:268-271): the offset grows
                # by len(seq[last_chrom]) only at each chrom TRANSITION in
                # k-mer order, so chromosomes contributing no k-mers are
                # skipped in the sum; reproduced, not fixed
                present = np.unique(self.chrom).tolist()
                chain = present if present[0] == 0 else [0] + present
                offmap = np.zeros(len(self.seq), dtype=np.int64)
                acc = 0
                for j in range(1, len(chain)):
                    acc += len(self.seq[chain[j - 1]])
                    offmap[chain[j]] = acc
                # vectorized interval union: global positions ascend, so
                # the running last_end is the previous span's end; each
                # span [pos-h, pos+h] starts after it (a span at 0 stays
                # whole), expanded by a repeat + ragged arange
                gpos = self.pos[rep_idx] + offmap[self.chrom[rep_idx]]
                start = gpos - h
                end = gpos + h
                prev_end = np.concatenate([[0], end[:-1]])
                eff = np.where((start > prev_end) | (start == 0), start, prev_end + 1)
                cnt = end - eff + 1
                ends_c = np.cumsum(cnt)
                flat = np.arange(int(ends_c[-1]), dtype=np.int64)
                flat -= np.repeat(ends_c - cnt, cnt)
                self.repeat_coors = np.repeat(eff, cnt) + flat

        # mapping results
        self.mapped_pos = None  # (chrom, pos) int arrays
        self.mapped_variants = None  # (n_hits, n_samples) uint8
        self.mapped_names: List[str] = []

    @property
    def ksize(self) -> int:
        return self.kmers.shape[0]

    def map(self, arr: SkaArray):
        """Look the reference's split k-mers up in the array's sorted
        keys on the device (replaces ska_ref.rs:508-533): lower bounds,
        clipped, a hit where the key there is equal; hit rows gather
        their variants on the host, reverse-strand hits through
        RC_IUPAC."""
        if self.k != arr.k:
            raise ValueError(f"K-mer sizes do not match ref:{self.k} skf:{arr.k}")
        self.mapped_names = list(arr.names)

        if arr.ksize == 0:
            # an all-weeded .skf maps nothing; the writers then report
            # the reference's "No split k-mers mapped to reference"
            # (ska_ref.rs:557,674)
            self.mapped_variants = np.zeros((0, len(arr.names)), np.uint8)
            self.mapped_chrom = self.chrom[:0]
            self.mapped_pos = self.pos[:0]
            return

        with record_function("ska::lookup"):
            sorted_keys, perm = arr.sorted_view()
            if use_distributed(self.device):
                # the keys cut into key ranges over the process group
                # (parallel/postbuild.py); every rank gets every row
                found, rows_idx = distributed_lookup(sorted_keys, self.kmers,
                                                     self.device)
                hit = np.flatnonzero(found)
                cidx = rows_idx[hit]
            else:
                table = KD.from_numpy_keys(sorted_keys, self.device)
                queries = KD.from_numpy_keys(self.kmers, self.device)
                idx = KD.lower_bound(table, queries).clamp_(0, arr.ksize - 1)
                found = KD.equal(table[idx], queries)
                hit_t = torch.nonzero(found).squeeze(1)
                hit = hit_t.cpu().numpy()
                cidx = idx[hit_t].cpu().numpy()
        with record_function("ska::gather"):
            rows = arr.variants[cidx if perm is None else perm[cidx]]
            # reverse-strand hits translate through RC_IUPAC
            # (ska_ref.rs:520-526)
            rows = np.where(self.krc[hit][:, None], RC_IUPAC[rows], rows)
        self.mapped_variants = rows
        self.mapped_chrom = self.chrom[hit]
        self.mapped_pos = self.pos[hit]

    # ---- pseudoalignment (ska_ref/aln_writer.rs) ---------------------------

    def pseudoalignment(self) -> List[bytearray]:
        """One row per sample from the host library's AlnWriter; with
        SKA_THREADS > 1 the samples run in threads (ctypes drops the GIL
        around the call), in sample order, so the bytes do not depend on
        the thread count."""
        if self.mapped_variants is None or len(self.mapped_variants) == 0:
            raise ValueError("No split k-mers mapped to reference")
        ref_concat = np.concatenate(self.seq) if self.seq else np.zeros(0, np.uint8)
        chrom_len = np.array([len(s) for s in self.seq], dtype=np.int64)
        reps = np.array(self.repeat_coors, dtype=np.int64)
        h = (self.k - 1) // 2

        def one(i):
            return bytearray(native.aln_write(
                ref_concat, chrom_len, self.mapped_chrom, self.mapped_pos,
                self.mapped_variants[:, i], h, IS_AMBIGUOUS.view(np.uint8),
                self.ambig_mask, reps,
            ))

        n = self.mapped_variants.shape[1]
        threads = min(int(os.environ.get("SKA_THREADS", "1") or 1), n)
        with record_function("ska::pseudoalign"):
            if threads > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=threads) as ex:
                    return list(ex.map(one, range(n)))
            return [one(i) for i in range(n)]

    # ---- outputs (ska_ref.rs:636-658, 672-752) -----------------------------

    def write_aln(self, fh):
        alns = self.pseudoalignment()
        with record_function("ska::aln"):
            for name, seq in zip(self.mapped_names, alns):
                fastx.write_fasta(name, bytes(seq), fh)

    def write_vcf(self, fh):
        alns = self.pseudoalignment()
        aln_mat = np.array([np.frombuffer(bytes(a), dtype=np.uint8) for a in alns])

        w = fh.write
        w("##fileformat=VCFv4.4\n")
        for contig in self.chrom_names:
            w(f"##contig=<ID={contig}>\n")
        w("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t")
        w("\t".join(self.mapped_names) + "\n")

        with record_function("ska::vcf"):
            self._vcf_records(lambda text: _write_pieces(w, text), aln_mat)

    def _vcf_records(self, w, aln_mat):
        # a site is emitted iff any sample differs from the reference
        # base (ska_ref.rs:707-750); the host library writes the records
        # (csrc/host/vcf_write.cpp), one w() a block of them
        ref_concat = np.concatenate(self.seq) if self.seq else np.zeros(0, np.uint8)
        lens = np.array([len(s) for s in self.seq], dtype=np.int64)
        for text in native.vcf_write(aln_mat, ref_concat, np.cumsum(lens) - lens,
                                     self.chrom_names):
            w(text)


# A pipe takes a write of at most PIPE_BUF (4096) bytes whole or not at
# all. So a closed reader fails the next piece with BrokenPipeError
# (exit 141) even where stdout is unbuffered (PYTHONUNBUFFERED), whose
# text layer drops, unreported, what a partial write of a larger piece
# leaves.
_PIECE = 4096


def _write_pieces(w, text):
    for i in range(0, len(text), _PIECE):
        w(text[i:i + _PIECE])
