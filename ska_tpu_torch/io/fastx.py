"""FASTA/FASTQ(.gz) parsing to flat numpy tensors (the port's copy of
ska_tpu/io/fastx.py).

Replaces needletail in the reference (src/ska_dict.rs:118-180). Records are
concatenated into a single uint8 tensor with one separator byte ('\\0',
an invalid base) between records, plus per-record boundary metadata, ready
for the device extraction kernel.
"""

import gzip
import re
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_SEP = 0  # separator byte; (0 & 0xF) == 0 != 14 is *valid* -> must handle explicitly


def _open(path):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def peek_format(path: str) -> str:
    """'fasta' or 'fastq' by peeking the first record, like needletail
    (reference src/ska_dict.rs:357-366 peeks the first record's format)."""
    with _open(path) as f:
        first = f.read(1)
        if first == b">":
            return "fasta"
        if first == b"@":
            return "fastq"
        raise ValueError(f"Invalid FASTA/Q record in {path}")


@dataclass
class FastxFile:
    """Parsed records from one file."""

    ids: List[str] = field(default_factory=list)
    seqs: List[bytes] = field(default_factory=list)
    quals: List[Optional[bytes]] = field(default_factory=list)
    is_fastq: bool = False


def read_fastx(path: str) -> FastxFile:
    fmt = peek_format(path)
    out = FastxFile(is_fastq=(fmt == "fastq"))
    with _open(path) as f:
        data = f.read()
    if fmt == "fasta":
        # split on '>' at line starts
        pos = data.find(b">")
        while pos != -1:
            hdr_end = data.find(b"\n", pos)
            if hdr_end == -1:
                break
            nxt = data.find(b"\n>", hdr_end)
            seq_end = len(data) if nxt == -1 else nxt + 1
            header = data[pos + 1 : hdr_end].decode().strip()
            seq = data[hdr_end + 1 : seq_end].replace(b"\n", b"").replace(b"\r", b"")
            out.ids.append(header)
            out.seqs.append(seq)
            out.quals.append(None)
            pos = -1 if nxt == -1 else nxt + 1
    else:
        lines = data.split(b"\n")
        i = 0
        n = len(lines)
        while i + 3 < n or (i + 3 == n and lines[i]):
            hdr = lines[i]
            if not hdr:
                break
            if not hdr.startswith(b"@"):
                raise ValueError(f"Invalid FASTQ record in {path}")
            seq = lines[i + 1].rstrip(b"\r")
            qual = lines[i + 3].rstrip(b"\r")
            out.ids.append(hdr[1:].decode().strip())
            out.seqs.append(seq)
            out.quals.append(qual)
            i += 4
    if not out.ids:
        raise ValueError(f"Invalid path/file: {path}")
    return out


@dataclass
class SeqBatch:
    """Flat concatenated representation of one sample's records.

    seq:      uint8[T] ASCII bases, records separated by one 0 byte
    qual:     uint8[T] PHRED+33 scores (0 where none)
    rec_id:   int32[T] record index per position
    rec_last: bool[T]  True at the final base of each record
    has_qual: whether quality scores are present
    """

    seq: np.ndarray
    qual: np.ndarray
    rec_last: np.ndarray
    has_qual: bool
    n_records: int

    def slice(self, a: int, end: int) -> "SeqBatch":
        """Positions [a, end) as a batch of their own, viewing this one's
        arrays; n_records counts the records that end inside it."""
        rec_last = self.rec_last[a:end]
        return SeqBatch(seq=self.seq[a:end], qual=self.qual[a:end],
                        rec_last=rec_last, has_qual=self.has_qual,
                        n_records=int(np.count_nonzero(rec_last)))


def build_batch(seqs, quals=None) -> SeqBatch:
    """Concatenate records with zero-byte separators into a SeqBatch.

    bytes.join + frombuffer instead of per-record numpy arrays: the old
    3-arrays-per-record loop cost ~30s at a million reads."""
    n = len(seqs)
    has_qual = quals is not None and any(q is not None for q in quals)
    seqs_b = [bytes(s) for s in seqs]
    seq = np.frombuffer(b"\x00".join(seqs_b), dtype=np.uint8)
    lengths = np.array([len(s) for s in seqs_b], dtype=np.int64)
    rec_last = np.zeros(len(seq), dtype=bool)
    if n:
        offs = np.concatenate([[0], np.cumsum(lengths[:-1] + 1)])
        ends = offs + lengths - 1
        rec_last[ends[lengths > 0]] = True
    if has_qual:
        # records WITHOUT quality in a mixed batch (e.g. a FASTA mate in
        # a FASTQ pair) fill with 0xFF — out of band for PHRED+33
        # (printable ASCII only) — which sample._qual_pass treats as
        # always-passing, matching the reference's `qual: None => true`
        # per-record rule (split_kmer.rs:66-71); a zero fill would fail
        # every quality check and silently drop the record's k-mers
        # under strict
        quals_b = [
            bytes(q) if q is not None else b"\xff" * len(s)
            for q, s in zip(quals, seqs_b)
        ]
        qual = np.frombuffer(b"\x00".join(quals_b), dtype=np.uint8)
    else:
        qual = np.zeros(len(seq), dtype=np.uint8)
    return SeqBatch(seq=seq, qual=qual, rec_last=rec_last, has_qual=has_qual, n_records=n)


# --- input lists / sample naming ----------------------------------------------

# reference io_utils.rs:31-46
_RE_PATH = re.compile(r"^.+/(.+)\.(?i:fa|fasta|fastq|fastq\.gz)$")
_RE_NAME = re.compile(r"^(.+)\.(?i:fa|fasta|fastq|fastq\.gz)$")


def read_input_fastas(seq_files):
    """(name, path, None) triples with extension-stripped names."""
    out = []
    for f in seq_files:
        m = _RE_PATH.match(f) or _RE_NAME.match(f)
        name = m.group(1) if m else f
        out.append((name, f, None))
    return out


def get_input_list(file_list=None, seq_files=None):
    """Parse -f file lists (name\\tseq1[\\tseq2]) or positional FASTA paths
    (reference io_utils.rs:116-146)."""
    if file_list is not None:
        out = []
        with open(file_list) as f:
            for line in f:
                fields = line.split()
                if not fields:
                    continue
                if len(fields) == 2:
                    out.append((fields[0], fields[1], None))
                elif len(fields) == 3:
                    out.append((fields[0], fields[1], fields[2]))
                else:
                    raise ValueError("Unable to parse line in file_list")
        return out
    return read_input_fastas(seq_files)


def write_fasta(name, seq_bytes, fh):
    """needletail-style FASTA record with Unix line ending (one line per seq)."""
    fh.write(b">" + name.encode() + b"\n")
    fh.write(bytes(seq_bytes) + b"\n")
