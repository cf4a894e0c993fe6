"""In-memory JSON API (the port of ska_tpu/webapi.py): the equivalent of
the reference's WebAssembly front end (src/wasm/ + src/lib.rs:894-1446).

The reference ships a browser build exposing two wasm-bindgen structs:

- ``SkaData`` (lib.rs:926-1104): index a reference FASTA, map query
  samples against it, return per-chromosome pseudoalignment strings,
  variant count and coverage as JSON.
- ``AlignData`` (lib.rs:1126-1446): accumulate samples (FASTA or paired
  FASTQ, paired up by a file-name digit heuristic), produce the
  unfiltered reference-free alignment, a pairwise SNP distance matrix,
  and a canonical neighbor-joining tree in Newick form (the reference
  delegates NJ to the speedytree crate, ska_align.rs:104-110).

Here they are plain Python classes. ``SkaData`` maps over the port's
per-sample build (sample.build_sample: one device pass, every sort on
the radix kernel) and its RefSka (the reference scan and the lookup on
the device). ``AlignData`` builds on the cohort path of ``ska build``
(sample.build_samples_merged, then api.assemble's union) and takes its
SNP distances from ``ska distance``'s class Gram (distance.class_gram).
Inputs are file paths; outputs are the same JSON documents, byte for
byte, as the JAX package's. Both classes take ``device=`` (resolved by
torchinit.get_device: the card unless the caller asks for the CPU).

Each call runs in the span ``ska::call``. Inside it an align call runs
the build's spans (``ska::parse``, ``ska::stage``, ``ska::to_device``,
``ska::device_pass``, ``ska::to_host``), ``ska::union``, ``ska::gram``,
``ska::nj`` (neighbor joining) and ``ska::doc`` (the alignment's FASTA
and the JSON document).

Known divergence, by design (as in the JAX package): the reference's
>=3-fastq pairing loop (lib.rs:1309-1384) indexes its index list with
values popped *from* that list (``input_files[fastq_files[tmpind]]``
where ``tmpind`` is itself an element, not a position), which panics or
mispairs for most inputs; this implements the documented intent (greedy
pairing by the same-name digit-difference test). Newick branch-length
formatting follows Python float formatting, not speedytree's.
"""

import io
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from torch.profiler import record_function

from .api import assemble
from .constants import QUAL_NOFILTER
from .distance import class_gram
from .merge import merge_samples
from .ref import RefSka
from .sample import build_sample, build_samples_merged
from .sampletypes import QualOpts
from .torchinit import get_device

__all__ = ["SkaData", "AlignData", "neighbor_joining"]


# ---------------------------------------------------------------------------
# file-name helpers (lib.rs:1169-1183, 1233-1246)


def _file_kind(name: str) -> str:
    """'fastq' or 'fasta' by extension, peeling one trailing .gz
    (lib.rs:1169-1183)."""
    parts = name.split(".")
    ext = parts[-1] if parts else ""
    if ext == "gz" and len(parts) >= 2:
        ext = parts[-2]
    return "fastq" if ext in ("fq", "fastq") else "fasta"


def _same_pair(n1: str, n2: str) -> bool:
    """The reference's read-pair heuristic (lib.rs:1233-1246): equal-length
    names that differ at some position where both characters are one of
    '0'/'1'/'2'."""
    if len(n1) != len(n2):
        return False
    for a, b in zip(n1, n2):
        if a != b and a in "012" and b in "012":
            return True
    return False


def _clean_name(name: str) -> str:
    """Phylip/Newick display name (ska_align.rs:81-88): spaces to
    underscores, extension substrings removed."""
    return (
        name.replace(" ", "_")
        .replace(".fasta", "")
        .replace(".fa", "")
        .replace(".fastq", "")
        .replace(".fq", "")
    )


# ---------------------------------------------------------------------------
# canonical neighbor joining (replaces speedytree::NeighborJoiningSolver
# <Canonical>, ska_align.rs:104-110)


def _fmt_len(x: float) -> str:
    s = f"{x:.10g}"
    return "0" if s == "-0" else s


def neighbor_joining(dist: np.ndarray, names: Sequence[str]) -> str:
    """Canonical (Saitou-Nei) neighbor joining over a dense distance
    matrix; returns an unrooted Newick string terminating in the standard
    3-way root multifurcation. O(n^3), first-minimum tiebreak on the
    Q-matrix so the result is deterministic.
    """
    n = len(names)
    if n == 0:
        return ";"
    if n == 1:
        return f"{names[0]};"
    D = np.asarray(dist, dtype=np.float64).copy()
    if D.shape != (n, n):
        raise ValueError("distance matrix shape mismatch")
    nodes: List[str] = list(names)

    while len(nodes) > 3:
        m = len(nodes)
        r = D.sum(axis=1)
        # Q(i,j) = (m-2) d(i,j) - r_i - r_j, minimized over i<j
        Q = (m - 2) * D - r[:, None] - r[None, :]
        iu = np.triu_indices(m, 1)
        b = int(np.argmin(Q[iu]))
        i, j = int(iu[0][b]), int(iu[1][b])
        dij = D[i, j]
        li = 0.5 * dij + (r[i] - r[j]) / (2.0 * (m - 2))
        lj = dij - li
        merged = f"({nodes[i]}:{_fmt_len(li)},{nodes[j]}:{_fmt_len(lj)})"
        # distances from the new node u: d(u,k) = (d(i,k)+d(j,k)-d(i,j))/2
        du = 0.5 * (D[i, :] + D[j, :] - dij)
        keep = [x for x in range(m) if x not in (i, j)]
        D2 = np.empty((m - 1, m - 1), dtype=np.float64)
        D2[: m - 2, : m - 2] = D[np.ix_(keep, keep)]
        D2[: m - 2, m - 2] = du[keep]
        D2[m - 2, : m - 2] = du[keep]
        D2[m - 2, m - 2] = 0.0
        nodes = [nodes[x] for x in keep] + [merged]
        D = D2

    if len(nodes) == 2:
        return f"({nodes[0]}:{_fmt_len(D[0, 1])},{nodes[1]}:0);"
    la = 0.5 * (D[0, 1] + D[0, 2] - D[1, 2])
    lb = 0.5 * (D[0, 1] + D[1, 2] - D[0, 2])
    lc = 0.5 * (D[0, 2] + D[1, 2] - D[0, 1])
    return (
        f"({nodes[0]}:{_fmt_len(la)},{nodes[1]}:{_fmt_len(lb)},"
        f"{nodes[2]}:{_fmt_len(lc)});"
    )


# ---------------------------------------------------------------------------


def _check_width(k: int):
    """Width dispatch mirrors lib.rs:942-987: k<32 one limb, k<64 two.

    The reference panics for k >= 64 with the off-by-one message "k values
    larger than 64 not supported" (lib.rs:986); the boundary is kept
    (k == 64 rejected) but stated accurately. The build underneath
    enforces odd 5..=63, where the reference's SkaDict::new panics
    "Invalid k-mer length" (ska_dict.rs:342-344).
    """
    if not (k < 64):
        raise ValueError(f"k must be smaller than 64 (got {k})")


_NOFILTER_QUAL = QualOpts(min_count=1, min_qual=0, qual_filter=QUAL_NOFILTER)


class SkaData:
    """Interactive reference mapper (reference SkaData, lib.rs:926-1104).

    Indexes a reference FASTA once on ``device``, then maps any number of
    query samples (FASTA or FASTQ, optionally paired) against it,
    returning a JSON document per query.
    """

    def __init__(self, ref_file: str, k: int = 31, device=None):
        _check_width(k)
        self.k = k
        self.rc = True
        self.device = get_device(device)
        # rc=True, ambig_mask=False, repeat_mask=False fixed, lib.rs:946-948
        self.reference = RefSka(k, ref_file, True, False, False,
                                device=self.device)
        # bulk byte decode (latin-1 = 1:1 byte->char like chr)
        self.reference_string = [
            np.asarray(s, dtype=np.uint8).tobytes().decode("latin-1")
            for s in self.reference.seq
        ]
        self.n_maps = 0

    def map(
        self,
        input_file: str,
        rev_reads: Optional[str] = None,
        proportion_reads: Optional[float] = None,
    ) -> str:
        """Map one sample; returns the JSON document of lib.rs:1041-1098:
        per-chromosome mapped sequences, variant count, coverage. The
        call runs in the span ``ska::call``, the merge in ``ska::merge``."""
        with record_function("ska::call"):
            name = os.path.basename(input_file)
            # query dict with no count/quality filtering (ska_map.rs:47-51)
            sd = build_sample(
                name, self.k, (input_file, rev_reads), self.rc, _NOFILTER_QUAL,
                proportion_reads, device=self.device,
            )
            with record_function("ska::merge"):
                arr = merge_samples([sd])
            self.reference.map(arr)
            self.n_maps += 1
            whole = bytes(self.reference.pseudoalignment()[0]).decode()

            results = {}
            chunks = []
            cur = 0
            for chrom in self.reference_string:
                chunks.append(whole[cur : cur + len(chrom)])
                cur += len(chrom)
            results["Mapped sequences"] = chunks
            results["Number of variants"] = int(len(self.reference.mapped_pos))
            mapped = len(whole) - whole.count("-")
            results["Coverage"] = mapped / len(whole) if whole else 0.0
            return json.dumps(results)

    def get_reference(self) -> str:
        """Reference chromosomes joined by newlines (lib.rs:1100-1103)."""
        return "\n".join(self.reference_string)


# split k-mers both samples hold with different middle bases: the pairs
# of classes a != b, neither of them the gap '-' (class 0)
_CLASS = np.arange(16)
_DIFFERING = ((_CLASS[:, None] != _CLASS) & (_CLASS[:, None] > 0)
              & (_CLASS > 0)).astype(np.int64)


def snp_distances(variants: np.ndarray, device=None) -> np.ndarray:
    """The (n, n) int64 SNP distance matrix of ska_align.rs:90-98 over a
    merged (rows, n) variants matrix: for each pair of samples the rows
    where both hold a base and the letters differ. Letters are the
    IUPAC codes of 4-bit base sets, one class each, so that is the sum
    of the class Gram's G[i, a, j, b] over a != b, both not '-'."""
    n = variants.shape[1]
    G = class_gram(variants, device).reshape(n, 16, n, 16)
    return np.einsum("iajb,ab->ij", G, _DIFFERING)


class AlignData:
    """Interactive reference-free aligner + NJ tree (reference AlignData,
    lib.rs:1126-1446); its samples build on ``device``."""

    def __init__(self, k: int = 31, device=None):
        _check_width(k)
        self.k = k
        self.device = get_device(device)
        self.file_names: List[str] = []
        self._inputs: List[Tuple[str, str, Optional[str]]] = []
        # the merged build's batch results of the files built so far, their
        # input indices counted over all calls: the reference builds each
        # added file once and accumulates the dicts (lib.rs:1205-1384
        # get_queries), so repeated align() calls must not re-read and
        # re-build previously added samples
        self._batches: list = []
        self._n_built = 0

    def _add(self, f1: str, f2: Optional[str] = None):
        name = os.path.basename(f1)
        self.file_names.append(name)
        self._inputs.append((name, f1, f2))

    def align(
        self,
        input_files: Sequence[str],
        proportion_reads: Optional[float] = None,
    ) -> str:
        """Add files (pairing FASTQs by the digit heuristic), then return
        the JSON document of lib.rs:1397-1444: newick, names, alignment.
        The call runs in the span ``ska::call``."""
        with record_function("ska::call"):
            fastqs = [f for f in input_files
                      if _file_kind(os.path.basename(f)) == "fastq"]
            for f in input_files:
                if _file_kind(os.path.basename(f)) != "fastq":
                    self._add(f)

            # pair FASTQs greedily by the same-sample name test (intent of
            # lib.rs:1205-1384; see module docstring for the divergence note)
            remaining = list(fastqs)
            while remaining:
                f1 = remaining.pop(0)
                mate = None
                for cand in remaining:
                    if _same_pair(os.path.basename(f1), os.path.basename(cand)):
                        mate = cand
                        break
                if mate is not None:
                    remaining.remove(mate)
                    self._add(f1, mate)
                else:
                    self._add(f1)

            if len(self._inputs) <= 2:
                # lib.rs:1386-1400
                results = {}
                results["newick"] = "Not enough sequences to align"
                results["alignment"] = "Not enough sequences to align"
                results["names"] = list(self.file_names)
                return json.dumps(results)

            if self._n_built < len(self._inputs):
                # build only the files not built yet (proportion_reads
                # applies to them alone, as in the reference where each
                # align() call builds just the files it was handed)
                base = self._n_built
                batches = build_samples_merged(
                    self._inputs[base:], self.k, True, _NOFILTER_QUAL,
                    proportion_reads, device=self.device,
                )
                self._batches.extend(([base + i for i in idx], *rest)
                                     for idx, *rest in batches)
                self._n_built = len(self._inputs)
            arr = assemble(self._batches, self.k, True)
            dist = snp_distances(arr.variants, self.device)
            clean = [_clean_name(n) for n in self.file_names]
            with record_function("ska::nj"):
                newick = neighbor_joining(dist, clean)

            with record_function("ska::doc"):
                buf = io.BytesIO()
                arr.write_fasta(buf)  # unfiltered, lib.rs:1407-1421
                results = {}
                results["newick"] = newick
                results["names"] = list(self.file_names)
                results["alignment"] = buf.getvalue().decode()
                return json.dumps(results)

    def get_size(self) -> int:
        return len(self._inputs)
