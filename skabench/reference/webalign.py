"""Plain reference of the browser's reference-free aligner, ska.rust
v0.5.2's wasm ``AlignData`` (src/lib.rs:1126-1446), over a cohort of
FASTA assemblies: the JSON document that one ``align()`` call of all the
files returns, worked out again from the files.

- Each sample's split k-mers through ``build.sample`` (FASTA: no count
  or quality filter applies), merged into one array (``kmers.merge``):
  rows in key order, one IUPAC letter a sample, '-' where it lacks the
  split k-mer.
- The alignment, unfiltered (lib.rs:1407-1421): one FASTA record a
  sample in input order, named by the file's base name, its sequence
  the sample's column of letters on one line.
- The SNP distance of two samples (ska_align.rs:90-98): the rows where
  both hold a letter and the letters differ, counted by comparing the
  two columns directly.
- The tree: neighbour joining of that matrix (``neighbor_joining``), the
  leaves named by ``clean_name`` (ska_align.rs:81-88).
- The document: ``json.dumps`` of newick, names (the files' base
  names), alignment, in that order (lib.rs:1425-1444).

Nothing here imports the program under test or JAX.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import build
from . import kmers as R

_GAP = ord("-")


def clean_name(name: str) -> str:
    """A leaf's name (ska_align.rs:81-88): spaces become underscores and
    the substrings .fasta, .fa, .fastq and .fq go, in that order."""
    name = name.replace(" ", "_")
    for ext in (".fasta", ".fa", ".fastq", ".fq"):
        name = name.replace(ext, "")
    return name


def mismatches(variants: np.ndarray) -> np.ndarray:
    """(n, n) int64: for each pair of samples (columns of the (rows, n)
    letters), the rows where both hold a letter other than '-' and the
    two letters differ."""
    cols = np.ascontiguousarray(variants.T)
    held = cols != _GAP
    n = cols.shape[0]
    out = np.zeros((n, n), np.int64)

    def row(i):
        for j in range(i + 1, n):
            out[i, j] = out[j, i] = np.count_nonzero(
                held[i] & held[j] & (cols[i] != cols[j]))

    with ThreadPoolExecutor(8) as pool:  # numpy drops the GIL
        list(pool.map(row, range(n)))
    return out


def branch(x: float) -> str:
    """A branch length as Newick text: Python's "%.10g", a negative zero
    written as 0."""
    s = "%.10g" % x
    return "0" if s == "-0" else s


def neighbor_joining(dist, names) -> str:
    """Neighbour joining (Saitou and Nei 1987, Mol Biol Evol 4:406) of a
    symmetric distance matrix, as an unrooted Newick string. The rules:

    - nodes start as the leaves, in the order of names;
    - while more than three nodes remain (m of them): r(i) is the sum of
      d(i, k) over all nodes k, and Q(i, j) = (m - 2) d(i, j) - r(i) -
      r(j); the pair joined is the first minimum of Q over i < j, taken
      in row-major order (by i, then by j);
    - the branch to i is d(i, j) / 2 + (r(i) - r(j)) / (2 (m - 2)) long,
      the branch to j d(i, j) less the branch to i;
    - the joined node is "(i:<branch i>,j:<branch j>)", at distance
      (d(i, k) + d(j, k) - d(i, j)) / 2 from every other node k; i and j
      leave the list, the others keep their order, and the joined node
      goes last;
    - three nodes a, b, c end the tree as "(a:la,b:lb,c:lc);" with la =
      (d(a, b) + d(a, c) - d(b, c)) / 2, lb = (d(a, b) + d(b, c) - d(a,
      c)) / 2 and lc = (d(a, c) + d(b, c) - d(a, b)) / 2;
    - two nodes give "(a:d(a, b),b:0);", one "a;", none ";";
    - branch lengths are written by ``branch``.

    Distances are Python floats; with whole-number inputs every distance
    and row sum stays a multiple of a power of two, so they are exact
    and the tie-break does not depend on the order of the sums.
    """
    n = len(names)
    if n == 0:
        return ";"
    if n == 1:
        return f"{names[0]};"
    d = [[float(x) for x in row] for row in np.asarray(dist)]
    nodes = list(names)
    while len(nodes) > 3:
        m = len(nodes)
        r = [sum(row) for row in d]
        best = None
        for i in range(m):
            for j in range(i + 1, m):
                q = (m - 2) * d[i][j] - r[i] - r[j]
                if best is None or q < best[0]:
                    best = (q, i, j)
        _, i, j = best
        dij = d[i][j]
        li = dij / 2 + (r[i] - r[j]) / (2 * (m - 2))
        lj = dij - li
        joined = f"({nodes[i]}:{branch(li)},{nodes[j]}:{branch(lj)})"
        rest = [x for x in range(m) if x != i and x != j]
        du = [(d[i][x] + d[j][x] - dij) / 2 for x in rest]
        d = [[d[x][y] for y in rest] + [du[a]] for a, x in enumerate(rest)]
        d.append(du + [0.0])
        nodes = [nodes[x] for x in rest] + [joined]
    if len(nodes) == 2:
        return f"({nodes[0]}:{branch(d[0][1])},{nodes[1]}:0);"
    ab, ac, bc = d[0][1], d[0][2], d[1][2]
    return (f"({nodes[0]}:{branch((ab + ac - bc) / 2)},"
            f"{nodes[1]}:{branch((ab + bc - ac) / 2)},"
            f"{nodes[2]}:{branch((ac + bc - ab) / 2)});")


def document(names, variants: np.ndarray) -> str:
    """The JSON document of one align() call of the files names (base
    names, in input order) whose merged letters are variants."""
    cols = np.ascontiguousarray(variants.T)
    alignment = b"".join(b">" + name.encode() + b"\n" + col.tobytes() + b"\n"
                         for name, col in zip(names, cols))
    newick = neighbor_joining(mismatches(variants), [clean_name(x) for x in names])
    return json.dumps({"newick": newick, "names": list(names),
                       "alignment": alignment.decode()})


def expected(cfg: dict, inputs: dict) -> dict:
    """The document of align() of every cohort FASTA file in order, with
    the merged array's row and sample counts."""
    files = []
    for _, p1, p2 in inputs["samples"]:
        if p2 is not None:
            raise ValueError("the aligner's reference takes FASTA assemblies")
        files.append(p1)
    with ThreadPoolExecutor(min(8, len(files))) as pool:
        dicts = list(pool.map(lambda p: build.sample(cfg, p, None), files))
    _, variants, _ = R.merge(dicts)
    names = [os.path.basename(p) for p in files]
    return {"doc": document(names, variants), "rows": int(variants.shape[0]),
            "samples": len(files)}
