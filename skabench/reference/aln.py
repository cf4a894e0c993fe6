"""Plain reference of ``ska map -f aln``: the pseudoalignment of every
sample of a merged array against a reference (mapping.Reference), as the
FASTA text that upstream's alignment writer prints (ska_ref.rs:636-658):
one record a sample, in the array's sample order, named by the sample,
its sequence the reference's records joined end to end on one line."""

import numpy as np

from .mapping import Reference


def aln(ref: Reference, names, table, variants, control: bool = False) -> bytes:
    """The aln file of `ska map` of a merged array (keys table, (rows,
    samples) letters variants) against ref; the control looks keys up by
    their 32-bit fingerprint."""
    found, rows = ref.match(table, control)
    hits = variants[rows[found]]
    out = []
    for s, name in enumerate(names):
        seq = ref.alignment(found, np.ascontiguousarray(hits[:, s]))
        out.append(b">" + name.encode() + b"\n" + seq.tobytes() + b"\n")
    return b"".join(out)


def lines_differing(want: bytes, got: bytes) -> int:
    """Lines of got that differ from want, position by position, plus
    the lines one has beyond the other."""
    a, b = want.split(b"\n"), got.split(b"\n")
    return max(len(a), len(b)) - sum(x == y for x, y in zip(a, b))
