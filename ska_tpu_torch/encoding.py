"""IUPAC base-set tables at the I/O boundary (the port's copy of the
tables of ska_tpu/encoding.py that its path uses).

Middle bases are carried on the device as 4-bit sets (bit A=1, C=2, T=4,
G=8, i.e. ``1 << code`` for the 2-bit code ``(ascii >> 1) & 3``) and
reduced with bitwise OR, which is exactly the reference's 1024-entry
IUPAC table (bit_encoding.rs:388-453). ASCII IUPAC letters appear only
at the host boundary: ``SET_TO_ASCII`` when the variants matrix leaves
the device, ``IS_AMBIGUOUS`` in the site filters.
"""

import numpy as np

# 16-entry set -> ASCII IUPAC (0 = missing '-')
_SET_ASCII = {
    0: ord("-"),
    1: ord("A"), 2: ord("C"), 4: ord("T"), 8: ord("G"),
    3: ord("M"), 5: ord("W"), 9: ord("R"),
    6: ord("Y"), 10: ord("S"), 12: ord("K"),
    7: ord("H"), 11: ord("V"), 13: ord("D"), 14: ord("B"),
    15: ord("N"),
}
SET_TO_ASCII = np.array([_SET_ASCII[i] for i in range(16)], dtype=np.uint8)

# True for anything not a/c/g/t/u/- (reference is_ambiguous, :58-61)
IS_AMBIGUOUS = np.ones(256, dtype=bool)
for _c in b"acgtuACGTU-":
    IS_AMBIGUOUS[_c] = False

