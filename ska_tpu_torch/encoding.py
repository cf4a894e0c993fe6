"""IUPAC base-set tables at the I/O boundary (the port's copy of the
tables of ska_tpu/encoding.py that its path uses).

Middle bases are carried on the device as 4-bit sets (bit A=1, C=2, T=4,
G=8, i.e. ``1 << code`` for the 2-bit code ``(ascii >> 1) & 3``) and
reduced with bitwise OR, which is exactly the reference's 1024-entry
IUPAC table (bit_encoding.rs:388-453). ASCII IUPAC letters appear only
at the host boundary: ``SET_TO_ASCII`` when the variants matrix leaves
the device, ``IS_AMBIGUOUS`` in the site filters, ``RC_IUPAC`` for the
reverse-strand hits of `ska map`, ``ASCII_TO_SET`` and ``BASE_PROB`` in
`ska distance`; ``LETTER_CODE`` decodes 2-bit codes for `ska nk
--full-info`.
"""

import numpy as np

LETTER_CODE = np.frombuffer(b"ACTG", dtype=np.uint8)  # 2-bit code -> ASCII

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

# ASCII -> 4-bit set (unknown chars -> 0)
ASCII_TO_SET = np.zeros(256, dtype=np.uint8)
for _s, _a in _SET_ASCII.items():
    if _s:
        ASCII_TO_SET[_a] = _s
        ASCII_TO_SET[_a | 0x20] = _s  # lowercase
ASCII_TO_SET[ord("U")] = 4  # U behaves as T
ASCII_TO_SET[ord("u")] = 4

# reverse complement of a 4-bit set: swap A<->T and C<->G bits
RC_SET = np.zeros(16, dtype=np.uint8)
for _s in range(16):
    RC_SET[_s] = (((_s & 1) << 2) | ((_s & 4) >> 2)
                  | ((_s & 2) << 2) | ((_s & 8) >> 2))

# ASCII IUPAC -> reverse complement ASCII, with '-' for anything unknown
# (reference RC_IUPAC, bit_encoding.rs:475-508); 'U'/'u' give 'A'
RC_IUPAC = np.full(256, ord("-"), dtype=np.uint8)
for _a in range(256):
    if ASCII_TO_SET[_a]:
        RC_IUPAC[_a] = SET_TO_ASCII[RC_SET[ASCII_TO_SET[_a]]]

# ASCII -> probability 4-vector [p(A), p(C), p(T), p(G)]
# (reference base_to_prob, bit_encoding.rs:65-85; '-' and N -> zeros)
BASE_PROB = np.zeros((256, 4), dtype=np.float64)
for _a in range(256):
    _s = int(ASCII_TO_SET[_a])
    if _s in (0, 15):
        continue
    _bits = [i for i in range(4) if _s & (1 << i)]
    BASE_PROB[_a, _bits] = 1.0 / len(_bits)
