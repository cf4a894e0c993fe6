"""`ska cov`: k-mer count histogram + 2-component Poisson mixture fit
(the port's copy of ska_tpu/coverage.py).

Counterpart of reference src/coverage.rs: counting the split k-mers of a
FASTQ pair becomes the device sort/segment histogram
(ops.segment.count_histogram; chunked over the dispatch cap by
ops.pipeline.chunk_key_counts) instead of a hashmap
(coverage.rs:104-135); the 2-parameter MLE (w0 * Pois(1) + (1-w0) *
Pois(c), coverage.rs:176-220) is fit on the host with the same BFGS +
Armijo backtracking scheme on the analytic gradient
(coverage.rs:310-345), a copy of the JAX package's numpy code. The JAX
package's native host counting branch is not copied: the port counts on
its device path.
"""

import math
from typing import List

import numpy as np
import torch

from .constants import check_k
from .io import fastx
from .ops import extract as X
from .ops import keys as K
from .ops import pipeline as P
from .ops import segment as S
from .ops.npkeys import width_for_k
from .sample import (_bucket, _chunk_views, _max_chunk_bases, _stage_raw,
                     _valid_bases, key_totals)
from .torchinit import get_device

MAX_COUNT = 1000
MIN_FREQ = 50
INIT_W0 = 0.8
INIT_C = 20.0


def _hist_from_raw(seqs, rec_ends, k, rc, W):
    """Device masks + extraction + count histogram of one sample staged
    as a (1, L) row of raw sequence bytes (quality ignored,
    coverage.rs:102)."""
    valid, _, rec_last = P.device_masks(seqs, None, rec_ends, False, False)
    res = X.extract_windows(seqs, valid, rec_last, k, rc, W)
    return S.count_histogram(res["key"][0], res["emit"][0], MAX_COUNT)


class CoverageHistogram:
    def __init__(self, fastq1: str, fastq2: str, k: int, rc: bool,
                 verbose: bool = False, device=None):
        check_k(k)
        self.k = k
        self.rc = rc
        self.verbose = verbose
        self.w0 = INIT_W0
        self.c = INIT_C
        self.cutoff = 0
        self.fitted = False
        dev = get_device(device)

        for f in (fastq1, fastq2):
            if fastx.peek_format(f) != "fastq":
                raise ValueError(
                    f"{f} appears to be FASTA.\nCoverage can only be used with "
                    "FASTQ files, not FASTA."
                )

        seqs: List[bytes] = []
        for f in (fastq1, fastq2):
            seqs.extend(fastx.read_fastx(f).seqs)
        batch = fastx.build_batch(seqs)  # quality ignored (coverage.rs:102)
        L = len(batch.seq)

        W = width_for_k(k)
        cap = _max_chunk_bases()
        if L + k + 1 > cap:
            self.counts = _chunked_hist(batch, k, rc, W, cap, dev)
        else:
            seqs, _, rec_ends, _ = _stage_raw([batch], _bucket(L + k + 1))
            hist = _hist_from_raw(torch.from_numpy(seqs).to(dev),
                                  torch.from_numpy(rec_ends).to(dev), k, rc, W)
            self.counts = hist.cpu().numpy().astype(np.int64)

    def fit_histogram(self) -> int:
        if self.fitted:
            raise RuntimeError("Model already fitted")
        # truncate trailing low-frequency bins (coverage.rs:166-173)
        counts = list(self.counts)
        while counts and counts[-1] < MIN_FREQ:
            counts.pop()
        self.counts = np.array(counts, dtype=np.int64)
        c64 = self.counts.astype(np.float64)

        par, converged = _bfgs(
            np.array([self.w0, self.c]),
            lambda p: -_log_likelihood(p, c64),
            lambda p: -_grad_ll(p, c64),
        )
        if not converged:
            raise RuntimeError("Optimiser did not converge")
        self.w0, self.c = float(par[0]), float(par[1])
        self.cutoff = _find_cutoff(par, len(self.counts))
        self.fitted = True
        return self.cutoff

    def plot_hist(self, out=None):
        if not self.fitted:
            raise RuntimeError("Model has not yet been fitted")
        import sys

        out = out or sys.stdout
        out.write("Count\tK_mers\tMixture_density\tComponent\n")
        for idx, count in enumerate(self.counts):
            i = float(idx + 1)
            dens = math.exp(_lse(_a(self.w0, i), _b(self.w0, self.c, i)))
            comp = "Error" if (idx + 1) < self.cutoff else "Coverage"
            out.write(f"{idx + 1}\t{int(count)}\t{_rust_exp(dens)}\t{comp}\n")



# --- mixture model (coverage.rs:287-363) ---------------------------------------


# IEEE shims mirroring Rust f64 semantics: the reference's soft bound is
# INCLUSIVE (0.0..=1.0, coverage.rs:316), so a line-search probe landing
# exactly on w0 == 0.0 or 1.0 evaluates ln(0) — which Rust returns as
# -inf and the optimizer walks away from, while python's math.log/exp
# and float division raise. A boundary iterate must degrade the
# objective, not crash the fit.

def _ln(x):
    if x > 0.0:
        return math.log(x)
    return float("-inf") if x == 0.0 else float("nan")


def _exp(x):
    try:
        return math.exp(x)  # exp(-inf) = 0.0, exp(nan) = nan
    except OverflowError:
        return float("inf")  # Rust: exp(huge/ +inf) = +inf


def _div(n, d):
    try:
        return n / d
    except ZeroDivisionError:
        if n == 0.0 or math.isnan(n):
            return float("nan")
        return math.copysign(float("inf"), n) * math.copysign(1.0, d)


def _lse(a, b):
    m = max(a, b)
    return m + _ln(_exp(a - m) + _exp(b - m))


def _ln_dpois(x, lam):
    return x * _ln(lam) - math.lgamma(x + 1.0) - lam


def _a(w0, i):
    return _ln(w0) + _ln_dpois(i, 1.0)


def _b(w0, c, i):
    return _ln(1.0 - w0) + _ln_dpois(i, c)


def _log_likelihood(pars, counts):
    w0, c = float(pars[0]), float(pars[1])
    if not (0.0 <= w0 <= 1.0) or c < 1.0:
        return -1.7976931348623157e308  # f64::MIN soft bound (coverage.rs:314-317)
    ll = 0.0
    for i, cnt in enumerate(counts):
        x = i + 1.0
        ll += cnt * _lse(_a(w0, x), _b(w0, c, x))
    return ll


def _grad_ll(pars, counts):
    w0, c = float(pars[0]), float(pars[1])
    gw = 0.0
    gc = 0.0
    for i, cnt in enumerate(counts):
        x = i + 1.0
        av = _a(w0, x)
        bv = _b(w0, c, x)
        dlda = 1.0 / (1.0 + _exp(bv - av))
        dldb = 1.0 / (1.0 + _exp(av - bv))
        gw += cnt * (_div(dlda, w0) - _div(dldb, 1.0 - w0))
        gc += cnt * (dldb * (x / c - 1.0))
    return np.array([gw, gc])


def _find_cutoff(pars, max_cutoff):
    w0, c = float(pars[0]), float(pars[1])
    cutoff = 1
    while cutoff < max_cutoff:
        if _a(w0, float(cutoff)) - _b(w0, c, float(cutoff)) < 0.0:
            break
        cutoff += 1
    return cutoff


def _bfgs(x0, f, g, max_iters=20, tol_cost=1e-6, armijo_c=1e-4):
    """Small dense BFGS with Armijo backtracking (mirrors argmin's setup,
    coverage.rs:184-196). Returns (x, converged)."""
    n = len(x0)
    H = np.eye(n)
    x = x0.astype(np.float64)
    fx = f(x)
    gx = g(x)
    for _ in range(max_iters):
        p = -H @ gx
        # backtracking line search
        alpha = 1.0
        gtp = float(gx @ p)
        fnew = f(x + alpha * p)
        while not (fnew <= fx + armijo_c * alpha * gtp) and alpha > 1e-16:
            alpha *= 0.9
            fnew = f(x + alpha * p)
        s = alpha * p
        xn = x + s
        gn = g(xn)
        if abs(fx - fnew) < tol_cost:
            return xn, True
        y = gn - gx
        sy = float(s @ y)
        if sy > 1e-12:
            rho = 1.0 / sy
            I = np.eye(n)
            H = (I - rho * np.outer(s, y)) @ H @ (I - rho * np.outer(y, s)) + rho * np.outer(
                s, s
            )
        x, fx, gx = xn, fnew, gn
    return x, False


def _rust_exp(x: float) -> str:
    """Rust's {:e} format: shortest-roundtrip mantissa, bare exponent
    (e.g. 4.4633459e7, 5e-1)."""
    if x == 0.0:
        return "0e0"
    s = repr(float(abs(x)))
    if "e" in s:
        mant, exp = s.split("e")
        e = int(exp)
    else:
        e = 0
        mant = s
    digits = mant.replace(".", "").lstrip("0")
    intpart = mant.split(".")[0]
    if intpart != "0" and intpart != "":
        e += len(intpart) - 1
    else:
        frac = mant.split(".")[1] if "." in mant else ""
        nz = len(frac) - len(frac.lstrip("0"))
        e += -(nz + 1)
    digits = digits.rstrip("0") or "0"
    sign = "-" if x < 0 else ""
    if len(digits) == 1:
        return f"{sign}{digits}e{e}"
    return f"{sign}{digits[0]}.{digits[1:]}e{e}"


def _chunked_hist(batch, k, rc, W, cap, dev):
    """Bounded-memory count histogram: per-chunk sorted split-key counts
    summed across k-1-overlap slices, then binned (same rules as
    ops.segment.count_histogram: bin[c-1] for c <= MAX_COUNT)."""
    Lp = _bucket(cap + k + 1)
    valid_full = _valid_bases(batch.seq)
    kparts, cparts = [], []
    for a, b, end in _chunk_views(batch, k, cap, valid_full):
        seqs, _, rec_ends, _ = _stage_raw([batch.slice(a, end)], Lp)
        skeys, is_start, counts = P.chunk_key_counts_from_raw(
            torch.from_numpy(seqs[0]).to(dev),
            torch.from_numpy(rec_ends[0]).to(dev), k, rc, W)
        sel = is_start.cpu().numpy()
        kparts.append(K.to_numpy_keys(skeys)[sel])
        cparts.append(counts.cpu().numpy()[sel].astype(np.int64))

    keys = np.concatenate(kparts) if kparts else np.zeros((0, W), np.uint64)
    cnts = np.concatenate(cparts) if cparts else np.zeros(0, np.int64)
    if len(keys) == 0:
        return np.zeros(MAX_COUNT, np.int64)
    totals = key_totals(keys, cnts)[2]
    keep = totals <= MAX_COUNT
    return np.bincount(
        totals[keep] - 1, minlength=MAX_COUNT
    ).astype(np.int64)[:MAX_COUNT]
