"""`.skf` persistence: CBOR + snappy framing, byte-compatible with the
reference's serde/ciborium/snap stack (merge_ska_array.rs:108-126,191-204);
the port's copy of ska_tpu/io/skf.py.

``save`` is the host library's writer (csrc/host/save.cpp), which
encodes and compresses on SKA_THREADS threads: field order and inner
ndarray layout ({"v":1,"dim":[r,c],"data":[...]}) match serde's output,
u128 keys (k > 31) are CBOR positive bignums as ciborium encodes them,
and the snappy chunks come from the same greedy compressor as the JAX
package's, so its bytes equal those of the JAX package's serial writer
at any thread count.

Counters of the writer (``torchinit.save_counts``, zeroed with the
launch counters): ``saved_files``, the `.skf` files written;
``save_chunks``, their 64 KiB snappy framing chunks; ``save_threads``,
the most threads one save used; ``save_wide_keys``, the keys written as
tag-2 bignums (u128 keys whose high limb is not 0).
"""

import threading

import numpy as np
from torch.profiler import record_function

from ..array import SkaArray
from ..ops import npkeys as K
from . import cbor, native, snappy

saved_files = 0
save_chunks = 0
save_threads = 0
save_wide_keys = 0
_counts_lock = threading.Lock()  # saves may run in threads at once


def save(arr: SkaArray, path: str, add_suffix: bool = True):
    """add_suffix mirrors save_skf/delete (generic_modes.rs:270-283,200-204)."""
    global saved_files, save_chunks, save_threads, save_wide_keys
    if add_suffix and not path.endswith(".skf"):
        path = path + ".skf"
    chunks, threads, wide = native.skf_save(
        path, arr.keys, arr.variants, arr.counts, arr.names, arr.k, arr.rc,
        arr.ska_version)
    with _counts_lock:
        saved_files += 1
        save_chunks += chunks
        save_threads = max(save_threads, threads)
        save_wide_keys += wide
    return path


def load(path: str) -> SkaArray:
    """The array of an .skf, in the span ``ska::load`` around its three
    steps: ``ska::read`` (the file's bytes), ``ska::decompress`` (the
    snappy frame) and ``ska::decode`` (the CBOR and the array views)."""
    with record_function("ska::load"):
        with record_function("ska::read"), open(path, "rb") as f:
            raw = f.read()
        with record_function("ska::decompress"):
            data = snappy.frame_decompress(raw)
        with record_function("ska::decode"):
            return _decode(cbor.loads(data), path)


def _decode(obj, path: str) -> SkaArray:
    if not isinstance(obj, dict) or "split_kmers" not in obj:
        raise ValueError(f"Could not read input file: {path}")
    k = obj["k"]
    k_bits = obj.get("k_bits", 64)
    W = max(1, k_bits // 64)
    sk = obj["split_kmers"]
    if isinstance(sk, cbor.UIntArray):
        # .lo may be uint8 (byte-narrow bulk decode); keys are u64 limbs.
        # The decoder owns the buffer, so a dtype-matching view needs no copy.
        lo = sk.lo if sk.lo.dtype == np.uint64 else sk.lo.astype(np.uint64)
        if W == 1:
            keys = lo[:, None]
        else:
            hi = sk.hi if sk.hi.dtype == np.uint64 else sk.hi.astype(np.uint64)
            keys = np.stack([hi, lo], axis=-1)
    else:
        keys = K.from_python_ints(sk, W)
    v = obj["variants"]
    vdata = v["data"]
    if isinstance(vdata, cbor.UIntArray):
        vlo = vdata.lo
        if vlo.dtype != np.uint8:
            vlo = vlo.astype(np.uint8)
        variants = vlo.reshape(v["dim"][0], v["dim"][1])
    else:
        variants = np.array(vdata, dtype=np.uint8).reshape(v["dim"][0], v["dim"][1])
    vc = obj["variant_count"]
    if isinstance(vc, cbor.UIntArray):
        # counts are bounded by n_samples: a u64 buffer reinterprets as
        # int64 zero-copy, and a byte-narrow (uint8) buffer is kept as is
        counts = (vc.lo.view(np.int64) if vc.lo.dtype == np.uint64
                  else vc.lo)
    else:
        counts = np.array(vc, dtype=np.int64)
    # Row order is kept exactly as stored: the reference's alignment
    # output follows it.
    return SkaArray(
        k=k,
        rc=bool(obj["rc"]),
        names=[str(n) for n in obj["names"]],
        keys=keys,
        variants=variants,
        counts=counts,
        ska_version=str(obj.get("ska_version", "")),
    )
