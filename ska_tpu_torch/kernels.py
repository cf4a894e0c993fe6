"""Build and load the port's native libraries.

Two routes, both with a plain C interface bound by ctypes:

- each hand-written CUDA kernel, ``csrc/<name>.cu``, is compiled by nvcc
  for Hopper (sm_90a) into ``build/ska_tpu_torch/lib<name>.so``;
- the host library, ``csrc/host/*.cpp`` (the .skf codec, the batch
  union, the site filters, map's AlnWriter and the two `ska lo` cores),
  is compiled by g++ into ``build/ska_tpu_torch/libska_host.so``.

``build/`` sits at the root of the checkout. A library is built at first
use and again whenever a source, or a header it includes
(``csrc/host/*.h``), is newer than it. Nothing is compiled
when a module is imported, and nothing here falls back to another
route: a missing compiler or a failed build raises. Each build writes a
file of its own and renames it into place, so concurrent processes
(test workers) may race to build the same library. ``builds`` counts
the compiler runs of this process (SKA_DISPATCH_STATS reports it), and
each run is a ``ska::compile`` span in a profiler's trace.
"""

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
HOST_SRC_DIR = os.path.join(SRC_DIR, "host")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ska_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]

# compiler runs started by _compile in this process (an up-to-date
# library is no run); libraries may be built from several threads at once
builds = 0
_builds_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host library cannot be built")


def _compile(compiler: str, flags, srcs, so: str, headers=()) -> str:
    """Compile srcs into so unless it is newer than all of them and of
    the headers they include. The compiler's report is kept beside it as
    <so>.log. The compiler's run is the span ``ska::compile``."""
    global builds
    if os.path.exists(so) and os.path.getmtime(so) >= max(
            os.path.getmtime(s) for s in (*srcs, *headers)):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    with _builds_lock:
        builds += 1
    from torch.profiler import record_function

    with record_function("ska::compile"):
        r = subprocess.run([compiler, *flags, "-o", tmp, *srcs],
                           capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed on {srcs}:\n"
            f"{r.stdout}{r.stderr}")
    with open(so + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees old or new
    return so


def build(name: str) -> str:
    """Compile csrc/<name>.cu with nvcc unless its library is up to
    date; returns the library's path. The ptxas report (registers,
    shared memory, spills) is kept as lib<name>.so.log."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    return _compile(_nvcc(), NVCC_FLAGS, [src],
                    os.path.join(BUILD_DIR, f"lib{name}.so"))


def build_host() -> str:
    """Compile csrc/host/*.cpp with g++ into libska_host.so unless it is
    newer than them and csrc/host/*.h; returns the library's path."""
    srcs = sorted(glob.glob(os.path.join(HOST_SRC_DIR, "*.cpp")))
    headers = glob.glob(os.path.join(HOST_SRC_DIR, "*.h"))
    return _compile(_gxx(), GXX_FLAGS, srcs,
                    os.path.join(BUILD_DIR, "libska_host.so"), headers)


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name))


def load_host() -> ctypes.CDLL:
    return ctypes.CDLL(build_host())
