"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc
for Hopper (sm_90a) into ``build/ska_tpu_torch/lib<name>.so`` at the root
of the checkout, at first use and again whenever the source is newer than
the library. Nothing is compiled when a module is imported, and nothing
here falls back to another route: a missing nvcc or a failed build raises.
"""

import ctypes
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ska_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is up to date; returns
    the library's path. The compiler's report (registers, shared memory,
    spills from ptxas) is kept beside it as lib<name>.so.log."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    with open(so + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees old or new
    return so


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name))
