"""ska_tpu_torch: the PyTorch/CUDA port of ska_tpu.

The JAX package ``ska_tpu`` stays the reference. This package keeps its
module and function names but imports nothing of it: it keeps its own
copies of the host code it uses (FASTA/FASTQ parsing, the .skf codec,
``SkaArray``, merging, staging helpers, the CLI grammar, and a C++ host
library, ``csrc/host/``, built by g++ at first use), and rewrites the
device code as torch ops on an explicit ``device``. The one TPU kernel
on the build path, the bitonic sort of ``ska_tpu/ops/sort.py``, is a
hand-written Hopper radix sort here (``csrc/radix_sort.cu``, wrapped by
``ops/sort.py``).

Ported so far: ``ska build`` of FASTA and paired FASTQ samples (count
and quality filters, samples over the dispatch cap built in chunks,
``--min-count auto``), ``ska align``, ``ska cov``, ``ska map`` (the
reference scan on the device, the lookup on the radix sort kernel),
``ska distance`` (the class Gram on the device) and ``ska weed``
(``python -m ska_tpu_torch build|align|cov|map|distance|weed``); the
build, the map lookup and the distance Gram also run sharded over a
torch.distributed group, one process per card (``parallel/``). The
package never imports jax.
"""
