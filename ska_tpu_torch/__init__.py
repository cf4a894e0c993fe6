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

Ported: all ten subcommands (``python -m ska_tpu_torch
build|align|cov|map|distance|weed|merge|delete|nk|lo``): ``ska build``
of FASTA and paired FASTQ samples (count and quality filters, samples
over the dispatch cap built in chunks, ``--min-count auto``), ``ska
map`` (the reference scan on the device, the lookup in a hand-written
lower-bound kernel, ``csrc/lower_bound.cu``), ``ska distance`` (the
class Gram on the device), and the host commands ``merge``,
``delete``, ``nk`` and ``lo`` (its C++ cores). The
build, the map lookup and the distance Gram also run sharded over a
torch.distributed group, one process per card (``parallel/``). The
in-memory JSON API (``webapi``: SkaData, AlignData, neighbor joining,
over the per-sample build of ``sample.build_sample(s)``) and the
driver hooks (``graft_entry``: entry, dryrun_multichip) are ported too,
and so are the CLI's two switches: SKA_PROFILE=<dir> (a torch.profiler
trace of any command, ``cli.py``) and SKA_DISPATCH_STATS=1 (kernel
launches and builds at exit, ``torchinit.py``).
Left out by design: the JAX package's pinned C++ host route
(``host_cmds``, ``ska_host``, SKA_NATIVE_*), its pure-Python ``lo``
graph and its pure-Python encoders. The package never imports jax.
"""
