"""Sharded build, `map` lookup and `distance` Gram over a
torch.distributed process group (port of ska_tpu/parallel/).

The JAX package shards over a device mesh in one process; here a mesh of
D devices is a process group of D ranks, one card each (NCCL on CUDA,
gloo on the CPU), and its shard_map collectives become
``all_gather_into_tensor``, ``all_to_all_single`` with per-rank split
sizes, and ``all_reduce``. Every output is byte-identical to the serial
port's at any world size.

Submodule re-exports are lazy (module __getattr__), as in the JAX
package: ``use_distributed`` answers from the environment and the
process group alone.
"""

import os

_LAZY = {
    "distributed_build": "build",
    "distributed_build_multi": "build",
    "distributed_merged_build": "build",
    "dryrun_step": "build",
    "init_multihost": "multihost",
    "is_primary": "multihost",
    "postbuild": None,  # submodule itself
}

__all__ = ["use_distributed", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name] or name}", __name__)
        value = mod if _LAZY[name] is None else getattr(mod, name)
        globals()[name] = value  # cache: next access skips __getattr__
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def use_distributed(device=None) -> bool:
    """The sharded-path policy: SKA_DISTRIBUTED=0 is off, =1 is on when
    the process group has more than one rank, and the default, auto, is
    on when it has more than one rank and the device (``device``, else
    SKA_DEVICE, else ``cuda``) is a card. Asks the environment and
    torch.distributed only, never CUDA."""
    flag = os.environ.get("SKA_DISTRIBUTED", "auto")
    if flag == "0":
        return False
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return False
    if flag == "1":
        return True
    dev = device or os.environ.get("SKA_DEVICE") or "cuda"
    return str(dev).split(":")[0] == "cuda"
