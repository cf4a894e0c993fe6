"""Joining the process group (port of ska_tpu/parallel/multihost.py).

Every rank calls ``init_multihost()`` before it touches a card; the CLI
does so when SKA_COORDINATOR is set:

    SKA_COORDINATOR=host0:8476 SKA_NUM_PROCESSES=4 SKA_PROCESS_ID=$RANK \\
        python -m ska_tpu_torch build -o out -f samples.tsv

One rank drives one card: rank r takes card r % (cards of its host),
and the group runs on NCCL; with ``--device cpu`` it runs on gloo.
"""

import datetime
import logging
import os

log = logging.getLogger("ska_tpu_torch")

# a lost rank fails every collective after this long instead of hanging
# the others; generous, because a rank may wait for another's whole
# local build stage
TIMEOUT = datetime.timedelta(minutes=30)


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, device=None, timeout=TIMEOUT):
    """Join the process group from the arguments or SKA_COORDINATOR,
    SKA_NUM_PROCESSES and SKA_PROCESS_ID.

    A no-op returning False without a coordinator, a process id, or with
    one process, so single-process runs need no changes. On a card the
    rank's card becomes the current device before anything allocates,
    so that ``cuda`` means this rank's card from then on."""
    coordinator_address = coordinator_address or os.environ.get("SKA_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SKA_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid = os.environ.get("SKA_PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if not coordinator_address or num_processes <= 1 or process_id is None:
        return False

    import torch
    import torch.distributed as dist

    from ..torchinit import get_device

    dev = get_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timeout,
    )
    log.info("multihost: rank %d of %d on %s (%s)", process_id,
             num_processes, dev.type, dist.get_backend())
    return True


def is_primary() -> bool:
    """True on the rank that writes the outputs: rank 0, or the only
    process when no group is joined."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
