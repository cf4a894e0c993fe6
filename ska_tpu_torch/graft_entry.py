"""Driver entry points of the port (the counterparts of the repo's
__graft_entry__.py).

entry(device=None) -> (fn, example_args): the flagship device step, one
merged `ska build` pass of a batch of samples (split k-mer extraction,
canonical keys, ONE global sort by (key, sample id) on the radix kernel,
the segmented IUPAC union and the variants matrix), at k=31 on 4 random
rows of 4096 bases.

dryrun_multichip(n, device=None): a torch.distributed group of n ranks,
one process each (NCCL on the cards, gloo on the CPU), runs
parallel.build.dryrun_step once; returns its row count. Inside a group
that is already joined it runs in place. A rank process is

    python -m ska_tpu_torch.graft_entry <rank> <n> <port> <device>
"""

import datetime
import json
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from .ops import pipeline as P
from .ops.npkeys import width_for_k
from .torchinit import get_device

log = logging.getLogger("ska_tpu_torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600


def entry(device=None):
    """(fn, example_args): fn(seqs, valid, qual_ok, rec_last) is
    ops.pipeline.merged_build_pipeline at k=31; the args are the (4,
    4096) rows of __graft_entry__.entry() (random ACGT from
    default_rng(0), one record a row) on the resolved device."""
    dev = get_device(device)
    k = 31
    W = width_for_k(k)
    S, L = 4, 4096

    def step(seqs, valid, qual_ok, rec_last):
        return P.merged_build_pipeline(seqs, valid, qual_ok, rec_last, k,
                                       True, W, False, False, 0)

    rng = np.random.default_rng(0)
    seqs = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(S, L))
    rec_last = np.zeros((S, L), bool)
    rec_last[:, L - 1] = True
    args = (torch.from_numpy(seqs), torch.ones((S, L), dtype=torch.bool),
            torch.ones((S, L), dtype=torch.bool), torch.from_numpy(rec_last))
    return step, tuple(a.to(dev) for a in args)


def dryrun_multichip(n_devices: int, device=None) -> int:
    """parallel.build.dryrun_step in a group of n_devices ranks: in place
    when this process is in a joined group, else in n_devices rank
    processes started here and waited for. Returns rank 0's row count;
    raises if a rank fails."""
    from .parallel import comm
    from .parallel.build import dryrun_step

    dev = get_device(device)
    if comm.joined():
        return dryrun_step(n_devices, device=dev)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) on "
                         f"{torch.cuda.device_count()} CUDA devices: NCCL "
                         "takes one rank a card")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ska_tpu_torch.graft_entry", str(r),
         str(n_devices), str(port), dev.type],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(n_devices)]
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
            if p.returncode:
                failed.append(f"rank {r}: exit {p.returncode}\n"
                              f"{err.decode()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("dryrun_multichip failed:\n" + "\n".join(failed))
    report = json.loads(outs[0].decode().strip().splitlines()[-1])
    log.info("dryrun_multichip: %s", json.dumps(report))
    return report["n_rows"]


def _rank_main(rank: int, world: int, port: int, device: str):
    """One rank of dryrun_multichip; rank 0 prints its report as one JSON
    line: rows, backend, world size and radix kernel launches."""
    import torch.distributed as dist

    from . import torchinit
    from .parallel.build import dryrun_step

    dev = get_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        torchinit.reset_launch_counts()
        n_rows = dryrun_step(world, device=dev)
        report = {"n_rows": int(n_rows), "backend": dist.get_backend(),
                  "world": world, **torchinit.launch_counts()}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(report))


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
