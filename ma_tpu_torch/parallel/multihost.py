"""Multi-process execution helpers (port of ma_tpu/parallel/multihost.py).

ma_tpu joins a `jax.distributed` cluster and sees every chip of every host
in one global mesh. Here every rank is a process of its own in one
torch.distributed group: `init_multihost` joins it, `global_group` is the
counterpart of `global_mesh`. Read batches are data parallel per process
(each aligns its own FASTQ shard, `shard_paths`) and each writes its own
SAM (`output_path_for_process`); `merge_sam_shards` joins them on the host.
Index arrays are either held whole by each rank or sharded over the ranks
(sharded_index.py, sharded_fmd.py).

`python -m ma_tpu_torch.parallel.worker` runs these end to end.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ma_tpu_torch.parallel.mesh import RankGroup


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device,
    backend: str,
    timeout: float = 60.0,
) -> RankGroup:
    """torch.distributed.init_process_group with ma_tpu's environment
    fallbacks (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID). The
    address is `host:port` (rank 0 listens there), or an init method with
    its scheme (`tcp://...`, `file:///path`). `device` and `backend` are the
    caller's choice, printed here; `timeout` (seconds) bounds the
    rendezvous and every collective, so a rank whose peer is gone raises
    instead of hanging. Returns this rank's group."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])  # NB: 0 is a valid id
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_multihost needs a coordinator address, the number of "
                         "processes and this process's id (or COORDINATOR_ADDRESS, "
                         "NUM_PROCESSES and PROCESS_ID)")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"init_multihost: rank {process_id} of {num_processes}, backend {backend}, "
          f"device {dev}, {init_method}", flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return global_group(dev)


def global_group(device) -> RankGroup:
    """This process's group over every rank of the default process group
    (global_mesh's counterpart); `device` is this rank's device."""
    return RankGroup(dist.get_rank(), dist.get_world_size(), device, dist.get_backend())


def _rank_world(group: Optional[RankGroup]):
    """(rank, world size) of `group`, else of the default process group,
    else (0, 1), as jax reports a single process."""
    if group is not None:
        return group.rank, group.world_size
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_paths(paths: Sequence[str], group: Optional[RankGroup] = None) -> list:
    """Round-robin input files over the ranks (each aligns its own shard of
    the read set)."""
    rank, world = _rank_world(group)
    return [p for i, p in enumerate(paths) if i % world == rank]


def output_path_for_process(base: str, group: Optional[RankGroup] = None) -> str:
    """This rank's SAM shard name: `base` itself in a one-rank world."""
    rank, world = _rank_world(group)
    if world == 1:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}.part{rank:04d}{ext}"


def merge_sam_shards(shard_paths: Sequence[str], out_path: str) -> int:
    """Concatenate per-process SAM shards into one file: the header is taken
    from the first shard (all shards were written against the same Pack, so
    headers are identical); records append in shard order. Returns the
    number of alignment records written."""
    n = 0
    with open(out_path, "w") as out:
        for i, p in enumerate(sorted(shard_paths)):
            with open(p) as f:
                for line in f:
                    if line.startswith("@"):
                        if i == 0:
                            out.write(line)
                        continue
                    out.write(line)
                    n += 1
    return n
