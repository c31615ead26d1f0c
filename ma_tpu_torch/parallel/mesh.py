"""Rank groups: data parallelism over torch.distributed (port of
ma_tpu/parallel/mesh.py).

ma_tpu runs one program over a `jax.sharding.Mesh` whose "reads" axis
splits the batch, and XLA places the shards. Here each device has its own
process (a rank), and a `RankGroup` names what that process is: its rank,
the world size, its device and the backend of the process group. The
caller chooses both: `cuda:r` over `nccl` where each rank has its own card,
`cuda:0` over `gloo` where ranks share one card (NCCL refuses two ranks on
one device), `cpu` over `gloo` on the CPU. Nothing picks a device or a
backend on its own.

ma_tpu's names and theirs here:

- `READS_AXIS`: the rank index, `RankGroup.rank`;
- `make_mesh(devices, n)`: `multihost.init_multihost(..., device=,
  backend=)` in each of n processes, or `RankGroup` alone for one process;
- `batch_sharding(mesh)`: `local_rows`, this rank's contiguous rows;
- `replicated(mesh)`: nothing to do, each rank holds its own copy on its
  device;
- `pad_batch_to_mesh`: `pad_batch_to_group`;
- `Aligner(sharding=...)`: one `Aligner(pack, device=group.device)` a rank
  on that rank's reads, the ranks' SAM merged in rank order
  (`multihost.merge_sam_shards`; worker.py's `align` mode).

The seeding state machines and alignment are per read, so the data-parallel
path needs no collective; the sharded indexes (sharded_index.py,
sharded_fmd.py) merge through `RankGroup.all_reduce`, the one collective
the port uses: a sum, which every backend takes for CUDA and CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class RankGroup:
    """This process's place in a group of ranks, and counts of the
    collectives it ran (each rank runs the same ones, in the same
    order: the sharded lookups depend on that)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    pg: Optional[Any] = None  # a torch.distributed group; None = the default group
    collectives: int = 0
    bytes: int = 0  # payload of those collectives, as this rank holds it

    def __post_init__(self):
        self.device = torch.device(self.device)
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of {self.world_size}")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it. A one-rank group
        without a process group returns `t` as it is."""
        self.collectives += 1
        self.bytes += t.numel() * t.element_size()
        if self.world_size > 1 or dist.is_initialized():
            dist.all_reduce(t, group=self.pg)
        return t

    def reset_counts(self) -> None:
        self.collectives = 0
        self.bytes = 0


def pad_batch_to_group(seqs: np.ndarray, lens: np.ndarray, group: RankGroup):
    """Pad B up to a multiple of the world size with empty reads (code 4,
    length 0: they align to nothing). Returns (seqs, lens, B)."""
    n = group.world_size
    B = seqs.shape[0]
    rem = (-B) % n
    if rem:
        seqs = np.concatenate([seqs, np.full((rem, seqs.shape[1]), 4, seqs.dtype)])
        lens = np.concatenate([lens, np.zeros(rem, lens.dtype)])
    return seqs, lens, B


def local_rows(seqs: np.ndarray, lens: np.ndarray, group: RankGroup):
    """This rank's contiguous block of a batch padded by pad_batch_to_group
    (the block `batch_sharding` gives device `rank` of the reads axis)."""
    if seqs.shape[0] % group.world_size:
        raise ValueError("pad the batch to a multiple of the world size first")
    per = seqs.shape[0] // group.world_size
    rows = slice(group.rank * per, (group.rank + 1) * per)
    return seqs[rows], lens[rows]
