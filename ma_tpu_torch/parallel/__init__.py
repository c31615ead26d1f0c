"""Multi-device execution on torch.distributed (port of ma_tpu/parallel/):
one process a device, a `RankGroup` naming its rank, device and backend.

ma_tpu's exports and theirs here: `READS_AXIS` -> `RankGroup.rank`;
`make_mesh` -> `init_multihost` (every process) or `RankGroup`;
`batch_sharding` -> `local_rows`; `replicated` -> each rank's own copy;
`pad_batch_to_mesh` -> `pad_batch_to_group`. The rest of ma_tpu's package
keeps its names: multihost.py (`init_multihost`, `global_mesh` ->
`global_group`, `shard_paths`, `output_path_for_process`,
`merge_sam_shards`), sharded_index.py (`shard_minimizer_index`,
`sharded_minimizer_seeding`), sharded_fmd.py (`FMDShardDev`,
`shard_fmd_index`, the `*_sharded` lookups, `sharded_fmd_seeding`).
worker.py runs ranks as processes (`python -m ma_tpu_torch.parallel.worker`).
"""
from ma_tpu_torch.parallel.mesh import RankGroup, local_rows, pad_batch_to_group
from ma_tpu_torch.parallel.multihost import global_group, init_multihost

__all__ = [
    "RankGroup",
    "global_group",
    "init_multihost",
    "local_rows",
    "pad_batch_to_group",
]
