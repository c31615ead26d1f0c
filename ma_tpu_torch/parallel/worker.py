"""One rank of a multi-process run (the port's counterpart of ma_tpu's
scripts/multihost_worker.py).

    python -m ma_tpu_torch.parallel.worker --rank R --world W \\
        --init file:///tmp/rdv --device cpu --backend gloo \\
        --dir WORKDIR --modes psum,seed-mm,seed-fmd,align

joins the group (`init_multihost`; `--init` is `host:port` or an init
method with its scheme), runs the modes in order and prints one JSON line
of results as the last line of its output. The device and the backend are
the caller's: `--device cpu --backend gloo` on the CPU, `--device cuda:0
--backend gloo` for ranks sharing one card, `--device cuda:R --backend
nccl` for a card a rank. `--timeout` bounds the rendezvous and every
collective, so a rank whose peer never starts or dies exits non-zero.

Modes, over the files in WORKDIR:

- `psum`: the sum of rank + 1 over the ranks (int32 all_reduce, which
  must be right), then a probe of an int64 all_reduce and an int32
  all_gather on the device, each reported as "ok" or the error;
- `seed-mm`: for each `seed-mm*.npz` (keys `index`, a prefix of
  `MinimizerIndex.store` files in WORKDIR, and `seqs`, `lens`,
  `contig_starts`, `ref_len_forward`, `k`, `w`, `max_occ`,
  `max_seeds_per_shard`): shard the index over the ranks, hold this rank's
  shard on the device and run `sharded_minimizer_seeding`; rank 0 writes
  the SeedBatch to `<case>.out.npz`;
- `seed-fmd`: for each `seed-fmd*.npz` (`index`, an `FMDIndex.store`
  prefix, `seqs`, `lens`, `contig_starts`, `techniques`, and optionally
  `occ_k` / `sa_rows`): shard the FMD index by rows and run
  `sharded_fmd_seeding` for each technique (and `occ4_sharded` /
  `sa_lookup_sharded` on the given rows); rank 0 writes `<case>.out.npz`;
- `align`: this rank's share (`shard_paths`) of WORKDIR's `*.fq` files,
  aligned with minimizers against the `Pack.store` files of prefix
  WORKDIR/g (and its `MinimizerIndex.store` file, if there is one) to
  `output_path_for_process(WORKDIR/out.sam)`, timed between two
  collectives.

`--warmup N` (N > 0) runs N reads through each seed-fmd technique, and the
first batch through the aligner, before the timed runs.

`run_ranks` starts the ranks of one run as processes of this module and
returns each rank's results.
"""
from __future__ import annotations

import argparse
import glob
import io
import json
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
MODES = ("psum", "seed-mm", "seed-fmd", "align")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _first_line(e: BaseException) -> str:
    return f"error: {type(e).__name__}: {str(e).strip().splitlines()[0] if str(e) else ''}"


def run_psum(group) -> dict:
    dev = group.device
    want = group.world_size * (group.world_size + 1) // 2
    got = int(group.all_reduce(torch.full((1,), group.rank + 1, dtype=torch.int32,
                                          device=dev)).item())
    if got != want:
        raise AssertionError(f"all_reduce gave {got}, want {want}")
    probe = {"all_reduce_int32": "ok"}
    try:
        y = torch.full((1,), group.rank + 1, dtype=torch.int64, device=dev)
        dist.all_reduce(y, group=group.pg)
        probe["all_reduce_int64"] = "ok" if int(y.item()) == want else f"wrong: {int(y.item())}"
    except RuntimeError as e:
        probe["all_reduce_int64"] = _first_line(e)
    try:
        x = torch.full((1,), group.rank + 1, dtype=torch.int32, device=dev)
        parts = [torch.zeros_like(x) for _ in range(group.world_size)]
        dist.all_gather(parts, x, group=group.pg)
        ok = [int(p.item()) for p in parts] == list(range(1, group.world_size + 1))
        probe["all_gather_int32"] = "ok" if ok else f"wrong: {[int(p.item()) for p in parts]}"
    except RuntimeError as e:
        probe["all_gather_int32"] = _first_line(e)
    return {"sum": got, "want": want, "probe": probe}


def _cases(directory: str, mode: str) -> list:
    return sorted(p for p in glob.glob(os.path.join(directory, f"{mode}*.npz"))
                  if not p.endswith(".out.npz"))


def _save(path: str, fields: dict) -> None:
    np.savez(path, **{k: v.cpu().numpy() for k, v in fields.items()})


def run_seed_mm(group, directory: str) -> list:
    from ma_tpu_torch.index.minimizer import MinimizerIndex
    from ma_tpu_torch.parallel.sharded_index import (
        shard_minimizer_index,
        shard_to_device,
        sharded_minimizer_seeding,
    )

    dev = group.device
    out = []
    for case in _cases(directory, "seed-mm"):
        z = np.load(case)
        mmi = MinimizerIndex.load(os.path.join(directory, str(z["index"])))
        shards = shard_minimizer_index(mmi, group.world_size)
        t0 = time.perf_counter()
        shard = shard_to_device(shards, group.rank, dev)
        _sync(dev)
        t_up = time.perf_counter() - t0
        seqs = torch.as_tensor(z["seqs"], device=dev)
        lens = torch.as_tensor(z["lens"], device=dev)
        kw = dict(k=int(z["k"]), w=int(z["w"]), max_occ=int(z["max_occ"]),
                  max_seeds_per_shard=int(z["max_seeds_per_shard"]))
        run = lambda: sharded_minimizer_seeding(  # noqa: E731
            group, shard, seqs, lens, z["contig_starts"], int(z["ref_len_forward"]), **kw)
        run()  # warm-up
        _sync(dev)
        group.reset_counts()
        t0 = time.perf_counter()
        sb = run()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        dev_bytes = sum(t.numel() * t.element_size() for t in
                        (shard.pos, shard.strand, shard.chd_d, shard.chd_table) if t is not None)
        out.append({"case": Path(case).stem, "ms": ms, "collectives": group.collectives,
                    "bytes_reduced": group.bytes, "n_seeds": int(sb.n_seeds.sum()),
                    "index_entries": len(mmi.hash_sorted), "shard_entries": shards.hash.shape[1],
                    "shard_device_bytes": dev_bytes, "chd_upload_s": t_up})
        if group.rank == 0:
            _save(case[:-4] + ".out.npz", sb._asdict())
    return out


def run_seed_fmd(group, directory: str, warmup: int) -> list:
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.parallel.sharded_fmd import (
        FMDShardDev,
        occ4_sharded,
        sa_lookup_sharded,
        shard_fmd_index,
        sharded_fmd_seeding,
    )

    dev = group.device
    out = []
    for case in _cases(directory, "seed-fmd"):
        z = np.load(case)
        fmd = FMDIndex.load(os.path.join(directory, str(z["index"])))
        slab = FMDShardDev.from_shards(shard_fmd_index(fmd, group.world_size), group.rank, dev)
        seqs = torch.as_tensor(z["seqs"], device=dev)
        lens = torch.as_tensor(z["lens"], device=dev)
        fields, res = {}, {"case": Path(case).stem, "slab_device_bytes": sum(
            t.numel() * t.element_size() for t in (slab.bwt_words, slab.occ_cp, slab.ssa))}
        for tech in (str(t) for t in z["techniques"]):
            if warmup:
                sharded_fmd_seeding(group, slab, seqs[:warmup], lens[:warmup],
                                    z["contig_starts"], technique=tech)
            _sync(dev)
            group.reset_counts()
            t0 = time.perf_counter()
            sb = sharded_fmd_seeding(group, slab, seqs, lens, z["contig_starts"], technique=tech)
            _sync(dev)
            res[tech] = {"ms": (time.perf_counter() - t0) * 1e3,
                         "collectives": group.collectives, "bytes_reduced": group.bytes}
            fields.update({f"{tech}.{k}": v for k, v in sb._asdict().items()})
        if "occ_k" in z.files:
            group.reset_counts()
            fields["occ4"] = occ4_sharded(group, slab, torch.as_tensor(z["occ_k"], device=dev))
            fields["sa"] = sa_lookup_sharded(group, slab, torch.as_tensor(z["sa_rows"],
                                                                          device=dev))
            res["lookups"] = {"collectives": group.collectives}
        out.append(res)
        if group.rank == 0:
            _save(case[:-4] + ".out.npz", fields)
    return out


def run_align(group, directory: str, batch_size: int, warmup: int) -> dict:
    from ma_tpu_torch import kernels
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.io.fasta import read_reads
    from ma_tpu_torch.parallel.multihost import output_path_for_process, shard_paths
    from ma_tpu_torch.pipeline.aligner import Aligner

    dev = group.device
    prefix = os.path.join(directory, "g")
    mine = shard_paths(sorted(glob.glob(os.path.join(directory, "*.fq"))), group)
    reads = [r for p in mine for r in read_reads(p)]
    aligner = Aligner(Pack.load(prefix), device=dev, index_prefix=prefix)
    aligner.pset.set("Seeding Technique", "minimizers")
    if warmup:  # the first batch, which loads the index and the native libraries
        aligner.align_to_sam(iter(reads[:batch_size]), io.StringIO(), batch_size=batch_size)
    out_path = output_path_for_process(os.path.join(directory, "out.sam"), group)
    walls = torch.zeros(group.world_size, dtype=torch.float64, device=dev)
    group.all_reduce(torch.zeros(1, dtype=torch.int32, device=dev))  # start together
    for k in kernels.KERNELS:
        k.reset()
    t0 = time.perf_counter()
    with open(out_path, "w") as f:
        n = aligner.align_to_sam(iter(reads), f, batch_size=batch_size)
    _sync(dev)
    walls[group.rank] = time.perf_counter() - t0
    group.all_reduce(walls)  # every rank's wall, and the end of the slowest
    return {"reads": n, "files": [os.path.basename(p) for p in mine],
            "out": os.path.basename(out_path), "walls_s": walls.tolist(),
            "launches": {k.name: k.launches for k in kernels.KERNELS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="host:port, tcp://..., or file:///path")
    ap.add_argument("--device", required=True, help="cpu, cuda:0, ...")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--dir", required=True)
    ap.add_argument("--modes", required=True, help="comma-separated: " + ", ".join(MODES))
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds for the rendezvous and each collective")
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--warmup", type=int, default=0,
                    help="reads of seed-fmd's warm-up; > 0 also warms align up on a batch")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        ap.error(f"unknown modes {unknown}")

    from ma_tpu_torch.parallel.multihost import init_multihost

    group = init_multihost(args.init, args.world, args.rank, device=args.device,
                           backend=args.backend, timeout=args.timeout)
    results = {}
    for mode in modes:
        t0 = time.perf_counter()
        if mode == "psum":
            results[mode] = run_psum(group)
        elif mode == "seed-mm":
            results[mode] = run_seed_mm(group, args.dir)
        elif mode == "seed-fmd":
            results[mode] = run_seed_fmd(group, args.dir, args.warmup)
        else:
            results[mode] = run_align(group, args.dir, args.batch_size, args.warmup)
        results[mode + "_s"] = time.perf_counter() - t0
    dist.destroy_process_group()
    print(json.dumps({"rank": group.rank, "world": group.world_size, "backend": group.backend,
                      "device": str(group.device), "results": results}), flush=True)
    return 0


def worker_command(rank: int, world: int, init: str, device: str, backend: str,
                   directory: str, modes: str, timeout: float = 60.0, *extra: str) -> list:
    """The command line of one rank."""
    return [sys.executable, "-m", "ma_tpu_torch.parallel.worker", "--rank", str(rank),
            "--world", str(world), "--init", init, "--device", device, "--backend", backend,
            "--dir", directory, "--modes", modes, "--timeout", str(timeout), *extra]


def run_ranks(world: int, directory: str, modes: str, *, devices, backend: str,
              timeout: float = 60.0, wall_timeout: float = 600.0, extra=(), env=None) -> list:
    """Start `world` ranks of this module on `devices` (one a rank), wait at
    most `wall_timeout` seconds for all of them, and return each rank's JSON
    results in rank order. Each rank's output goes to
    `directory/rank<r>.out` and `.err`. Raises if a rank fails or the
    time runs out (then every rank still running is killed)."""
    init = f"file://{os.path.join(os.path.abspath(directory), 'rdv-' + uuid.uuid4().hex)}"
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    logs, procs = [], []
    try:
        for r in range(world):
            out = open(os.path.join(directory, f"rank{r}.out"), "w")
            err = open(os.path.join(directory, f"rank{r}.err"), "w")
            logs += [out, err]
            procs.append(subprocess.Popen(
                worker_command(r, world, init, str(devices[r]), backend, directory, modes,
                               timeout, *extra),
                cwd=ROOT, env=env, stdout=out, stderr=err))
        deadline = time.monotonic() + wall_timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"ranks still running after {wall_timeout} s: "
                           + _tails(directory, world)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"rank exit codes {[p.returncode for p in procs]}: "
                           + _tails(directory, world))
    return [json.loads(Path(directory, f"rank{r}.out").read_text().strip().splitlines()[-1])
            for r in range(world)]


def _tails(directory: str, world: int) -> str:
    return "\n".join(f"--- rank {r}:\n" + Path(directory, f"rank{r}.err").read_text()[-3000:]
                     for r in range(world))


if __name__ == "__main__":
    sys.exit(main())
