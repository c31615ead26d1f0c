"""App-glue managers — the ExecutionContext layer (a copy of
ma_tpu/pipeline/execution_context.py over the port's Aligner, on an
explicit device).

Re-design of the reference's GUI/CLI shared state holders (reference:
libs/ma/inc/ma/util/execution-context.h — GenomeManager :16-150,
ReadsManager :~200, OutputManager :225-272, ExecutionContext::doAlign
:275-412): genome manifest management (the "<name>.json" file written by
--Create_Index), input read-set bookkeeping, SAM output naming, and the
one-call do_align() driving the full pipeline.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, List, Optional

from ma_tpu_torch.config.parameters import ParameterSetManager


class GenomeManager:
    """Genome/index manifest (execution-context.h:16-150): loads the JSON
    written at index-build time and exposes pack/FMD/minimizer handles."""

    def __init__(self):
        self.prefix: Optional[str] = None
        self.name: Optional[str] = None
        self._pack = None
        self._fmd = None

    @staticmethod
    def make_index(fasta: str, folder: str, name: str, log=print) -> str:
        """makeIndexAndPackForGenome (execution-context.h:108-138)."""
        from ma_tpu_torch.cli import create_index

        return create_index(fasta, folder, name, log=log)

    def load_genome(self, json_or_prefix: str) -> None:
        """Accepts the manifest path or a bare index prefix."""
        prefix = json_or_prefix
        if prefix.endswith(".json"):
            with open(prefix) as f:
                manifest = json.load(f)
            if manifest.get("type") not in ("MA Genome", "MA-TPU Genome"):
                raise ValueError(f"{json_or_prefix} is not an MA Genome manifest")
            prefix = os.path.join(os.path.dirname(prefix), manifest["prefix"])
            self.name = manifest.get("name")
        elif os.path.exists(prefix + ".json"):
            with open(prefix + ".json") as f:
                self.name = json.load(f).get("name")
        self.prefix = prefix
        self._pack = None
        self._fmd = None

    @property
    def ready(self) -> bool:
        return self.prefix is not None

    def pack(self):
        if self._pack is None:
            from ma_tpu_torch.containers.pack import Pack

            self._pack = Pack.load(self.prefix)
        return self._pack

    def fmd(self):
        if self._fmd is None:
            from ma_tpu_torch.index.fmd_index import FMDIndex

            self._fmd = FMDIndex.load(self.prefix)
        return self._fmd


class ReadsManager:
    """Input read-set bookkeeping (execution-context.h:~200)."""

    def __init__(self):
        self.primary: List[str] = []
        self.mates: List[str] = []

    @property
    def paired(self) -> bool:
        return bool(self.mates)

    def reads(self):
        from ma_tpu_torch.io.fasta import read_reads

        for path in self.primary:
            yield from read_reads(path)

    def mate_reads(self):
        from ma_tpu_torch.io.fasta import read_reads

        for path in self.mates:
            yield from read_reads(path)


class OutputManager:
    """SAM output naming (execution-context.h:225-272): explicit path, or
    derived <first-input>.sam; "stdout" writes to stdout."""

    def __init__(self, reads: ReadsManager, out_path: Optional[str] = None):
        self.reads = reads
        self.out_path = out_path

    def path(self) -> str:
        if self.out_path:
            return self.out_path
        if self.reads.primary:
            base = self.reads.primary[0]
            for suf in (".fastq.gz", ".fasta.gz", ".fq.gz", ".fa.gz",
                        ".fastq", ".fasta", ".fq", ".fa"):
                if base.endswith(suf):
                    base = base[: -len(suf)]
                    break
            return base + ".sam"
        return "out.sam"

    def open(self):
        p = self.path()
        return sys.stdout if p == "stdout" else open(p, "w")


class ExecutionContext:
    """One-call alignment entry point (ExecutionContext::doAlign,
    execution-context.h:275-412) on `device`."""

    def __init__(self, params: Optional[ParameterSetManager] = None, *, device):
        self.device = device
        self.params = params or ParameterSetManager()
        self.genome = GenomeManager()
        self.reads = ReadsManager()
        self.output = OutputManager(self.reads)

    def do_align(
        self, progress: Optional[Callable[[int], bool]] = None
    ) -> int:
        """Run the full pipeline on the configured genome/reads/output.
        Returns the number of reads aligned; progress(n)->False cancels
        (the doAlign callback contract, cmdMa.cpp:398-415)."""
        if not self.genome.ready:
            raise RuntimeError("no genome loaded")
        from ma_tpu_torch.pipeline.aligner import Aligner

        aligner = Aligner(
            self.genome.pack(),
            self.params,
            device=self.device,
            fmd=self.genome.fmd(),
            index_prefix=self.genome.prefix,
        )
        out = self.output.open()
        t0 = time.perf_counter()
        try:
            if self.reads.paired:
                from ma_tpu_torch.io.fasta import zip_paired
                from ma_tpu_torch.pipeline.paired import PairedAligner

                paired = PairedAligner(aligner)
                n = paired.align_to_sam(
                    zip_paired(self.reads.reads(), self.reads.mate_reads()), out
                )
            else:
                n = aligner.align_to_sam(
                    self.reads.reads(), out, progress=progress
                )
        finally:
            if out is not sys.stdout:
                out.close()
        self.runtime = time.perf_counter() - t0
        return n
