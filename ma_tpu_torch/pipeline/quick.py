"""Convenience one-call APIs (a copy of ma_tpu/pipeline/quick.py over the
port's Aligner, on an explicit device).

Re-design of the reference python helpers
(reference: libs/ma/python/setupaligner.py quick_align/test_aligner:1-60):
module-by-module pipelines collapsed into one call, plus the random
self-check used by the reference's own integration tests
(libs/ma/tests/random_alignments.py).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ma_tpu_torch.config.parameters import ParameterSetManager
from ma_tpu_torch.containers.nucseq import NucSeq, decode_seq, revcomp_codes
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.index.fmd_index import FMDIndex
from ma_tpu_torch.pipeline.aligner import Aligner


def quick_align(
    reads: Union[str, NucSeq, Sequence[Union[str, NucSeq]]],
    pack: Pack,
    fmd: Optional[FMDIndex] = None,
    preset: str = "Default",
    *,
    device,
    **param_overrides,
):
    """Align read(s) against a pack in one call (setupaligner.quick_align).

    Returns a list of Alignment lists (or a single list for one read).
    """
    single = isinstance(reads, (str, NucSeq))
    if single:
        reads = [reads]
    reads = [
        r if isinstance(r, NucSeq) else NucSeq.from_str(r, name=f"q{i}")
        for i, r in enumerate(reads)
    ]
    if fmd is None:
        fmd = FMDIndex.build(pack)
    mgr = ParameterSetManager()
    mgr.set_selected(preset)
    for name, value in param_overrides.items():
        mgr.selected[name.replace("_", " ")].set(value)
    result = Aligner(pack, mgr, device=device, fmd=fmd).align_batch(reads)
    return result[0] if single else result


def test_aligner(
    genome_size: int = 65536,
    n_reads: int = 100,
    read_len: int = 150,
    sub_rate: float = 0.01,
    seed: int = 0,
    preset: str = "Default",
    *,
    device,
) -> float:
    """Random-genome self check (random_alignments.py): simulate reads,
    align, return the fraction placed at their true position/strand."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_size).astype(np.uint8)
    pack = Pack.empty()
    pack.append("test_genome", genome)
    fmd = FMDIndex.build(pack)
    reads, truth = [], []
    for i in range(n_reads):
        p = int(rng.integers(0, genome_size - read_len))
        codes = genome[p : p + read_len].copy()
        for j in np.nonzero(rng.random(read_len) < sub_rate)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        rev = bool(rng.integers(0, 2))
        if rev:
            codes = revcomp_codes(codes)
        reads.append(NucSeq.from_str(decode_seq(codes), name=f"t{i}"))
        truth.append((p, rev))
    mgr = ParameterSetManager()
    mgr.set_selected(preset)
    res = Aligner(pack, mgr, device=device, fmd=fmd).align_batch(reads)
    ok = 0
    for alns, (p, rev) in zip(res, truth):
        if not alns:
            continue
        a = alns[0]
        if (
            bool(pack.is_reverse_strand(a.begin_on_ref)) == rev
            and abs(a.sam_position(pack) - 1 - p) <= 5
        ):
            ok += 1
    return ok / n_reads
