"""Mapping quality + secondary/supplementary classification.

Host re-design of the reference MappingQuality module
(reference: libs/ma/src/module/mappingQuality.cpp:11-135):

* sort by score; best = primary
* others: supplementary while (count < max and query-overlap with primary
  < threshold), else secondary
* MAPQ of primary: (s1 - s2)/s1 against the best non-supplementary
  runner-up; if no runner-up: s1/(match*qlen); halved for single-seed
  alignments; doubled for near-perfect scores with >=3 alignments; capped 1
* supplementaries inherit the primary's MAPQ; output re-sorted by `larger`
* truncate to Report-N best; drop alignments below the minimal score
"""
from __future__ import annotations

from typing import List

from ma_tpu_torch.containers.alignment import Alignment


def mapping_quality(
    alignments: List[Alignment],
    query_len: int,
    match: int = 2,
    max_supplementary: int = 1,
    max_overlap_supplementary: float = 0.1,
    report_n: int = 0,
    min_score: int = 75,
) -> List[Alignment]:
    alns = sorted(alignments, key=lambda a: -a.score())
    if not alns:
        return []
    first = alns[0]
    first.secondary = False
    first.supplementary = False
    n_supp = 0
    for a in alns[1:]:
        a.mapping_quality = 0.0
        if n_supp < max_supplementary and a.overlap(first) < max_overlap_supplementary:
            a.supplementary = True
            a.secondary = False
            n_supp += 1
        else:
            a.supplementary = False
            a.secondary = True

    if len(alns) - n_supp >= 2:
        second = next(a for a in alns[1:] if not a.supplementary)
        if first.score() == 0:
            first.mapping_quality = 0.0
        else:
            first.mapping_quality = (first.score() - second.score()) / first.score()
    else:
        first.mapping_quality = first.score() / float(match * query_len)

    if first.num_seeds() <= 1:
        first.mapping_quality /= 2
    if first.score() >= match * query_len * 0.8 and len(alns) >= 3:
        first.mapping_quality *= 2
    first.mapping_quality = min(first.mapping_quality, 1.0)
    if first.stats.set_mapping_quality_to_zero:
        first.mapping_quality = 0.0

    if n_supp > 0:
        for a in alns[1:]:
            if a.supplementary:
                a.mapping_quality = first.mapping_quality
        import functools

        alns.sort(key=functools.cmp_to_key(lambda a, b: -1 if a.larger(b) else 1))

    if report_n != 0 and len(alns) > report_n + n_supp:
        alns = alns[: report_n + n_supp]
    return [a for a in alns if a.score() >= min_score]
