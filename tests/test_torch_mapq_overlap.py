"""Mapping quality's overlap test: the port's `Alignment.overlap` (a merge
of the two run lists) against ma_tpu's (every run against every run), float
for float, and `mapping_quality` on top of it under the PacBio preset's
settings. Each case builds the same alignments in both packages by the
same `append` calls."""
import numpy as np
import pytest

from ma_tpu.containers import alignment as JAl
from ma_tpu.pipeline.quality import mapping_quality as j_mapq
from ma_tpu_torch.containers import alignment as TAl
from ma_tpu_torch.pipeline.quality import mapping_quality as t_mapq


def _long_ops(rng, length, sub=0.01, ins=0.02, dele=0.02):
    """(op name, size) calls of a `length`-base alignment at the given
    substitution / insertion / deletion rates per base: match runs between
    errors, about a third of the longer ones appended as a seed run."""
    ops, q = [], 0
    rate = sub + ins + dele
    while q < length:
        run = int(rng.geometric(rate))
        if run > 15 and rng.random() < 0.3:
            ops.append(("SEED", run))
        elif run > 1:
            ops.append(("MATCH", run))
        q += run
        kind = rng.choice(3, p=[sub / rate, ins / rate, dele / rate])
        size = int(rng.integers(1, 4))
        if kind == 0:
            ops.append(("MISMATCH", 1))
            q += 1
        elif kind == 1:
            ops.append(("INSERTION", size))
            q += size
        else:
            ops.append(("DELETION", size))
    return ops


def _pair(ops, begin_q, begin_ref=0):
    """The same alignment built in ma_tpu and in the port."""
    out = []
    for mod in (JAl, TAl):
        a = mod.Alignment(begin_on_ref=begin_ref, begin_on_query=begin_q)
        for op, size in ops:
            a.append(getattr(mod, op), size)
        out.append(a)
    return out


def _case(name, seed):
    """Two alignments (each a (ma_tpu, port) pair) for one named case."""
    rng = np.random.default_rng(seed)
    la, lb = (int(x) for x in rng.integers(2_000, 30_001, 2))
    a_ops, b_ops = _long_ops(rng, la), _long_ops(rng, lb)
    a = _pair(a_ops, 0)
    a_end = a[0].end_on_query
    if name == "offset":
        b = _pair(b_ops, int(rng.integers(1, a_end)))
    elif name == "contained":
        b = _pair(_long_ops(rng, max(a_end // 3, 100)), a_end // 3)
    elif name == "disjoint":
        b = _pair(b_ops, a_end + int(rng.integers(1, 500)))
    elif name == "touching":
        b = _pair(b_ops, a_end)
    elif name == "indels_only":
        b = _pair([("INSERTION", 7), ("DELETION", 3), ("INSERTION", 900)], a_end // 2)
    elif name == "one_run":
        b = _pair([("SEED" if seed % 2 else "MATCH", int(rng.integers(1, a_end)))],
                  int(rng.integers(0, a_end)))
    else:  # both one run
        a = _pair([("MATCH", 5_000)], 0)
        b = _pair([("SEED", 4_000)], int(rng.integers(0, 6_000)))
    return a, b


CASES = ["offset", "contained", "disjoint", "touching", "indels_only", "one_run",
         "both_one_run"]


@pytest.mark.parametrize("name,seed", [(n, s) for n in CASES for s in range(3)])
def test_overlap_equals_ma_tpu(name, seed):
    (ja, ta), (jb, tb) = _case(name, seed)
    for j1, t1, j2, t2 in ((ja, ta, jb, tb), (jb, tb, ja, ta), (ja, ta, ja, ta)):
        want = j1.overlap(j2)
        got = t1.overlap(t2)
        assert type(got) is type(want) and got == want, (name, seed)
    if name in ("disjoint", "touching"):
        assert ta.overlap(tb) == 0.0
    if name == "offset":
        assert 0.0 < ta.overlap(tb) < 1.0


def _read_alignments(rng, read_len, n):
    """`n` alignments of one read: a long primary-like one and others at
    random query offsets, some over it and some beside it, with random
    seed counts."""
    out = []
    for k in range(n):
        begin = 0 if k == 0 else int(rng.integers(0, read_len - 1_000))
        length = int(rng.integers(1_000, read_len - begin + 1))
        pair = _pair(_long_ops(rng, length), begin, int(rng.integers(0, 10**6)))
        for a in pair:
            a.stats.name = f"r{k}"
            a.stats.index_of_strip = k
            a.stats.num_seeds = a.num_seeds()
        out.append(pair)
    return [p[0] for p in out], [p[1] for p in out]


def _aln_fields(alns):
    return [(a.data, a.begin_on_ref, a.end_on_ref, a.begin_on_query, a.end_on_query,
             a.iscore, a.secondary, a.supplementary, repr(a.mapping_quality)) for a in alns]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("report_n", [0, 2])
def test_mapping_quality_pacbio_equals_ma_tpu(seed, report_n):
    rng = np.random.default_rng(100 + seed)
    read_len = int(rng.integers(3_000, 12_001))
    want, got = _read_alignments(rng, read_len, int(rng.integers(3, 9)))
    kw = dict(match=2, max_supplementary=100, report_n=report_n)
    want = j_mapq(want, read_len, **kw)
    got = t_mapq(got, read_len, **kw)
    assert got and _aln_fields(got) == _aln_fields(want)
