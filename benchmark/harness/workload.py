"""The genome, the donor and the reads of a cell, all drawn from the seed.

One general generator reads a configuration's `genome` block and a traffic
file's parameters (lengths, error rates, donor variants, inversions,
strands, random reads). Everything is vectorised numpy; the same seed gives
the same arrays. The truth of every read (the genome position of each of
its bases, its strand, its planted inversion) is kept for the placement
metric and for the reference's comparison.
"""
from __future__ import annotations

import dataclasses

import numpy as np

COMPLEMENT = np.array([3, 2, 1, 0, 4], np.uint8)
KIND_GENOME, KIND_RANDOM = 0, 1


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes[::-1]]


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per purpose, so that adding draws to one
    stream never moves another."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF] + list(stream.encode())
    return np.random.default_rng(words)


@dataclasses.dataclass
class Genome:
    name: str
    codes: np.ndarray  # uint8 [G], forward strand, 0..3
    # planted repeat copies: [K, 4] int64 rows (family, start, length, strand)
    copies: np.ndarray


def _substitute(codes: np.ndarray, rate: float, rng) -> None:
    hit = np.flatnonzero(rng.random(len(codes)) < rate)
    codes[hit] = (codes[hit] + rng.integers(1, 4, len(hit), dtype=np.uint8)) % 4


def make_genome(spec: dict, seed: int) -> Genome:
    """A uniform random genome of `length` bases with repeat families
    planted at non-overlapping places: each group of `spec["repeats"]` has
    `families` consensus sequences of `min_len`..`max_len` bases and
    `copies` copies spread over them, each copy substituted at `divergence`
    from its consensus. The layout (family lengths, where each copy lies
    and on which strand) is the same for every seed; the bases are the
    seed's."""
    rng = rng_for(seed, "genome")
    layout = rng_for(0, "genome layout")
    G = int(spec["length"])
    codes = rng.integers(0, 4, G, dtype=np.uint8)
    fams, fam_div, copy_fam = [], [], []
    for grp in spec.get("repeats", []):
        lens = layout.integers(int(grp["min_len"]), int(grp["max_len"]) + 1,
                               int(grp["families"]))
        base = len(fams)
        for L in lens:
            fams.append(rng.integers(0, 4, int(L), dtype=np.uint8))
            fam_div.append(float(grp["divergence"]))
        copy_fam += [base + k % int(grp["families"]) for k in range(int(grp["copies"]))]
    n = len(copy_fam)
    rows = np.zeros((n, 4), np.int64)
    if n:
        slot = G // n
        if slot <= max(len(f) for f in fams):
            raise ValueError("the genome is too short for its planted copies")
        order = layout.permutation(n)
        for s, k in enumerate(order):
            f = copy_fam[k]
            c = fams[f].copy()
            _substitute(c, fam_div[f], rng)
            strand = int(layout.integers(0, 2))
            if strand:
                c = revcomp(c)
            start = s * slot + int(layout.integers(0, slot - len(c)))
            codes[start : start + len(c)] = c
            rows[s] = (f, start, len(c), strand)
    return Genome(name=str(spec.get("contig", "chr")), codes=codes, copies=rows)


def make_donor(genome: Genome, spec: dict | None, seed: int):
    """The donor the reads come from: the genome with SNPs at `snp_rate`
    and indels of `indel_len` bases at `indel_rate` (half insertions).
    Returns (donor codes, genome position of each donor base); an inserted
    base maps to the genome base it follows."""
    G = len(genome.codes)
    if not spec:
        return genome.codes, np.arange(G, dtype=np.int64)
    rng = rng_for(seed, "donor")
    donor = genome.codes.copy()
    _substitute(donor, float(spec["snp_rate"]), rng)
    n_ev = int(rng.binomial(G, float(spec["indel_rate"])))
    pos = np.sort(rng.choice(G - 16, n_ev, replace=False))
    lo, hi = spec["indel_len"]
    lens = rng.integers(int(lo), int(hi) + 1, n_ev)
    is_ins = rng.random(n_ev) < 0.5
    diff = np.zeros(G + 1, np.int64)
    np.add.at(diff, pos[~is_ins], 1)
    np.add.at(diff, pos[~is_ins] + lens[~is_ins], -1)
    deleted = np.cumsum(diff[:G]) > 0
    counts = np.ones(G, np.int64)
    np.add.at(counts, pos[is_ins], lens[is_ins])
    counts[deleted] = 0
    dmap = np.repeat(np.arange(G, dtype=np.int64), counts)
    out = np.repeat(donor, counts)
    inserted = np.concatenate(([False], dmap[1:] == dmap[:-1]))
    out[inserted] = rng.integers(0, 4, int(inserted.sum()), dtype=np.uint8)
    return out, dmap


@dataclasses.dataclass
class Pool:
    """The reads of a run, in stream order. `fwd` holds each read as it lies
    on the forward strand (`tpos`: the genome position of each base), `seq`
    as the aligner gets it (reverse complemented where `strand` is 1)."""

    fwd: np.ndarray  # uint8, all reads concatenated
    seq: np.ndarray  # uint8, all reads concatenated, read orientation
    tpos: np.ndarray  # int64, genome position of each forward base (-1: random read)
    off: np.ndarray  # int64 [n + 1]
    strand: np.ndarray  # int8 [n]
    kind: np.ndarray  # int8 [n]: KIND_GENOME or KIND_RANDOM
    inv: np.ndarray  # int64 [n]: start of the inverted stretch in fwd, or -1
    inv_len: int

    def __len__(self) -> int:
        return len(self.strand)

    @property
    def lens(self) -> np.ndarray:
        return np.diff(self.off)

    def fwd_of(self, i: int) -> np.ndarray:
        return self.fwd[self.off[i] : self.off[i + 1]]

    def seq_of(self, i: int) -> np.ndarray:
        return self.seq[self.off[i] : self.off[i + 1]]

    def tpos_of(self, i: int) -> np.ndarray:
        return self.tpos[self.off[i] : self.off[i + 1]]

    def ref_span(self) -> tuple:
        """(first, last) genome position of each read's forward bases."""
        lo = np.minimum.reduceat(self.tpos, self.off[:-1])
        hi = np.maximum.reduceat(self.tpos, self.off[:-1])
        return lo, hi


def read_lengths(spec: dict, n: int) -> np.ndarray:
    """`fixed` bases each, or log-normal (`median`, `sigma`) clipped to
    [`min`, `max`]: the n quantiles at (i + 1/2) / n, in one order that no
    seed changes."""
    if "fixed" in spec:
        return np.full(n, int(spec["fixed"]), np.int64)
    from statistics import NormalDist

    med, sigma = float(spec["median"]), float(spec["sigma"])
    z = np.asarray([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    L = np.clip(np.rint(med * np.exp(sigma * z)), int(spec["min"]), int(spec["max"]))
    return rng_for(0, "lengths").permutation(L.astype(np.int64))


def _segments(lengths: np.ndarray):
    off = np.concatenate(([0], np.cumsum(lengths)))
    within = np.arange(off[-1]) - np.repeat(off[:-1], lengths)
    return off, within


def make_pool(genome: Genome, traffic: dict, seed: int, chunk_bases: int = 1 << 22) -> Pool:
    """`traffic["pool_reads"]` reads drawn from the donor by the traffic's
    lengths, error model, inversions, strands and random-read share."""
    donor, dmap = make_donor(genome, traffic.get("donor"), seed)
    rng = rng_for(seed, "reads")
    n = int(traffic["pool_reads"])
    err = traffic["errors"]
    p_sub, p_ins, p_del = float(err["substitution"]), float(err["insertion"]), float(err["deletion"])
    inv = traffic.get("inversion") or {}
    inv_len, inv_every = int(inv.get("length", 0)), int(inv.get("every", 0))
    # where each read starts, how long it is and whether it is random are
    # the same for every seed (evenly spread over the donor, in one fixed
    # order): the seed draws the bases, errors and strands, so that every
    # seed's window meets the planted repeats alike
    layout = rng_for(0, "read layout")
    lengths = read_lengths(traffic["length"], n)
    kind = np.where(layout.random(n) < float(traffic.get("random_share", 0.0)),
                    KIND_RANDOM, KIND_GENOME).astype(np.int8)
    slot_of = layout.permutation(n)
    strand = (rng.random(n) < float(traffic["reverse_share"])).astype(np.int8)
    fwd_parts, tpos_parts = [], []
    D = len(donor)
    chunk = max(1, chunk_bases // int(lengths.mean() * 1.2 + 64))
    for c0 in range(0, n, chunk):
        L = lengths[c0 : c0 + chunk]
        # a template long enough that the emitted bases cover the read
        T = L if p_ins == p_del == 0 else np.ceil(L * (1.1 + p_del) + 64).astype(np.int64)
        start = ((slot_of[c0 : c0 + chunk] + 0.5) / n * (D - T)).astype(np.int64)
        toff, within = _segments(T)
        src = np.repeat(start, T) + within
        u = rng.random(len(src))
        is_del = u < p_del
        is_ins = (u >= p_del) & (u < p_del + p_ins)
        is_sub = (u >= p_del + p_ins) & (u < p_del + p_ins + p_sub)
        base = donor[src].copy()
        base[is_sub] = (base[is_sub] + rng.integers(1, 4, int(is_sub.sum()), dtype=np.uint8)) % 4
        counts = np.where(is_del, 0, np.where(is_ins, 2, 1))
        emit = np.repeat(np.arange(len(src)), counts)
        codes = base[emit]
        first = np.concatenate(([True], emit[1:] != emit[:-1]))
        # an insertion emits a random base before its template base
        ins_base = is_ins[emit] & first
        codes[ins_base] = rng.integers(0, 4, int(ins_base.sum()), dtype=np.uint8)
        tp = dmap[src[emit]]
        read_of = np.repeat(np.arange(len(L)), T)[emit]
        eoff = np.searchsorted(read_of, np.arange(len(L) + 1))
        keep = (np.arange(len(emit)) - eoff[read_of]) < L[read_of]
        got = np.bincount(read_of[keep], minlength=len(L))
        if (got < L).any():
            raise ValueError("a template ran short of its read length")
        codes, tp = codes[keep], tp[keep]
        off, within = _segments(L)
        rk = kind[c0 : c0 + chunk]
        rand = np.repeat(rk == KIND_RANDOM, L)
        codes[rand] = rng.integers(0, 4, int(rand.sum()), dtype=np.uint8)
        tp[rand] = -1
        if inv_len and inv_every:
            for k in range(len(L)):
                i = c0 + k
                if i % inv_every == 0 and rk[k] == KIND_GENOME and L[k] >= 4 * inv_len:
                    m = off[k] + L[k] // 2
                    codes[m : m + inv_len] = revcomp(codes[m : m + inv_len])
                    tp[m : m + inv_len] = tp[m : m + inv_len][::-1].copy()
        fwd_parts.append(codes)
        tpos_parts.append(tp)
    fwd = np.concatenate(fwd_parts)
    tpos = np.concatenate(tpos_parts)
    off = np.concatenate(([0], np.cumsum(lengths)))
    inv_start = np.full(n, -1, np.int64)
    if inv_len and inv_every:
        sel = (np.arange(n) % inv_every == 0) & (kind == KIND_GENOME) & (lengths >= 4 * inv_len)
        inv_start[sel] = lengths[sel] // 2
    # read orientation: reverse-strand reads reverse complemented
    within = np.arange(off[-1]) - np.repeat(off[:-1], lengths)
    rev = np.repeat(strand == 1, lengths)
    src = np.where(rev, np.repeat(off[1:], lengths) - 1 - within, np.arange(off[-1]))
    seq = fwd[src]
    seq[rev] = COMPLEMENT[seq[rev]]
    return Pool(fwd=fwd, seq=seq, tpos=tpos, off=off, strand=strand, kind=kind,
                inv=inv_start, inv_len=inv_len)


def copy_of(genome: Genome, lo: np.ndarray, hi: np.ndarray):
    """For reads spanning genome positions [lo, hi]: the planted copy that
    holds the whole span (-1 if none), and whether the span touches any copy."""
    cp = genome.copies
    if not len(cp):
        z = np.full(len(lo), -1, np.int64)
        return z, np.zeros(len(lo), bool)
    order = np.argsort(cp[:, 1])
    starts, ends = cp[order, 1], cp[order, 1] + cp[order, 2]
    k = np.searchsorted(starts, hi, side="right") - 1  # last copy starting at or before hi
    kk = np.clip(k, 0, len(starts) - 1)
    touches = (k >= 0) & (ends[kk] > lo)
    inside = touches & (starts[kk] <= lo) & (ends[kk] > hi)
    return np.where(inside, order[kk], -1), touches


def parse_name(name: str, n_pool: int, handed_out: int):
    """The pool index of a read name the stream handed out (`r<i>`, or
    `r<i>.<c>` on its c-th pass), or None for any other name."""
    if not name.startswith("r"):
        return None
    head, _, cyc = name[1:].partition(".")
    if not head.isdigit() or (cyc and not cyc.isdigit()):
        return None
    i, c = int(head), int(cyc or 0)
    if i >= n_pool or c * n_pool + i >= handed_out or (cyc and c == 0):
        return None
    return i
