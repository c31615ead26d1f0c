"""Realistic synthetic genomes + read simulators.

A copy of ma_tpu/utils/simulate.py, changed only in its imports.

The BASELINE configs name real genomes (E. coli K-12, chr21, GRCh38); this
environment has no network access, so benchmark/parity workloads use
synthetic genomes with the structural features that make real genomes hard
(uniform-random sequence has none of them): dispersed repeat families
(transposon-like, 5-20% diverged copies), tandem repeats/microsatellites,
segmental duplications, low-complexity (dust) patches, and GC skew via a
first-order Markov chain. Read simulators cover Illumina-like (subs-
dominated) and PacBio/ONT-like (indel-dominated) error models.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class GenomeSpec:
    length: int
    n_repeat_families: int = 4
    repeat_fraction: float = 0.25  # fraction of genome covered by dispersed repeats
    repeat_len_range: Tuple[int, int] = (300, 3000)
    repeat_divergence: Tuple[float, float] = (0.05, 0.20)
    tandem_fraction: float = 0.02
    segdup_fraction: float = 0.05
    segdup_divergence: float = 0.02
    dust_fraction: float = 0.01
    gc_skew: float = 0.15  # Markov-chain GC bias amplitude


def _markov_sequence(n: int, rng: np.random.Generator, gc_skew: float) -> np.ndarray:
    """First-order Markov chain with a slowly varying GC bias."""
    # GC bias wanders sinusoidally along the genome (isochore-ish)
    pos = np.arange(n)
    gc = 0.5 + gc_skew * np.sin(2 * np.pi * pos / max(n / 7, 1e4))
    p_g_or_c = gc / 2.0
    p_a_or_t = (1 - gc) / 2.0
    probs = np.stack([p_a_or_t, p_g_or_c, p_g_or_c, p_a_or_t], axis=1)  # A C G T
    u = rng.random(n)[:, None]
    return (np.cumsum(probs, axis=1) < u).sum(axis=1).astype(np.uint8)


def _mutate(codes: np.ndarray, rate: float, rng: np.random.Generator) -> np.ndarray:
    out = codes.copy()
    hits = np.nonzero(rng.random(len(out)) < rate)[0]
    out[hits] = (out[hits] + rng.integers(1, 4, size=len(hits))) % 4
    return out


def simulate_genome(spec: GenomeSpec, seed: int = 0) -> np.ndarray:
    """Genome as uint8 base codes (0..3)."""
    rng = np.random.default_rng(seed)
    n = spec.length
    g = _markov_sequence(n, rng, spec.gc_skew)

    # dispersed repeat families (transposon-like)
    families = [
        _markov_sequence(int(rng.integers(*spec.repeat_len_range)), rng, 0.0)
        for _ in range(spec.n_repeat_families)
    ]
    covered = 0
    target = int(n * spec.repeat_fraction)
    while covered < target:
        fam = families[int(rng.integers(len(families)))]
        div = float(rng.uniform(*spec.repeat_divergence))
        copy = _mutate(fam, div, rng)
        if rng.random() < 0.5:  # half the copies on the reverse strand
            copy = (3 - copy)[::-1]
        # occasional truncation (fragmented elements)
        if rng.random() < 0.3:
            cut = int(rng.integers(len(copy) // 4, len(copy)))
            copy = copy[:cut]
        p = int(rng.integers(0, n - len(copy)))
        g[p : p + len(copy)] = copy
        covered += len(copy)

    # tandem repeats / microsatellites
    covered = 0
    target = int(n * spec.tandem_fraction)
    while covered < target:
        unit = rng.integers(0, 4, size=int(rng.integers(1, 7))).astype(np.uint8)
        reps = int(rng.integers(10, 120))
        arr = np.tile(unit, reps)
        arr = _mutate(arr, 0.02, rng)
        p = int(rng.integers(0, n - len(arr)))
        g[p : p + len(arr)] = arr
        covered += len(arr)

    # segmental duplications (large, low-divergence copies)
    covered = 0
    target = int(n * spec.segdup_fraction)
    while covered < target and n > 100_000:
        size = int(rng.integers(10_000, min(60_000, n // 10)))
        src = int(rng.integers(0, n - size))
        dst = int(rng.integers(0, n - size))
        g[dst : dst + size] = _mutate(g[src : src + size], spec.segdup_divergence, rng)
        covered += size

    # dust patches (homopolymers / AT runs)
    covered = 0
    target = int(n * spec.dust_fraction)
    while covered < target:
        size = int(rng.integers(30, 400))
        base = rng.integers(0, 4)
        arr = np.full(size, base, np.uint8)
        if rng.random() < 0.5:  # AT dinucleotide runs
            arr[::2] = 0
            arr[1::2] = 3
        p = int(rng.integers(0, n - size))
        g[p : p + size] = arr
        covered += size
    return g


def ecoli_like(seed: int = 0) -> np.ndarray:
    """4.6 Mbp, modest repeat content (IS-element-like families)."""
    return simulate_genome(
        GenomeSpec(length=4_600_000, repeat_fraction=0.08, segdup_fraction=0.01,
                   n_repeat_families=6, tandem_fraction=0.005), seed,
    )


def chr21_like(seed: int = 1) -> np.ndarray:
    """40 Mbp, human-like repeat load (~45% repeats, segdups, satellites)."""
    return simulate_genome(
        GenomeSpec(length=40_000_000, repeat_fraction=0.40, segdup_fraction=0.08,
                   n_repeat_families=12, tandem_fraction=0.04, dust_fraction=0.02),
        seed,
    )


def simulate_illumina(
    genome: np.ndarray, n_reads: int, read_len: int = 150,
    sub_rate: float = 0.004, indel_rate: float = 0.0002,
    seed: int = 0,
) -> Tuple[List[np.ndarray], List[Tuple[int, bool]]]:
    """Illumina-like reads: subs-dominated, rare 1bp indels.
    Returns (code arrays, [(true_pos, is_reverse)])."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    reads, truth = [], []
    for i in range(n_reads):
        p = int(rng.integers(0, G - read_len - 8))
        codes = genome[p : p + read_len + 8].copy()
        # indels first (on the template), then cut to length, then subs
        out = []
        j = 0
        while len(out) < read_len and j < len(codes):
            r = rng.random()
            if r < indel_rate:  # deletion in read
                j += 1
                continue
            if r < 2 * indel_rate:  # insertion in read
                out.append(int(rng.integers(0, 4)))
                continue
            out.append(int(codes[j]))
            j += 1
        arr = np.array(out[:read_len], np.uint8)
        hits = np.nonzero(rng.random(len(arr)) < sub_rate)[0]
        arr[hits] = (arr[hits] + rng.integers(1, 4, size=len(hits))) % 4
        rev = bool(i % 2)
        if rev:
            arr = (3 - arr)[::-1]
        reads.append(arr)
        truth.append((p, rev))
    return reads, truth


def simulate_long_reads(
    genome: np.ndarray, n_reads: int, mean_len: int = 8000,
    error_rate: float = 0.08, seed: int = 0,
) -> Tuple[List[np.ndarray], List[Tuple[int, bool]]]:
    """PacBio-CLR/ONT-like reads: errors split ~40% ins / 35% del / 25% sub
    (classic CLR profile), lognormal-ish lengths."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    reads, truth = [], []
    for i in range(n_reads):
        ln = int(np.clip(rng.lognormal(np.log(mean_len), 0.4), 500, G // 2))
        p = int(rng.integers(0, G - ln - 64))
        tmpl = genome[p : p + ln + 64]
        out = []
        j = 0
        while len(out) < ln and j < len(tmpl):
            r = rng.random()
            if r < error_rate * 0.40:
                out.append(int(rng.integers(0, 4)))  # insertion
                continue
            if r < error_rate * 0.75:
                j += 1  # deletion
                continue
            if r < error_rate:
                out.append(int((tmpl[j] + rng.integers(1, 4)) % 4))
                j += 1
                continue
            out.append(int(tmpl[j]))
            j += 1
        arr = np.array(out[:ln], np.uint8)
        rev = bool(i % 2)
        if rev:
            arr = (3 - arr)[::-1]
        reads.append(arr)
        truth.append((p, rev))
    return reads, truth


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 80) -> None:
    from ma_tpu_torch.containers.nucseq import decode_seq

    seq = decode_seq(codes)
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), width):
            f.write(seq[i : i + width] + "\n")


def write_fastq(path: str, reads, prefix: str = "r") -> None:
    from ma_tpu_torch.containers.nucseq import decode_seq

    with open(path, "w") as f:
        for i, codes in enumerate(reads):
            s = decode_seq(codes)
            f.write(f"@{prefix}{i}\n{s}\n+\n{'I' * len(s)}\n")
