"""Packed reference collection.

TPU-native re-design of the reference Pack container
(reference: libs/ma/inc/ma/container/pack.h:39-1580): a collection of contigs
concatenated on the forward strand, with the coordinate convention

    positions p in [0, 2L):  p <  L  -> forward strand
                             p >= L  -> reverse strand (folded)

where L = unpacked_size_forward_strand (pack.h:816-931).

Host representation is a plain uint8 code array (fast numpy slicing); the
2-bit packed form used by the FM-index build lives in ma_tpu_torch/index/.
N runs ("holes", pack.h hole records) are tracked so bridging/ambiguous
regions can be filtered.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Sequence, Tuple

import numpy as np

from ma_tpu_torch.containers.nucseq import NucSeq, encode_seq, revcomp_codes


@dataclasses.dataclass
class Pack:
    codes: np.ndarray  # [L] uint8 forward-strand codes (0..3; 4 only inside holes)
    names: List[str]
    starts: np.ndarray  # [C] int64 contig start offsets (forward coords)
    lengths: np.ndarray  # [C] int64 contig lengths
    holes: List[Tuple[int, int]]  # (start, end) N runs in forward coords

    # ------------------------------------------------------------------ build
    @classmethod
    def empty(cls) -> "Pack":
        return cls(
            codes=np.zeros(0, dtype=np.uint8),
            names=[],
            starts=np.zeros(0, dtype=np.int64),
            lengths=np.zeros(0, dtype=np.int64),
            holes=[],
        )

    def append(self, name: str, codes: np.ndarray) -> None:
        """Append a contig (mirrors Pack::vAppendSequence, pack.h:600-700)."""
        codes = np.asarray(codes, dtype=np.uint8)
        start = int(self.codes.shape[0])
        # record N runs as holes
        is_n = codes >= 4
        if is_n.any():
            d = np.diff(np.concatenate(([0], is_n.view(np.int8), [0])))
            for s, e in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
                self.holes.append((start + int(s), start + int(e)))
        self.codes = np.concatenate([self.codes, codes])
        self.names.append(name)
        self.starts = np.concatenate([self.starts, [start]]).astype(np.int64)
        self.lengths = np.concatenate([self.lengths, [len(codes)]]).astype(np.int64)

    @classmethod
    def from_contigs(cls, contigs: Sequence[Tuple[str, str]]) -> "Pack":
        p = cls.empty()
        for name, seq in contigs:
            p.append(name, encode_seq(seq))
        return p

    @classmethod
    def from_fasta(cls, path: str) -> "Pack":
        from ma_tpu_torch.io.fasta import read_fasta

        p = cls.empty()
        for rec in read_fasta(path):
            p.append(rec.name, rec.codes)
        return p

    # ----------------------------------------------------------- coordinates
    @property
    def unpacked_size_forward_strand(self) -> int:
        return int(self.codes.shape[0])

    @property
    def unpacked_size_forward_plus_reverse(self) -> int:
        # pack.h:493
        return 2 * self.unpacked_size_forward_strand

    @property
    def start_of_reverse_strand(self) -> int:
        # pack.h:816-818
        return self.unpacked_size_forward_strand

    @property
    def num_contigs(self) -> int:
        return len(self.names)

    def is_reverse_strand(self, pos) -> np.ndarray | bool:
        # pack.h:900-902
        return pos >= self.start_of_reverse_strand

    def absolute_position(self, pos):
        """Fold a [0,2L) position to forward coords (pack.h:909-914)."""
        L2 = self.unpacked_size_forward_plus_reverse
        return np.where(
            np.asarray(pos) >= self.start_of_reverse_strand, L2 - (np.asarray(pos) + 1), pos
        )

    def pos_to_reverse_strand(self, pos):
        """Mirror a position across the strand border (pack.h:924)."""
        return self.unpacked_size_forward_plus_reverse - np.asarray(pos) - 1

    def seq_id_for_position(self, pos) -> np.ndarray:
        """Contig id for [0,2L) positions (pack.h:933-945)."""
        abs_pos = self.absolute_position(np.asarray(pos, dtype=np.int64))
        return np.searchsorted(self.starts, abs_pos, side="right") - 1

    # scalar fast path: numpy scalar ops cost ~5 us each, which dominated
    # SAM emission at ~35 us/record — plain ints + bisect are ~0.3 us
    @property
    def _py(self):
        """(L, starts list) with python ints, cached."""
        c = getattr(self, "_py_cache", None)
        if c is None or c[2] is not self.starts:
            c = (int(self.codes.shape[0]), self.starts.tolist(), self.starts)
            self._py_cache = c
        return c

    def seq_id_py(self, pos: int) -> int:
        import bisect

        L, starts, _ = self._py
        abs_pos = 2 * L - pos - 1 if pos >= L else pos
        return bisect.bisect_right(starts, abs_pos) - 1

    def pos_in_contig(self, pos) -> np.ndarray:
        """0-based offset within the owning contig, forward coords."""
        abs_pos = self.absolute_position(np.asarray(pos, dtype=np.int64))
        return abs_pos - self.starts[self.seq_id_for_position(pos)]

    def bridging(self, begin: int, end: int) -> bool:
        """True iff [begin,end) crosses a contig boundary or the strand border
        (pack.h:1004-1014)."""
        if end <= begin:
            return False
        if end > self.unpacked_size_forward_plus_reverse:
            return True
        if self.is_reverse_strand(begin) != self.is_reverse_strand(end - 1):
            return True
        return bool(self.seq_id_for_position(begin) != self.seq_id_for_position(end - 1))

    # ---------------------------------------------------------------- extract
    def extract(self, begin: int, end: int) -> np.ndarray:
        """Extract codes for [begin,end) in the [0,2L) coordinate space.

        Reverse-strand ranges return the reverse complement of the mirrored
        forward range (pack.h vExtract semantics).
        """
        L = self.unpacked_size_forward_strand
        if begin < 0 or end > 2 * L or end < begin:
            raise IndexError(f"extract [{begin},{end}) out of range [0,{2*L})")
        if end <= L:
            return self.codes[begin:end].copy()
        if begin >= L:
            fb = 2 * L - end
            fe = 2 * L - begin
            return revcomp_codes(self.codes[fb:fe])
        raise ValueError("extract range bridges the strand border")

    def contig_codes(self, i: int) -> np.ndarray:
        s = int(self.starts[i])
        return self.codes[s : s + int(self.lengths[i])]

    def extract_contig(self, i: int) -> NucSeq:
        return NucSeq(self.contig_codes(i), name=self.names[i])

    # ------------------------------------------------------------------- I/O
    def store(self, prefix: str) -> None:
        """Persist as <prefix>.pack.npz + <prefix>.json manifest.

        Same role as Pack::vStoreCollection (pack.h:725) and the genome JSON
        manifest (execution-context.h:96-102); format is ours.
        """
        np.savez_compressed(
            prefix + ".pack.npz",
            codes=self.codes,
            starts=self.starts,
            lengths=self.lengths,
            holes=np.asarray(self.holes, dtype=np.int64).reshape(-1, 2),
        )
        with open(prefix + ".json", "w") as f:
            json.dump(
                {"type": "MA-TPU Genome", "version": 1, "names": self.names, "prefix": os.path.basename(prefix)},
                f,
            )

    @classmethod
    def load(cls, prefix: str) -> "Pack":
        with open(prefix + ".json") as f:
            manifest = json.load(f)
        z = np.load(prefix + ".pack.npz")
        return cls(
            codes=z["codes"],
            names=list(manifest["names"]),
            starts=z["starts"],
            lengths=z["lengths"],
            holes=[(int(s), int(e)) for s, e in z["holes"]],
        )
