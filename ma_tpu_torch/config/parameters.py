"""Reflection-based configuration system.

Re-design of the reference's parameter subsystem
(reference: libs/ms/inc/ms/util/parameter.h:54-1204): typed parameters with
name / shorthand / description / category / range check, presets
(Default / Illumina / Illumina Paired / PacBio / Nanopore / SV-Illumina /
SV-PacBio, parameter.h:1067-1135), and a manager with lookup by normalized
name or short flag. CLI help and flag parsing are generated from this
registry (like cmdMa.cpp:107-238).

Parameter names and default values mirror the reference exactly
(parameter.h:615-912 for the per-preset set, :1014-1046 for the global DP
scoring set) so that `maCMD`-style flags keep working.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional

CATEGORIES = [
    "General",
    "Dynamic Programming",
    "Paired Reads",
    "Seeding",
    "Strip of Consideration",
    "SAM Output",
    "SV Parameters",
    "Heuristics",
    "Minimizers",
]


def normalize(name: str) -> str:
    """Lowercase, non-alnum -> underscore (ParameterSetBase::uniqueParameterName)."""
    return re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")


@dataclasses.dataclass
class Parameter:
    name: str
    default: Any
    description: str = ""
    category: str = "General"
    short: Optional[str] = None
    choices: Optional[List[str]] = None
    check: Optional[Callable[[Any], bool]] = None
    value: Any = None

    def __post_init__(self):
        if self.value is None:
            self.value = self.default

    def get(self):
        return self.value

    def set(self, v):
        t = type(self.default)
        if t is bool and isinstance(v, str):
            v = v.lower() in ("1", "true", "yes", "on")
        elif t in (int, float):
            v = t(v)
        if self.choices is not None and v not in self.choices:
            if isinstance(v, int) and 0 <= v < len(self.choices):
                v = self.choices[v]
            else:
                raise ValueError(f"{self.name}: {v!r} not in {self.choices}")
        if self.check is not None and not self.check(v):
            raise ValueError(f"{self.name}: value {v!r} out of range")
        self.value = v


def positive(v) -> bool:
    return v >= 0


class ParameterSet:
    """One preset: the full aligner parameter set (Presetting, parameter.h:521)."""

    def __init__(self, name: str = "Unnamed"):
        self.name = name
        self.by_name: Dict[str, Parameter] = {}
        self.by_short: Dict[str, Parameter] = {}
        P = self._add

        # --- General / global (parameter.h:1014-1046; cmdMa -t)
        # On TPU the device batch is the parallel axis; this sizes the host
        # worker side (IO + CIGAR assembly) and is otherwise advisory.
        P("Number of Threads", 0, "Number of host worker threads (0 = auto).", "General", short="t", check=positive)

        # --- Dynamic Programming (parameter.h:621-648)
        P("Padding", 1000, "Max length of DP extension towards read endpoints.", "Dynamic Programming", check=positive)
        P("Bandwidth for Extensions", 512, "DP bandwidth for endpoint extensions.", "Dynamic Programming", check=positive)
        P("Minimal Bandwidth in Gaps", 20, "Minimal DP bandwidth when filling gaps between seeds.", "Dynamic Programming", check=positive)
        P("Z Drop", 200, "Stop DP extension if the score drops faster than this.", "Dynamic Programming", check=positive)
        P("Detect Small Inversions", False, "Use DP to search for small inversions.", "Dynamic Programming")
        P("Z Drop Inversions", 100, "Z-drop threshold for inversion detection.", "Dynamic Programming", check=positive)

        # --- Paired reads (parameter.h:650-669)
        P("Use Paired Reads", False, "Enable paired-read mode.", "Paired Reads")
        P("Mean Distance of Paired Reads", 400.0, "Expected insert size.", "Paired Reads", short="d")
        P("Standard Deviation of Paired Reads", 150.0, "Insert size standard deviation.", "Paired Reads", short="S", check=positive)
        P("Score Factor for Paired Reads", 1.25, "Multiplier on scores of successfully paired reads.", "Paired Reads", check=positive)

        # --- Seeding (parameter.h:671-705)
        P("Seeding Technique", "maxSpan", "Initial seeding technique.", "Seeding", short="s", choices=["maxSpan", "SMEMs", "MEMs", "minimizers"])
        P("Minimal Seed Length", 16, "Discard seeds shorter than this.", "Seeding", short="l", check=positive)
        P("Minimal Ambiguity", 0, "Keep extending while occurrence count is above this.", "Seeding", check=positive)
        P("Maximal Ambiguity", 100, "Discard seeds occurring more often than this (0=disable).", "Seeding", check=positive)
        P("Skip Ambiguous Seeds", False, "Discard (rather than sample) over-ambiguous seeds.", "Seeding")
        P("Seeding Drop-off A - Minimal Seed Size", 15, "Read drop-off: minimal seed size A.", "Seeding", check=positive)
        P("Seeding Drop-off B - Factor", 0.005, "Read drop-off factor B.", "Seeding", check=positive)

        # --- SoC (parameter.h:707-724)
        P("Maximal Number of SoCs", 30, "Consider only the best N SoCs (0=all).", "Strip of Consideration", short="N", check=positive)
        P("Minimal Number of SoCs", 1, "Always consider at least N SoCs.", "Strip of Consideration", short="M", check=positive)
        P("Fixed SoC Width", 0, "Fixed SoC width (0 = formula from paper).", "Strip of Consideration", check=positive)
        P("Rectangular SoC", True, "Rectangular vs parallelogram SoC shape.", "Strip of Consideration")

        # --- SAM (parameter.h:726-760)
        P("Maximal Number of Reported Alignments", 0, "Max alignments to output (0=unlimited).", "SAM Output", short="n", check=positive)
        P("Minimal Alignment Score", 75, "Suppress alignments scoring below this.", "SAM Output")
        P("Omit Secondary Alignments", False, "Suppress secondary alignments.", "SAM Output")
        P("Omit Supplementary Alignments", False, "Suppress supplementary alignments.", "SAM Output")
        P("Maximal Supplementary Overlap", 0.1, "Query-overlap fraction below which non-primary is supplementary.", "SAM Output", check=positive)
        P("Number Supplementary Alignments", 1, "Max supplementary alignments per primary.", "SAM Output", check=positive)
        P("Emulate NGMLR's tag output", False, "Emit NGMLR-style SAM tags (for Sniffles).", "SAM Output")
        P("Use M in CIGAR", True, "Use M ops instead of =/X in CIGARs.", "SAM Output")
        P("Output long cigars in CG tag", True, "Move >65536-op CIGARs into the CG:B:I tag.", "SAM Output")
        P("Soft clip", False, "Output full query sequence with soft clipping.", "SAM Output")

        # --- SV (parameter.h:762-830)
        P("Maximal distance between clusters", 200, "Max delta distance within a cluster.", "SV Parameters", check=positive)
        P("re seeding padding", 100, "Padding for reseeding rectangles.", "SV Parameters", check=positive)
        P("Minimal Seed Size SV", 18, "Minimal seed size for the SV caller.", "SV Parameters", check=positive)
        P("Maximal Ambiguity SV", 10000, "Max seed ambiguity for the SV caller.", "SV Parameters", check=positive)
        P("Do Dummy Jumps", True, "Compute edges connecting to the sentinel vertex.", "SV Parameters")
        P("Minimal Dummy Distance", 50, "Min distance of dummy-jump seeds from read ends.", "SV Parameters", check=positive)
        P("Maximal Dummy Distance", 60, "Max distance of dummy-jump seeds from read ends.", "SV Parameters", check=positive)
        P("Paired Mate - Mate Pair", True, "Reverse-complement mates on insertion.", "SV Parameters")
        P("Max Size Reseed", 50, "Max width/height of reseeding rectangles.", "SV Parameters", check=positive)
        P("Min Size Edge", 0, "Discard matrix entries closer than this.", "SV Parameters", check=positive)
        P("Max Size Edge", 0, "Discard matrix entries further apart than this (0=off).", "SV Parameters", check=positive)
        P("Max Fuzziness Filter", 50, "Max fuzziness for SV calls.", "SV Parameters", check=positive)
        P("Max Supp Nt", 10, "Short-call low-support filter: max supporting nt.", "SV Parameters", check=positive)
        P("Max Call Size Filter", 20, "Short-call low-support filter: max call size.", "SV Parameters", check=positive)
        P("Max Ref Ambiguity Jump", 10, "Max reference ambiguity for jumps.", "SV Parameters", check=positive)
        P("Max Occ MM Filter", 200, "Max k-mer occurrences during read filtering.", "SV Parameters", check=positive)
        P("Min NT in SoC", 150, "Discard SoCs with less accumulated seed nt (before reseeding).", "SV Parameters", check=positive)
        P("Min NT after reseeding", 100, "Discard SoCs with less accumulated seed nt (after reseeding).", "SV Parameters", check=positive)
        P("Min Reads in call", 2, "Keep SV calls supported by at least this many reads.", "SV Parameters", check=positive)

        # --- Heuristics (parameter.h:832-885)
        P("SoC Score Drop-off", 0.1, "Stop harmonizing SoCs scoring below frac*max.", "Heuristics", check=positive)
        P("Minimal Harmonization Score", 18, "Discard harmonized SoCs scoring below this.", "Heuristics", check=positive)
        P("Relative Minimal Harmonization Score", 0.002, "Discard harmonized SoCs scoring below len(read)*this.", "Heuristics", check=positive)
        P("Harmonization Drop-off A - Score Difference", 0.0001, "Score-difference tolerance for harmonization drop-off.", "Heuristics", check=positive)
        P("Harmonization Drop-off B - Lookahead", 3, "Lookahead count for harmonization drop-off.", "Heuristics", check=positive)
        P("Harmonization Score Drop-off - Minimal Query Length", 800, "Read length above which low-scoring SoCs are skipped.", "Heuristics", check=positive)
        P("Artifact Filter A - Maximal Delta Distance", 0.1, "Delta-distance artifact filter fraction.", "Heuristics", check=positive)
        P("Artifact Filter B - Minimal Delta Distance", 16, "Delta-distance artifact filter minimum.", "Heuristics", check=positive)
        P("Pick Local Seed Set A - Enabled", False, "Enable local seed-set computation.", "Heuristics")
        P("Pick Local Seed Set B - Optimistic Gap Estimation", True, "Optimistic vs pessimistic gap cost estimate.", "Heuristics")
        P("Maximal Gap Size", 20, "Gaps larger than this use dual z-drop extension.", "Heuristics", check=positive)
        P("Minimum Genome Size for Heuristics", 10000000, "Disable drop-off heuristics below this genome size.", "Heuristics", check=positive)
        P("Disable All Heuristics", False, "Disable all runtime heuristics.", "Heuristics")

        # --- Minimizers (parameter.h:886-891)
        P("Minimizers - k", 15, "Minimizer k-mer size.", "Minimizers")
        P("Minimizers - w", 10, "Minimizer window size.", "Minimizers")
        P("Minimizers - flag", 0, "Minimizer flags.", "Minimizers")
        P("Minimizers - bucket_bits", 14, "Minimizer index bucket bits.", "Minimizers")
        P("Minimizers - mini_batch_size", 50000000, "Minimizer mini batch size.", "Minimizers")
        P("Minimizers - batch_size", 4000000000, "Minimizer batch size.", "Minimizers")
        # the reference hardcodes sdust_thres = 0 (minimizer_index.h:73 —
        # masking disabled); exposed here so SDUST (ops/sdust.py) is
        # reachable from the config for repeat-heavy real genomes
        P("Minimizers - SDUST Threshold", 0,
          "SDUST low-complexity masking threshold for minimizer queries "
          "(0 = off, the reference's hardcoded setting; typical: 20).",
          "Minimizers")

        # --- Global DP scoring (GlobalParameter, parameter.h:1014-1046).
        # Kept per-set here for simplicity; values are shared via presets.
        P("Match Score", 2, "Match score (DP and SoC width).", "Dynamic Programming", check=positive)
        P("Mismatch Penalty", 4, "Mismatch penalty.", "Dynamic Programming", check=positive)
        P("Gap penalty", 4, "First gap-open penalty (2-piece affine).", "Dynamic Programming", check=positive)
        P("Extend Penalty", 2, "First gap-extend penalty.", "Dynamic Programming", check=positive)
        P("Second Gap Penalty", 24, "Second gap-open penalty.", "Dynamic Programming", check=positive)
        P("Second Extend Penalty", 1, "Second gap-extend penalty.", "Dynamic Programming", check=positive)
        P("Pick Local Seed Set C - Maximal Gap Penalty", 100, "Max gap penalty in local seed-set computation.", "Heuristics", check=positive)
        P("fuzziness-s", 200.0, "Max fuzziness for SV entries.", "SV Parameters")
        P("fuzziness-s-neg", 200.0, "Max fuzziness for SV entries (negative direction).", "SV Parameters")
        P("fuzziness-m", 0.5, "Fuzziness slope.", "SV Parameters")
        P("fuzziness-h", 25.0, "Fuzziness zero-point.", "SV Parameters")
        P("Seed Dir Fuzziness", 3, "Absolute fuzziness in seed direction.", "SV Parameters", check=positive)

    def _add(self, name, default, description="", category="General", short=None, choices=None, check=None):
        p = Parameter(name=name, default=default, description=description, category=category,
                      short=short, choices=choices, check=check)
        self.by_name[normalize(name)] = p
        if short is not None:
            self.by_short[short] = p
        return p

    def __getitem__(self, name: str) -> Parameter:
        return self.by_name[normalize(name)]

    def get(self, name: str):
        return self[name].get()

    def set(self, name: str, value):
        self[name].set(value)

    def clone(self, name: str) -> "ParameterSet":
        c = ParameterSet(name)
        for k, p in self.by_name.items():
            c.by_name[k].value = p.value
        return c


def default_presets() -> Dict[str, ParameterSet]:
    """The seven built-in presets (parameter.h:1079-1133)."""
    sets: Dict[str, ParameterSet] = {}
    sets["default"] = ParameterSet("Default")

    s = ParameterSet("Illumina")
    s.set("Seeding Technique", "SMEMs")
    s.set("Maximal Ambiguity", 500)
    s.set("Minimal Number of SoCs", 10)
    s.set("Maximal Number of SoCs", 20)
    sets["illumina"] = s

    s = s.clone("Illumina Paired")
    s.set("Use Paired Reads", True)
    sets["illuminapaired"] = s

    s = ParameterSet("PacBio")
    s.set("Number Supplementary Alignments", 100)
    s.set("Minimal Number of SoCs", 5)
    sets["pacbio"] = s

    s = ParameterSet("Nanopore")
    s.set("Seeding Technique", "SMEMs")
    s.set("Number Supplementary Alignments", 100)
    s.set("Minimal Number of SoCs", 5)
    sets["nanopore"] = s

    s = ParameterSet("SV-Illumina")
    s.set("Maximal Ambiguity", 1)
    s.set("Min NT in SoC", 25)
    s.set("Rectangular SoC", False)
    s.set("Do Dummy Jumps", False)
    s.set("Relative Minimal Harmonization Score", 0)
    s.set("Min Reads in call", 10)
    s.set("Minimal Harmonization Score", 25)
    s.set("Max Size Edge", 200)
    sets["sv-illumina"] = s

    s = ParameterSet("SV-PacBio")
    s.set("Fixed SoC Width", 3000)
    s.set("Max Size Reseed", 1000)
    s.set("Maximal Ambiguity", 1)
    s.set("Min Size Edge", 200)
    s.set("Min NT in SoC", 25)
    s.set("Min NT after reseeding", 600)
    s.set("Rectangular SoC", False)
    s.set("Relative Minimal Harmonization Score", 0)
    s.set("Minimal Harmonization Score", 25)
    sets["sv-pacbio"] = s
    return sets


class ParameterSetManager:
    """Holds all presets + the selected one (parameter.h:1067-1204)."""

    def __init__(self):
        self.sets = default_presets()
        self.selected = self.sets["default"]

    def set_selected(self, key: str):
        k = normalize(key)
        if k not in self.sets:
            raise KeyError(f"The presetting '{key}' can not be found.")
        self.selected = self.sets[k]

    def get(self, key: str) -> ParameterSet:
        return self.sets[normalize(key)]

    def by_name(self, name: str) -> Parameter:
        return self.selected[name]
