"""ma_tpu_torch — the PyTorch/CUDA port of ma_tpu for one NVIDIA H100.

The JAX package `ma_tpu` stays the reference; every module here mirrors its
counterpart there (`ma_tpu_torch/ops/soc.py` <-> `ma_tpu/ops/soc.py`, ...).
Each Pallas kernel of the ported path is a hand-written CUDA C++ kernel
under `csrc/`, built with nvcc on first use and bound with ctypes
(`ma_tpu_torch/kernels.py`); beside each sits its plain PyTorch version,
which a wrapper runs only for tensors on the CPU.

Nothing here imports jax. Every entry point that allocates takes an explicit
`device`; there is no default device.

Ported: single-end short and long reads with every seeding technique
(minimizers, with SDUST masking; the FMD techniques maxSpan, SMEMs and
MEMs), small inversions, NGMLR tags, paired reads
(`pipeline/paired.py`), `Aligner.align_to_sam`, the MSV structural-variant
caller (`msv/`: `compute_sv_jumps_batch(..., device=...)`,
`sweep_sv_jumps`, the call filters, TSV/HTML output, the npz store,
`reconstruct_sequenced_genome`), and the command line `python -m
ma_tpu_torch.cli` (index, align, paired, `--Sv`, `--Serve`; on cuda unless
given `--Device cpu`). See README.md, "PyTorch/CUDA port".
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing the package must not pull in the whole pipeline
    if name == "Aligner":
        from ma_tpu_torch.pipeline.aligner import Aligner

        return Aligner
    raise AttributeError(name)
