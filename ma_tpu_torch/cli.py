"""`maCMD`-compatible command line front end (a copy of ma_tpu/cli.py over
the port: `python -m ma_tpu_torch.cli`, or `ma-tpu-torch`).

Re-design of the reference CLI (reference: cmdMa.cpp:252-432):

* first pass picks the presetting (`-p` / `--Presetting`)
* `-X` / `--Create_Index fasta,folder,name` builds pack + FMD index
* `-x` / `--Index` loads a genome by manifest prefix
* `-i` / `--In` (comma list) and `-m` / `--Mate_In` select reads
* every other flag resolves against the parameter registry by short
  letter (`-t 4`) or normalized long name (`--Minimal_Seed_Length 12`);
  boolean parameters may appear without a value
* help text is generated from parameter reflection (cmdMa.cpp:107-238)
* `--Device cuda|cpu` picks the device (default cuda; no CUDA device and no
  `--Device cpu` is an error, never a silent CPU run); it is left out of
  the `@PG CL:` command, so the SAM equals ma_tpu's for the same flags
* `--Sv` calls structural variants (the MSV pipeline: jumps, sweep, calls
  as TSV plus an SVG/HTML summary and an interactive view), on the same
  device rule as alignment
* `--GUI [port]` serves the local web console (gui.py); its actions run
  this command line in process, on the device its form names
"""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from ma_tpu_torch import __version__
from ma_tpu_torch.config.parameters import ParameterSetManager, normalize

def _by_short(mgr: ParameterSetManager, c: str):
    try:
        return mgr.selected.by_short[c]
    except KeyError:
        raise RuntimeError(f"unknown option: -{c}")


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def generate_help(mgr: ParameterSetManager) -> str:
    lines = [
        "=" * 20 + " MA-TPU: The Modular Aligner, TPU-native " + "=" * 20,
        f"Version {__version__}",
        "",
        "Usage:",
        "  ma-tpu --Create_Index <fasta,folder,name>       build an index",
        "  ma-tpu -x <index> -i <reads.fq[,more]> [-o out.sam] [options]",
        "",
        "Available presettings: "
        + ", ".join(f"'{s.name}'" for s in mgr.sets.values()),
        "",
        "General options:",
        "  -x, --Index <file_name>         genome/index prefix (from --Create_Index)",
        "  -i, --In <file_name>            FASTA/FASTQ read files (comma separated)",
        "  -m, --Mate_In <file_name>       mate files: enables paired mode",
        "  -o, --SAM_File_name <name>      SAM output path (default stdout)",
        "  -X, --Create_Index <fa,dir,name> build FMD index for a FASTA file",
        "  -p, --Presetting <name>         parameter preset",
        "  -h, --Help                      print this message",
        "      --Device <cuda|cpu>         device to align on (default cuda)",
        "",
    ]
    by_cat: dict = {}
    for p in mgr.selected.by_name.values():
        by_cat.setdefault(p.category, []).append(p)
    for cat, params in by_cat.items():
        lines.append(f"{cat} options:")
        for p in params:
            short = f"-{p.short}, " if p.short else "    "
            lines.append(
                f"  {short}--{p.name.replace(' ', '_')} <{type(p.default).__name__}>"
            )
            lines.append(f"        {p.description} [default: {p.default}]")
        lines.append("")
    return "\n".join(lines)


def create_index(fasta: str, folder: str, name: str, log=print) -> str:
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.index.minimizer import MinimizerIndex

    os.makedirs(folder, exist_ok=True)
    prefix = os.path.join(folder, name)
    log(f"Loading genome {fasta} ...")
    pack = Pack.from_fasta(fasta)
    pack.store(prefix)
    log(f"Packed {pack.num_contigs} contigs, {pack.unpacked_size_forward_strand} bp.")
    t0 = time.perf_counter()
    log("Building FMD index ...")
    fmd = FMDIndex.build(pack)
    fmd.store(prefix)
    log(f"FMD index built in {time.perf_counter() - t0:.1f}s -> {prefix}.fmd.npz")
    t0 = time.perf_counter()
    log("Building minimizer index ...")
    mmi = MinimizerIndex.build(pack)
    mmi.store(prefix)
    log(f"Minimizer index built in {time.perf_counter() - t0:.1f}s -> {prefix}.mmi.npz")
    return prefix


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    mgr = ParameterSetManager()

    if not argv:
        print(generate_help(mgr))
        return 0

    # first pass: presetting (cmdMa.cpp:278-284)
    try:
        for i in range(1, len(argv)):
            if argv[i - 1] in ("-p", "--Presetting") or (
                argv[i - 1].startswith("--")
                and normalize(argv[i - 1][2:]) == "presetting"
            ):
                mgr.set_selected(argv[i])
    except KeyError as ex:
        print(f"Error:\n{ex.args[0]}", file=sys.stderr)
        return 1

    index_prefix = None
    in_files: List[str] = []
    mate_files: List[str] = []
    out_path = None
    serve_path = None
    sv_mode = False
    device_name = "cuda"

    try:
        i = 0
        while i < len(argv):
            opt = argv[i]
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            key = normalize(opt[2:]) if opt.startswith("--") else None
            if opt in ("-p",) or key == "presetting":
                i += 2
                continue
            if opt in ("-h",) or key in ("help",):
                print(generate_help(mgr))
                return 0
            if opt == "-x" or key == "index":
                # accept both the manifest path (idx/g.json) and the prefix
                index_prefix = nxt[:-5] if nxt and nxt.endswith(".json") else nxt
                i += 2
                continue
            if opt == "-i" or key == "in":
                in_files = nxt.split(",")
                i += 2
                continue
            if opt == "-m" or key == "mate_in":
                mate_files = nxt.split(",")
                mgr.selected.set("Use Paired Reads", True)
                i += 2
                continue
            if opt == "-o" or key == "sam_file_name":
                out_path = nxt
                i += 2
                continue
            if opt == "--Sv" or key == "sv":
                sv_mode = True
                i += 1
                continue
            if opt == "--Serve" or key == "serve":
                serve_path = nxt
                i += 2
                continue
            if opt == "--GUI" or key == "gui":
                # maGUI role (gui/src/maGUI.cpp:45-332): local web console
                # generated from the parameter reflection (gui.py)
                from ma_tpu_torch.gui import serve as gui_serve

                port = 8765
                if nxt is not None and _is_number(nxt):
                    port = int(nxt)
                gui_serve(port)
                return 0
            if key == "device":
                device_name = nxt
                i += 2
                continue
            if opt == "-X" or key == "create_index":
                parts = nxt.split(",")
                if len(parts) != 3:
                    raise RuntimeError("--Create_Index needs exactly three parameters")
                create_index(parts[0], parts[1], parts[2])
                return 0
            # generic registry lookup (cmdMa.cpp:349-417)
            if nxt is not None and (not nxt.startswith("-") or _is_number(nxt)):
                if opt.startswith("--") and len(opt) > 2:
                    mgr.selected[opt[2:]].set(nxt)
                elif opt.startswith("-") and len(opt) == 2:
                    _by_short(mgr, opt[1]).set(nxt)
                else:
                    raise RuntimeError(
                        f"unknown option type: {opt}. Did you forget to add "
                        "the '-' or '--' at the beginning?"
                    )
                i += 2
            else:  # boolean flag
                if opt.startswith("--") and len(opt) > 2:
                    p = mgr.selected[opt[2:]]
                elif opt.startswith("-") and len(opt) == 2:
                    p = _by_short(mgr, opt[1])
                else:
                    raise RuntimeError(f"unknown option type: {opt}")
                if not isinstance(p.default, bool):
                    raise RuntimeError("Parameters need to be provided as key value pairs")
                p.set(True)
                i += 1

        if serve_path is not None:
            if index_prefix is None:
                raise RuntimeError("--Serve requires an index (-x)")
            return run_server(mgr, index_prefix, serve_path, _device(device_name))
        if index_prefix is None or not in_files:
            raise RuntimeError(
                "both an index (-x) and at least one read file (-i) must be provided"
            )
        if sv_mode:
            return run_sv_calling(mgr, index_prefix, in_files, out_path,
                                  _device(device_name))
        return run_alignment(mgr, index_prefix, in_files, mate_files, out_path,
                             _device(device_name))
    except (RuntimeError, KeyError) as ex:
        print(f"Error:\n{ex}", file=sys.stderr)
        return 1


def _device(name: Optional[str]):
    """The torch device of `--Device`: cuda (the default) needs a CUDA
    device; the CPU runs only when asked for."""
    import torch

    if name not in ("cuda", "cpu"):
        raise RuntimeError(f"--Device takes cuda or cpu, not {name}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ma_tpu_torch aligns on an NVIDIA GPU (an H100); "
            "pass --Device cpu to align on the CPU"
        )
    return torch.device(name)


def _command(argv: List[str]) -> str:
    """The `@PG CL:` command: ma_tpu's, so `--Device` and its value are
    left out."""
    kept, i = [], 0
    while i < len(argv):
        if argv[i].startswith("--") and normalize(argv[i][2:]) == "device":
            i += 2
            continue
        kept.append(argv[i])
        i += 1
    return "ma-tpu " + " ".join(kept)


def run_sv_calling(
    mgr: ParameterSetManager,
    index_prefix: str,
    in_files: List[str],
    out_path: Optional[str],
    device,
) -> int:
    """--Sv mode: reads -> jumps -> calls -> TSV (+ SVG next to it) —
    the MSV python scripts as one command (computeSvJumps.py +
    sweepSvJumps.py flow over the in-memory store), the seed stage on
    `device`."""
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.minimizer import MinimizerIndex
    from ma_tpu_torch.io.fasta import read_reads
    from ma_tpu_torch.msv.ambiguity import compute_call_ambiguity
    from ma_tpu_torch.msv.html_view import render_interactive_html
    from ma_tpu_torch.msv.inserted import compute_inserted_sequences
    from ma_tpu_torch.msv.pipeline import compute_sv_jumps, seeds_for_reads, sweep_sv_jumps
    from ma_tpu_torch.msv.render import calls_to_tsv, render_html

    pack = Pack.load(index_prefix)
    if MinimizerIndex.exists(index_prefix):
        mmi = MinimizerIndex.load(index_prefix)
    else:
        mmi = MinimizerIndex.build(pack)
    reads = []
    for path in in_files:
        reads.extend(read_reads(path))
    tracer = None
    if os.environ.get("MA_TPU_PROFILE"):
        from ma_tpu_torch.utils import profile

        tracer = profile.AnalyzeRuntimes()
        profile.install(tracer, device)
    g = mgr.selected.get
    t0 = time.perf_counter()
    jumps = compute_sv_jumps(
        reads, pack, mmi,
        min_seed_len=int(g("Minimal Seed Size SV")),
        max_occ=int(g("Maximal Ambiguity SV")),
        min_nt_in_soc=int(g("Min NT in SoC")),
        device=device,
    )
    calls = sweep_sv_jumps(
        jumps,
        min_reads=int(g("Min Reads in call")),
        max_supp_nt=int(g("Max Supp Nt")),
        max_call_size=int(g("Max Call Size Filter")),
        max_fuzziness=int(g("Max Fuzziness Filter")),
    )
    compute_call_ambiguity(calls, pack)
    compute_inserted_sequences(calls, jumps, reads)
    out = out_path or "calls.tsv"
    calls_to_tsv(calls, out)
    render_html(out + ".html", jumps, calls,
                genome_len=pack.unpacked_size_forward_strand)

    # seed dot-plots for the calls' supporting reads (cap the refetch)
    supp_ids: List[int] = []
    jump_by_id = {j.id: j for j in jumps}
    for c in calls:
        for jid in c.supporting_jump_ids or []:
            j = jump_by_id.get(jid)
            if j is not None:
                supp_ids.append(int(j.read_id))
    supp_ids = sorted(set(supp_ids))[:512]
    rs = seeds_for_reads(
        reads, pack, mmi, supp_ids,
        min_seed_len=int(g("Minimal Seed Size SV")),
        max_occ=int(g("Maximal Ambiguity SV")),
        min_nt_in_soc=int(g("Min NT in SoC")),
        device=device,
    ) if supp_ids else {}
    render_interactive_html(
        out + ".view.html", jumps, calls,
        genome_len=pack.unpacked_size_forward_strand,
        read_seeds=rs, pack=pack,
    )
    print(
        f"done. {len(reads)} reads -> {len(jumps)} jumps -> {len(calls)} "
        f"calls in {time.perf_counter() - t0:.1f}s -> {out}",
        file=sys.stderr,
    )
    if tracer is not None:
        tracer.analyze(out=sys.stderr)
        profile.install(None)
    return 0


def run_alignment(
    mgr: ParameterSetManager,
    index_prefix: str,
    in_files: List[str],
    mate_files: List[str],
    out_path: Optional[str],
    device,
) -> int:
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.io.fasta import read_reads, zip_paired
    from ma_tpu_torch.pipeline.aligner import Aligner

    pack = Pack.load(index_prefix)
    fmd = FMDIndex.load(index_prefix)
    aligner = Aligner(pack, mgr, device=device, fmd=fmd, index_prefix=index_prefix)
    if os.environ.get("MA_TPU_PROFILE"):
        from ma_tpu_torch.utils.profile import AnalyzeRuntimes

        aligner.profiler = AnalyzeRuntimes()
    cmd = _command(sys.argv[1:])

    def all_reads(paths):
        for path in paths:
            yield from read_reads(path)

    out = open(out_path, "w") if out_path and out_path != "stdout" else sys.stdout
    t0 = time.perf_counter()

    # stderr progress line (ProgressPrinter / doAlign callback,
    # cmdMa.cpp:398-415, fileReader.h:624)
    def progress(n_done: int) -> bool:
        print(f"\r{n_done} reads aligned.   ", end="", file=sys.stderr)
        return True

    try:
        if mate_files:
            from ma_tpu_torch.pipeline.paired import PairedAligner

            paired = PairedAligner(aligner)
            n = paired.align_to_sam(
                zip_paired(all_reads(in_files), all_reads(mate_files)), out, cmd=cmd
            )
        else:
            n = aligner.align_to_sam(all_reads(in_files), out, cmd=cmd,
                                     progress=progress)
    finally:
        if out is not sys.stdout:
            out.close()
    dt = time.perf_counter() - t0
    print(f"\rdone. {n} reads in {dt:.1f}s ({n / max(dt, 1e-9):.0f} reads/s)",
          file=sys.stderr)
    if aligner.n_rescued_reads:
        print(
            f"{aligner.n_rescued_reads} reads overflowed a fixed-shape "
            "capacity and were re-aligned through the boosted rescue stage",
            file=sys.stderr,
        )
    if aligner.n_overflow_reads > aligner.n_rescued_reads:
        print(
            f"warning: {aligner.n_overflow_reads - aligner.n_rescued_reads} "
            "reads overflowed a fixed-shape capacity (seed slots / "
            "minimizer lanes / SoC window) and were not rescued; their "
            "alignments may use a truncated seed set",
            file=sys.stderr,
        )
    if aligner.profiler is not None:
        aligner.profiler.analyze(out=sys.stderr)
        aligner.profiler = None
    return 0


def run_server(mgr: ParameterSetManager, index_prefix: str,
               socket_path: str, device) -> int:
    """--Serve <socket>: persistent alignment daemon.

    Keeps one Aligner warm on `device` (the index uploaded, the kernels
    built and loaded) and serves align requests over a unix socket as
    newline-delimited JSON: {"in": [paths], "mate": [paths]?, "out": path,
    "batch": int?} -> {"ok": true, "n": N, "seconds": t}. {"cmd":
    "shutdown"} ends the server. The reference gets the same effect from
    its long-lived GUI/DB processes (execution-context.h).
    """
    import json
    import socket as socketlib

    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.io.fasta import read_reads, zip_paired
    from ma_tpu_torch.pipeline.aligner import Aligner

    pack = Pack.load(index_prefix)
    fmd = FMDIndex.load(index_prefix)
    aligner = Aligner(pack, mgr, device=device, fmd=fmd, index_prefix=index_prefix)

    if os.path.exists(socket_path):
        os.unlink(socket_path)
    srv = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    srv.bind(socket_path)
    srv.listen(1)
    print(f"ma-tpu server ready on {socket_path} ({device})", file=sys.stderr, flush=True)

    def all_reads(paths):
        for path in paths:
            yield from read_reads(path)

    try:
        while True:
            conn, _ = srv.accept()
            with conn, conn.makefile("rw") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                        if req.get("cmd") == "shutdown":
                            f.write(json.dumps({"ok": True, "bye": True}) + "\n")
                            f.flush()
                            return 0
                        t0 = time.perf_counter()
                        with open(req["out"], "w") as out:
                            if req.get("mate"):
                                from ma_tpu_torch.pipeline.paired import PairedAligner

                                n = PairedAligner(aligner).align_to_sam(
                                    zip_paired(all_reads(req["in"]),
                                               all_reads(req["mate"])),
                                    out, batch_size=int(req.get("batch", 4096)),
                                )
                            else:
                                n = aligner.align_to_sam(
                                    all_reads(req["in"]), out,
                                    batch_size=int(req.get("batch", 4096)),
                                )
                        f.write(json.dumps({
                            "ok": True, "n": n,
                            "seconds": round(time.perf_counter() - t0, 3),
                        }) + "\n")
                    except Exception as ex:  # report, keep serving
                        f.write(json.dumps({"ok": False, "error": str(ex)}) + "\n")
                    f.flush()
    finally:
        srv.close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
