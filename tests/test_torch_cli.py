"""The port's command line (`python -m ma_tpu_torch.cli`) on the CPU:
--Create_Index writes the files ma_tpu writes and each package loads the
other's; `-x ... -i ... [-m ...] --Device cpu` gives ma_tpu's SAM (its
library under the reference setting MA_TPU_DP=fused MA_TPU_FINISH=native,
and its command line for the same flags, byte for byte); every registry
flag sets what ma_tpu's sets; the help text is ma_tpu's plus the --Device
line; without a CUDA device and without --Device cpu it exits 1; --Sv
--Device cpu writes ma_tpu's three files byte for byte; --GUI exits 1;
--Serve answers requests; the execution context and the
quick API run over the port."""
import io
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_paired import ma_tpu_reference, paired_data, write_paired_files

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The paired library of test_torch_paired as files, indexed by the port
    (port/idx) and by ma_tpu (ref/idx)."""
    from ma_tpu.cli import create_index
    from ma_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("cli")
    write_paired_files(d, paired_data())
    assert main(["--Create_Index", f"{d}/genome.fa,{d}/port,idx"]) == 0
    create_index(f"{d}/genome.fa", f"{d}/ref", "idx", log=lambda *_: None)
    return d


SUFFIXES = (".pack.npz", ".fmd.npz", ".mmi.npz")


@pytest.mark.parametrize("writer,loader", [("port", "ma_tpu"), ("ref", "ma_tpu_torch")])
def test_index_files_interchangeable(files, writer, loader):
    """The two packages write the same arrays and manifest, and each loads
    the files the other wrote."""
    import importlib

    for suffix in SUFFIXES:
        a, b = (np.load(files / w / f"idx{suffix}") for w in ("port", "ref"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), (suffix, k)
    assert json.loads((files / "port/idx.json").read_text()) == \
        json.loads((files / "ref/idx.json").read_text())
    prefix = str(files / writer / "idx")
    pack = importlib.import_module(loader + ".containers.pack").Pack.load(prefix)
    fmd = importlib.import_module(loader + ".index.fmd_index").FMDIndex.load(prefix)
    mmi = importlib.import_module(loader + ".index.minimizer").MinimizerIndex.load(prefix)
    assert pack.names == ["chrP"] and pack.unpacked_size_forward_strand == 16_000
    assert fmd.n == 32_000 and (mmi.k, mmi.w) == (15, 10)


# case -> flags after -x/-i/-o (single-end reads of r1.fq)
SINGLE = {"default": [], "ngmlr": ["--Emulate_NGMLR's_tag_output"]}


def _cmd_of_this_process() -> str:
    """The @PG command of a main() call in this process: this process's own
    arguments, as ma_tpu writes them."""
    return "ma-tpu " + " ".join(sys.argv[1:])


@pytest.fixture(scope="module")
def ma_tpu_library_sams(files):
    """ma_tpu's library SAM per SINGLE case on the same reads and index,
    under its reference setting, with this process's @PG command."""
    prefix = str(files / "ref/idx")
    out = {}
    with ma_tpu_reference() as fresh:
        from ma_tpu.config.parameters import ParameterSetManager
        from ma_tpu.containers.pack import Pack
        from ma_tpu.index.fmd_index import FMDIndex
        from ma_tpu.io.fasta import read_reads
        from ma_tpu.pipeline.aligner import Aligner

        for case, flags in SINGLE.items():
            fresh()
            mgr = ParameterSetManager()
            for flag in flags:
                mgr.selected[flag[2:]].set(True)
            al = Aligner(Pack.load(prefix), FMDIndex.load(prefix), mgr, index_prefix=prefix)
            buf = io.StringIO()
            al.align_to_sam(read_reads(str(files / "r1.fq")), buf, cmd=_cmd_of_this_process())
            out[case] = buf.getvalue()
    return out


@pytest.mark.parametrize("case", list(SINGLE))
def test_main_sam_equals_ma_tpu_library(files, ma_tpu_library_sams, case, capsys):
    from ma_tpu_torch.cli import main

    out = files / f"main_{case}.sam"
    rc = main(["-x", str(files / "port/idx"), "-i", str(files / "r1.fq"), "-o", str(out),
               *SINGLE[case], "--Device", "cpu"])
    assert rc == 0
    assert "done. 64 reads" in capsys.readouterr().err
    sam = out.read_text()
    assert sam.count("\n") > 3 + 60
    assert sam == ma_tpu_library_sams[case]
    assert (case == "ngmlr") == ("\tSA:Z:" in sam or "\tNM:i:" in sam)


def _env(tmp):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MA_TPU_DP="fused",
               MA_TPU_FINISH="native", MA_TPU_XLA_CACHE=str(tmp / "xla"))
    return env


# ma_tpu's command line on the CPU, as tests/test_serve.py runs it
MA_TPU_CLI = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
              "import sys; from ma_tpu.cli import main; sys.exit(main(sys.argv[1:]))")


def test_command_line_equals_ma_tpu(files):
    """Both command lines on the same paired flags, each on the other's
    index: the SAM is byte-identical, the @PG line included (--Device is
    left out of it); the port's equals its library's too."""
    pytest.importorskip("jax")
    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.io.fasta import read_reads, zip_paired
    from ma_tpu_torch.pipeline.aligner import Aligner
    from ma_tpu_torch.pipeline.paired import PairedAligner

    flags = ["-i", str(files / "r1.fq"), "-m", str(files / "r2.fq"), "-o", "OUT", "-p",
             "IlluminaPaired", "--Score_Factor_for_Paired_Reads", "1.5"]
    runs = {"port": ([sys.executable, "-m", "ma_tpu_torch.cli", "-x", str(files / "ref/idx")],
                     ["--Device", "cpu"]),
            "ref": ([sys.executable, "-c", MA_TPU_CLI, "-x", str(files / "port/idx")], [])}
    sams = {}
    for who, (head, tail) in runs.items():
        out = str(files / f"cl_{who}.sam")
        argv = head + [out if f == "OUT" else f for f in flags] + tail
        res = subprocess.run(argv, capture_output=True, text=True, env=_env(files), cwd=ROOT,
                             timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        assert "done. 128 reads" in res.stderr
        sams[who] = open(out).read().replace(f"cl_{who}.sam", "OUT").replace(
            str(files / ("ref" if who == "port" else "port")), "IDX")
    assert sams["port"].count("\n") >= 3 + 128
    assert sams["port"] == sams["ref"]

    mgr = ParameterSetManager()
    mgr.set_selected("IlluminaPaired")
    mgr.selected.set("Score Factor for Paired Reads", 1.5)
    prefix = str(files / "ref/idx")
    al = Aligner(Pack.load(prefix), mgr, device="cpu", fmd=FMDIndex.load(prefix),
                 index_prefix=prefix)
    buf = io.StringIO()
    pairs = zip_paired(read_reads(str(files / "r1.fq")), read_reads(str(files / "r2.fq")))
    head = sams["port"].splitlines(keepends=True)[2]
    PairedAligner(al).align_to_sam(pairs, buf, cmd=head.split("CL:", 1)[1].rstrip("\n"))
    assert buf.getvalue() == sams["port"]


def _parsed(pkg: str, argv, monkeypatch):
    """The parameter values main() of package `pkg` leaves for the aligner."""
    import importlib

    cli = importlib.import_module(pkg + ".cli")
    seen = {}

    def capture(mgr, *args):
        seen.update((k, p.value) for k, p in mgr.selected.by_name.items())
        seen["_preset"] = mgr.selected.name
        return 0

    monkeypatch.setattr(cli, "run_alignment", capture)
    assert cli.main(list(argv)) == 0
    return seen


def _flag_values(form: str):
    """argv setting every registry parameter to a value other than its
    default (booleans by the bare flag where the default is False), by its
    long name or, with form "short", by its letter where it has one."""
    from ma_tpu_torch.config.parameters import ParameterSetManager

    argv = []
    for p in ParameterSetManager().selected.by_name.values():
        if isinstance(p.default, bool):
            value = None if not p.default else "false"
        elif p.choices is not None:
            value = str(p.choices[-1])
        elif isinstance(p.default, (int, float)):
            value = str(p.default + 1)
        else:
            continue
        flag = f"-{p.short}" if form == "short" and p.short else "--" + p.name.replace(" ", "_")
        argv += [flag] if value is None else [flag, value]
    return argv


@pytest.mark.parametrize("form", ["long", "short"])
def test_every_registry_flag_parses_as_ma_tpu(form, monkeypatch):
    pytest.importorskip("jax")
    argv = ["-p", "Nanopore", "-x", "IDX", "-i", "r.fq", *_flag_values(form), "--Device", "cpu"]
    port = _parsed("ma_tpu_torch", argv, monkeypatch)
    ref = _parsed("ma_tpu", argv[:-2], monkeypatch)
    assert port == ref
    assert port["_preset"] == "Nanopore" and port["use_paired_reads"] is True


def test_help_is_ma_tpus_plus_the_device_line(capsys):
    from ma_tpu.cli import generate_help as ref_help
    from ma_tpu.config.parameters import ParameterSetManager as RefManager
    from ma_tpu_torch.cli import generate_help, main
    from ma_tpu_torch.config.parameters import ParameterSetManager

    port = generate_help(ParameterSetManager()).splitlines()
    ref = ref_help(RefManager()).splitlines()
    extra = [line for line in port if line not in ref]
    assert len(extra) == 1 and "--Device <cuda|cpu>" in extra[0]
    assert [line for line in port if line != extra[0]] == ref
    assert main([]) == 0 and main(["-h"]) == 0
    assert capsys.readouterr().out.count("--Device <cuda|cpu>") == 2


@pytest.mark.parametrize("argv", [
    ["-p", "nonexistent", "-x", "y", "-i", "z"],
    ["-i", "reads.fq"],
    ["-x", "idx", "-i", "r.fq", "--No_Such_Flag", "1"],
    ["-x", "idx", "-i", "r.fq", "--Minimal_Seed_Length"],
], ids=["preset", "no_index", "unknown_flag", "value_missing"])
def test_flag_errors_as_ma_tpu(argv, capsys):
    from ma_tpu.cli import main as ref_main
    from ma_tpu_torch.cli import main

    assert main(argv + ["--Device", "cpu"]) == 1
    port = capsys.readouterr().err
    assert ref_main(argv) == 1
    assert port == capsys.readouterr().err and port.startswith("Error:")


@pytest.fixture(scope="module")
def sv_files(tmp_path_factory):
    """tests/test_torch_msv.py's SV problem as files (genome.fa, reads.fq),
    indexed by the port (port/idx) and by ma_tpu (ref/idx)."""
    from ma_tpu.cli import create_index
    from ma_tpu_torch.cli import main
    from ma_tpu_torch.containers.nucseq import decode_seq
    from test_torch_msv import sv_data

    d = tmp_path_factory.mktemp("sv")
    ref, reads = sv_data()
    seq = decode_seq(ref)
    (d / "genome.fa").write_text(
        ">chrR\n" + "\n".join(seq[i : i + 80] for i in range(0, len(seq), 80)) + "\n")
    (d / "reads.fq").write_text("".join(
        f"@sv{i}\n{decode_seq(c)}\n+\n{'I' * len(c)}\n" for i, c in enumerate(reads)))
    assert main(["--Create_Index", f"{d}/genome.fa,{d}/port,idx"]) == 0
    create_index(f"{d}/genome.fa", f"{d}/ref", "idx", log=lambda *_: None)
    return d


# the SV parameters --Sv reads, set by flags to a preset's values: ma_tpu's
# -p cannot select the SV presets (their keys, "sv-pacbio", are not what
# normalize() makes of any name; ROADMAP Queue 3), so the case passes them
SV_PARAMS = ("Minimal Seed Size SV", "Maximal Ambiguity SV", "Min NT in SoC",
             "Min Reads in call", "Max Supp Nt", "Max Call Size Filter",
             "Max Fuzziness Filter")


def _sv_flags(preset: str):
    from ma_tpu_torch.config.parameters import ParameterSetManager

    ps = ParameterSetManager().sets[preset]
    return [f for p in SV_PARAMS for f in ("--" + p.replace(" ", "_"), str(ps.get(p)))]


@pytest.mark.parametrize("preset", ["default", "sv-pacbio"])
def test_sv_files_equal_ma_tpu(sv_files, preset, capsys):
    """--Sv --Device cpu writes ma_tpu's calls.tsv, .html and .view.html
    byte for byte (ma_tpu's command line in a subprocess, each on the
    other's index), and its "done." line."""
    pytest.importorskip("jax")
    from ma_tpu_torch.cli import main

    flags = ["-i", str(sv_files / "reads.fq"), "--Sv", *_sv_flags(preset)]
    port_out, ref_out = sv_files / f"port_{preset}.tsv", sv_files / f"ref_{preset}.tsv"
    assert main(["-x", str(sv_files / "ref/idx"), *flags, "-o", str(port_out),
                 "--Device", "cpu"]) == 0
    port_done = capsys.readouterr().err
    res = subprocess.run([sys.executable, "-c", MA_TPU_CLI, "-x", str(sv_files / "port/idx"),
                          *flags, "-o", str(ref_out)], capture_output=True, text=True,
                         env=_env(sv_files), cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    for suffix in ("", ".html", ".view.html"):
        a = (sv_files / f"port_{preset}.tsv{suffix}").read_bytes()
        assert a == (sv_files / f"ref_{preset}.tsv{suffix}").read_bytes(), suffix
    tsv = port_out.read_text().splitlines()
    assert len(tsv) >= 2 and tsv[0].startswith("from_pos\tto_pos")
    done = lambda err: err.split("done. ")[1].split(" calls in ")[0]  # noqa: E731
    assert done(port_done) == done(res.stderr)
    assert "104 reads ->" in port_done


def test_no_card_exits_1_without_device_cpu(files, monkeypatch, capsys):
    """With no CUDA device the command line refuses to align unless given
    --Device cpu: it names the card and writes no SAM."""
    from ma_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = files / "nocard.sam"
    assert main(["-x", str(files / "port/idx"), "-i", str(files / "r1.fq"),
                 "-o", str(out)]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "NVIDIA GPU" in err and "--Device cpu" in err
    assert not out.exists()
    assert main(["-x", str(files / "port/idx"), "--Serve", str(files / "s.sock")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert main(["-x", "idx", "-i", "r.fq", "--Device", "tpu"]) == 1
    assert "--Device takes cuda or cpu" in capsys.readouterr().err


def test_sv_without_card_exits_1(sv_files, monkeypatch, capsys):
    """--Sv follows the same device rule: no CUDA device and no --Device
    cpu exits 1, naming the card, and writes no file."""
    from ma_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = sv_files / "nocard.tsv"
    assert main(["-x", str(sv_files / "port/idx"), "-i", str(sv_files / "reads.fq"), "--Sv",
                 "-o", str(out)]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "NVIDIA GPU" in err and "--Device cpu" in err
    assert not list(sv_files.glob("nocard*"))


def test_pg_command_leaves_out_the_device():
    from ma_tpu_torch.cli import _command

    assert _command(["-x", "a", "--Device", "cpu", "-i", "b"]) == "ma-tpu -x a -i b"
    assert _command(["--device", "cuda"]) == "ma-tpu "


def test_serve_answers_single_end_and_paired_requests(files):
    """--Serve on the CPU: a single-end and a paired request over the unix
    socket, each written as the port's library writes it, then shutdown."""
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.io.fasta import read_reads, zip_paired
    from ma_tpu_torch.pipeline.aligner import Aligner
    from ma_tpu_torch.pipeline.paired import PairedAligner

    sock = str(files / "srv.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ma_tpu_torch.cli", "-x", str(files / "port/idx"), "--Serve",
         sock, "--Device", "cpu"], env=_env(files), cwd=ROOT, stderr=subprocess.PIPE,
        text=True)
    try:
        for _ in range(1500):  # up to 5 minutes on a loaded machine
            if os.path.exists(sock):
                break
            assert proc.poll() is None, proc.stderr.read()
            time.sleep(0.2)
        else:
            raise AssertionError("server socket never appeared")
        requests = [
            {"in": [str(files / "r1.fq")], "out": str(files / "srv1.sam"), "batch": 32},
            {"in": [str(files / "r1.fq")], "mate": [str(files / "r2.fq")],
             "out": str(files / "srv2.sam"), "batch": 32},
        ]
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(sock)
            f = c.makefile("rw")
            for req, n in zip(requests, (64, 128)):
                f.write(json.dumps(req) + "\n")
                f.flush()
                resp = json.loads(f.readline())
                assert resp["ok"] and resp["n"] == n, resp
            f.write(json.dumps({"cmd": "shutdown"}) + "\n")
            f.flush()
            assert json.loads(f.readline()) == {"ok": True, "bye": True}
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    prefix = str(files / "port/idx")
    al = Aligner(Pack.load(prefix), device="cpu", fmd=FMDIndex.load(prefix), index_prefix=prefix)
    single, paired = io.StringIO(), io.StringIO()
    al.align_to_sam(read_reads(str(files / "r1.fq")), single, batch_size=32)
    PairedAligner(al).align_to_sam(
        zip_paired(read_reads(str(files / "r1.fq")), read_reads(str(files / "r2.fq"))), paired,
        batch_size=32)
    assert (files / "srv1.sam").read_text() == single.getvalue()
    assert (files / "srv2.sam").read_text() == paired.getvalue()


def test_execution_context_and_quick_api(files):
    from ma_tpu_torch.containers.nucseq import decode_seq
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.io.fasta import read_reads
    from ma_tpu_torch.pipeline.aligner import Aligner
    from ma_tpu_torch.pipeline.execution_context import ExecutionContext, GenomeManager
    from ma_tpu_torch.pipeline.quick import quick_align, test_aligner

    ctx = ExecutionContext(device="cpu")
    ctx.genome.load_genome(str(files / "port/idx.json"))
    ctx.reads.primary = [str(files / "r1.fq")]
    ctx.output.out_path = str(files / "ctx.sam")
    assert ctx.do_align() == 64
    prefix = str(files / "port/idx")
    want = io.StringIO()
    Aligner(Pack.load(prefix), device="cpu", index_prefix=prefix).align_to_sam(
        read_reads(str(files / "r1.fq")), want)
    assert (files / "ctx.sam").read_text() == want.getvalue()
    ctx.reads.mates = [str(files / "r2.fq")]
    assert ctx.do_align() == 128

    assert GenomeManager.make_index(str(files / "genome.fa"), str(files / "gm"), "idx",
                                    log=lambda *_: None) == str(files / "gm/idx")
    genome = np.asarray(Pack.load(prefix).codes)
    alns = quick_align(decode_seq(genome[5_000:5_150]), Pack.load(prefix), device="cpu",
                       Seeding_Technique="minimizers")
    assert alns and alns[0].begin_on_ref == 5_000
    assert test_aligner(genome_size=16_384, n_reads=16, device="cpu") >= 0.9
