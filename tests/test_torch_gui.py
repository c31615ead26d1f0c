"""The port's web console (ma_tpu_torch/gui.py, a copy of ma_tpu/gui.py with
a device field) and `--GUI` in its command line: the page reflects the
port's parameters, index and align actions posted through HTTP on the CPU
write the files `ma_tpu_torch.cli.main` writes for the same arguments, the
arguments each action builds are ma_tpu's plus `--Device`, and a cuda
action with no CUDA device logs rc 1 and writes nothing."""
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture()
def server():
    from http.server import ThreadingHTTPServer

    from ma_tpu_torch import gui

    gui._state.update(mgr=None, log=[], busy=False)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), gui._Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def post(server, form):
    urllib.request.urlopen(server + "/run", data=urllib.parse.urlencode(form).encode())


def wait_done(timeout=240) -> str:
    """The log once the action has ended (the server clears `busy`)."""
    from ma_tpu_torch import gui

    t0 = time.time()
    while time.time() - t0 < timeout:
        with gui._lock:
            if not gui._state["busy"]:
                return "\n".join(gui._state["log"])
        time.sleep(0.1)
    raise TimeoutError("\n".join(gui._state["log"]))


def run(server, form) -> str:
    from ma_tpu_torch import gui

    with gui._lock:
        gui._state["log"] = []
    post(server, form)
    time.sleep(0.05)
    return wait_done()


def test_page_reflects_parameters(server):
    from ma_tpu_torch.config.parameters import ParameterSetManager

    page = urllib.request.urlopen(server + "/").read().decode()
    pset = ParameterSetManager().selected
    for name in ("Seeding Technique", "Match Score", "Z Drop", "Detect Small Inversions"):
        assert name in page, name
    for c in {p.category for p in pset.by_name.values()}:
        assert c in page, c
    for preset in ("Default", "PacBio", "Nanopore"):
        assert preset in page
    assert '<select name="device"><option selected>cuda</option><option>cpu</option>' in page


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from ma_tpu_torch.containers.nucseq import decode_seq

    d = tmp_path_factory.mktemp("gui")
    rng = np.random.default_rng(12)
    seq = decode_seq(rng.integers(0, 4, size=30_000).astype(np.uint8))
    (d / "genome.fa").write_text(">g\n" + seq + "\n")
    with open(d / "reads.fq", "w") as f:
        for i in range(8):
            p = int(rng.integers(0, 30_000 - 150))
            f.write(f"@r{i}\n{seq[p:p+150]}\n+\n{'I'*150}\n")
    return d


def test_index_and_align_through_gui_equal_cli(server, files, tmp_path):
    """Index and align through HTTP form posts on the CPU; the index files
    and the SAM equal cli.main's with the same arguments, byte for byte."""
    from ma_tpu_torch.cli import main

    log = run(server, {"action": "index", "preset": "Default", "device": "cpu",
                       "fasta": str(files / "genome.fa"), "outdir": str(tmp_path),
                       "name": "gidx"})
    assert "[done rc=0]" in log, log
    assert main(["--Create_Index", f"{files / 'genome.fa'},{tmp_path / 'cli'},gidx"]) == 0
    made = sorted(p.name for p in tmp_path.glob("gidx*"))
    assert made and made == sorted(p.name for p in (tmp_path / "cli").glob("gidx*"))
    for name in made:
        assert (tmp_path / name).read_bytes() == (tmp_path / "cli" / name).read_bytes(), name

    log = run(server, {"action": "align", "preset": "Default", "device": "cpu",
                       "index": str(tmp_path / "gidx"), "reads": str(files / "reads.fq"),
                       "out": str(tmp_path / "gui.sam"),
                       "param:Seeding Technique": "minimizers"})
    assert "[done rc=0]" in log, log
    assert "--Seeding Technique minimizers --Device cpu" in log
    assert main(["-x", str(tmp_path / "gidx"), "-i", str(files / "reads.fq"), "-o",
                 str(tmp_path / "cli.sam"), "--Seeding Technique", "minimizers",
                 "--Device", "cpu"]) == 0
    sam = (tmp_path / "gui.sam").read_bytes()
    assert sam == (tmp_path / "cli.sam").read_bytes()
    assert len([ln for ln in sam.decode().splitlines() if not ln.startswith("@")]) >= 7


FORMS = {
    "index": {"action": "index", "fasta": "g.fa", "outdir": "d", "name": "n"},
    "align": {"action": "align", "index": "d/n", "reads": "r.fq", "out": "o.sam",
              "param:Seeding Technique": "minimizers", "param:Z Drop": "200",
              "param:Match Score": "3", "param:No Such Parameter": "1"},
    "paired_preset": {"action": "align", "preset": "Illumina", "index": "d/n",
                      "reads": "r1.fq", "mates": "r2.fq",
                      "param:Detect Small Inversions": "true",
                      "param:Use Paired Reads": "false"},
    "sv": {"action": "sv", "index": "d/n", "reads": "s.fq", "out": "c.tsv",
           "preset": "PacBio", "param:Min Reads in call": "3"},
    "defaults": {"action": "align"},
}


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
@pytest.mark.parametrize("form", FORMS, ids=str)
def test_run_action_args_are_ma_tpus_plus_device(form, device, monkeypatch):
    """_run_action's command line is ma_tpu's for the same form, plus
    `--Device` and the form's device (cuda when the form has none)."""
    import ma_tpu.cli
    import ma_tpu.gui
    import ma_tpu_torch.cli
    from ma_tpu_torch import gui

    got = {}
    for pkg_gui, pkg_cli in ((gui, ma_tpu_torch.cli), (ma_tpu.gui, ma_tpu.cli)):
        pkg_gui._state.update(mgr=None, log=[], busy=True)

        def main(args, g=pkg_gui):
            got[g] = args
            return 0

        monkeypatch.setattr(pkg_cli, "main", main)
        f = dict(FORMS[form])
        if f.get("preset"):
            pkg_gui._mgr().set_selected(f["preset"])
        if device:
            f["device"] = device
        pkg_gui._run_action(f["action"], f)
        assert pkg_gui._state["log"][-1] == "[done rc=0]"
        assert not pkg_gui._state["busy"]
    assert got[gui] == got[ma_tpu.gui] + ["--Device", device or "cuda"]


def test_cuda_action_without_a_card_logs_rc_1(server, files, tmp_path, monkeypatch):
    """No CUDA device: the cuda action fails with the command line's error
    and rc 1, and never runs on the CPU (no SAM is written)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ma_tpu_torch.cli import main

    assert main(["--Create_Index", f"{files / 'genome.fa'},{tmp_path},idx"]) == 0
    log = run(server, {"action": "align", "index": str(tmp_path / "idx"),
                       "reads": str(files / "reads.fq"), "out": str(tmp_path / "o.sam")})
    assert log.endswith("[done rc=1]"), log
    assert "--Device cuda" in log and "no CUDA device" in log
    assert not (tmp_path / "o.sam").exists()


@pytest.mark.parametrize("argv,port", [
    (["--GUI", "0"], 0), (["--GUI"], 8765),
    (["--Seeding_Technique", "minimizers", "--GUI", "9000"], 9000)])
def test_gui_flag_serves_the_console(argv, port, monkeypatch):
    import ma_tpu_torch.gui
    from ma_tpu_torch.cli import main

    served = []
    monkeypatch.setattr(ma_tpu_torch.gui, "serve", served.append)
    assert main(argv) == 0
    assert served == [port]
