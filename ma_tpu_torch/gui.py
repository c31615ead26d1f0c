"""maGUI-role front end: a reflection-generated local web UI.

A copy of ma_tpu/gui.py, changed in its imports and in one field: the form
picks the device (cuda, the default, or cpu), which the actions pass to the
command line as `--Device`. There is no fallback: with no CUDA device a cuda
action logs the command line's error and `[done rc=1]`.

The reference ships a wxWidgets desktop app (reference:
gui/src/maGUI.cpp:45-332) whose entire surface is: pick files, pick a
preset, edit the parameter set (widgets generated from the parameter
reflection), run index creation / alignment, watch progress. This module
provides the same surface as a dependency-free local web page: the form
is generated from config/parameters.py reflection (name, type, choices,
description, category — the same metadata the wx GUI reflects over), and
actions run the CLI entry points in a worker thread with live log
streaming.

Usage: python -m ma_tpu_torch.gui [port]      (default 8765, localhost only),
or python -m ma_tpu_torch.cli --GUI [port]
"""
from __future__ import annotations

import html
import io
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ma_tpu_torch.config.parameters import ParameterSetManager

_state = {
    "mgr": None,  # ParameterSetManager
    "log": [],  # list[str]
    "busy": False,
}
_lock = threading.Lock()


def _mgr() -> ParameterSetManager:
    if _state["mgr"] is None:
        _state["mgr"] = ParameterSetManager()
    return _state["mgr"]


def _log(msg: str) -> None:
    with _lock:
        _state["log"].append(msg)


class _Tee(io.TextIOBase):
    def write(self, s):
        if s.strip():
            _log(s.rstrip("\n"))
        return len(s)


def _run_action(action: str, form: dict) -> None:
    """Worker thread: run the CLI machinery with the GUI's parameters."""
    import contextlib
    import sys

    from ma_tpu_torch import cli

    mgr = _mgr()
    args = []
    if action == "index":
        args = ["--Create_Index",
                f"{form.get('fasta', '')},{form.get('outdir', '.')},"
                f"{form.get('name', 'idx')}"]
    elif action == "align":
        args = ["-x", form.get("index", ""), "-i", form.get("reads", ""),
                "-o", form.get("out", "out.sam")]
        if form.get("mates"):
            args += ["-m", form["mates"]]
    elif action == "sv":
        args = ["--Sv", "-x", form.get("index", ""),
                "-i", form.get("reads", ""),
                "-o", form.get("out", "calls.tsv")]
    # preset + edited parameters ride as CLI flags so the run is exactly
    # reproducible from the printed command line
    preset = form.get("preset")
    if preset and preset.lower() != "default":
        args = ["-p", preset] + args
    pset = mgr.selected
    for key, val in form.items():
        if not key.startswith("param:"):
            continue
        name = key[len("param:"):]
        try:
            p = pset[name]  # normalized lookup (config/parameters.py)
        except KeyError:
            continue
        cur = str(p.value)
        if isinstance(p.value, bool):
            val = "true" if val in ("on", "true", "1") else "false"
            cur = "true" if p.value else "false"
        if val != cur:
            args += [f"--{name}", val]
    args += ["--Device", form.get("device", "cuda")]
    _log(f"$ ma_tpu {' '.join(args)}")
    try:
        with contextlib.redirect_stderr(_Tee()):
            rc = cli.main(args)
        _log(f"[done rc={rc}]")
    except BaseException as e:  # surface, don't kill the server
        _log(f"[error] {e!r}")
    finally:
        with _lock:
            _state["busy"] = False


_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>ma_tpu</title><style>
body {{ font-family: system-ui, sans-serif; margin: 1.5em; max-width: 70em; }}
fieldset {{ margin-bottom: 1em; border: 1px solid #bbb; border-radius: 6px; }}
legend {{ font-weight: 600; }}
label {{ display: inline-block; min-width: 22em; }}
input, select {{ margin: 2px 0; }}
.param {{ display: block; }}
.desc {{ color: #666; font-size: 0.85em; margin-left: 1em; }}
#log {{ background: #111; color: #ddd; padding: 0.8em; min-height: 8em;
       white-space: pre-wrap; font-family: monospace; font-size: 0.85em; }}
.actions button {{ font-size: 1.05em; padding: 0.4em 1.2em; margin-right: 1em; }}
</style></head><body>
<h2>ma_tpu &mdash; alignment console</h2>
<form method="post" action="/run">
<fieldset><legend>Files</legend>
<label>Genome FASTA</label><input name="fasta" size="50" value="genome.fa"><br>
<label>Index dir / name</label><input name="outdir" size="24" value=".">
<input name="name" size="16" value="idx"><br>
<label>Index prefix (for align/SV)</label><input name="index" size="50" value="./idx"><br>
<label>Reads (FASTA/FASTQ[.gz])</label><input name="reads" size="50" value="reads.fq"><br>
<label>Mates (paired mode, optional)</label><input name="mates" size="50"><br>
<label>Output</label><input name="out" size="50" value="out.sam"><br>
</fieldset>
<fieldset><legend>Device</legend>
<select name="device"><option selected>cuda</option><option>cpu</option></select>
<span class="desc">cuda needs an NVIDIA GPU; there is no fallback to the CPU</span>
</fieldset>
<fieldset><legend>Preset</legend>
<select name="preset">{presets}</select>
<span class="desc">selecting a preset resets unedited parameters to its defaults</span>
</fieldset>
{params}
<fieldset class="actions"><legend>Run</legend>
<button name="action" value="index">Create Index</button>
<button name="action" value="align">Align</button>
<button name="action" value="sv">SV calls (--Sv)</button>
<span class="desc">{status}</span>
</fieldset>
</form>
<h3>Log</h3><div id="log">{log}</div>
<script>
if ({busy}) setTimeout(() => location.reload(), 1500);
</script>
</body></html>"""


def _render() -> str:
    mgr = _mgr()
    pset = mgr.selected
    groups: dict = {}
    for p in pset.by_name.values():
        groups.setdefault(p.category, []).append(p)
    parts = []
    for cat in sorted(groups):
        rows = []
        for p in groups[cat]:
            key = html.escape(f"param:{p.name}")
            desc = html.escape(p.description)
            label = html.escape(p.name)
            if isinstance(p.value, bool):
                chk = "checked" if p.value else ""
                inp = (f'<input type="hidden" name="{key}" value="false">'
                       f'<input type="checkbox" name="{key}" value="true" {chk}>')
            elif p.choices is not None:
                opts = "".join(
                    f'<option {"selected" if c == p.value else ""}>'
                    f"{html.escape(str(c))}</option>"
                    for c in p.choices
                )
                inp = f'<select name="{key}">{opts}</select>'
            else:
                inp = (f'<input name="{key}" size="10" '
                       f'value="{html.escape(str(p.value))}">')
            rows.append(
                f'<span class="param"><label title="{desc}">{label}</label>'
                f'{inp}<span class="desc">{desc}</span></span>'
            )
        parts.append(
            f"<fieldset><legend>{html.escape(cat)}</legend>"
            + "".join(rows) + "</fieldset>"
        )
    presets = "".join(
        f'<option {"selected" if s is mgr.selected else ""}>'
        f"{html.escape(s.name)}</option>"
        for s in mgr.sets.values()
    )
    with _lock:
        log = html.escape("\n".join(_state["log"][-200:]))
        busy = _state["busy"]
    return _PAGE.format(
        presets=presets, params="".join(parts), log=log,
        busy="true" if busy else "false",
        status="running..." if busy else "idle",
    )


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def _send(self, body: str, code: int = 200):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path.startswith("/log"):
            with _lock:
                body = json.dumps(_state["log"][-200:])
            self._send(body)
            return
        self._send(_render())

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        form = {}
        for k, v in urllib.parse.parse_qsl(self.rfile.read(n).decode()):
            form[k] = v  # later keys win (checkbox hidden+real pattern)
        preset = form.get("preset", "Default")
        try:
            _mgr().set_selected(preset)
        except Exception:
            pass
        action = form.get("action", "")
        with _lock:
            busy = _state["busy"]
            if not busy and action:
                _state["busy"] = True
        if not busy and action:
            threading.Thread(
                target=_run_action, args=(action, form), daemon=True
            ).start()
        self.send_response(303)
        self.send_header("Location", "/")
        self.end_headers()


def serve(port: int = 8765, open_browser: bool = False):
    srv = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    print(f"ma_tpu GUI on http://127.0.0.1:{port}/ (ctrl-c to stop)")
    if open_browser:
        import webbrowser

        webbrowser.open(f"http://127.0.0.1:{port}/")
    srv.serve_forever()


if __name__ == "__main__":
    import sys

    serve(int(sys.argv[1]) if len(sys.argv) > 1 else 8765)
