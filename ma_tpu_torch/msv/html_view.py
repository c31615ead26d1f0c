"""Interactive SV visualizer — the bokeh-server equivalent.

A copy of ma_tpu/msv/html_view.py, changed only in its imports.

The reference ships a bokeh app with linked plots: the adjacency matrix
(calls = circles, jumps = crosses), per-read seed dot-plots, and a
recall/accuracy UI vs a ground-truth run (reference:
libs/msv/python/sv_visualization/bokeh_server.py:1-40 + renderer/*,
renderer decimation in libs/msv/src/util/renderer_speedup.cpp).

Here the same surface is a single self-contained HTML file (no server, no
JS dependencies): SVG adjacency matrix with wheel-zoom/drag-pan, per-mark
hover tooltips, a click-to-inspect detail panel (call rectangle, strands,
support, inserted sequence, supporting jump ids), an optional ground-truth
overlay (neutral outlined squares — identity by shape, not a 4th hue) with
recall/precision stats, and a collapsible table view of the calls.

Palette: 3 validated categorical slots (all-pairs safe) + neutral inks;
light/dark from prefers-color-scheme.
"""
from __future__ import annotations

import html
import json
from typing import Optional, Sequence

from ma_tpu_torch.msv.calls import SvCall
from ma_tpu_torch.msv.jumps import DUMMY_LOCATION, SvJump


def _call_row(c: SvCall) -> dict:
    ins = ""
    if c.inserted_sequence is not None and len(c.inserted_sequence):
        ins = "".join("ACGTN"[min(int(b), 4)] for b in c.inserted_sequence)
    return {
        "x": int(c.from_pos), "y": int(c.to_pos),
        "w": int(c.from_size), "h": int(c.to_size),
        "ff": bool(c.from_forward), "tf": bool(c.to_forward),
        "reads": int(c.supp_reads), "nt": int(c.supp_nt),
        "amb": int(c.reference_ambiguity), "ins": ins, "id": int(c.id),
        "jumps": list(map(int, c.supporting_jump_ids or [])),
    }


def _match(call: dict, truth: dict, tol: int) -> bool:
    return (
        abs(call["x"] - truth["x"]) <= tol + truth["w"]
        and abs(call["y"] - truth["y"]) <= tol + truth["h"]
    )


def render_interactive_html(
    path: str,
    jumps: Sequence[SvJump] = (),
    calls: Sequence[SvCall] = (),
    genome_len: Optional[int] = None,
    truth: Sequence[SvCall] = (),
    title: str = "ma_tpu SV viewer",
    max_points: int = 50000,
    match_tol: int = 50,
    read_seeds: Optional[dict] = None,
    pack=None,
    context: int = 40,
) -> None:
    """`read_seeds` ({read_id: [(q, len, ref, fwd), ...]}, e.g. from
    msv.pipeline.seeds_for_reads) enables the per-read seed dot-plot in the
    call detail panel; `pack` enables the +-`context` nucleotide track
    around each call's two breakends (the bokeh app's seed-plot and
    nucleotide-track roles, sv_visualization/bokeh_server.py:1-40)."""
    jrows = [
        {
            "x": int(j.from_pos), "y": int(j.to_pos),
            "q": [int(j.query_from), int(j.query_to)],
            "nt": int(j.num_supporting_nt), "read": int(j.read_id),
            "ff": bool(j.from_forward), "tf": bool(j.to_forward),
            "id": int(j.id),
        }
        for j in list(jumps)[:max_points]
        if j.from_pos != DUMMY_LOCATION and j.to_pos != DUMMY_LOCATION
    ]
    crows = [_call_row(c) for c in calls]
    trows = [_call_row(c) for c in truth]
    if pack is not None:
        L = pack.unpacked_size_forward_strand

        def _ctx(pos: int, size: int):
            lo = max(int(pos) - context, 0)
            hi = min(int(pos) + max(int(size), 1) + context, L)
            hi = min(hi, lo + 200)  # bound the embedded string
            if hi <= lo:
                return None
            seq = "".join(
                "ACGTN"[min(int(b), 4)] for b in pack.codes[lo:hi]
            )
            hl = int(pos) - lo
            return [seq, hl, max(min(max(int(size), 1), hi - lo - hl), 0), lo]

        for c in crows:
            c["cf"] = _ctx(c["x"], c["w"])
            c["ct"] = _ctx(c["y"], c["h"])
    rseeds = {
        str(int(rid)): [[int(q), int(l), int(r), bool(fw)] for (q, l, r, fw) in ss]
        for rid, ss in (read_seeds or {}).items()
    }
    # recall/precision at the fixed tolerance (the bokeh recall UI role)
    hit_truth = [any(_match(c, t, match_tol) for c in crows) for t in trows]
    hit_call = [any(_match(c, t, match_tol) for t in trows) for c in crows]
    stats = ""
    if trows:
        recall = sum(hit_truth) / len(trows)
        prec = sum(hit_call) / max(len(crows), 1)
        stats = (
            f"recall {sum(hit_truth)}/{len(trows)} = {recall:.1%} · "
            f"precision {sum(hit_call)}/{max(len(crows),1)} = {prec:.1%} "
            f"(tolerance {match_tol} bp)"
        )
    hi = genome_len or max(
        [r["x"] + r.get("w", 0) for r in jrows + crows + trows]
        + [r["y"] + r.get("h", 0) for r in jrows + crows + trows]
        + [1]
    )
    data = json.dumps(
        {"jumps": jrows, "calls": crows, "truth": trows, "hi": hi,
         "rseeds": rseeds}
    )

    rows_html = "".join(
        f"<tr><td>{c['id']}</td><td>{c['x']}</td><td>{c['y']}</td>"
        f"<td>{c['w']}x{c['h']}</td>"
        f"<td>{'-+'[c['ff']]}{'-+'[c['tf']]}</td><td>{c['reads']}</td>"
        f"<td>{c['nt']}</td><td>{html.escape(c['ins'][:40])}</td></tr>"
        for c in crows
    )

    page = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title>
<style>
.viz-root {{
  color-scheme: light;
  --surface-1: #fcfcfb; --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e4e3df;
  --series-1: #2a78d6; /* jumps */
  --series-2: #eb6834; /* calls, strand switch */
  --series-3: #1baf7a; /* calls, same strand */
  font-family: ui-monospace, monospace; background: var(--surface-1);
  color: var(--text-primary); margin: 16px;
}}
@media (prefers-color-scheme: dark) {{
  .viz-root {{
    color-scheme: dark;
    --surface-1: #1a1a19; --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #33322f;
    --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
  }}
}}
.wrap {{ display: flex; gap: 16px; align-items: flex-start; }}
svg {{ background: var(--surface-1); border: 1px solid var(--grid); cursor: grab; }}
#panel {{ min-width: 280px; max-width: 380px; font-size: 12px;
         color: var(--text-secondary); }}
#panel b {{ color: var(--text-primary); }}
#tip {{ position: fixed; pointer-events: none; background: var(--surface-1);
       border: 1px solid var(--grid); padding: 4px 6px; font-size: 11px;
       display: none; z-index: 2; color: var(--text-primary); }}
.legend {{ display: flex; gap: 14px; font-size: 12px; margin: 6px 0;
          color: var(--text-secondary); }}
.sw {{ display: inline-block; width: 10px; height: 10px; margin-right: 4px;
      vertical-align: -1px; }}
table {{ border-collapse: collapse; font-size: 11px; }}
td, th {{ border: 1px solid var(--grid); padding: 2px 6px;
         color: var(--text-secondary); }}
summary {{ cursor: pointer; margin-top: 10px; color: var(--text-secondary); }}
.track {{ font-size: 11px; letter-spacing: 1px; overflow-wrap: anywhere;
         margin: 4px 0; color: var(--text-secondary); }}
.track .hl {{ color: var(--series-2); font-weight: bold;
             text-decoration: underline; }}
</style></head><body class="viz-root">
<h3>{html.escape(title)}</h3>
<div class="legend">
  <span><span class="sw" style="background:var(--series-1)"></span>jump</span>
  <span><span class="sw" style="border:2px solid var(--series-2);background:none"></span>call (strand switch)</span>
  <span><span class="sw" style="border:2px solid var(--series-3);background:none"></span>call (same strand)</span>
  {'<span><span class="sw" style="border:2px dashed var(--text-secondary);background:none"></span>truth</span>' if trows else ''}
  <span style="margin-left:auto">{html.escape(stats)}</span>
</div>
<div class="wrap">
  <svg id="m" width="760" height="760" viewBox="0 0 760 760"></svg>
  <div id="panel">wheel = zoom, drag = pan, hover = tooltip, click a call
    for details</div>
</div>
<div id="tip"></div>
<details><summary>table view ({len(crows)} calls)</summary>
<table><tr><th>id</th><th>from</th><th>to</th><th>size</th><th>strands</th>
<th>reads</th><th>nt</th><th>inserted</th></tr>{rows_html}</table></details>
<script>
const D = {data};
const svg = document.getElementById('m'), tip = document.getElementById('tip');
const panel = document.getElementById('panel');
const W = 760, PAD = 44;
let vx = 0, vy = 0, vs = 1;  // view offset (genome coords) and scale
const full = D.hi || 1;
function sx(g) {{ return PAD + (g - vx) / full * vs * (W - 2 * PAD); }}
function sy(g) {{ return W - PAD - (g - vy) / full * vs * (W - 2 * PAD); }}
function inv(px) {{ return (px - PAD) / (vs * (W - 2 * PAD)) * full + vx; }}
const NS = 'http://www.w3.org/2000/svg';
function el(tag, attrs) {{
  const e = document.createElementNS(NS, tag);
  for (const k in attrs) e.setAttribute(k, attrs[k]);
  return e;
}}
function fmt(n) {{ return n.toLocaleString('en-US'); }}
function draw() {{
  svg.textContent = '';
  // axes + ticks
  svg.appendChild(el('line', {{x1: PAD, y1: W - PAD, x2: W - PAD, y2: W - PAD,
    stroke: 'var(--grid)'}}));
  svg.appendChild(el('line', {{x1: PAD, y1: PAD, x2: PAD, y2: W - PAD,
    stroke: 'var(--grid)'}}));
  for (let i = 0; i <= 4; i++) {{
    const g = vx + full / vs * i / 4;
    const t = el('text', {{x: sx(g), y: W - PAD + 14, 'font-size': 10,
      fill: 'var(--text-secondary)', 'text-anchor': 'middle'}});
    t.textContent = fmt(Math.round(g)); svg.appendChild(t);
    const g2 = vy + full / vs * i / 4;
    const t2 = el('text', {{x: PAD - 4, y: sy(g2) + 3, 'font-size': 10,
      fill: 'var(--text-secondary)', 'text-anchor': 'end'}});
    t2.textContent = fmt(Math.round(g2)); svg.appendChild(t2);
  }}
  for (const j of D.jumps) {{
    const x = sx(j.x), y = sy(j.y);
    if (x < PAD - 4 || x > W - PAD + 4 || y < PAD - 4 || y > W - PAD + 4) continue;
    const m = el('path', {{d: `M${{x-3}},${{y-3}} L${{x+3}},${{y+3}} ` +
      `M${{x-3}},${{y+3}} L${{x+3}},${{y-3}}`, stroke: 'var(--series-1)',
      'stroke-width': 1.5, fill: 'none', 'pointer-events': 'stroke'}});
    m.addEventListener('mousemove', ev => tooltip(ev,
      `jump (${{fmt(j.x)}}, ${{fmt(j.y)}}) read ${{j.read}} ` +
      `q[${{j.q[0]}},${{j.q[1]}}) nt=${{j.nt}}`));
    m.addEventListener('mouseleave', hide);
    svg.appendChild(m);
  }}
  for (const t of D.truth) {{
    const x = sx(t.x), y = sy(t.y);
    if (x < 0 || x > W || y < 0 || y > W) continue;
    svg.appendChild(el('rect', {{x: x - 7, y: y - 7, width: 14, height: 14,
      fill: 'none', stroke: 'var(--text-secondary)', 'stroke-dasharray': '3 2',
      'stroke-width': 1.5}}));
  }}
  for (const c of D.calls) {{
    const x = sx(c.x), y = sy(c.y);
    if (x < 0 || x > W || y < 0 || y > W) continue;
    const col = (c.ff !== c.tf) ? 'var(--series-2)' : 'var(--series-3)';
    const r = 5 + Math.min(c.reads, 10);
    const m = el('circle', {{cx: x, cy: y, r: r, fill: 'none', stroke: col,
      'stroke-width': 2, 'pointer-events': 'all'}});
    m.addEventListener('mousemove', ev => tooltip(ev,
      `call ${{c.id}} (${{fmt(c.x)}}, ${{fmt(c.y)}}) reads=${{c.reads}}`));
    m.addEventListener('mouseleave', hide);
    m.addEventListener('click', () => inspect(c));
    svg.appendChild(m);
  }}
}}
function tooltip(ev, text) {{
  tip.style.display = 'block';
  tip.style.left = (ev.clientX + 12) + 'px';
  tip.style.top = (ev.clientY + 12) + 'px';
  tip.textContent = text;
}}
function hide() {{ tip.style.display = 'none'; }}
function track(label, t) {{
  // nucleotide track around a breakend: +-context with the call region
  // highlighted (the bokeh nucleotide-track role)
  if (!t) return '';
  const [seq, hl, n, lo] = t;
  return `<div class="track"><b>${{label}}</b> @${{fmt(lo)}}<br>` +
    `${{seq.slice(0, hl)}}<span class="hl">${{seq.slice(hl, hl + n)}}</span>` +
    `${{seq.slice(hl + n)}}</div>`;
}}
function inspect(c) {{
  panel.innerHTML =
    `<b>call ${{c.id}}</b><br>from ${{fmt(c.x)}} +${{c.w}} ` +
    `(${{c.ff ? 'fwd' : 'rev'}})<br>to ${{fmt(c.y)}} +${{c.h}} ` +
    `(${{c.tf ? 'fwd' : 'rev'}})<br>support: ${{c.reads}} reads, ` +
    `${{c.nt}} nt<br>ambiguity: ${{c.amb}}<br>` +
    (c.ins ? `inserted: <b>${{c.ins}}</b><br>` : '') +
    `jumps: ${{c.jumps.join(', ') || '-'}}` +
    track('from breakend', c.cf) + track('to breakend', c.ct);
  // linked per-read dot-plot (the bokeh seed-plot role): each supporting
  // jump drawn as its query span vs its two reference breakends, plus the
  // SEEDS of supporting reads as diagonal segments (query vs reference)
  const js = D.jumps.filter(j => c.jumps.includes(j.id));
  if (!js.length) return;
  const reads = [...new Set(js.map(j => j.read))];
  const seedsOf = r => (D.rseeds && D.rseeds[String(r)]) || [];
  const segs = [];  // [r0, q0, r1, q1, read]
  for (const r of reads)
    for (const [q, l, rp, fw] of seedsOf(r))
      segs.push(fw ? [rp, q, rp + l, q + l, r] : [rp, q, rp - l, q + l, r]);
  const SW = 260, SP = 30;
  const rvals = js.flatMap(j => [j.x, j.y]).concat(
    segs.flatMap(s => [s[0], s[2]]));
  const rlo = Math.min(...rvals);
  const rhi = Math.max(...rvals);
  const qhi = Math.max(...js.map(j => j.q[1]).concat(
    segs.map(s => s[3]))) || 1;
  const rs = v => SP + (v - rlo) / Math.max(rhi - rlo, 1) * (SW - 2 * SP);
  const qs = v => SW - SP - v / qhi * (SW - 2 * SP);
  const mini = el('svg', {{width: SW, height: SW, style:
    'border:1px solid var(--grid); margin-top:8px; display:block'}});
  for (const s of segs) {{
    const hue = reads.indexOf(s[4]) % 3 + 1;
    const ln = el('path', {{d:
      `M${{rs(s[0])}},${{qs(s[1])}} L${{rs(s[2])}},${{qs(s[3])}}`,
      stroke: `var(--series-${{hue}})`, 'stroke-width': 1, fill: 'none',
      opacity: 0.6}});
    ln.addEventListener('mousemove', ev => tooltip(ev,
      `seed read ${{s[4]}}: q${{s[1]}} ref ${{fmt(s[0])}} ` +
      `len ${{Math.abs(s[3] - s[1])}}`));
    ln.addEventListener('mouseleave', hide);
    mini.appendChild(ln);
  }}
  for (const j of js) {{
    const hue = reads.indexOf(j.read) % 3 + 1;
    const ln = el('path', {{d:
      `M${{rs(j.x)}},${{qs(j.q[0])}} L${{rs(j.y)}},${{qs(j.q[1])}}`,
      stroke: `var(--series-${{hue}})`, 'stroke-width': 1.5, fill: 'none',
      'stroke-dasharray': '4 2'}});
    ln.addEventListener('mousemove', ev => tooltip(ev,
      `read ${{j.read}}: q[${{j.q[0]}},${{j.q[1]}}) ref ` +
      `${{fmt(j.x)}} -> ${{fmt(j.y)}}`));
    ln.addEventListener('mouseleave', hide);
    mini.appendChild(ln);
    for (const [rp, qp] of [[j.x, j.q[0]], [j.y, j.q[1]]])
      mini.appendChild(el('circle', {{cx: rs(rp), cy: qs(qp), r: 3,
        fill: `var(--series-${{hue}})`}}));
  }}
  const cap = el('text', {{x: SW / 2, y: 12, 'font-size': 10,
    'text-anchor': 'middle', fill: 'var(--text-secondary)'}});
  cap.textContent = (segs.length ? 'seeds + ' : '') +
    `supporting jumps: ref ${{fmt(rlo)}}-${{fmt(rhi)}} (x) vs query (y)`;
  mini.appendChild(cap);
  panel.appendChild(mini);
}}
svg.addEventListener('wheel', ev => {{
  ev.preventDefault();
  const f = ev.deltaY < 0 ? 1.25 : 0.8;
  const gx = inv(ev.offsetX);
  const gy = vy + (W - PAD - ev.offsetY) / (vs * (W - 2 * PAD)) * full;
  vs *= f;
  vx = gx - (gx - vx) / f;
  vy = gy - (gy - vy) / f;
  draw();
}});
let drag = null;
svg.addEventListener('mousedown', ev => drag = [ev.clientX, ev.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', ev => {{
  if (!drag) return;
  const dx = (ev.clientX - drag[0]) / (vs * (W - 2 * PAD)) * full;
  const dy = (ev.clientY - drag[1]) / (vs * (W - 2 * PAD)) * full;
  vx -= dx; vy += dy; drag = [ev.clientX, ev.clientY];
  draw();
}});
draw();
</script></body></html>"""
    with open(path, "w") as f:
        f.write(page)
