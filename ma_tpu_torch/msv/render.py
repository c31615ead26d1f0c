"""SV observability: TSV export + self-contained SVG adjacency-matrix plot.

A copy of ma_tpu/msv/render.py, changed only in its imports.

The reference ships a bokeh server rendering calls as circles and jumps as
crosses on the (from, to) plane with linked read/seed views
(reference: libs/msv/python/sv_visualization/bokeh_server.py:1-40,
renderer/*, plus C++ decimation helpers renderer_speedup.cpp). Here the
same adjacency-matrix view renders as a dependency-free standalone HTML/SVG
file, and calls/jumps export as TSV for external tooling.
"""
from __future__ import annotations

import html
from typing import Optional, Sequence

from ma_tpu_torch.msv.calls import SvCall
from ma_tpu_torch.msv.jumps import DUMMY_LOCATION, SvJump


def calls_to_tsv(calls: Sequence[SvCall], path: str) -> None:
    with open(path, "w") as f:
        f.write(
            "from_pos\tto_pos\tfrom_size\tto_size\tfrom_forward\tto_forward\t"
            "supp_reads\tsupp_nt\tref_ambiguity\tscore\tinserted_size\n"
        )
        for c in calls:
            ins = len(c.inserted_sequence) if c.inserted_sequence is not None else 0
            f.write(
                f"{c.from_pos}\t{c.to_pos}\t{c.from_size}\t{c.to_size}\t"
                f"{int(c.from_forward)}\t{int(c.to_forward)}\t{c.supp_reads}\t"
                f"{c.supp_nt}\t{c.reference_ambiguity}\t{c.score():.3f}\t{ins}\n"
            )


def jumps_to_tsv(jumps: Sequence[SvJump], path: str) -> None:
    with open(path, "w") as f:
        f.write(
            "from_pos\tto_pos\tquery_from\tquery_to\tfrom_forward\t"
            "to_forward\tsupp_nt\tread_id\tdummy\n"
        )
        for j in jumps:
            f.write(
                f"{j.from_pos}\t{j.to_pos}\t{j.query_from}\t{j.query_to}\t"
                f"{int(j.from_forward)}\t{int(j.to_forward)}\t"
                f"{j.num_supporting_nt}\t{j.read_id}\t{int(j.is_dummy())}\n"
            )


def render_html(
    path: str,
    jumps: Sequence[SvJump] = (),
    calls: Sequence[SvCall] = (),
    genome_len: Optional[int] = None,
    size: int = 760,
    max_points: int = 20000,
) -> None:
    """Adjacency-matrix SVG: jumps = crosses, calls = circles (the bokeh
    view's main plot); decimated to max_points like renderer_speedup."""
    pts = []
    for j in list(jumps)[:max_points]:
        if j.from_pos == DUMMY_LOCATION or j.to_pos == DUMMY_LOCATION:
            continue
        pts.append((j.from_pos, j.to_pos))
    lo = 0
    hi = genome_len or max(
        [x for (x, y) in pts] + [y for (x, y) in pts]
        + [c.from_pos + c.from_size for c in calls]
        + [c.to_pos + c.to_size for c in calls]
        + [1]
    )
    span = max(hi - lo, 1)
    sc = lambda v: 40 + (v - lo) * (size - 60) / span

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" '
        f'style="background:#fff;font-family:monospace">',
        f'<line x1="40" y1="{size-20}" x2="{size-20}" y2="{size-20}" stroke="#888"/>',
        f'<line x1="40" y1="20" x2="40" y2="{size-20}" stroke="#888"/>',
        f'<text x="{size//2}" y="{size-4}" font-size="11">from (reference)</text>',
        f'<text x="4" y="{size//2}" font-size="11" transform="rotate(-90 10,{size//2})">to (reference)</text>',
    ]
    for (x, y) in pts:
        cx, cy = sc(x), size - 20 - (sc(y) - 40)
        parts.append(
            f'<path d="M{cx-2},{cy-2} L{cx+2},{cy+2} M{cx-2},{cy+2} '
            f'L{cx+2},{cy-2}" stroke="#4a72b8" stroke-width="1"/>'
        )
    for c in calls:
        cx, cy = sc(c.from_pos), size - 20 - (sc(c.to_pos) - 40)
        r = 4 + min(c.supp_reads, 12)
        color = "#d1495b" if c.from_forward != c.to_forward else "#2e933c"
        title = html.escape(
            f"({c.from_pos},{c.to_pos}) supp={c.supp_reads} nt={c.supp_nt}"
        )
        parts.append(
            f'<circle cx="{cx}" cy="{cy}" r="{r}" fill="none" stroke="{color}" '
            f'stroke-width="1.5"><title>{title}</title></circle>'
        )
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write(
            "<!doctype html><html><head><meta charset='utf-8'>"
            "<title>ma_tpu SV view</title></head><body>"
            "<h3 style='font-family:monospace'>SV adjacency matrix — jumps "
            "(crosses), calls (circles; red = strand switch)</h3>"
            + "".join(parts)
            + "</body></html>"
        )
