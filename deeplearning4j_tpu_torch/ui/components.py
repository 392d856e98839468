"""UI chart/table/text components with JSON serialization.

Analog of the reference's ``deeplearning4j-ui-components`` module
(SURVEY §2.12): typed chart/bean components (ChartLine, ChartHistogram,
ChartScatter, ComponentTable, ComponentText, StyleChart) that serialize
to JSON for a JS frontend. The UI server's endpoints emit these, and
they render standalone via :func:`render_html` (self-contained inline-SVG
export — no JS dependency, works air-gapped).
"""

from __future__ import annotations

import html as _html
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


def _esc(v) -> str:
    return _html.escape(str(v), quote=True)


@dataclass
class StyleChart:
    """(reference: StyleChart.Builder)"""
    width: int = 640
    height: int = 360
    title_size: int = 14
    series_colors: Tuple[str, ...] = ("#2563eb", "#dc2626", "#059669",
                                      "#d97706", "#7c3aed", "#0891b2")
    margin: int = 40

    def to_dict(self) -> dict:
        return {"width": self.width, "height": self.height,
                "titleSize": self.title_size,
                "seriesColors": list(self.series_colors),
                "margin": self.margin}


class Component:
    component_type = "component"

    def to_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


@dataclass
class ChartLine(Component):
    """Multi-series line chart (reference: ChartLine.Builder.addSeries)."""
    title: str = ""
    style: StyleChart = field(default_factory=StyleChart)
    series: List[dict] = field(default_factory=list)
    component_type = "ChartLine"

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "ChartLine":
        if len(x) != len(y):
            raise ValueError(f"series {name!r}: len(x)={len(x)} != "
                             f"len(y)={len(y)}")
        self.series.append({"name": name, "x": [float(v) for v in x],
                            "y": [float(v) for v in y]})
        return self

    def to_dict(self) -> dict:
        return {"componentType": self.component_type, "title": self.title,
                "style": self.style.to_dict(), "series": self.series}


@dataclass
class ChartScatter(ChartLine):
    component_type = "ChartScatter"


@dataclass
class ChartHistogram(Component):
    """Binned bars (reference: ChartHistogram.Builder.addBin)."""
    title: str = ""
    style: StyleChart = field(default_factory=StyleChart)
    bins: List[dict] = field(default_factory=list)
    component_type = "ChartHistogram"

    def add_bin(self, lower: float, upper: float, count: float
                ) -> "ChartHistogram":
        self.bins.append({"lower": float(lower), "upper": float(upper),
                          "count": float(count)})
        return self

    def to_dict(self) -> dict:
        return {"componentType": self.component_type, "title": self.title,
                "style": self.style.to_dict(), "bins": self.bins}


@dataclass
class ComponentTable(Component):
    """(reference: ComponentTable)"""
    header: List[str] = field(default_factory=list)
    rows: List[List[str]] = field(default_factory=list)
    title: str = ""
    component_type = "ComponentTable"

    def to_dict(self) -> dict:
        return {"componentType": self.component_type, "title": self.title,
                "header": self.header, "rows": self.rows}


@dataclass
class ComponentText(Component):
    """(reference: ComponentText)"""
    text: str = ""
    component_type = "ComponentText"

    def to_dict(self) -> dict:
        return {"componentType": self.component_type, "text": self.text}


@dataclass
class ComponentDiv(Component):
    """Container of child components (reference: ComponentDiv)."""
    children: List[Component] = field(default_factory=list)
    component_type = "ComponentDiv"

    def add(self, c: Component) -> "ComponentDiv":
        self.children.append(c)
        return self

    def to_dict(self) -> dict:
        return {"componentType": self.component_type,
                "children": [c.to_dict() for c in self.children]}


# ---------------------------------------------------------------------------
# standalone SVG/HTML rendering (air-gapped export)
# ---------------------------------------------------------------------------

def _svg_chart_line(c: ChartLine) -> str:
    st = c.style
    m, w, h = st.margin, st.width, st.height
    pw, ph = w - 2 * m, h - 2 * m
    all_x = [v for s in c.series for v in s["x"]] or [0.0, 1.0]
    all_y = [v for s in c.series for v in s["y"]] or [0.0, 1.0]
    x0, x1 = min(all_x), max(all_x)
    y0, y1 = min(all_y), max(all_y)
    if x1 == x0:
        x1 = x0 + 1
    if y1 == y0:
        y1 = y0 + 1
    sx = lambda v: m + (v - x0) / (x1 - x0) * pw
    sy = lambda v: h - m - (v - y0) / (y1 - y0) * ph
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
             f'height="{h}">',
             f'<text x="{w//2}" y="{m//2}" text-anchor="middle" '
             f'font-size="{st.title_size}">{_esc(c.title)}</text>',
             f'<rect x="{m}" y="{m}" width="{pw}" height="{ph}" '
             f'fill="none" stroke="#888"/>']
    scatter = isinstance(c, ChartScatter)
    for i, s in enumerate(c.series):
        color = st.series_colors[i % len(st.series_colors)]
        pts = [(sx(x), sy(y)) for x, y in zip(s["x"], s["y"])]
        if scatter:
            parts += [f'<circle cx="{x:.1f}" cy="{y:.1f}" r="3" '
                      f'fill="{color}"/>' for x, y in pts]
        elif pts:
            d = " ".join(f"{x:.1f},{y:.1f}" for x, y in pts)
            parts.append(f'<polyline points="{d}" fill="none" '
                         f'stroke="{color}" stroke-width="1.5"/>')
        parts.append(f'<text x="{m + 4}" y="{m + 14 + 14 * i}" '
                     f'fill="{color}" font-size="11">{_esc(s["name"])}</text>')
    parts.append("</svg>")
    return "".join(parts)


def _svg_chart_histogram(c: ChartHistogram) -> str:
    st = c.style
    m, w, h = st.margin, st.width, st.height
    pw, ph = w - 2 * m, h - 2 * m
    if not c.bins:
        return f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" ' \
               f'height="{h}"></svg>'
    lo = min(b["lower"] for b in c.bins)
    hi = max(b["upper"] for b in c.bins)
    top = max(b["count"] for b in c.bins) or 1.0
    sx = lambda v: m + (v - lo) / ((hi - lo) or 1.0) * pw
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
             f'height="{h}">',
             f'<text x="{w//2}" y="{m//2}" text-anchor="middle" '
             f'font-size="{st.title_size}">{_esc(c.title)}</text>']
    color = st.series_colors[0]
    for b in c.bins:
        x = sx(b["lower"])
        bw = max(sx(b["upper"]) - x - 1, 1)
        bh = b["count"] / top * ph
        parts.append(f'<rect x="{x:.1f}" y="{h - m - bh:.1f}" '
                     f'width="{bw:.1f}" height="{bh:.1f}" fill="{color}"/>')
    parts.append("</svg>")
    return "".join(parts)


def render_html(components: Sequence[Component],
                title: str = "dl4j-tpu report") -> str:
    """Self-contained HTML (inline SVG) for a list of components."""
    body = []
    for c in components:
        if isinstance(c, ChartHistogram):
            body.append(_svg_chart_histogram(c))
        elif isinstance(c, ChartLine):   # covers ChartScatter
            body.append(_svg_chart_line(c))
        elif isinstance(c, ComponentTable):
            rows = "".join(
                "<tr>" + "".join(f"<td>{_esc(v)}</td>" for v in r) + "</tr>"
                for r in c.rows)
            head = "".join(f"<th>{_esc(v)}</th>" for v in c.header)
            body.append(f"<h3>{_esc(c.title)}</h3><table border='1' "
                        f"cellpadding='4'><tr>{head}</tr>{rows}</table>")
        elif isinstance(c, ComponentText):
            body.append(f"<p>{_esc(c.text)}</p>")
        elif isinstance(c, ComponentDiv):
            body.append(render_html(c.children, title=""))
    inner = "\n".join(body)
    if not title:
        return inner
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title></head><body>{inner}</body></html>")
