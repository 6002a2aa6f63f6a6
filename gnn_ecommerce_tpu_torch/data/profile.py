"""Self-contained dataset profiling report, without pandas.

Counterpart of ``gnn_ecommerce_tpu/data/profile.py`` over a
:class:`~.frame.Frame` whose columns carry pandas' ``read_csv`` types
(:func:`~.frame.read_frame`): int64, float64 (NaN missing), bool, and
strings (an object column, ``None`` missing, named ``str`` as pandas >= 3
names it). The structure and the HTML are the JAX package's, computed with
numpy under pandas' definitions:

- the sample is ``df.sample(n, random_state=seed)``'s rows: numpy's
  ``RandomState(seed).choice(n_rows, n, replace=False)``;
- quantiles are ``np.quantile``'s; ``value_counts`` sorts by count, ties in
  first-seen order; ``nunique`` and ``duplicated`` treat NaN as one value;
- Pearson and Spearman (average ranks) over pairwise-complete rows, NaN for
  a constant column, rounded to 4 places;
- ``memory_usage(deep=False)``: a RangeIndex's 132 bytes, 8 a row for
  int64 and float64, 1 for bool, and for a string column pandas' Arrow
  buffers (8 bytes a row, the UTF-8 bytes, a validity byte per 8 rows when
  any is missing);
- the sample table is ``df.head(10).to_html(border=0, index=False,
  max_cols=30)``'s bytes.

A string column whose name contains "time" is a datetime column, as in the
JAX package; its values must be in the reference dump's
``YYYY-MM-DD HH:MM:SS UTC`` form (anything else raises), and its histogram
counts calendar months.
"""
from __future__ import annotations

import html as _html
import math
import re

import numpy as np

from .frame import Frame

# Palette (single source for both modes; dark steps are selected, not
# auto-flipped).
_PAL = {
    "light": dict(surface="#fcfcfb", panel="#f4f3f0", text="#0b0b0b",
                  text2="#52514e", grid="#d8d7d2", bar="#2a78d6",
                  pos="#2a78d6", neg="#e34948", mid="#f0efec"),
    "dark": dict(surface="#1a1a19", panel="#232321", text="#ffffff",
                 text2="#c3c2b7", grid="#44433f", bar="#3987e5",
                 pos="#3987e5", neg="#e66767", mid="#383835"),
}

_NUM_QUANTILES = (0.01, 0.05, 0.25, 0.50, 0.75, 0.95, 0.99)
_TIME_FORMAT = re.compile(r"^\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2} UTC$")
# pandas' RangeIndex.memory_usage(deep=False).
_RANGE_INDEX_BYTES = 132
# pandas' display.precision: the digits of a float in to_html.
_HTML_DIGITS = 6


def _esc(x) -> str:
    return _html.escape(str(x))


def _fmt(v) -> str:
    if isinstance(v, float):
        if v != v:  # nan
            return "—"
        if abs(v) >= 1e5 or (0 < abs(v) < 1e-3):
            return f"{v:.4g}"
        return f"{v:,.4g}" if abs(v) >= 1 else f"{v:.4f}"
    if isinstance(v, (int, np.integer)):
        return f"{v:,}"
    return _esc(v)


def _svg_bars(counts, labels, width=420, height=120) -> str:
    """Bar chart: thin bars, 2px gaps, native hover tooltips; more than 96
    bars are merged into adjacent groups."""
    n = len(counts)
    if n == 0 or max(counts) == 0:
        return "<svg class='chart' width='420' height='24'></svg>"
    max_bars = 96
    if n > max_bars:
        k = -(-n // max_bars)
        counts = [sum(counts[i : i + k]) for i in range(0, n, k)]
        labels = [f"{labels[i]} … {labels[min(i + k, n) - 1]}" for i in range(0, n, k)]
        n = len(counts)
    peak = max(counts)
    gap = 2
    bw = max(2, (width - gap * (n - 1)) // n)
    parts = [
        f"<svg class='chart' role='img' width='{width}' height='{height}' "
        f"viewBox='0 0 {width} {height}'>"
    ]
    for i, (c, lab) in enumerate(zip(counts, labels)):
        h = 0 if peak == 0 else max(1 if c else 0, round((height - 18) * c / peak))
        x = i * (bw + gap)
        y = height - 14 - h
        parts.append(
            f"<rect x='{x}' y='{y}' width='{bw}' height='{h}' rx='2' "
            f"fill='var(--bar)'><title>{_esc(lab)}: {c:,}</title></rect>"
        )
    parts.append(
        f"<line x1='0' y1='{height - 13.5}' x2='{width}' y2='{height - 13.5}' "
        f"stroke='var(--grid)' stroke-width='1'/>"
    )
    parts.append(
        f"<text x='0' y='{height - 2}' class='tick'>{_esc(labels[0])}</text>"
        f"<text x='{width}' y='{height - 2}' text-anchor='end' class='tick'>"
        f"{_esc(labels[-1])}</text></svg>"
    )
    return "".join(parts)


def _stat_table(pairs) -> str:
    rows = "".join(
        f"<tr><td>{_esc(k)}</td><td class='num'>{_fmt(v)}</td></tr>" for k, v in pairs
    )
    return f"<table class='kv'>{rows}</table>"


# ---------------------------------------------------------------------------
# Columns: pandas' types and missing values over numpy
# ---------------------------------------------------------------------------


def _is_str(col: np.ndarray) -> bool:
    return col.dtype.kind in "OU"


def _is_numeric(col: np.ndarray) -> bool:
    return col.dtype.kind in "iufb"


def dtype_name(col: np.ndarray) -> str:
    """pandas' name of the column's dtype (``str`` for strings)."""
    return "str" if _is_str(col) else str(col.dtype)


def _missing(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.array([v is None for v in col], dtype=bool)
    return np.zeros(len(col), dtype=bool)


def _present_strings(col: np.ndarray) -> np.ndarray:
    """The non-missing values of a string column as a numpy str array."""
    keep = col[~_missing(col)]
    return np.asarray(keep.tolist(), dtype=str) if len(keep) else np.zeros(0, dtype=str)


def _codes(col: np.ndarray) -> np.ndarray:
    """Integer codes equal where values are equal (NaN and None one value)."""
    miss = _missing(col)
    vals = _present_strings(col) if _is_str(col) else col[~miss]
    codes = np.full(len(col), -1, dtype=np.int64)
    if len(vals):
        codes[~miss] = np.unique(vals, return_inverse=True)[1].ravel()
    return codes


def _nunique(col: np.ndarray) -> int:
    vals = _present_strings(col) if _is_str(col) else col[~_missing(col)]
    return len(np.unique(vals))


def value_counts(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(values, counts) by count descending, ties in first-seen order."""
    if len(values) == 0:
        return values, np.zeros(0, dtype=np.int64)
    uniq, first, counts = np.unique(values, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    uniq, counts = uniq[order], counts[order]
    order = np.argsort(-counts, kind="stable")
    return uniq[order], counts[order]


def memory_bytes(frame: Frame) -> int:
    """``DataFrame.memory_usage(deep=False).sum()`` under a RangeIndex."""
    total = _RANGE_INDEX_BYTES
    for name in frame.columns:
        col = frame[name]
        if _is_str(col):
            n = len(col)
            total += 8 * n + len("".join(_present_strings(col).tolist()).encode())
            if _missing(col).any():
                total += -(-n // 8)
        else:
            total += col.nbytes
    return total


def _duplicated_rows(frame: Frame) -> int:
    """``DataFrame.duplicated().sum()``: rows equal to an earlier row."""
    n = len(frame)
    if n == 0 or not frame.columns:
        return 0
    codes = [_codes(frame[c]) + 1 for c in frame.columns]
    if float(np.prod([float(c.max()) + 1 for c in codes])) < 2.0**62:
        key = np.zeros(n, dtype=np.int64)  # one int per row: mixed-radix codes
        for c in codes:
            key = key * (int(c.max()) + 1) + c
        return n - len(np.unique(key))
    return n - len(np.unique(np.stack(codes, axis=1), axis=0))


def _take(frame: Frame, rows: np.ndarray) -> Frame:
    return Frame({c: frame[c][rows] for c in frame.columns})


# ---------------------------------------------------------------------------
# Per-column profiles
# ---------------------------------------------------------------------------


def _profile_numeric(col: np.ndarray) -> dict:
    v = col[~_missing(col)]
    d: dict = {"kind": "numeric"}
    if len(v) == 0:
        d["stats"] = [("count", 0)]
        d["hist"] = ([], [])
        return d
    v = v.astype(np.float64)
    qs = np.quantile(v, _NUM_QUANTILES)
    d["stats"] = (
        [("mean", float(v.mean())), ("std", float(v.std())),
         ("min", float(v.min())), ("max", float(v.max()))]
        + [(f"q{int(q * 100)}", float(x)) for q, x in zip(_NUM_QUANTILES, qs)]
        + [("zeros", int((v == 0).sum())), ("negative", int((v < 0).sum()))]
    )
    # 24 bins between q1 and q99 (both tails clipped into the edge bins).
    hi = qs[-1] if qs[-1] > qs[0] else v.max()
    lo = qs[0] if qs[-1] > qs[0] else v.min()
    # A constant column, or a spread below one float64 ulp: one bar.
    if not (np.isfinite(lo) and np.isfinite(hi)) or (hi - lo) <= 0 or (
        (hi - lo) < 32 * np.spacing(max(abs(lo), abs(hi)))
    ):
        d["hist"] = ([int(len(v))], [f"{lo:.6g}"])
        return d
    counts, edges = np.histogram(np.clip(v, lo, hi), bins=24)
    labels = [f"[{edges[i]:.4g}, {edges[i + 1]:.4g})" for i in range(len(counts))]
    d["hist"] = (counts.tolist(), labels)
    return d


def _profile_categorical(col: np.ndarray) -> dict:
    vals = _present_strings(col)
    uniq, counts = value_counts(vals)
    lens = np.char.str_len(vals) if len(vals) else np.zeros(0, dtype=np.int64)
    other = int(counts[15:].sum()) if len(counts) > 15 else 0
    hist_counts = counts[:15].tolist() + ([other] if other else [])
    labels = [str(x) for x in uniq[:15]] + (["(other)"] if other else [])
    return {
        "kind": "categorical",
        "stats": [
            ("top", str(uniq[0]) if len(uniq) else "—"),
            ("top freq", int(counts[0]) if len(counts) else 0),
            ("mean length", float(lens.sum(dtype=np.float64) / len(lens)) if len(lens) else float("nan")),
            ("max length", int(lens.max()) if len(lens) else 0),
        ],
        "hist": (hist_counts, labels),
    }


def _profile_datetime(col: np.ndarray, name: str) -> dict:
    vals = _present_strings(col)
    bad = [v for v in vals.tolist() if not _TIME_FORMAT.match(v)]
    if bad:
        raise ValueError(
            f"column {name!r}: datetime values must read 'YYYY-MM-DD HH:MM:SS UTC', "
            f"got {bad[0]!r}"
        )
    d: dict = {"kind": "datetime"}
    if len(vals) == 0:
        d["stats"] = [("count", 0)]
        d["hist"] = ([], [])
        return d
    t = np.char.replace(np.char.replace(vals, " UTC", ""), " ", "T").astype("datetime64[s]")
    first, last = t.min(), t.max()
    d["stats"] = [
        ("first", str(first).replace("T", " ") + "+00:00"),
        ("last", str(last).replace("T", " ") + "+00:00"),
    ]
    months, counts = np.unique(t.astype("datetime64[M]"), return_counts=True)
    d["hist"] = (counts.tolist(), [str(m) for m in months])
    return d


# ---------------------------------------------------------------------------
# Correlations: pandas' Pearson and Spearman over pairwise-complete rows
# ---------------------------------------------------------------------------


def _avg_ranks(v: np.ndarray) -> np.ndarray:
    """1-based ranks, ties averaged (``rank(method="average")``)."""
    order = np.argsort(v, kind="mergesort")
    sv = v[order]
    starts = np.flatnonzero(np.r_[True, sv[1:] != sv[:-1]])
    ends = np.r_[starts[1:], len(sv)]
    avg = (starts + ends + 1) / 2.0
    ranks = np.empty(len(v), dtype=np.float64)
    ranks[order] = np.repeat(avg, ends - starts)
    return ranks


def _corr_pair(x: np.ndarray, y: np.ndarray, method: str) -> float:
    ok = ~(np.isnan(x) | np.isnan(y))
    x, y = x[ok], y[ok]
    n = len(x)
    if n < 1:
        return float("nan")
    if method == "spearman":
        x, y = _avg_ranks(x), _avg_ranks(y)
        dx, dy = x - (n + 1) / 2.0, y - (n + 1) / 2.0
    else:
        # pandas' running means leave a constant column exactly constant.
        if (x == x[0]).all() or (y == y[0]).all():
            return float("nan")
        dx, dy = x - x.mean(), y - y.mean()
    divisor = math.sqrt(float(dx @ dx) * float(dy @ dy))
    return float(dx @ dy) / divisor if divisor != 0 else float("nan")


def _corr_matrix(sub: list, method: str) -> list:
    k = len(sub)
    out = np.full((k, k), np.nan)
    for a in range(k):
        for b in range(a + 1):
            out[a, b] = out[b, a] = _corr_pair(sub[a], sub[b], method)
    return np.round(out, 4).tolist()


# ---------------------------------------------------------------------------
# The sample table: pandas' to_html
# ---------------------------------------------------------------------------


def _trim_zeros_float(strs: list) -> list:
    """pandas' ``_trim_zeros_float``: trailing zeros trimmed equally from
    every decimal number, one kept after the point."""
    number = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")

    def is_number(x):
        return number.match(x) is not None

    def should_trim(values):
        nums = [x for x in values if is_number(x)]
        return len(nums) > 0 and all(x.endswith("0") for x in nums)

    while should_trim(strs):
        strs = [x[:-1] if is_number(x) else x for x in strs]
    return [x + "0" if is_number(x) and x.endswith(".") else x for x in strs]


def _format_floats(v: np.ndarray) -> list:
    """pandas' fixed-width float formatting of one column (NaN as ``NaN``)."""
    def fmt(spec):
        return _trim_zeros_float(["NaN" if x != x else format(x, spec) for x in v.tolist()])

    out = fmt(f".{_HTML_DIGITS}f")
    too_long = bool(out) and max(len(x) for x in out) > _HTML_DIGITS + 6
    a = np.abs(v)
    large = bool((a > 1e6).any())
    small = bool(((a < 10 ** (-_HTML_DIGITS)) & (a > 0)).any())
    if small or (too_long and large):
        out = fmt(f".{_HTML_DIGITS}e")
    return out


def _html_cells(col: np.ndarray) -> list:
    if col.dtype.kind == "f":
        return _format_floats(col)
    if col.dtype.kind == "O":
        return ["NaN" if v is None else str(v) for v in col.tolist()]
    return [str(v) for v in col.tolist()]


def _cell(s: str) -> str:
    s = s.replace("\t", "\\t").replace("\r", "\\r").replace("\n", "\\n")
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;").strip()


def head_html(frame: Frame, rows: int = 10, max_cols: int = 30) -> str:
    """``frame.head(rows).to_html(border=0, index=False, max_cols=max_cols)``:
    past ``max_cols`` columns, the middle ones give way to a ``...``
    column."""
    names = frame.columns
    cols = [_html_cells(frame[c][:rows]) for c in names]
    n = min(rows, len(frame))
    if len(names) > max_cols:
        half = max_cols // 2
        names = names[:half] + ["..."] + names[len(names) - half :]
        cols = cols[:half] + [["..."] * n] + cols[len(cols) - half :]
    lines = [
        '<table class="dataframe">',
        "  <thead>",
        '    <tr style="text-align: right;">',
        *[f"      <th>{_cell(str(c))}</th>" for c in names],
        "    </tr>",
        "  </thead>",
        "  <tbody>",
    ]
    for r in range(n):
        lines.append("    <tr>")
        lines.extend(f"      <td>{_cell(col[r])}</td>" for col in cols)
        lines.append("    </tr>")
    lines += ["  </tbody>", "</table>"]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The profile and its report
# ---------------------------------------------------------------------------


def _is_datetime(name: str, col: np.ndarray) -> bool:
    return _is_str(col) and "time" in name.lower()


def profile_frame(df: Frame, sample_rows: int = 1_000_000, seed: int = 0) -> dict:
    """Compute the profile structure (exact overview; sampled shapes)."""
    n_rows, n_cols = len(df), len(df.columns)
    exact_missing = {c: int(_missing(df[c]).sum()) for c in df.columns}
    exact_distinct = {c: _nunique(df[c]) for c in df.columns}
    sampled = n_rows > sample_rows
    sdf = (
        _take(df, np.random.RandomState(seed).choice(n_rows, size=sample_rows, replace=False))
        if sampled else df
    )

    variables = {}
    for c in df.columns:
        col = sdf[c]
        if _is_datetime(c, col):
            prof = _profile_datetime(col, c)
        elif _is_numeric(col):
            prof = _profile_numeric(col)
        else:
            prof = _profile_categorical(col)
        prof["dtype"] = dtype_name(col)
        prof["missing"] = exact_missing[c]
        prof["missing_pct"] = 100.0 * exact_missing[c] / max(n_rows, 1)
        prof["distinct"] = exact_distinct[c]
        variables[c] = prof

    num_cols = [c for c in df.columns if _is_numeric(df[c])]
    corr = {}
    if len(num_cols) >= 2:
        sub = [sdf[c].astype(np.float64) for c in num_cols]
        corr = {
            "columns": num_cols,
            "pearson": _corr_matrix(sub, "pearson"),
            "spearman": _corr_matrix(sub, "spearman"),
        }

    total_cells = n_rows * max(n_cols, 1)
    return {
        "overview": {
            "rows": n_rows,
            "columns": n_cols,
            "missing_cells": int(sum(exact_missing.values())),
            "missing_pct": 100.0 * sum(exact_missing.values()) / max(total_cells, 1),
            "duplicate_rows": _duplicated_rows(sdf),
            "memory_bytes": memory_bytes(df),
            "sampled": sampled,
            "sample_rows": int(len(sdf)),
            "sample_seed": seed,
        },
        "variables": variables,
        "correlations": corr,
        "sample_html": head_html(df),
    }


def _corr_matrix_html(names, matrix) -> str:
    head = "<tr><th></th>" + "".join(f"<th>{_esc(c)}</th>" for c in names) + "</tr>"
    body = []
    for c, row in zip(names, matrix):
        cells = []
        for v in row:
            if v != v:
                cells.append("<td class='num'>—</td>")
                continue
            pole = "var(--pos)" if v >= 0 else "var(--neg)"
            pct = int(round(abs(v) * 100))
            cells.append(
                f"<td class='num corr' style='background:color-mix(in srgb, "
                f"{pole} {pct}%, var(--mid))'>{v:+.2f}</td>"
            )
        body.append(f"<tr><th>{_esc(c)}</th>{''.join(cells)}</tr>")
    return f"<table class='corr-m'>{head}{''.join(body)}</table>"


def render_html(profile: dict, title: str = "Dataset profile",
                headline: dict | None = None) -> str:
    """Render the profile structure as one self-contained HTML document."""
    ov = profile["overview"]
    p_l, p_d = _PAL["light"], _PAL["dark"]

    sections = []
    note = (
        f"Distribution shapes and correlations computed on a uniform sample "
        f"of {ov['sample_rows']:,} rows (seed {ov['sample_seed']}); counts, "
        f"missing and distinct are exact."
        if ov["sampled"]
        else "Computed on the full frame (no sampling)."
    )
    sections.append(
        "<section id='overview'><h2>Overview</h2>"
        + _stat_table(
            [("rows", ov["rows"]), ("columns", ov["columns"]),
             ("missing cells", ov["missing_cells"]),
             ("missing %", round(ov["missing_pct"], 4)),
             ("duplicate rows (sample)", ov["duplicate_rows"]),
             ("memory", f"{ov['memory_bytes'] / 1e6:,.1f} MB")]
        )
        + f"<p class='note'>{note}</p></section>"
    )
    if headline:
        sections.append(
            "<section id='headline'><h2>Headline statistics</h2>"
            + _stat_table(sorted(headline.items()))
            + "</section>"
        )

    var_parts = ["<section id='variables'><h2>Variables</h2>"]
    for name, v in profile["variables"].items():
        counts, labels = v["hist"]
        chart = _svg_bars(counts, labels) if counts else ""
        var_parts.append(
            f"<div class='var'><h3>{_esc(name)} "
            f"<span class='kind'>{_esc(v['kind'])} · {_esc(v['dtype'])}</span></h3>"
            f"<div class='row'><div>"
            + _stat_table(
                [("distinct", v["distinct"]), ("missing", v["missing"]),
                 ("missing %", round(v["missing_pct"], 4))] + v["stats"]
            )
            + f"</div><div>{chart}</div></div></div>"
        )
    var_parts.append("</section>")
    sections.append("".join(var_parts))

    mrows = []
    for c, v in profile["variables"].items():
        pct = v["missing_pct"]
        w = round(pct * 3)
        mrows.append(
            f"<tr><th>{_esc(c)}</th><td><svg class='chart' width='320' "
            f"height='14'><rect x='0' y='2' width='{max(w, 1 if pct else 0)}' "
            f"height='10' rx='2' fill='var(--bar)'>"
            f"<title>{pct:.3f}% missing</title></rect></svg></td>"
            f"<td class='num'>{pct:.3f}%</td></tr>"
        )
    sections.append(
        "<section id='missing'><h2>Missing values</h2>"
        f"<table class='kv'>{''.join(mrows)}</table></section>"
    )

    corr = profile["correlations"]
    if corr:
        sections.append(
            "<section id='correlations'><h2>Correlations</h2>"
            "<h3>Pearson</h3>"
            + _corr_matrix_html(corr["columns"], corr["pearson"])
            + "<h3>Spearman</h3>"
            + _corr_matrix_html(corr["columns"], corr["spearman"])
            + "</section>"
        )
    else:
        sections.append(
            "<section id='correlations'><h2>Correlations</h2>"
            "<p class='note'>Fewer than two numeric columns.</p></section>"
        )

    sections.append(
        "<section id='sample'><h2>Sample (first 10 rows)</h2>"
        f"<div class='sample'>{profile['sample_html']}</div></section>"
    )

    css = f"""
.viz-root {{ color-scheme: light;
  --surface: {p_l['surface']}; --panel: {p_l['panel']};
  --text: {p_l['text']}; --text2: {p_l['text2']}; --grid: {p_l['grid']};
  --bar: {p_l['bar']}; --pos: {p_l['pos']}; --neg: {p_l['neg']};
  --mid: {p_l['mid']}; }}
@media (prefers-color-scheme: dark) {{
  :root:where(:not([data-theme="light"])) .viz-root {{ color-scheme: dark;
    --surface: {p_d['surface']}; --panel: {p_d['panel']};
    --text: {p_d['text']}; --text2: {p_d['text2']}; --grid: {p_d['grid']};
    --bar: {p_d['bar']}; --pos: {p_d['pos']}; --neg: {p_d['neg']};
    --mid: {p_d['mid']}; }} }}
:root[data-theme="dark"] .viz-root {{ color-scheme: dark;
  --surface: {p_d['surface']}; --panel: {p_d['panel']};
  --text: {p_d['text']}; --text2: {p_d['text2']}; --grid: {p_d['grid']};
  --bar: {p_d['bar']}; --pos: {p_d['pos']}; --neg: {p_d['neg']};
  --mid: {p_d['mid']}; }}
body.viz-root {{ background: var(--surface); color: var(--text);
  font: 14px/1.5 system-ui, sans-serif; margin: 2em auto; max-width: 980px;
  padding: 0 1em; }}
h1, h2, h3 {{ color: var(--text); }}
.kind, .note, .tick {{ color: var(--text2); font-size: 12px;
  font-weight: normal; fill: var(--text2); }}
section {{ margin-bottom: 2.2em; }}
.var {{ background: var(--panel); border-radius: 8px; padding: 10px 14px;
  margin: 10px 0; }}
.row {{ display: flex; gap: 24px; flex-wrap: wrap; align-items: flex-start; }}
table {{ border-collapse: collapse; }}
td, th {{ padding: 2px 10px; text-align: left; border-bottom: 1px solid
  var(--grid); font-weight: normal; }}
th {{ color: var(--text2); }}
.num {{ text-align: right; font-variant-numeric: tabular-nums; }}
.corr-m td.corr {{ color: var(--text); min-width: 52px; }}
.sample {{ overflow-x: auto; }}
.sample table {{ font-size: 12px; }}
.chart rect:hover {{ opacity: 0.85; }}
"""
    body = "".join(sections)
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_esc(title)}</title><style>{css}</style></head>"
        f"<body class='viz-root'><h1>{_esc(title)}</h1>{body}</body></html>"
    )


def profile_report(df: Frame, title: str = "Dataset profile",
                   headline: dict | None = None,
                   sample_rows: int = 1_000_000, seed: int = 0) -> str:
    """One-call profile: compute + render."""
    return render_html(
        profile_frame(df, sample_rows=sample_rows, seed=seed), title=title, headline=headline
    )
