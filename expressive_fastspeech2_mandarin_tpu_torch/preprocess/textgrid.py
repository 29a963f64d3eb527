"""Praat TextGrid reading and writing, long and short text formats; the JAX
package's ``preprocess/textgrid.py:16-165``.

The feature extractor reads the "phones" interval tier of MFA-style
TextGrids. A quoted mark escapes ``"`` as ``""``; an empty mark (a gap
interval) reads back as ``""``. The writer emits the long format MFA
exports.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class Interval:
    start: float
    end: float
    text: str


@dataclass
class Tier:
    name: str
    intervals: list[Interval] = field(default_factory=list)

    @property
    def start(self) -> float:
        return self.intervals[0].start if self.intervals else 0.0

    @property
    def end(self) -> float:
        return self.intervals[-1].end if self.intervals else 0.0


@dataclass
class TextGrid:
    xmin: float
    xmax: float
    tiers: list[Tier] = field(default_factory=list)

    def get_tier_by_name(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier named {name!r}; have "
                       f"{[t.name for t in self.tiers]}")


_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")
_STR_RE = re.compile(r'"((?:[^"]|"")*)"')


def _tokens(text: str):
    """Numbers and quoted strings in order; keywords and bracketed indices
    (``item [1]:``) are skipped."""
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "[":
            j = text.find("]", i)
            i = len(text) if j < 0 else j + 1
        elif ch == '"':
            m = _STR_RE.match(text, i)
            if not m:
                raise ValueError(f"unterminated string at offset {i}")
            yield ("str", m.group(1).replace('""', '"'))
            i = m.end()
        elif ch.isdigit() or (ch == "-" and i + 1 < len(text)
                              and text[i + 1].isdigit()):
            m = _NUM_RE.match(text, i)
            yield ("num", float(m.group(0)))
            i = m.end()
        else:
            i += 1


def read_textgrid(path: str) -> TextGrid:
    with open(path, encoding="utf-8") as f:
        return parse_textgrid(f.read())


def parse_textgrid(content: str) -> TextGrid:
    """A TextGrid from its text, long or short format. Point tiers are
    read past and kept empty."""
    toks = list(_tokens(content))
    # Header: "ooTextFile" "TextGrid" xmin xmax [tiers? <exists>] size
    idx = 0
    nums: list[float] = []
    while idx < len(toks) and len(nums) < 2:
        kind, val = toks[idx]
        if kind == "num":
            nums.append(val)
        idx += 1
    xmin, xmax = nums[0], nums[1]
    while idx < len(toks) and toks[idx][0] != "num":
        idx += 1
    n_tiers = int(toks[idx][1])
    idx += 1

    tg = TextGrid(xmin, xmax)
    for _ in range(n_tiers):
        # class, name, xmin, xmax, size, then the items.
        while idx < len(toks) and toks[idx][0] != "str":
            idx += 1
        tier_type = toks[idx][1]
        idx += 1
        tier_name = toks[idx][1]
        idx += 1
        vals: list[float] = []
        while idx < len(toks) and len(vals) < 3:
            if toks[idx][0] == "num":
                vals.append(toks[idx][1])
            idx += 1
        n_items = int(vals[2])
        tier = Tier(tier_name)
        width = 3 if tier_type == "IntervalTier" else 2
        for _ in range(n_items):
            entry: list = []
            while idx < len(toks) and len(entry) < width:
                entry.append(toks[idx][1])
                idx += 1
            if width == 3:
                tier.intervals.append(
                    Interval(float(entry[0]), float(entry[1]), str(entry[2])))
        tg.tiers.append(tier)
    return tg


def write_textgrid(tg: TextGrid, path: str) -> None:
    """Write the long format, every tier as an IntervalTier."""
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {tg.xmin:.6f}",
        f"xmax = {tg.xmax:.6f}",
        "tiers? <exists>",
        f"size = {len(tg.tiers)}",
        "item []:",
    ]
    for ti, tier in enumerate(tg.tiers, 1):
        lines += [
            f"    item [{ti}]:",
            '        class = "IntervalTier"',
            f'        name = "{tier.name}"',
            f"        xmin = {tg.xmin:.6f}",
            f"        xmax = {tg.xmax:.6f}",
            f"        intervals: size = {len(tier.intervals)}",
        ]
        for ii, iv in enumerate(tier.intervals, 1):
            text = iv.text.replace('"', '""')
            lines += [
                f"        intervals [{ii}]:",
                f"            xmin = {iv.start:.6f}",
                f"            xmax = {iv.end:.6f}",
                f'            text = "{text}"',
            ]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
