"""Chinese text normalization: non-standard words → spoken hanzi; the JAX
package's ``text/normalizer_zh.py``.

Dates, times, ratios, licence plates, telephone numbers, money,
percentages, fractions, ranges, temperatures, measure phrases, acronyms,
decimals and integers, as ordered regex rules over one
number-verbalization core, then punctuation canonicalization and spoken
symbols.
"""

from __future__ import annotations

import re

_DIGITS = "零一二三四五六七八九"
_UNITS_SMALL = ["", "十", "百", "千"]
_UNITS_BIG = ["", "万", "亿", "万亿"]


def verbalize_digits(s: str) -> str:
    """Digit-by-digit reading (telephone style); 1 → 幺."""
    return "".join("幺" if c == "1" else _DIGITS[int(c)] if c.isdigit() else c
                   for c in s)


def _four_digits(s: str) -> str:
    """Verbalize up to 4 digits with positional units."""
    out = []
    n = len(s)
    for i, c in enumerate(s):
        d = int(c)
        pos = n - i - 1
        if d == 0:
            if out and out[-1] != "零" and any(x != "0" for x in s[i + 1:]):
                out.append("零")
        else:
            out.append(_DIGITS[d] + _UNITS_SMALL[pos])
    return "".join(out)


def verbalize_number(s: str) -> str:
    """Integer string → spoken hanzi (standard grouping by 万/亿)."""
    s = s.lstrip("0") or "0"
    if s == "0":
        return "零"
    groups = []
    while s:
        groups.append(s[-4:])
        s = s[:-4]
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        spoken = _four_digits(g)
        if spoken:
            # Non-leading group with leading zeros needs a 零 joiner
            # (10001 → 一万零一).
            if parts and gi < len(groups) - 1 and g.zfill(4)[0] == "0":
                spoken = "零" + spoken
            parts.append(spoken + _UNITS_BIG[gi])
    out = "".join(parts).strip("零")
    # 一十X → 十X at the very front (e.g. 12 → 十二).
    if out.startswith("一十"):
        out = out[1:]
    return out or "零"


def verbalize_decimal(s: str) -> str:
    if "." not in s:
        return verbalize_number(s)
    whole, frac = s.split(".", 1)
    return (verbalize_number(whole or "0") + "点"
            + "".join(_DIGITS[int(c)] for c in frac if c.isdigit()))


def _num(m_str: str) -> str:
    return verbalize_decimal(m_str.replace(",", ""))


# Rule order matters: most specific first.
_RULES: list[tuple[re.Pattern, callable]] = []


def _rule(pattern: str):
    def deco(fn):
        _RULES.append((re.compile(pattern), fn))
        return fn
    return deco


@_rule(r"(\d{4})[-/年](\d{1,2})[-/月](\d{1,2})日?")
def _date(m):
    y = "".join(_DIGITS[int(c)] for c in m.group(1))
    return f"{y}年{verbalize_number(m.group(2))}月{verbalize_number(m.group(3))}日"


@_rule(r"(\d{1,2}):(\d{2})(?::(\d{2}))?")
def _time(m):
    h, mi, se = m.group(1), m.group(2), m.group(3)
    out = f"{verbalize_number(h)}点"
    if mi != "00":
        out += f"{verbalize_number(mi)}分"
    if se:
        out += f"{verbalize_number(se)}秒"
    return out


@_rule(r"(\d{1,2}):(\d{1,2})(?!\d)")
def _ratio(m):
    # N:M ratio (reference: normalizer/special.py _ratio_normalize). The
    # time rule above claims HH:MM with a two-digit minute field first.
    return f"{verbalize_number(m.group(1))}比{verbalize_number(m.group(2))}"


@_rule(r"([京津沪渝蒙新藏宁桂港澳黑吉辽晋冀青鲁豫苏皖浙闽赣湘鄂粤琼甘贵云陕台]"
       r"[A-Z])\s?([\dA-Z]{4,6})")
def _car_number(m):
    # License plates: keep the province+letter prefix, read the tail
    # digit-by-digit with letters spelled out, short pause between
    # (reference: normalizer/car_number.py:10-32).
    prefix = m.group(1)
    tail = " ".join(verbalize_digits(c) if c.isdigit() else c
                    for c in m.group(2))
    return f"{prefix} {tail}"


@_rule(r"1[3-9]\d{9}")
def _mobile(m):
    return verbalize_digits(m.group(0))


@_rule(r"(\d{3,4})-(\d{7,8})")
def _telephone(m):
    return verbalize_digits(m.group(1)) + verbalize_digits(m.group(2))


@_rule(r"[¥￥]\s?(\d[\d,]*(?:\.\d+)?)")
def _money_yuan(m):
    return _num(m.group(1)) + "元"


@_rule(r"\$\s?(\d[\d,]*(?:\.\d+)?)")
def _money_dollar(m):
    return _num(m.group(1)) + "美元"


@_rule(r"(\d[\d,]*(?:\.\d+)?)\s?%")
def _percent(m):
    return "百分之" + _num(m.group(1))


@_rule(r"(\d+)/(\d+)")
def _fraction(m):
    return f"{verbalize_number(m.group(2))}分之{verbalize_number(m.group(1))}"


@_rule(r"(\d+(?:\.\d+)?)[~～\-](\d+(?:\.\d+)?)")
def _range(m):
    return f"{verbalize_decimal(m.group(1))}到{verbalize_decimal(m.group(2))}"


@_rule(r"(-)?([\d,]+(?:\.\d+)?)(℃|°C)")
def _temperature(m):
    sign = "零下" if m.group(1) else ""
    return sign + _num(m.group(2)) + "摄氏度"


# The reference's full measure-unit inventory (reference:
# normalizer/measure.py:24-38): complex compounds first, then two-char
# units, then the single-char table.
_MEASURE_UNITS = (
    r"((?:千|分|厘|毫|微)米|(?:千|毫|微)克|公里|小时|"
    r"[匹张座回场尾条个首阙阵网炮顶丘棵只支袭辆挑担颗壳窠曲墙群腔"
    r"砣客贯扎捆刀令打手罗坡山岭江溪钟队单双对出口头脚板跳枝件贴"
    r"针线管名位身堂课本页家户层丝毫厘分钱两斤铢石钧锱忽"
    r"寸尺丈里寻常铺程撮勺合升斗盘碗碟叠桶笼盆"
    r"盒杯斛锅簋篮罐瓶壶卮盏箩箱煲啖袋钵年月日季刻时周天秒旬"
    r"纪岁世更夜春夏秋冬代伏辈丸泡粒幢堆根道面片块克米点])")


@_rule(r"(-?\d+(?:\.\d+)?)" + _MEASURE_UNITS)
def _measure(m):
    # Quantity + measure word → number reading (reference:
    # normalizer/measure.py:45-66), e.g. 10.23公里 → 十点二三公里.
    n = m.group(1)
    sign = "负" if n.startswith("-") else ""
    return sign + verbalize_decimal(n.lstrip("-")) + m.group(2)


@_rule(r"([A-Z]{2,4})(?=[^A-Za-z]|$)")
def _acronym(m):
    # Spell out short all-caps acronyms letter by letter (space separated so
    # the letter symbols survive the symbol table).
    return " ".join(m.group(0)) + " "


@_rule(r"(-)?(\d[\d,]*\.\d+)")
def _decimal(m):
    return ("负" if m.group(1) else "") + _num(m.group(2))


@_rule(r"(-)?(\d[\d,]*)")
def _integer(m):
    return ("负" if m.group(1) else "") + _num(m.group(2))


# Punctuation canonicalization (reference: normalizer/symbol.py
# _symbol_to_symbol_dict) runs before pronunciations so "。。" collapses.
_PUNCT = {
    ",": "，", "：": "，", ":": "，", "…": "。", "。。": "。",
    "!": "！", "?": "？", "●": "", "△": "", "＊": "",
}

# Symbol pronunciations (reference: normalizer/symbol.py
# _symbol_to_pronunciation_dict + this repo's unit abbreviations).
_SYMBOLS = {
    "＋": "加", "+": "加", "×": "乘", "÷": "除以", "=": "等于",
    "℃": "摄氏度", "km": "千米", "kg": "千克", "cm": "厘米",
    "mm": "毫米", "ml": "毫升", "㎡": "平方米",
    "#": "井", "@": "欸特", "&": "和", "π": "派", "°": "度",
    "α": "阿尔法", "β": "贝塔", "γ": "伽玛", "θ": "西塔", "μ": "缪",
    "∵": "因为", "∴": "所以",
}


def normalize_chinese(text: str) -> str:
    """Apply all rules left-to-right, earliest-match-wins per position."""
    for pattern, fn in _RULES:
        text = pattern.sub(fn, text)
    for sym, repl in _PUNCT.items():
        while sym in text:
            text = text.replace(sym, repl)
    for sym, spoken in _SYMBOLS.items():
        text = text.replace(sym, spoken)
    return re.sub(r"\s+", " ", text).strip()
