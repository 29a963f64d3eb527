"""English number normalization without ``inflect``: ordinals, cardinals,
decimals, dollars and pounds spelled out; the JAX package's
``text/numbers_en.py``.
"""

from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = ["", " thousand", " million", " billion", " trillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _below_thousand(n: int) -> str:
    parts = []
    if n >= 100:
        parts.append(_UNITS[n // 100] + " hundred")
        n %= 100
    if n >= 20:
        if n % 10:
            parts.append(_TENS[n // 10] + " " + _UNITS[n % 10])
        else:
            parts.append(_TENS[n // 10])
    elif n > 0 or not parts:
        parts.append(_UNITS[n])
    return " ".join(parts)


def number_to_words(n: int) -> str:
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + number_to_words(-n)
    groups = []
    scale = 0
    while n > 0 and scale < len(_SCALES):
        n, rem = divmod(n, 1000)
        if rem:
            groups.append(_below_thousand(rem) + _SCALES[scale])
        scale += 1
    return " ".join(reversed(groups))


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_IRREGULAR:
        last = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def _expand_decimal(m: re.Match) -> str:
    whole, frac = m.group(1).split(".")
    return (
        number_to_words(int(whole))
        + " point "
        + " ".join(number_to_words(int(d)) for d in frac)
    )


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1).replace(",", "")
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    out = []
    if dollars:
        out.append(f"{number_to_words(dollars)} dollar{'s' if dollars != 1 else ''}")
    if cents:
        out.append(f"{number_to_words(cents)} cent{'s' if cents != 1 else ''}")
    return ", ".join(out) if out else "zero dollars"


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(lambda m: f"{number_to_words(int(m.group(1)))} pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(_expand_decimal, text)
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(0)[:-2])), text)
    text = _number_re.sub(lambda m: number_to_words(int(m.group(0))), text)
    return text
