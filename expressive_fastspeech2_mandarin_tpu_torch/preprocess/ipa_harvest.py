"""Phone inventories harvested from MFA TextGrids, and metadata
re-encoded with them; the JAX package's ``preprocess/ipa_harvest.py:29-140``.

* ``harvest_phones``: the marks of every ``<root>/<speaker>/*.TextGrid``'s
  phones tier, with their counts (a gap's empty mark counts as ``sp``);
* ``write_inventory``: a JSON inventory that
  ``text.symbols.load_symbol_table`` reads, or that a config names as its
  ``symbol_table`` path;
* ``reencode_metadata``: each metadata line's ``{phones}`` rewritten from
  its TextGrid, prefixed, trimmed as ``get_alignment`` trims.
"""

from __future__ import annotations

import json
import os
from collections import Counter

from .textgrid import read_textgrid

PHONE_TIERS = ("phones", "phone")


def _phone_tier(tg):
    for tier in tg.tiers:
        if tier.name.lower() in PHONE_TIERS:
            return tier
    return None


def iter_textgrids(root: str):
    """Yield (speaker, basename, path) for every TextGrid under root."""
    for speaker in sorted(os.listdir(root)):
        spk_dir = os.path.join(root, speaker)
        if not os.path.isdir(spk_dir):
            continue
        for fname in sorted(os.listdir(spk_dir)):
            if fname.endswith(".TextGrid"):
                yield speaker, fname[: -len(".TextGrid")], os.path.join(
                    spk_dir, fname)


def harvest_phones(root: str) -> Counter:
    """Collect phone-mark usage counts from every TextGrid's phones tier."""
    counts: Counter = Counter()
    for _spk, _base, path in iter_textgrids(root):
        try:
            tg = read_textgrid(path)
        except (OSError, ValueError):
            continue
        tier = _phone_tier(tg)
        if tier is None:
            continue
        for iv in tier.intervals:
            mark = iv.text.strip()
            if mark:
                counts[mark] += 1
            else:
                # Gap intervals reencode as "sp" (textgrid_phones); the
                # inventory must cover them.
                counts["sp"] += 1
    return counts


def write_inventory(counts: Counter, path: str, name: str = "harvested",
                    prefix: str = "@") -> dict:
    """Write the JSON inventory (phones sorted, with frequencies)."""
    data = {
        "name": name,
        "prefix": prefix,
        "phonemes": sorted(counts),
        "frequencies": dict(sorted(counts.items())),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, ensure_ascii=False, indent=1)
    return data


def textgrid_phones(path: str) -> list[str] | None:
    """Phone marks of one TextGrid, with the preprocessor's alignment trim
    replicated exactly (preprocess/preprocessor.py:get_alignment): leading
    and trailing silences dropped, interior silences kept, empty gap marks
    normalized to ``sp`` — so reencoded phones stay 1:1 with the stored
    duration arrays."""
    tg = read_textgrid(path)
    tier = _phone_tier(tg)
    if tier is None:
        return None
    silences = ("sil", "sp", "spn")
    phones: list[str] = []
    end_idx = 0
    for iv in tier.intervals:
        p = iv.text.strip()
        if not phones and (p in silences or p == ""):
            continue
        if p in silences or p == "":
            phones.append(p or "sp")
        else:
            phones.append(p)
            end_idx = len(phones)
    return phones[:end_idx]


def reencode_metadata(meta_in: str, tg_root: str, meta_out: str,
                      prefix: str = "@") -> tuple[int, int]:
    """Rewrite each metadata line's ``{phones}`` field from its TextGrid.

    Lines whose TextGrid is missing or has no phones tier are dropped (the
    reference skips them too). Returns (written, dropped).
    """
    written = dropped = 0
    with open(meta_in) as fin, open(meta_out, "w") as fout:
        for line in fin:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("|")
            basename, speaker = parts[0], parts[1]
            tg_path = os.path.join(tg_root, speaker, basename + ".TextGrid")
            phones = None
            if os.path.exists(tg_path):
                try:
                    phones = textgrid_phones(tg_path)
                except (OSError, ValueError):
                    phones = None
            if not phones:
                dropped += 1
                continue
            tagged = [p if p.startswith(prefix) else prefix + p
                      for p in phones]
            parts[2] = "{" + " ".join(tagged) + "}"
            fout.write("|".join(parts) + "\n")
            written += 1
    return written, dropped
