"""IPA CLI: harvest a phone inventory from TextGrids, and re-encode
metadata with it (reference: create_ipa_symbols.py,
reprocess_with_ipa.py).

Subcommands:
  harvest  — walk a TextGrid tree, count its phones, write a JSON
             inventory that ``text.symbols.load_symbol_table`` and
             preprocess.yaml's ``symbol_table`` read
  reencode — rewrite the phones of train/val metadata from the TextGrids
             (``{@p1 @p2 ...}``)
"""

from __future__ import annotations

import argparse
import json


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="efs2-torch-ipa")
    sub = ap.add_subparsers(dest="cmd", required=True)

    hv = sub.add_parser("harvest")
    hv.add_argument("--textgrid-dir", required=True)
    hv.add_argument("--out", default="ipa_inventory.json")
    hv.add_argument("--name", default="harvested")
    hv.add_argument("--top", type=int, default=20,
                    help="print the N most frequent phones")

    re_ = sub.add_parser("reencode")
    re_.add_argument("--metadata", required=True, nargs="+",
                     help="train.txt / val.txt files to re-encode")
    re_.add_argument("--textgrid-dir", required=True)
    re_.add_argument("--suffix", default="_ipa",
                     help="output files get this suffix before .txt")

    args = ap.parse_args(argv)
    from ..preprocess.ipa_harvest import (
        harvest_phones,
        reencode_metadata,
        write_inventory,
    )

    if args.cmd == "harvest":
        counts = harvest_phones(args.textgrid_dir)
        write_inventory(counts, args.out, name=args.name)
        print(f"{len(counts)} unique phones -> {args.out}")
        for phone, n in counts.most_common(args.top):
            print(f"  {phone}: {n}")
    else:
        for meta in args.metadata:
            out = (meta[:-4] if meta.endswith(".txt") else meta) + \
                args.suffix + ".txt"
            written, dropped = reencode_metadata(meta, args.textgrid_dir, out)
            print(json.dumps({"input": meta, "output": out,
                              "written": written, "dropped": dropped}))


if __name__ == "__main__":
    main()
