#!/usr/bin/env python3
"""Print the dry run's cells (``results/dryrun_torch/*.json``, written by
``python -m repro_torch.launch.dryrun --all [--multi-pod]``) as one markdown
table, a row per architecture, a column per shape: on the (16, 16) mesh
and then the (2, 16, 16) one (MP), one rank's peak GB (and whether it
fits the card), the compute / memory / collective terms in ms (modelled
from H100 data-sheet constants, not measured) and the bound.

    python scripts/dryrun_table.py [DIR] [--against OTHER_DIR]

``--against`` compares each cell's per-rank FLOPs and collective bytes
with the same cell of another sweep (another torch release's), after the
table.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3_14b", "gemma3_1b", "glm4_9b", "tinyllama_1_1b", "qwen2_moe_a2_7b", "dbrx_132b",
         "pixtral_12b", "musicgen_medium", "zamba2_7b", "mamba2_2_7b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def compare(d: Path, other: Path) -> None:
    same_flops = same_coll = both = 0
    differ = []
    for f in sorted(d.glob("*.json")):
        g = other / f.name
        if not g.exists():
            continue
        a, b = json.loads(f.read_text()), json.loads(g.read_text())
        if a["status"] != "ok" or b["status"] != "ok":
            continue
        both += 1
        ra, rb = a["roofline"], b["roofline"]
        same_flops += ra["flops"] == rb["flops"]
        ca, cb = sum(ra["collective_bytes"].values()), sum(rb["collective_bytes"].values())
        same_coll += ca == cb
        if ra["flops"] != rb["flops"]:
            differ.append(f"{f.stem}: FLOPs {ra['flops']:.6g} vs {rb['flops']:.6g}")
        elif ca != cb:
            differ.append(f"{f.stem}: collective bytes {ca} vs {cb} ({cb / ca - 1:+.2e})")
    print(f"against {other}: {both} cells ok in both; FLOPs equal in {same_flops}, "
          f"collective bytes equal in {same_coll}")
    for line in differ:
        print(f"  {line}")


def main(argv) -> int:
    other = None
    if "--against" in argv:
        i = argv.index("--against")
        other, argv = Path(argv[i + 1]), argv[:i] + argv[i + 2:]
    d = Path(argv[0]) if argv else ROOT / "results" / "dryrun_torch"
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    counts = {}
    for arch in ARCHS:
        row = []
        for shape in SHAPES:
            cells = []
            for mesh in ("sp", "mp"):
                f = d / f"{arch}__{shape}__{mesh}.json"
                r = json.loads(f.read_text()) if f.exists() else {"status": "missing"}
                counts[r["status"]] = counts.get(r["status"], 0) + 1
                if r["status"] == "ok":
                    m, t = r["memory"], r["roofline"]
                    fit = "" if m["fits_80gb"] else " (over 80)"
                    cells.append(f"{m['peak_gb_per_chip']:.1f} GB{fit} · {1e3 * t['t_compute']:.4g}"
                                 f" / {1e3 * t['t_memory']:.4g} / {1e3 * t['t_collective']:.4g}"
                                 f" · {t['dominant']}")
                else:
                    cells.append(r["status"] + (f": {r['error'][:60]}" if "error" in r else ""))
            row.append(cells[0] if cells == ["skipped", "skipped"] else
                       f"{cells[0]}; MP {cells[1]}")
        print(f"| {arch} | " + " | ".join(row) + " |")
    print()
    print(", ".join(f"{k} {v}" for k, v in sorted(counts.items())))
    if other is not None:
        compare(d, other)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
