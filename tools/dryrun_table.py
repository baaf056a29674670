#!/usr/bin/env python3
"""Print the dry-run's cells as a markdown table, one row per
architecture × shape with the single-pod and multi-pod meshes side by side.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    python3 tools/dryrun_table.py [build/dryrun]

Each mesh's cell: status, per-device GB (the arguments plus the step's
peak of what its ops allocate), the dominant roofline term, and the collective
bytes per device by kind in GB (``AG`` all-gather, ``RS`` reduce-scatter,
``AR`` all-reduce counted twice, ``A2A`` all-to-all).  A failed cell
shows its error's first line.  The numbers are counts read against the
H100's datasheet constants, not measurements.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

KINDS = (("all-gather", "AG"), ("reduce-scatter", "RS"), ("all-reduce", "AR"),
         ("all-to-all", "A2A"))
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell_text(cell: dict | None) -> str:
    if cell is None:
        return "-"
    if cell["status"] != "ok":
        return f"**{cell['status']}**: {cell['error'].splitlines()[0][:70]}"
    r = cell["roofline"]
    coll = " ".join(f"{short} {r['coll_breakdown'][kind] / r['chips'] / 1e9:.3g}"
                    for kind, short in KINDS if r["coll_breakdown"].get(kind))
    return f"{r['per_device_hbm_gb']:.3g} GB, {r['dominant']}; {coll or 'none'}"


def main() -> None:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else "build/dryrun")
    cells = {}
    for path in sorted(root.glob("*.json")):
        c = json.loads(path.read_text())
        cells[(c["arch"], c["shape"], c["mesh"])] = c
    print("| arch | shape | single (16, 16) | multi (2, 16, 16) |")
    print("|---|---|---|---|")
    for arch in dict.fromkeys(a for a, _, _ in cells):
        for shape in SHAPES:
            single, multi = cells.get((arch, shape, "single")), cells.get((arch, shape, "multi"))
            if single is None and multi is None:
                continue
            print(f"| {arch} | {shape} | {cell_text(single)} | {cell_text(multi)} |")


if __name__ == "__main__":
    main()
