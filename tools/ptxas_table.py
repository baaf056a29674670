#!/usr/bin/env python3
"""Each kernel's registers, spills and serialized-wgmma warnings from
``nvcc -Xptxas -v`` logs, side by side for two builds.

    python3 tools/ptxas_table.py OLD.log NEW.log

A log is what ``repro_torch.kernels.build`` keeps beside each library
(``build/repro_torch_kernels/<hash>/<name>.log``).  Kernels are matched
by their demangled names with an ``SsdExt`` parameter and a last template
argument ``false`` dropped, so that a kernel which gained the SSD kernels'
``X`` instantiations (B/C groups and an initial state) is read against its
own parent; an ``X = true`` instantiation has no parent.  Likewise a
``hopper::FixedWidths<a, b>`` template argument and parameter (the flash
kernels at their own head dims) are dropped, and so is a sole template
argument ``<hopper::Widths>`` (the MLA forward, which took one for its
element type when fp16 came); a ``hopper::Widths`` instantiation of the
other kernels (the padded route) is read against its own parent, and an
fp16 one (``hopper::HalfWidths``, ``hopper::FixedHalfWidths<a, b>``) has
none.  Prints one JSON
line a kernel (``old`` / ``new``: registers, spill store bytes, C7515
warnings; null where a build lacks it) and last a summary line with the
kernels whose numbers differ.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ENTRY = re.compile(r"Compiling entry function '([^']+)'")
PROPS = re.compile(r"Function properties for (\S+)")
SPILL = re.compile(r"(\d+) bytes spill stores")
REGS = re.compile(r"Used (\d+) registers")
C7515 = re.compile(r"\(C7515\).*?function '([^']+)'")


def demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def key(name: str) -> str:
    """The name a kernel is matched by across builds."""
    name = re.sub(r",?\s*hopper::SsdExt", "", name).removeprefix("void ")
    # a kernel at its own widths (hopper.cuh: FixedWidths) against its parent
    name = re.sub(r"\s*>", ">", re.sub(r",\s*hopper::FixedWidths<\d+, \d+>", "", name))
    # the MLA forward at its bf16 element type against its parent, which had none
    name = re.sub(r"(flash_fwd_bf16_ws)<hopper::Widths>", r"\1", name)
    return re.sub(r"<false>", "", re.sub(r", false>", ">", name))


def parse(text: str) -> dict[str, dict]:
    kernels: dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        if m := ENTRY.search(line):
            current = kernels.setdefault(m.group(1), {"registers": None, "spill_stores": None,
                                                      "c7515": 0})
        elif m := PROPS.search(line):
            current = kernels.setdefault(m.group(1), {"registers": None, "spill_stores": None,
                                                      "c7515": 0})
        elif current is not None and (m := SPILL.search(line)):
            current["spill_stores"] = int(m.group(1))
        elif current is not None and (m := REGS.search(line)):
            current["registers"] = int(m.group(1))
        if m := C7515.search(line):
            kernels.setdefault(m.group(1), {"registers": None, "spill_stores": None,
                                            "c7515": 0})["c7515"] += 1
    names = demangle(list(kernels))
    return {key(names[n]): v for n, v in kernels.items()}


def main() -> int:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__.split("\n\n")[1])
    old, new = (parse(Path(p).read_text()) for p in sys.argv[1:])
    changed = []
    for name in sorted(set(old) | set(new)):
        row = {"kernel": name, "old": old.get(name), "new": new.get(name)}
        print(json.dumps(row))
        if name in old and name in new and old[name] != new[name]:
            changed.append(name)
    print(json.dumps({"kernels_old": len(old), "kernels_new": len(new),
                      "matched": len(set(old) & set(new)), "changed": changed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
