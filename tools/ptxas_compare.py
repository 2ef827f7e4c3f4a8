#!/usr/bin/env python3
"""Registers, stack and spills of each kernel of one CUDA source, this
tree's beside a parent tree's, as `nvcc -Xptxas -v` reports them.

    git archive <parent> | tar -x -C build/parent
    python3 tools/ptxas_compare.py --parent build/parent [--source histogram.cu]

Compiles `src/repro_torch/kernels/csrc/<source>` of both trees with the
build's flags (`kernels/build.NVCC_FLAGS`) and prints one JSON line a
kernel instantiation of the parent: its report, this tree's report of the
same instantiation and whether they are equal. An instantiation that gained
a trailing template flag in this tree (`kChunked`) is matched to the one
whose flag is 0, the flat body. Instantiations only this tree has follow,
with `parent: null`. Needs `nvcc` (the card's machine).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def ptxas(source: Path) -> dict[tuple[str, tuple[str, ...]], str]:
    """(kernel name, template arguments) -> "registers | stack, spills"."""
    from repro_torch.kernels import build as KB

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([KB._nvcc(), *KB.NVCC_FLAGS, "-c", str(source), "-o",
                              str(Path(tmp) / "k.o")],
                             capture_output=True, text=True, check=True)
    rows, cur = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
            targs = re.search(r"_kernelI((?:L[ib]\d+E)+)E", mangled)
            cur = (name.group(1) if name else mangled,
                   tuple(re.findall(r"L[ib](\d+)E", targs.group(1))) if targs else ())
            rows[cur] = ""
        elif cur is not None and "spill" in line:
            rows[cur] = line.split(":")[-1].strip() + rows[cur]
        elif cur is not None and "Used" in line and "registers" in line:
            rows[cur] = line.split("ptxas info    :")[-1].strip() + " | " + rows[cur]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the parent tree")
    ap.add_argument("--source", default="histogram.cu")
    args = ap.parse_args()
    rel = Path("src/repro_torch/kernels/csrc") / args.source
    old, new = ptxas(Path(args.parent) / rel), ptxas(ROOT / rel)
    matched = set()
    for (name, targs), report in old.items():
        key = next((k for k in ((name, targs), (name, targs + ("0",))) if k in new), None)
        matched.add(key)
        print(json.dumps({"function": f"{name}<{','.join(targs)}>", "parent": report,
                          "tree": new.get(key), "tree_function": key and
                          f"{key[0]}<{','.join(key[1])}>",
                          "same": key is not None and new[key] == report}), flush=True)
    for key, report in new.items():
        if key not in matched:
            print(json.dumps({"function": f"{key[0]}<{','.join(key[1])}>", "parent": None,
                              "tree": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
