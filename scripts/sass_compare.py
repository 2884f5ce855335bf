#!/usr/bin/env python3
"""Compare the machine code of two versions of the port's CUDA sources,
kernel by kernel.

    python3 scripts/sass_compare.py OLD_CSRC NEW_CSRC NAME [NAME ...]

Each ``<dir>/<NAME>.cu`` is compiled with ``nvcc -cubin`` for ``sm_90a`` with
the port's optimisation flags, disassembled with ``cuobjdump -sass``, and
every kernel of the old build is looked up by its demangled name in the new
build.  Prints one JSON line per source: the kernels whose SASS is
identical, those that differ (with the number of instruction lines that
differ, each build's instruction lines, the first three lines from the
first that differs in each build, and each build's registers and stack
bytes from ``cuobjdump -res-usage``), those missing from the new build, and the new build's kernels
that the old one lacks.  Exits 1 if a kernel of the old build is missing or
differs.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``, ``cu++filt``); no
card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin"]


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if candidate.exists():
        return str(candidate)
    raise SystemExit(f"{name} not found: this script needs the CUDA toolkit")


def sass_by_kernel(source: Path, workdir: Path):
    """({demangled kernel name: [SASS instruction lines]}, {name: (registers,
    stack bytes)}) of one source."""
    cubin = workdir / (source.stem + ".cubin")
    subprocess.run([_tool("nvcc"), *FLAGS, "-o", str(cubin), str(source)], check=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            # cuobjdump pads each line to the widest instruction of the whole
            # file, so the spacing changes when another kernel is added
            kernels[name].append(" ".join(line.split()))
    usage_text = subprocess.run([_tool("cuobjdump"), "-res-usage", str(cubin)], check=True,
                                capture_output=True, text=True).stdout
    usage = {m.group(1): (int(m.group(2)), int(m.group(3))) for m in
             re.finditer(r"Function (\S+):\s*REG:(\d+) STACK:(\d+)", usage_text)}
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(kernels), check=True,
                               capture_output=True, text=True).stdout.splitlines()
    # anonymous namespaces get a per-file internal name; drop it
    keys = [re.sub(r"_(?:INTERNAL|GLOBAL__N)\w*", "(anon)", d) for d in demangled]
    return dict(zip(keys, kernels.values())), dict(zip(keys, (usage.get(k) for k in kernels)))


def main() -> int:
    if len(sys.argv) < 4:
        print(__doc__, file=sys.stderr)
        return 2
    old_dir, new_dir, names = Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3:]
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            old_w, new_w = Path(tmp, "old"), Path(tmp, "new")
            old_w.mkdir(exist_ok=True)
            new_w.mkdir(exist_ok=True)
            old, old_use = sass_by_kernel(old_dir / f"{name}.cu", old_w)
            new, new_use = sass_by_kernel(new_dir / f"{name}.cu", new_w)
            same, differ, missing = [], {}, []
            for kernel, lines in old.items():
                if kernel not in new:
                    missing.append(kernel)
                elif new[kernel] == lines:
                    same.append(kernel)
                else:
                    other = new[kernel]
                    n = sum(a != b for a, b in zip(lines, other)) + abs(len(lines) - len(other))
                    first = next((i for i, (a, b) in enumerate(zip(lines, other)) if a != b),
                                 min(len(lines), len(other)))
                    differ[kernel] = {"lines": n, "old_lines": len(lines),
                                      "new_lines": len(other),
                                      "first_difference": [lines[first:first + 3],
                                                           other[first:first + 3]],
                                      "regs_stack_old": old_use[kernel],
                                      "regs_stack_new": new_use[kernel]}
            ok = ok and not differ and not missing
            print(json.dumps({"source": name, "old_kernels": len(old), "identical": len(same),
                              "differ": differ, "missing_in_new": missing,
                              "only_in_new": sorted(set(new) - set(old)),
                              "identical_kernels": same}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
