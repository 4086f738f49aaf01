#!/usr/bin/env python3
"""Compare the machine code (SASS) of two builds of the kernel library.

    python3 tools/compare_sass.py LIB_A.so LIB_B.so

Disassembles both with ``cuobjdump -sass`` (the CUDA toolkit's; on a machine
with the card) and compares them kernel by kernel: each kernel's
instructions with their encodings, addresses dropped.  Kernels in an
anonymous namespace carry a hash of their source file's path in their
mangled names, which differs between two checkouts; it is replaced by the
file's name.  Prints the number of kernels, those whose code differs and
those found in one library only, and exits 1 unless the two are equal.
"""

import os
import re
import shutil
import subprocess
import sys

ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+")
ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (looked on PATH and in $CUDA_HOME/bin)")


def kernels(lib: str) -> dict[str, list[str]]:
    """{kernel (normalised mangled name): its instruction lines}."""
    text = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = ANON.sub(r"_GLOBAL__N__\1", m.group(1))
            out[name] = []
        elif name is not None and "/*" in line:
            out[name].append(" ".join(ADDR.sub("", line).split()))
    return out


def main(a: str, b: str) -> int:
    ka, kb = kernels(a), kernels(b)
    common = sorted(set(ka) & set(kb))
    differ = [k for k in common if ka[k] != kb[k]]
    only = sorted(set(ka) ^ set(kb))
    print(f"{len(ka)} kernels in {os.path.basename(a)}, {len(kb)} in {os.path.basename(b)}; "
          f"{len(common)} in both, {len(differ)} with other instructions, {len(only)} in one "
          f"only; {sum(len(ka[k]) for k in common)} instructions compared")
    for k in differ[:20]:
        print(f"  differs: {k} ({len(ka[k])} / {len(kb[k])} instructions)")
    for k in only[:20]:
        print(f"  in one only: {k}")
    return 0 if not differ and not only else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
