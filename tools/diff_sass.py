"""Compare the SASS of the kernels in two builds of the port's kernel
library, kernel by kernel.

    python tools/diff_sass.py LIB_A LIB_B

Each LIB is a built kernel library, e.g. a tree's
`sound_bubble_tpu_torch/_build/libsbt_kernels.<key>.so` after a run that
built it (older trees: `libsbt_kernels.so`)
(`tools/time_stack_kernels.py` builds each tree it is given). Runs the CUDA
toolkit's `cuobjdump -sass` on both, splits each listing by function, drops
the address and encoding comments, and prints one JSON line: the functions
whose instructions are equal in both, those that differ (their instruction
counts, the lines that differ, and whether they are equal once register
numbers are ignored), and those in only one. Needs `cuobjdump` (PATH,
$CUDA_HOME/bin or /usr/local/cuda/bin), no card.
"""
import json
import os
import re
import shutil
import subprocess
import sys


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


def functions(lib: str) -> dict:
    """{mangled name: [instruction, ...]} of the library's SASS; the hash
    that each build puts into the names of a source's anonymous namespace
    (`_GLOBAL__N__<hash>_<n>_<file>_cu_<hash>`) is taken out."""
    text = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_(\d+_\w+?_cu)_[0-9a-f]{8}",
                  r"_GLOBAL__N__\1", text)
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        ins = re.sub(r"/\*.*?\*/", "", line).strip()
        if name and ins and not ins.startswith((".", "-")):
            out[name].append(ins)
    return out


def unnumbered(ins: list) -> list:
    return [re.sub(r"\b(U?R|U?P)\d+\b", r"\1", i) for i in ins]


def main(a: str, b: str) -> None:
    fa, fb = functions(a), functions(b)
    both = sorted(set(fa) & set(fb))
    print(json.dumps({
        "equal": [n for n in both if fa[n] == fb[n]],
        "differ": {n: {"count": [len(fa[n]), len(fb[n])],
                       "lines": sum(x != y for x, y in zip(fa[n], fb[n])),
                       "registers_only": unnumbered(fa[n]) == unnumbered(
                           fb[n])}
                   for n in both if fa[n] != fb[n]},
        "only_a": sorted(set(fa) - set(fb)),
        "only_b": sorted(set(fb) - set(fa))}))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(*sys.argv[1:])
