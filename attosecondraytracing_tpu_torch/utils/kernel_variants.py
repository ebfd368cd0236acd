"""Design variants of the gradient kernel K6 as ``csrc/`` trees of their own,
for :mod:`.kernel_ab`.

    python -m attosecondraytracing_tpu_torch.utils.kernel_variants OUT_DIR [NAME ...]

Writes ``OUT_DIR/<name>/`` for each named variant (default: all of them): a
copy of this checkout's ``csrc/`` with the edits below applied to the text.
The shipped sources hold one choice; a variant is measured as a build of its
own tree against them (``kernel_ab OUT_DIR/g3_b2 OUT_DIR/g6_b2_reg ...``), never
as a switch in the shipped code. OUT_DIR belongs in a directory that
``.gitignore`` lists (``build/``).

* ``g<G>_b<B>``: G tangent rows per block (``TANGENT_BATCH``) and a register
  budget of B 256-thread blocks per SM (``K6_MIN_BLOCKS`` in
  ``__launch_bounds__``), for G in 2, 3, 6 and B in 1, 2, 3, and G = 9
  (two groups for 18 rows) with B in 1, 2.
* ``..._reg``: each thread's 7 (1 + G) sums in registers, in place of the
  shipped column of dynamic shared memory.
* ``..._ieee``: the tangent-only factors of ``dual.cuh`` as IEEE divides
  (``1 / b``, ``0.5 / sqrt``, ``-r / (2 a)``), as in the first version.
"""

from __future__ import annotations

import argparse
import re
import shutil
from pathlib import Path

from ..ops._cuda import CSRC


def _set(name, value):
    return ("fused_grad.cu", rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};")


_REG = [
    ("fused_grad.cu", r"thread_sums<N_OUT, \(G > 0\)>\(\)", "thread_sums<N_OUT, false>()"),
    ("fused_grad.cu", r"smem = N_STATS \* \(1 \+ G\) \* MOMENT_THREADS \* \(int\)sizeof\(float\);",
     "smem = 0;"),
]

_IEEE = [
    ("dual.cuh", r"return __fdividef\(1\.0f, b\);", "return 1.0f / b;"),
    ("dual.cuh", r"0\.5f \* tangent_rcp\(r\.v\)", "0.5f / r.v"),
    ("dual.cuh", r"-0\.5f \* r\.v \* r\.v \* r\.v;", "-0.5f * r.v / a.v;"),
]


def variants() -> dict:
    """{name: [(file, pattern, replacement), ...]}"""
    out = {}
    for G, budgets in ((2, (1, 2, 3)), (3, (1, 2, 3)), (6, (1, 2, 3)), (9, (1, 2))):
        for B in budgets:
            out[f"g{G}_b{B}"] = [_set("TANGENT_BATCH", G), _set("K6_MIN_BLOCKS", B)]
    for base in ("g2_b3", "g3_b1", "g3_b2", "g3_b3", "g6_b1", "g6_b2", "g6_b3", "g9_b1", "g9_b2"):
        out[f"{base}_reg"] = out[base] + _REG
    out["g6_b2_ieee"] = out["g6_b2"] + _IEEE
    return out


def write(out_dir: Path, name: str) -> Path:
    """Write variant ``name``'s tree under ``out_dir``; every edit must
    apply exactly once."""
    dst = Path(out_dir) / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(CSRC, dst)
    for fname, pattern, repl in variants()[name]:
        path = dst / fname
        text, n = re.subn(pattern, repl, path.read_text())
        if n != 1:
            raise RuntimeError(f"variant {name}: {pattern!r} matched {n} times in {fname}")
        path.write_text(text)
    return dst


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("names", nargs="*")
    args = parser.parse_args(argv)
    for name in args.names or variants():
        print(write(args.out_dir, name), flush=True)


if __name__ == "__main__":
    main()
