"""A/B of builds of the kernel library in one process, on one card.

    python -m attosecondraytracing_tpu_torch.utils.kernel_ab OTHER_CSRC [OTHER_CSRC ...]
        [--rays N] [--image-rays N] [--rounds R] [--kernels K1,K6,...] [--chains flat,zernike,grid]
        [--zernike] [--grid]

Each ``OTHER_CSRC`` holds another ``csrc/`` tree of C interface version 7
(``art_abi_version``; :func:`bind` refuses any other version): the parent
commit's (unpacked with ``git archive`` into a directory that ``.gitignore``
lists) or a design written as a tree of its own. Each is compiled with
this checkout's flags, one ``nvcc`` per source (two trees at a time), into
``build/kernels_ab/<i>/`` and linked into a library beside this checkout's
own. For every build the ptxas lines of each kernel (registers, spills,
shared memory) are printed and, where the toolkit has ``cuobjdump``, the
static opcode counts of K2's and K8's SASS. The launch-only times at N rays
(default 1e7) are then taken in turns against this checkout (A), A B B A
per round: each window is 5 back-to-back launches between CUDA events, on
each chain of ``--chains``: ``flat``, the flagship (the default),
``zernike``, the flagship with its first toroid carrying the Zernike
defects of ``chip_smoke.py``'s phase zernike, and ``grid``, with its grid
map.

* K1, K3 and K4: one prepared launch serves each library, picked up
  through ``ops/_cuda._lib``. Their
  outputs of the two builds are compared ray by ray: the alive masks, and
  p, d, opl, opl_c and incidence bit for bit on the alive rays. K3 and K4
  run on the cases of :data:`K34_CASES` (``--kernels K3`` / ``K4`` name
  each kernel's): the flagship's source bundle in its spiral order and
  shuffled, with ignore_defects False on a deformed chain, the bundle past
  the mask (K3), past the mask and the first toroid (K3, phase streamed's
  traced bundle) and the byhand CONFIG's PointSource (K4, once); beside
  each of this build's times its byte bound and its issue-slot bound
  (:func:`_k34_bounds`: its SASS by stage over the warps' passes, counted
  where the rays die, :func:`streamed_stage_warps`).
* K1i is prepared per library: the flagship's image of ``--image-rays``
  rays (default ``--rays``), 512 x 512 pixels on the plane 490 mm behind it
  (the window fitted to a probe), one launch for all its chunks; the two
  builds' images are compared (sums of weights, summed pixel differences).
* K2, K5-K7 and K8 (at 1, 20 and 128 distances: ``K8_J1``, ``K8_J20``,
  ``K8_J128``; ``K8`` names all three) are prepared per library through the
  wrappers' own ``prepare_*`` (rows follow each library's rays per block
  and tangent batch). K6 is one gradient step's work: all 18 tangent rows
  of the flagship's pose vector. Each build's sums are compared with A's,
  relative to each statistic's scale.
* ``--zernike`` also times this checkout's K1-K8 on the Zernike-deformed
  flagship, and ``--grid`` on the grid flagship (its first toroid carrying
  a ``Fourrier`` map of chip_smoke.py's phase grid: a 1 nm map of 3000 x 640
  nodes), ``ignore_defects`` True, beside the undeformed flagship's
  launches in turns (undeformed, deformed, deformed, undeformed), in the
  same process.

With K6 among ``--kernels``, each build's K6 instantiation of each chain
(``stats_params_kernel<G>``, ``<G, zernike>``, ``<G, grid>``) is read by
stage from its SASS (:func:`sass_stages`: the defect branch's height in
"defects", what runs only where ignore_defects is False in "slopes"), with
the local-memory loads and stores of each stage, and each timed K6 beside
its issue-slot bound (:func:`issue_bound` over the warp passes of the
plain trace's alive warps, once per tangent group). Each other build's
SASS is compared with this one's function by function (:func:`sass_digests`).

Prints one line per kernel, chain and build and a JSON line with each
kernel's median per chain and build and the ratio B/A (and with
``--zernike`` / ``--grid`` each kernel's deformed and undeformed medians),
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda

#: K3's and K4's cases (``--kernels K3`` / ``K4`` name all of a kernel's): the
#: kernel (fresh: K4), the bundle (:func:`_streamed_bundles`) and
#: ignore_defects. A ``_slopes`` case runs on a deformed chain only; the
#: byhand bundle runs through the byhand CONFIG's own chain, once (with the
#: flat flagship's cases)
K34_CASES = {
    "K4": (True, "flagship", True),
    "K4_slopes": (True, "flagship", False),
    "K4_shuffled": (True, "shuffled", True),
    "K4_byhand": (True, "byhand", True),
    "K3": (False, "flagship", True),
    "K3_slopes": (False, "flagship", False),
    "K3_shuffled": (False, "shuffled", True),
    "K3_masked": (False, "masked", False),
    "K3_traced": (False, "traced", True),
}
KERNELS = ("K1", "K1i", "K2", *K34_CASES, "K5", "K6", "K7", "K8_J1", "K8_J20", "K8_J128")
#: bytes a ray of K3 (every stream in and out) and K4 (p, d in) moves
K34_BYTES_PER_RAY = {False: 74, True: 61}
#: the pixels of K1i's image
K1I_BINS = (512, 512)
#: distances of the K8 runs (20: scripts/bench_stats_kernel.py's; 128: the most a pass takes)
K8_DISTANCES = {"K8_J1": 1, "K8_J20": 20, "K8_J128": 128}


def build_other(csrc: Path, out_dir: Path) -> tuple[Path, str]:
    """Compile and link the ``.cu`` sources of ``csrc`` with this checkout's
    flags into ``out_dir``; returns the library's path and the ptxas lines
    of its kernels."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda._nvcc()
    jobs = []
    for unit in sorted(csrc.glob("*.cu")):
        obj = out_dir / f"{unit.stem}.o"
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-c", "-o", str(obj), str(unit)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    log = []
    for obj, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {obj.stem}.cu:\n{text}")
        log.append(text)
    lib = out_dir / "libkernels_other.so"
    subprocess.run([nvcc, *_cuda.ARCH, "-shared", "-o", str(lib), *(str(o) for o, _p in jobs)],
                   check=True, capture_output=True)
    return lib, ptxas_summary("\n".join(log))


def ptxas_summary(log: str) -> str:
    """One line per kernel entry of a ptxas ``-v`` log: registers, shared
    memory, spill stores and loads."""
    out, name, spills = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spills = _kernel_name(line.split("'")[1]), None
        elif name and spills is None and "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    return "\n".join(out)


def ptxas_fields(log: str) -> dict:
    """``{kernel: {"registers", "stack_frame", "spill_stores",
    "spill_loads"}}`` (bytes but the registers) from the lines of
    :func:`ptxas_summary`."""
    out = {}
    for line in ptxas_summary(log).splitlines():
        name, rest = line.rsplit(": Used ", 1)
        fields = {"registers": r"^(\d+) registers", "stack_frame": r"(\d+) bytes stack frame",
                  "spill_stores": r"(\d+) bytes spill stores", "spill_loads": r"(\d+) bytes spill loads"}
        out[name] = {k: int(m.group(1)) if (m := re.search(pat, rest)) else None for k, pat in fields.items()}
    return out


#: the kernels' DEFECTS instantiations (csrc/trace_common.cuh DefectBranch)
DEFECT_BRANCHES = {"0": "", "1": "zernike", "2": "grid"}


def _kernel_name(mangled: str) -> str:
    """The kernel's name in a mangled entry, with its template arguments:
    K6/K7's tangent batch and the DEFECTS branch (``<6, zernike>``)."""
    m = re.search(r"\d+((?:[a-z]+_)+kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L([ib])(\d+)E", m.group(2) or "")
    if args:  # the last argument is DEFECTS
        *lead, (_kind, branch) = args
        args = [v for _k, v in lead] + ([DEFECT_BRANCHES.get(branch, branch)] if branch != "0" else [])
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


#: SASS opcodes counted apart: the special-function unit, the IEEE sequences'
#: slow-path checks and calls, indexed constant loads, shuffles, conversions
#: and float64 adds (the block reduction), shared memory, barriers
SASS_CLASSES = ("MUFU", "FCHK", "CALL", "LDC", "SHFL", "F2F", "DADD", "LDS", "STS", "BAR", "BRA")
#: local-memory opcodes: a stack frame's loads and stores (spills, arrays
#: indexed at run time), counted on a line of their own where a kernel has
#: any, and per stage (:func:`stage_local_memory`)
LOCAL_MEMORY = ("LDL", "STL")
#: SASS opcodes by the pipe that issues them; any other opcode is "other"
SASS_PIPES = {
    "fp32": ("FFMA", "FMUL", "FADD", "FSETP", "FSEL", "FMNMX"),
    "integer": ("IMAD", "IADD3", "LOP3", "ISETP", "SHF", "LEA", "SEL"),
    "mufu": ("MUFU",),
    "conversion": ("F2F", "I2F", "F2I", "FRND"),
    "memory": ("LDS", "LDC", "LDG", "STS", "LDL", "STL"),
    "control": ("BRA", "BSSY", "BSYNC", "WARPSYNC", "VOTE"),
}
_PIPE_OF = {op: pipe for pipe, ops in SASS_PIPES.items() for op in ops}
#: per SM and clock on the H100: warp instructions issued (4 schedulers, one
#: each) and the lanes of each pipe (a warp instruction takes 32 lane slots)
ISSUE_PER_SM_CLOCK = 4
PIPE_LANES = {"fp32": 128, "integer": 64, "mufu": 16, "conversion": 16}
H100_SMS = 132
#: an instruction line of cuobjdump -sass or nvdisasm: its offset, an
#: optional predicate, the opcode before its first modifier
_OPCODE = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P(?:\d+|T)\s+)?([A-Z][A-Z0-9_]*)")
#: the default kernels of :func:`sass_summary`: K2, K8, K7 and K6 (and K6's
#: slope sums, functions of their own in a build that calls them)
SUMMARY_KERNELS = ("fused_source_moments_kernel", "fused_source_stats_kernel", "stats_primal_kernel",
                   "stats_params_kernel", "zernike_slopes", "grid_slopes")


def pipe_counts(opcodes) -> dict:
    """``{pipe: n, ..., "other": n, "total": n}`` of a sequence of opcodes
    (:data:`SASS_PIPES`)."""
    out = dict.fromkeys((*SASS_PIPES, "other", "total"), 0)
    for op in opcodes:
        out[_PIPE_OF.get(op, "other")] += 1
        out["total"] += 1
    return out


def _pipes_text(counts) -> str:
    return ", ".join(f"{p} {counts[p]:g}" for p in (*SASS_PIPES, "other"))


def _cuda_tool(name) -> str:
    return shutil.which(name) or str(Path(_cuda._nvcc()).with_name(name))


def sass_summary(lib_path, kernels=SUMMARY_KERNELS) -> str:
    """:func:`summarize_sass` of a library's ``cuobjdump -sass`` listing."""
    try:
        sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(lib_path)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as exc:
        return f"SASS counts unavailable ({exc})"
    return summarize_sass(sass, kernels)


def sass_digests(lib_path) -> dict:
    """``{function: digest}`` of every function in a library's ``cuobjdump
    -sass`` listing: a hash of its instructions with their offsets,
    encodings and label numbers left out, so two builds whose code is the
    same read equal (line information does not enter)."""
    import hashlib

    try:
        sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(lib_path)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    out, name, h = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            name, h = line.split(":", 1)[1].strip(), hashlib.sha1()
            out[name] = h
        elif h is not None and _OPCODE.match(line):
            text = re.sub(r"/\*[0-9a-fx]+\*/", "", line)
            h.update(re.sub(r"\.L_x_\d+", ".L", text).split(";")[0].strip().encode())
    return {k: v.hexdigest() for k, v in out.items()}


def same_sass_text(a: dict, b: dict) -> str:
    """Which functions of two builds' :func:`sass_digests` have the same
    code, by kernel name."""
    common = sorted(set(a) & set(b))
    differ = [_kernel_name(k) for k in common if a[k] != b[k]]
    return (f"SASS equal to A's in {len(common) - len(differ)} of {len(common)} functions"
            + (f"; differing: {', '.join(differ)}" if differ else ""))


def summarize_sass(sass: str, kernels=SUMMARY_KERNELS) -> str:
    """Static opcode counts of the named kernels in a ``cuobjdump -sass``
    listing (every surface family is compiled in; a flagship ray runs the
    toroid's): one line per kernel with the total, the opcodes of
    :data:`SASS_CLASSES` and the opcodes by pipe (:data:`SASS_PIPES`)."""
    out, name, ops = [], None, []

    def flush():
        if name and any(k in name for k in kernels):
            counts = {c: ops.count(c) for c in SASS_CLASSES}
            parts = ", ".join(f"{c} {n}" for c, n in counts.items())
            out.append(f"SASS {_kernel_name(name)}: {len(ops)} opcodes ({parts}); by pipe: "
                       f"{_pipes_text(pipe_counts(ops))}")
            local = {op: ops.count(op) for op in LOCAL_MEMORY}
            if any(local.values()):
                out.append(f"SASS {_kernel_name(name)}: local memory "
                           + ", ".join(f"{op} {n}" for op, n in local.items()))

    for line in sass.splitlines():
        if "Function :" in line:
            flush()
            name, ops = line.split(":", 1)[1].strip(), []
        else:
            m = _OPCODE.match(line)
            if m:
                ops.append(m.group(1))
    flush()
    return "\n".join(out)


# ---------------------------------------------------------------------------
# K7's SASS by stage: nvdisasm's inline line information
# ---------------------------------------------------------------------------

#: the branches the flagship takes where the device code branches on a kind:
#: the cone source, the mask's round hole and the toroids' rectangle
FLAGSHIP_PATH = {"source": "SRC_CONE", "mask": "SUP_ROUND_HOLE", "premask": "SUP_ROUND_HOLE",
                 "toroid": "SUP_RECT"}
#: the stages of a summing kernel's instructions, in the order of a ray
#: ("defects": a deformed mirror's branch up to its normal at the shifted
#: point; "slopes": the rest of it, which runs only when ignore_defects is
#: False)
STAGES = ("setup", "ray loop", "source", "walk", "premask", "map", "mask", "toroid", "plane", "quadric",
          "defects", "slopes", "mirror", "epilogue", "reduction", "slow path")
#: the functions of a deformed mirror's branch, and its slope sums (the
#: "slopes" stage, inline or called)
DEFECT_HITS = ("zernike_hit", "deformed_hit")
SLOPE_NORMALS = ("zernike_slopes", "grid_slopes")


def _function_of_lines(lines) -> list:
    """For each line (0-based) of a CUDA source, the name of the function
    whose body holds it (None outside functions): a function starts at a
    line at column 0 naming it before ``(`` (``__launch_bounds__`` skipped,
    the name then on the next line) and ends at the next ``}`` at column 0."""
    out, name = [None] * len(lines), None
    skip = ("//", "#", "}", "{", "template", "struct", "enum", "constexpr", "using", "namespace",
            "extern", " ", "\t")
    for i, line in enumerate(lines):
        if name is None and line and not line.startswith(skip):
            names = [n for n in re.findall(r"(\w+)\s*\(", line) if n != "__launch_bounds__"]
            if not names and i + 1 < len(lines):
                names = re.findall(r"^(\w+)\s*\(", lines[i + 1])
            name = names[0] if names else None
        out[i] = name
        if line == "}" or (name and line.rstrip().endswith("}") and not line.startswith(skip)):
            name = None
    return out


def _block(lines, start: int, opener: str, closer: str | None = None) -> set:
    """The 1-based line numbers from the first line at or after ``start``
    (0-based) holding ``opener`` to the first one after it holding
    ``closer``, or, without ``closer``, to the brace that closes the
    opener's block (its then-part: an ``} else {`` closes it)."""
    i = next(k for k in range(start, len(lines)) if opener in lines[k])
    if closer is not None:
        j = next(k for k in range(i + 1, len(lines)) if closer in lines[k])
        return set(range(i + 1, j + 2))
    depth = 0
    for j in range(i, len(lines)):
        depth -= lines[j].count("}")
        if j > i and depth <= 0:
            return set(range(i + 1, j + 1))
        depth += lines[j].count("{")
    raise ValueError(f"no end of the block at {opener!r}")


class _Sources:
    """The device sources of a ``csrc/`` tree, indexed by file name: each
    line's function, and the line sets the stage rules read."""

    def __init__(self, csrc: Path):
        self.lines = {p.name: p.read_text().splitlines() for p in Path(csrc).glob("*.cu*")}
        self.func = {name: _function_of_lines(text) for name, text in self.lines.items()}
        tc = self.lines["trace_common.cuh"]
        walk = self.func["trace_common.cuh"].index("trace_chain_maps")
        self.premask = _block(tc, walk, "if (el.pre_end > el.pre_begin) {")
        # a tree whose walk holds its mask and mirror steps inline (before
        # mask_step and mirror_step): their lines
        inline = "mask_step" not in self.func["trace_common.cuh"]
        self.mask = _block(tc, walk, "if (el.kind == ELEM_MASK) {") if inline else set()
        self.mirror = (_block(tc, walk, "const S dn = ux * h.nx", "s.alive = s.alive && h.hit;")
                       if inline else set())
        src = self.func["trace_common.cuh"].index("synth_source")
        self.source_only = {kind: _block(tc, src, f"if (src.kind == {kind}) {{")
                            for kind in ("SRC_SQUARE", "SRC_EXTENDED", "SRC_DISK")}
        # copies of one element step in an unrolled walk (K7's k7_walk)
        self.copies = int(re.search(r"constexpr int MAX_ELEMENTS = (\d+);", "\n".join(tc)).group(1))
        # K7's own ray loop (a kernel on for_thread_rays has none)
        grad = self.lines["fused_grad.cu"]
        loop = "for (int r = 0; r < K7_RAYS_PER_THREAD"
        self.ray_loop = _block(grad, 0, loop) if any(loop in line for line in grad) else set()
        # a deformed mirror's slopes: the lines of its branch past the
        # ignore_defects return, per file
        self.slopes = {}
        for name, text in self.lines.items():
            func, past = self.func[name], None
            for i, line in enumerate(text):
                if func[i] != past:
                    past = None
                if func[i] in DEFECT_HITS and "ignore_defects) return;" in line:
                    past = func[i]
                elif past:
                    self.slopes.setdefault(name, set()).add(i + 1)

    def frame(self, file: str, line: int):
        """(function, text) of a 1-based line of a file of the tree."""
        name = Path(file).name
        if name not in self.lines or not 0 < line <= len(self.lines[name]):
            return None, ""
        return self.func[name][line - 1], self.lines[name][line - 1]

    def case_of(self, file: str, line: int) -> str | None:
        """The ``case X:`` label of the switch case holding a line of a
        function (None outside a case)."""
        lines, func = self.lines[Path(file).name], self.func[Path(file).name]
        for k in range(line - 1, -1, -1):
            if func[k] != func[line - 1]:
                return None
            m = re.search(r"case (\w+):", lines[k])
            if m:
                return m.group(1)
            if "switch (" in lines[k]:
                return None
        return None


def _stage_of(chain, src: _Sources, path=FLAGSHIP_PATH):
    """(stage, weight) of an instruction from its inline chain of (file,
    line), innermost first: the stage (:data:`STAGES`) by the outermost
    frame that names one, and what it counts for in one pass of its stage:
    0 where the flagship's ``path`` does not run it (a ``case`` of the
    supports' switch or a source kind's block it does not take), 1 /
    MAX_ELEMENTS in K7's walk (unrolled: its static code holds one copy of
    an element step per element), else 1."""
    frames = [(f, ln, *src.frame(f, ln)) for f, ln in chain]
    funcs = [fn for _f, _ln, fn, _t in frames]
    if any(fn in ("reduce_columns", "reduce_to_row") for fn in funcs):
        return "reduction", 1.0
    if any(fn in SLOPE_NORMALS for fn in funcs):  # called where ignore_defects is False
        return "slopes", 1.0
    if "synth_source" in funcs or "vogel_point" in funcs or "sincos_pi_law" in funcs:
        # the line of synth_source (absent from a chain that starts inside
        # an out-of-line vogel_point) decides the source kind's branch
        lines = [ln for _f, ln, fn, _t in frames if fn == "synth_source"]
        skipped = set().union(*(b for k, b in src.source_only.items() if k != path["source"]))
        return "source", float(not lines or lines[0] not in skipped)
    walk = [fr for fr in frames if fr[2] in ("trace_chain_maps", "k7_walk")]
    if walk:
        _f, ln, fn, text = walk[-1]
        inner = frames[:frames.index(walk[-1])]  # what the walk's line calls, innermost first
        called = {fr[2] for fr in inner}
        # the walks' steps are functions (mask_step, mirror_step), a mirror's
        # defect branch its lines on zk_of / grid_end (inline in an older walk)
        calls = (("defects", "zernike_hit"), ("defects", "deformed_hit"), ("toroid", "toroid_hit"),
                 ("plane", "plane_hit"), ("quadric", "quadric_hit"), ("quadric", "k7_other_hit"),
                 ("mask", "mask_step"), ("mirror", "mirror_step"), ("map", "affine"))
        step = inner[-1][3] if inner and inner[-1][2] == "mirror_step" else text
        if fn == "trace_chain_maps" and ln in src.premask:
            stage = "premask"
        elif any(g in DEFECT_HITS and l in src.slopes.get(Path(f).name, ()) for f, l, g, _t in inner):
            stage = "slopes"
        elif "__any_sync" in text:
            stage = "walk"
        elif re.search(r"\bzk_of|\bgrid_end", step):
            stage = "defects"
        elif ln in src.mask:
            stage = "mask"
        elif ln in src.mirror:
            stage = "mirror"
        else:
            stage = next((st for st, f in calls if f in called or f + "(" in text or f + "<" in text),
                         "walk")
        weight = 1.0 / src.copies if fn == "k7_walk" else 1.0
        inc = [fr for fr in frames if fr[2] == "include"]
        if inc and stage in path:
            case = src.case_of(inc[0][0], inc[0][1])
            weight *= case is None or case == path[stage]
        return stage, weight
    kernel = [fr for fr in frames if fr[2] and fr[2].endswith("_kernel")]
    if any(fn in ("stats_geometry", "stats_terms", "add_moments") for fn in funcs) \
            or (kernel and re.search(r"expf|stats_|terms|acc\[", kernel[0][3])):
        return "epilogue", 1.0
    if "for_thread_rays" in funcs or (kernel and Path(kernel[-1][0]).name == "fused_grad.cu"
                                      and kernel[-1][1] in src.ray_loop):
        return "ray loop", 1.0
    return "setup", 1.0


def parse_nvdisasm(text: str, kernel: str) -> list:
    """The instructions of the first function of an ``nvdisasm -gi``
    listing whose mangled name holds ``kernel``: ``[(opcode, chain), ...]``,
    ``chain`` the (file, line) locations of the group of ``//## File``
    lines above it (one line per frame, ``File "f", line n inlined at
    ...``), innermost first. Instructions of subroutines ending in ``RET``
    (the IEEE sequences' slow paths, past the body's exit) carry the chain
    None, unless a label names the subroutine and it is not a slow path
    (``$..._slowpath:``): a part of the body the compiler outlined (a large
    kernel's ray loop) keeps its chains."""
    out, chain, inside, sub, ended, group, label = [], [], False, [], False, False, None
    for line in text.splitlines():
        head = re.match(r"\s*\.text\.(\S+):", line)
        if head:
            if inside:
                break
            inside = kernel in head.group(1)
            continue
        if not inside:
            continue
        if line.startswith("$") and line.rstrip().endswith(":"):
            label = line
            continue
        if "//##" in line:
            frame = re.search(r'File "([^"]+)", line (\d+)', line)
            chain = (chain if group else []) + [(frame.group(1), int(frame.group(2)))]
            group = True
            continue
        group = False
        m = _OPCODE.match(line)
        if m:
            sub.append((m.group(1), chain))
            if m.group(1) in ("EXIT", "RET"):
                # a segment ends: the body's (kept) or a subroutine's (slow
                # path, or an outlined part of the body: kept)
                slow = m.group(1) == "RET" and (label is None or "_slowpath" in label)
                out += [(op, None if slow else c) for op, c in sub]
                sub, ended = [], True
    # past the body's last exit and the subroutines: its closing loop and padding
    return out if ended else sub


def stage_counts(instructions, src: _Sources, path=FLAGSHIP_PATH) -> dict:
    """``{stage: pipe counts}`` of one pass of each stage on the flagship's
    path (:func:`parse_nvdisasm`, :func:`_stage_of`'s weights: code of
    branches it does not take left out, an unrolled walk's copies counted
    as one step); the slow paths counted apart."""
    counts = {}
    for op, chain in instructions:
        stage, weight = ("slow path", 1.0) if chain is None else _stage_of(chain, src, path)
        if weight:
            c = counts.setdefault(stage, dict.fromkeys((*SASS_PIPES, "other", "total"), 0))
            c[_PIPE_OF.get(op, "other")] += weight
            c["total"] += weight
    return {st: counts[st] for st in STAGES if st in counts}


def stage_local_memory(instructions, src: _Sources, path=FLAGSHIP_PATH) -> dict:
    """``{stage: n}``: the local-memory loads and stores
    (:data:`LOCAL_MEMORY`) among one pass of each stage's instructions, as
    :func:`stage_counts` weighs them."""
    out = {}
    for op, chain in instructions:
        if op in LOCAL_MEMORY:
            stage, weight = ("slow path", 1.0) if chain is None else _stage_of(chain, src, path)
            out[stage] = out.get(stage, 0) + weight
    return out


def sass_stages(lib_path, kernel: str = "stats_primal_kernelILi0E", csrc=None, local: bool = False):
    """:func:`stage_counts` of ``kernel`` (a piece of its mangled name: the
    default is K7 without defects) in a library built from ``csrc`` (default
    this checkout's) with line information (``-lineinfo``, as
    ``_cuda.NVCC_FLAGS`` builds): its cubins extracted (``cuobjdump
    -xelf``) and disassembled with the inline chains (``nvdisasm -gi``).
    With ``local`` also its :func:`stage_local_memory`: ``(stages, local)``."""
    import tempfile

    src = _Sources(Path(csrc or _cuda.CSRC))
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([_cuda_tool("cuobjdump"), "-xelf", "all", str(Path(lib_path).resolve())],
                       cwd=tmp, check=True, capture_output=True)
        for cubin in sorted(Path(tmp).glob("*.cubin")):
            if kernel.encode() not in cubin.read_bytes():  # its symbol names the object that holds it
                continue
            res = subprocess.run([_cuda_tool("nvdisasm"), "-c", "-gi", str(cubin)], capture_output=True,
                                 text=True)
            if kernel in res.stdout:
                instructions = parse_nvdisasm(res.stdout, kernel)
                stages = stage_counts(instructions, src)
                return (stages, stage_local_memory(instructions, src)) if local else stages
    raise RuntimeError(f"no function {kernel!r} in {lib_path}")


def issue_bound(stages: dict, warps: dict, clock_hz: float, sms: int = H100_SMS) -> dict:
    """The least time [ms] the SMs take to issue a launch's warp
    instructions (``stages``: :func:`stage_counts`; ``warps``: the warps of
    32 rays through each stage in the launch, the set-up and reduction's per
    warp of the grid), at one instruction per scheduler and clock
    (:data:`ISSUE_PER_SM_CLOCK`), and each pipe's own time at its lanes
    (:data:`PIPE_LANES`): ``{"issue": ms, pipe: ms, ...}``."""
    slots = {p: 0.0 for p in ("total", *PIPE_LANES)}
    for stage, counts in stages.items():
        for p in slots:
            slots[p] += counts[p] * warps.get(stage, 0)
    rate = sms * clock_hz / 1e3
    out = {"issue": slots["total"] / (ISSUE_PER_SM_CLOCK * rate)}
    out.update({p: slots[p] * 32 / (lanes * rate) for p, lanes in PIPE_LANES.items()})
    return out


def alive_by_stage(table, spec, chunks, n_total, dev, ignore_defects: bool = True, warps: bool = False):
    """The rays of a fused source's ``chunks`` alive on entering each
    element of ``table`` and past its folded masks, then at the chain's end:
    ``[entering 0, past masks 0, entering 1, ..., at the end]``, counted on
    the plain trace (K1's plain version, chunk by chunk, the sums on the
    device). A kernel's warp exit skips the rest of the chain for the
    others, so the function needs no more than these rays' work. With
    ``warps`` also the same counts of warps (32 consecutive rays of a chunk,
    a kernel warp's lanes) holding at least one such ray: ``(rays, warps)``."""
    from ..ops import fused_trace as ft
    from ..ops import trace as tr

    def states():
        for n_local, phase, k_frac in chunks:
            k = torch.arange(n_local, dtype=torch.int64, device=dev)
            (px, py, pz), (dx, dy, dz), _rr = ft.synth_spec(spec, k, n_total, phase, k_frac)
            zeros = torch.zeros_like(px)
            yield tr.TraceState(px, py, pz, dx, dy, dz, zeros, zeros, torch.ones_like(px, dtype=torch.bool),
                                zeros)

    rays, warp_counts = _walk_counts(table, states(), dev, ignore_defects)
    return (rays, warp_counts) if warps else rays


def _walk_counts(table, states, dev, ignore_defects: bool) -> tuple:
    """(rays, warps): :func:`alive_by_stage`'s counts of the chunks of rays
    ``states`` (``TraceState`` each, warps of 32 consecutive rays of a
    chunk) through ``table``, on the plain trace."""
    from ..ops import fused_trace as ft
    from ..ops import trace as tr

    counts = torch.zeros((2, 2 * len(table.elements) + 1), dtype=torch.int64, device=dev)
    elements = ft._grids_on(table.elements, dev)

    def add(i, alive):
        counts[0, i] += alive.sum()
        lanes = torch.cat([alive, alive.new_zeros((-alive.numel()) % 32)])
        counts[1, i] += lanes.view(-1, 32).any(dim=1).sum()

    for s in states:
        for i, (el, (M, b), pre) in enumerate(zip(elements, table.maps, table.premasks)):
            add(2 * i, s.alive)
            add(2 * i + 1, tr.premask_alive(pre, s)[0] if pre else s.alive)
            s = tr.chained_step(el, M, b, s, want_incidence=False, ignore_defects=ignore_defects,
                                premasks=pre, freeze_dead=False)
        add(-1, s.alive)
    return tuple([int(c) for c in row] for row in counts.tolist())


def streamed_stage_warps(table, bundle, fresh: bool, dev, ignore_defects: bool = True,
                         chunk: int = 1 << 22) -> dict:
    """K3's (K4's with ``fresh``) warp passes through each stage of
    :data:`STAGES` in one launch on ``bundle`` through the lab-frame
    ``table``: a warp holds 32 consecutive rays (``csrc/
    streamed_trace.cu``), its loads, to-lab map and stores ("setup") once,
    the walk's stages as :func:`stage_warps` counts them from the warps with
    a ray alive (a ray that enters dead walks nothing)."""
    from ..ops import trace as tr

    n = bundle.n_rays

    def states():
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            p, d = (x[lo:hi].to(dev, torch.float32) for x in (bundle.p, bundle.d))
            zeros = torch.zeros_like(p[:, 0])
            alive = (torch.ones_like(zeros, dtype=torch.bool) if fresh
                     else bundle.alive[lo:hi].to(dev, torch.bool))
            yield tr.TraceState(*p.unbind(1), *d.unbind(1), zeros, zeros, alive, zeros)

    _rays, warps = _walk_counts(table, states(), dev, ignore_defects)
    out = stage_warps(table, warps, 0, ignore_defects)
    out["setup"] = -(-n // 32)
    return out


def stage_warps(table, warps, n_blocks: int, ignore_defects: bool = True) -> dict:
    """The warp passes through each stage of :data:`STAGES` in one launch
    of a summing kernel on ``table`` (``warps`` from :func:`alive_by_stage`;
    ``n_blocks`` blocks of 8 warps): the set-up and the reduction once per
    warp, the source and the ray loop once per warp of rays, the walk per
    element entered, an element's map and step per warp past its masks, its
    folded masks' tests per warp entering it, the epilogue per warp with a
    ray alive at the end (a deformed mirror's slopes only without
    ``ignore_defects``)."""
    from ..ops import surfaces as srf
    from ..ops.trace import MaskElement

    out = {"setup": 8 * n_blocks, "reduction": 8 * n_blocks, "ray loop": warps[0], "source": warps[0],
           "epilogue": warps[-1]}
    for i, (el, pre) in enumerate(zip(table.elements, table.premasks)):
        entering, past = warps[2 * i], warps[2 * i + 1]
        steps = ["walk"] + (["premask"] if pre else [])
        for st in steps:
            out[st] = out.get(st, 0) + entering
        if isinstance(el, MaskElement):
            kinds = ["map", "mask"]
        else:
            surface = {srf.Toroid: "toroid", srf.Plane: "plane"}.get(type(el.surface), "quadric")
            kinds = ["map", surface, "mirror"]
            if el.defects:
                kinds += ["defects"] + ([] if ignore_defects else ["slopes"])
        for st in kinds:
            out[st] = out.get(st, 0) + past
    return out


def clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``) [Hz]."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def stages_text(tag: str, stages: dict, local: dict) -> str:
    """One line per stage of :func:`sass_stages`' counts: its warp
    instructions a pass, by pipe, and its local-memory loads and stores."""
    return "\n".join(f"{tag} SASS {st}: {c['total']:g} ({_pipes_text(c)}; local memory "
                     f"{local.get(st, 0):g})" for st, c in stages.items())


#: K6's instantiations by chain (csrc/fused_grad.cu stats_params_kernel<G,
#: DEFECTS>): the mangled piece with the build's tangent batch G
K6_BRANCHES = {"flat": 0, "zernike": 1, "grid": 2}


def k6_kernel(tangent_batch: int, chain: str) -> str:
    """The piece of K6's mangled name for ``chain``'s instantiation."""
    return f"stats_params_kernelILi{tangent_batch}ELi{K6_BRANCHES[chain]}E"


def _k6_stages(lib_path, tangent_batch: int, csrc, chains) -> dict:
    """{chain: (K6's SASS by stage, its local memory by stage)} of a build
    for each chain's instantiation (:func:`sass_stages`), or {chain: the
    reason}."""
    out = {}
    for chain in chains:
        try:
            out[chain] = sass_stages(lib_path, k6_kernel(tangent_batch, chain), csrc, local=True)
        except (OSError, RuntimeError, subprocess.CalledProcessError) as exc:
            out[chain] = f"unavailable ({exc})"
    return out


def _k7_stages_text(lib_path, csrc) -> str:
    """K7's SASS by stage (:func:`sass_stages`; a walk of the tree's own,
    not trace_chain_maps, reads as "ray loop"), one line per stage."""
    try:
        stages = sass_stages(lib_path, "stats_primal_kernelILi0E", csrc)
    except (OSError, RuntimeError, subprocess.CalledProcessError) as exc:
        return f"K7 SASS by stage unavailable ({exc})"
    return "\n".join(f"K7 SASS {stage}: {c['total']:g} ({_pipes_text(c)})" for stage, c in stages.items())


def bind(path) -> ctypes.CDLL:
    """The library at ``path`` bound through ``_cuda.load``: a build of C
    interface version 7; a build of any other version is refused."""
    probe = ctypes.CDLL(str(path))
    version = probe.art_abi_version() if hasattr(probe, "art_abi_version") else None
    if version != _cuda.ABI_VERSION:
        raise RuntimeError(f"{path}: C interface version {version}: A/B takes version "
                           f"{_cuda.ABI_VERSION} only")
    return _cuda.load(path)


#: the Zernike defects of the deformed flagship's first toroid (chip_smoke.py's
#: phase zernike), over its 150 x 32 mm support
ZERNIKE_COEFFS = {(2, 0): 2e-4, (3, 1): -1e-4, (4, 2): 5e-5, (6, 3): 2e-5}
#: the flagships: undeformed, and its first toroid Zernike- or grid-deformed
CHAINS = ("flat", "zernike", "grid")


def first_toroid_defects(kind: str, support):
    """The defects of the first toroid of the flagship ``kind``: none
    ("flat"), :data:`ZERNIKE_COEFFS` ("zernike"), or chip_smoke.py's grid
    flagship's Fourier-PSD map ("grid": RMS 1e-6 mm, smallest wavelength
    0.1 mm, seed 7; 3000 x 640 nodes over the 150 x 32 mm support)."""
    from ..models import defects

    if kind == "zernike":
        return [defects.Zernike(support, ZERNIKE_COEFFS)]
    if kind == "grid":
        return [defects.Fourrier(support, RMS=1e-6, smallest=0.1, seed=7)]
    if kind != "flat":
        raise ValueError(f"chains are {CHAINS}, got {kind!r}")
    return []


def flagship(n_rays: int = 16, kind: str = "flat"):
    """The flagship (round-hole mask and two grazing toroids at 80 deg in
    f-d-f, ``__graft_entry__._flagship_chain``; its first toroid deformed by
    :func:`first_toroid_defects` of ``kind``) as host float64 element
    records, and its cone source (25 mrad along +x) of ``n_rays`` rays."""
    from ..models import masks, mirrors, supports
    from ..models.placement import OEPlacement
    from ..ops import fused_trace as ft

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    defects = first_toroid_defects(kind, supports.SupportRectangle(150, 32))
    first = mirrors.DeformedMirror(tor, defects) if defects else tor
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "NumberRays": 16}
    chain = OEPlacement(props, [mask, first, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0],
                        [0.0, 0.0, 0.0])
    spec = ft.make_source_spec("cone", np.zeros(3), np.array([1.0, 0.0, 0.0]), 25e-3, n_rays=n_rays)
    return [e.to_device("cpu", torch.float64) for e in chain.optical_elements], spec


def shuffle_order(n_rays: int, device, seed: int = 0) -> torch.Tensor:
    """A seeded random permutation of ``n_rays`` ray indices on ``device``."""
    return torch.as_tensor(np.random.default_rng(seed).permutation(n_rays), device=device)


def permuted(bundle, order):
    """``bundle``'s rays in the order ``order`` (ray i is ray order[i])."""
    return bundle._replace(**{f: getattr(bundle, f)[order]
                              for f in ("p", "d", "opl", "opl_c", "alive", "intensity", "incidence")})


def traced_bundle(elements, bundle, device, ignore_defects: bool = True):
    """``bundle`` (fresh) traced through ``elements`` by K4, as a bundle a
    user feeds on to K3: dead rays, nonzero optical paths."""
    from ..ops import fused_trace as ft
    from ..ops.bundle import RayBundle

    out = ft.streamed_trace(ft.chain_table(None, elements), bundle, device=device, fresh=True,
                            ignore_defects=ignore_defects)
    return RayBundle(p=out.p, d=out.d, opl=out.opl, opl_c=out.opl_c, alive=out.alive,
                     intensity=bundle.intensity.to(device, torch.float32), incidence=out.incidence,
                     wavelength=bundle.wavelength.to(device, torch.float32))


def byhand_problem(n_rays: int, device):
    """The byhand CONFIG (``examples/CONFIG_toroidal2f-2f_byhand.py``, a
    toroid at 80 deg in 2f-2f) with its PointSource of ``n_rays`` rays,
    Gaussian-weighted to exp(-2) at the edge: (host float64 elements, the
    bundle on ``device``)."""
    import importlib.util

    from .. import main as art
    from ..models import sources

    path = Path(__file__).resolve().parents[2] / "examples" / "CONFIG_toroidal2f-2f_byhand.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    with art._config_aliases():
        spec.loader.exec_module(module)
    chain, props = module.OpticalChainList, module.SourceProperties
    bundle = sources.ApplyGaussianIntensityToRayList(
        sources.PointSource(module.SourcePoint, -module.SourcePoint, props["Divergence"], n_rays,
                            props["Wavelength"]), float(np.exp(-2.0)))
    return ([e.to_device("cpu", torch.float64) for e in chain.optical_elements],
            bundle.to(device, torch.float32))


def _streamed_bundles(host, spec, n_rays: int, device, names) -> dict:
    """K3's and K4's input bundles ``names`` (:data:`K34_CASES`) at
    ``n_rays`` rays, each with its lab-frame table: ``{name: (table,
    bundle)}``. "flagship": the cone source's bundle in its spiral order;
    "shuffled": the same rays in a seeded random order
    (:func:`shuffle_order`); "masked": the flagship bundle past the mask
    (ignore_defects False) before the toroids; "traced": past the mask and
    the first toroid before the second (phase streamed's bundle); "byhand":
    :func:`byhand_problem`."""
    from ..ops import fused_trace as ft

    out = {}
    bundle = ft.source_bundle(spec, n_rays, device=device)
    for name in names:
        if name == "flagship":
            out[name] = (ft.chain_table(None, host), bundle)
        elif name == "shuffled":
            out[name] = (ft.chain_table(None, host), permuted(bundle, shuffle_order(n_rays, device)))
        elif name == "masked":
            out[name] = (ft.chain_table(None, host[1:]),
                         traced_bundle(host[:1], bundle, device, ignore_defects=False))
        elif name == "traced":
            out[name] = (ft.chain_table(None, host[2:]), traced_bundle(host[:2], bundle, device))
        else:
            elements, byhand = byhand_problem(n_rays, device)
            out[name] = (ft.chain_table(None, elements), byhand)
    return out


def _alive_outputs(outs):
    """A bundle's alive mask and its p, d, opl, opl_c and incidence on the
    alive rays (copies)."""
    alive = outs.alive.clone()
    return alive, [x[alive].clone() for x in (outs.p, outs.d, outs.opl, outs.opl_c, outs.incidence)]


def _problems(n_rays: int, device, kind: str = "flat", n_image: int | None = None, k34=("K3", "K4")):
    """The flagship (round-hole mask and two grazing toroids in f-d-f, 25
    mrad cone source; its first toroid deformed by
    :func:`first_toroid_defects` of ``kind``) at ``n_rays`` rays: prepared
    launches of K1 and of K3's and K4's cases ``k34`` (:data:`K34_CASES`;
    any build), and ``per_lib(lib)``
    giving each library's ``{kernel: (launch, result)}`` of K2, K8 (1, 20
    and 128 distances over +-10 mm, per-distance chief-ray delay offsets),
    K5, K6 (the step's 18 tangent rows of scripts/bench_fused_grad.py's
    misalignment, Gaussian edge exp(-2)) and K7, and K1i at ``n_image`` rays
    (default ``n_rays``).
    Returns ``(shared, per_lib, results)``: ``results`` holds K1's and the
    K3 and K4 cases' outputs as the last launch left them, and each case's
    (table, bundle) under ``"K34_inputs"``."""
    from ..analysis import alignment as al
    from ..analysis import gigascan as gs
    from ..models.detector import Detector
    from ..ops import fused_grad as fg
    from ..ops import fused_scan as fs
    from ..ops import fused_trace as ft

    host, spec = flagship(n_rays, kind)
    edge = float(np.exp(-2.0))
    table = ft.chain_table(spec, host)
    outs, k1 = ft.prepare_fused_source_trace(table, spec, n_rays, device=device)
    k1()
    det = Detector(np.zeros(3))
    det.autoplace(ft.probe_trace(spec, host, 4096, device=device, dtype=torch.float32), 490.0)
    rot = det._plane_rotation()
    opl_ref, inv_dn = ft.chief_ray_refs(spec, host, det.centre, det.normal, device=device,
                                        dtype=torch.float32)
    bdet = ft.bake_detector(host, det.centre, det.normal, rot, opl_ref=opl_ref, inv_dn_chief=inv_dn)
    chunks = ft.source_chunks("cone", n_rays, n_rays)
    bundles = _streamed_bundles(host, spec, n_rays, device, {K34_CASES[k][1] for k in k34})
    shared, results = {"K1": k1}, {"K1": lambda: _alive_outputs(outs), "K34_inputs": {}}
    for key in k34:
        fresh, which, ignore = K34_CASES[key]
        table34, bundle34 = bundles[which]
        outs34, shared[key] = ft.prepare_streamed_trace(table34, bundle34, fresh=fresh, device=device,
                                                        ignore_defects=ignore)
        results[key] = lambda outs34=outs34: _alive_outputs(outs34)
        results["K34_inputs"][key] = bundles[which]
    dets = {}
    for key, J in K8_DISTANCES.items():
        distances = (0.0,) if J == 1 else tuple(float(d) for d in np.linspace(-10, 10, J))
        dets[key] = ft.bake_detector(host, det.centre, det.normal, rot, opl_ref=opl_ref,
                                     inv_dn_chief=inv_dn, distances=distances,
                                     delay_offsets=tuple(-d * inv_dn for d in distances))

    sspec = fs.make_scan_spec("cone", host, n_rays)
    svec = fs.scan_chain_scalars(host, spec.rot, spec.origin, det.centre, det.normal, rot)
    aux = fs.scan_aux(chunks, opl_ref, inv_dn, 0.0, spec.radius, edge)

    params = al.zero_params(len(host))
    params.angles[1, 0] = 2e-4
    params.shifts[1, 0] = 0.05
    geo =(np.asarray(spec.rot, np.float64), np.asarray(spec.origin, np.float64), det.centre,
           det.normal, rot)
    lspec = fg.FusedLossSpec(source_kind="cone", source_radius=float(spec.radius),
                             elements=tuple(host), opl_ref=float(opl_ref), gaussian_edge=edge,
                             n_rays=n_rays, duration_weight=0.0, survival_weight=1.0)
    gsvec = fg.chain_scalars_np(fg._apply_params_np(host, params), *geo)
    tang = fg.scalar_tangents(host, params, *geo)
    gchunks = fg._ray_chunks(lspec, fg.GRAD_CHUNK)
    window = gs._fit_extent(spec, host, min(n_rays, gs.EXTENT_PROBE_RAYS),
                            *(torch.as_tensor(v, dtype=torch.float32, device=device)
                              for v in (det.centre, det.normal, rot)), True, device)
    idet = ft.ImageDetector(tuple(det.centre), tuple(det.normal), tuple(map(tuple, rot[:2])), opl_ref)
    images = tuple(torch.zeros(K1I_BINS[0] * K1I_BINS[1], dtype=torch.float64, device=device)
                   for _ in range(2))
    n_image = n_image or n_rays
    image_chunks = ft.source_chunks("cone", n_image, n_image)

    def per_lib(lib):
        out = {}
        _cuda._lib = lib  # rows follow this library's rays per block and tangent batch
        rows2, k2 = ft.prepare_fused_source_moments(table, spec, bdet, chunks, n_rays,
                                                    device=device, gaussian_edge=edge)
        out["K2"] = (k2, lambda: rows2.sum(dim=0).cpu().numpy())
        for key, kdet in dets.items():
            rows8, k8 = ft.prepare_fused_source_stats(table, spec, kdet, chunks, n_rays,
                                                      device=device, gaussian_edge=edge)
            out[key] = (k8, lambda rows8=rows8: ft.stats_from_rows(rows8))
        rows5, k5 = fs.prepare_scan_moments(sspec, svec, aux, chunks, device=device)
        rows6, k6 = fg.prepare_stats_params(lspec, gsvec, tang, gchunks, device=device)

        def grad_result(rows, P):
            p, t = fg.params_from_rows(rows, P)
            return np.concatenate([p, t.reshape(-1)])

        rows7, k7 = fg.prepare_stats_params(lspec, gsvec, None, gchunks, device=device)
        k1i = ft.prepare_fused_source_image(table, spec, image_chunks, n_image, idet, window,
                                            K1I_BINS, device=device, gaussian_edge=edge)

        def image_result():
            kept, _cuda._lib = _cuda._lib, lib  # the launch binds the current library
            for img in images:
                img.zero_()
            k1i(images)
            _cuda._lib = kept
            return np.concatenate([img.cpu().numpy() for img in images])

        out.update({"K5": (k5, lambda: rows5.sum(dim=0).cpu().numpy()),
                    "K6": (k6, lambda: grad_result(rows6, len(tang))),
                    "K7": (k7, lambda: grad_result(rows7, 0)),
                    "K1i": (lambda: k1i(images), image_result)})
        return out

    table6 = fg.pose_table(lspec.elements, gsvec)
    alive6 = []

    def k6_warps(lib):
        """K6's warp passes through each stage in one launch of ``lib``'s
        build (:func:`stage_warps` of the plain trace's alive warps, once
        per group of the build's tangent batch)."""
        if not alive6:
            alive6.append(alive_by_stage(table6, fg.loss_source(lspec), gchunks, lspec.n_rays, device,
                                         ignore_defects=lspec.ignore_defects, warps=True)[1])
        groups = -(-len(tang) // lib.art_tangent_batch())
        n_blocks = ft.ray_grid([c[0] for c in gchunks], lib.art_moment_rays_per_block())[1]
        return {k: v * groups for k, v in stage_warps(table6, alive6[0], n_blocks,
                                                       lspec.ignore_defects).items()}

    results["K6_warps"] = k6_warps
    return shared, per_lib, results


def _window_ms(launch, inner=5) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        launch()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / inner


def _scales(a):
    """The scale of each entry of a kernel's sums: the sum of weights and a
    second moment their own value, a first moment sqrt(w m2), a cross moment
    the root of its two second moments' product (means sit near 0, so a
    first moment's own value is no scale). (16,): the moments; (7, J) or
    (7,): the stats sums."""
    a = np.abs(np.asarray(a, np.float64))
    if a.shape[0] == 7:
        w, _wx, _wy, wxx, wyy, _wd, wdd = a
        return np.stack([w, np.sqrt(w * wxx), np.sqrt(w * wyy), wxx, wyy, np.sqrt(w * wdd), wdd])
    w, m2 = a[0], {"x0": a[7], "y0": a[8], "d0": a[9], "cx": a[13], "cy": a[14], "cd": a[15]}
    first = [np.sqrt(w * m2[k]) for k in ("x0", "y0", "d0", "cx", "cy", "cd")]
    cross = [np.sqrt(m2[p] * m2[q]) for p, q in (("x0", "cx"), ("y0", "cy"), ("d0", "cd"))]
    return np.array([w, *first, a[7], a[8], a[9], *cross, a[13], a[14], a[15]])


def _difference(key, a, b) -> str:
    """B's sums against A's: the largest difference relative to each
    statistic's scale, the spatial sums and the delay sums apart (the delay
    sums carry the float32 optical path's rounding, fs-scale on ~1 m: a build
    that rounds differently moves them by a large share of their scale) (K6:
    primal sums so, tangents relative to the largest tangent of their
    statistic)."""
    def rel(x, y):
        d = np.abs(y - x) / np.maximum(_scales(x), 1e-300)
        delay = np.zeros(len(d), bool)
        delay[[5, 6] if len(d) == 7 else [3, 6, 9, 12, 15]] = True
        return f"{float(d[~delay].max()):.3g} (spatial) and {float(d[delay].max()):.3g} (delay)"

    if key == "K1i":
        wa, wb = a[:len(a) // 2], b[:len(b) // 2]
        da, db = a[len(a) // 2:], b[len(b) // 2:]
        return (f"sums of weights within {abs(wb.sum() / wa.sum() - 1):.3g}, pixels' weights within "
                f"{np.abs(wb - wa).sum() / wa.sum():.3g} and weight x delay within "
                f"{np.abs(db - da).sum() / max(np.abs(da).sum(), 1e-300):.3g} (summed, relative)")
    if key == "K6":
        pa, ta = a[:7], a[7:].reshape(-1, 7)
        pb, tb = b[:7], b[7:].reshape(-1, 7)
        scale = np.maximum(np.abs(ta).max(axis=0), 1e-300)
        return (f"primal sums within {rel(pa, pb)} of scale, tangents within "
                f"{np.max(np.abs(tb - ta) / scale):.3g} of each statistic's largest")
    return f"sums within {rel(a, b)} of scale"


def _outputs_difference(a, b) -> str:
    """K1's outputs of two builds (``(alive, [p, d, opl, opl_c, incidence]
    on the alive rays)``): whether the alive masks are equal and how many
    alive rays differ in any output bit."""
    (alive_a, xa), (alive_b, xb) = a, b
    if not torch.equal(alive_a, alive_b):
        return f"; alive masks differ on {int((alive_a != alive_b).sum())} rays"
    differ = torch.zeros(int(alive_a.sum()), dtype=torch.bool, device=alive_a.device)
    fields = []
    for name, u, v in zip(("p", "d", "opl", "opl_c", "incidence"), xa, xb):
        same = (u.view(torch.int32) == v.view(torch.int32))
        same = same.all(dim=1) if same.ndim == 2 else same
        differ |= ~same
        if not bool(same.all()):
            fields.append(f"{name} on {int((~same).sum())} (max |diff| {float((u - v).abs().max()):.3g})")
    return (f"; alive masks equal, {int(differ.sum())} of {differ.numel()} alive rays differ in "
            f"p, d, opl, opl_c or incidence (bit for bit){': ' + ', '.join(fields) if fields else ''}")


def _ab(key, shared, own, name, lib_a, lib, rounds, results=None):
    """A B B A rounds of one kernel against one other build: (A ms, B ms,
    the sums' or outputs' difference, or "")."""
    libs = {"A": lib_a, "B": lib}
    if key in shared:
        launch = {"A": shared[key], "B": shared[key]}
        outcome = None
        if results and key in results:
            got = {}
            for ab in ("A", "B"):
                _cuda._lib = libs[ab]
                launch[ab]()
                torch.cuda.synchronize()
                got[ab] = results[key]()
            _cuda._lib = lib_a
            compared = _outputs_difference(got["A"], got["B"])
    else:
        launch = {"A": own["A"][key][0], "B": own[name][key][0]}
        outcome = {"A": own["A"][key][1], "B": own[name][key][1]}
    times = {"A": [], "B": []}
    for ab in ("A", "B"):
        _cuda._lib = libs[ab]
        launch[ab]()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for ab in ("A", "B", "B", "A"):
            _cuda._lib = libs[ab]
            times[ab].append(_window_ms(launch[ab]))
    _cuda._lib = lib_a
    diff = f"; {_difference(key, outcome['A'](), outcome['B']())}" if outcome else ""
    if key in shared and results and key in results:
        diff = compared
    return float(np.median(times["A"])), float(np.median(times["B"])), diff


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other_csrc", type=Path, nargs="+")
    parser.add_argument("--rays", type=float, default=1e7)
    parser.add_argument("--image-rays", type=float, default=None)
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--kernels", default=",".join(KERNELS))
    parser.add_argument("--chains", default="flat")
    parser.add_argument("--zernike", action="store_true")
    parser.add_argument("--grid", action="store_true")
    args = parser.parse_args(argv)
    keys = []
    for k in args.kernels.split(","):
        if k in ("K3", "K4"):
            keys += [c for c in K34_CASES if c.split("_")[0] == k]
        else:
            keys += list(K8_DISTANCES) if k == "K8" else [k] if k else []
    chains = [c for c in args.chains.split(",") if c]
    if not set(keys) <= set(KERNELS) or not set(chains) <= set(CHAINS):
        raise SystemExit(f"--kernels takes {KERNELS} and K8; --chains {CHAINS}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    ab_dir = _cuda.BUILD_DIR.parent / "kernels_ab"
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source each, beside this build
        builds = [pool.submit(build_other, csrc, ab_dir / str(i))
                  for i, csrc in enumerate(args.other_csrc)]
        lib_a = _cuda.library()
        print(f"A = this checkout\n{ptxas_summary(_cuda.build_log_path().read_text())}\n"
              f"{sass_summary(lib_a._name)}", flush=True)
        if "K7" in keys:
            print(_k7_stages_text(lib_a._name, _cuda.CSRC), flush=True)
        k6_stages = {}
        if "K6" in keys:
            k6_stages["A"] = _k6_stages(lib_a._name, _cuda.tangent_batch(), _cuda.CSRC, chains)
        others = []
        for i, (csrc, build) in enumerate(zip(args.other_csrc, builds)):
            path, regs = build.result()
            lib = bind(path)
            print(f"B{i} = {csrc}\n{regs}\n{sass_summary(path)}\n"
                  f"{same_sass_text(sass_digests(lib_a._name), sass_digests(path))}", flush=True)
            if "K7" in keys:
                print(_k7_stages_text(path, csrc), flush=True)
            if "K6" in keys:
                k6_stages[f"B{i}"] = _k6_stages(path, lib.art_tangent_batch(), csrc, chains)
            others.append((f"B{i}", str(csrc), lib))
    for name, per_chain in k6_stages.items():
        for chain, stages in per_chain.items():
            print(f"K6 {chain} ({name}) SASS by stage: {stages}" if isinstance(stages, str)
                  else stages_text(f"K6 {chain} ({name})", *stages), flush=True)
    print(f"{card}; {1 + len(others)} libraries ready in {time.perf_counter() - t0:.1f} s", flush=True)
    flat, result, k34_sass = None, {}, {}
    for chain in chains:
        k34 = [k for k in keys if k in K34_CASES and _case_runs(k, chain)]
        shared, per_lib, results = _problems(int(args.rays), device, chain,
                                             int(args.image_rays or args.rays), k34)
        own = {"A": per_lib(lib_a)}
        for name, _csrc, lib in others:
            own[name] = per_lib(lib)
        _cuda._lib = lib_a
        if chain == "flat":
            flat = (shared, own["A"])
        for key in keys:
            if key in K34_CASES and key not in k34:
                continue
            for name, csrc, lib in others:
                a, b, diff = _ab(key, shared, own, name, lib_a, lib, args.rounds, results)
                result.setdefault(chain, {}).setdefault(key, {})[name] = {
                    "other": csrc, "A_ms": a, "B_ms": b, "B_over_A": b / a}
                if key == "K6":
                    for ab, lib_ab, ms in (("A", lib_a, a), (name, lib, b)):
                        bound = _k6_issue_bound(k6_stages, ab, chain, results["K6_warps"], lib_ab)
                        if bound:
                            result[chain][key][name][f"{ab}_issue_ms"] = bound["issue"]
                            print(f"K6 {chain} flagship ({ab}): {ms:.4f} ms against its issue-slot bound "
                                  + ", ".join(f"{p} {v:.4f}" for p, v in bound.items())
                                  + " ms (per pipe: its lanes)", flush=True)
                rays = int(args.image_rays or args.rays) if key == "K1i" else int(args.rays)
                print(f"{key} {chain} flagship vs {name}: this build {a:.4f} ms, other build {b:.4f} ms "
                      f"(B/A {b / a:.4f}; {2 * args.rounds} windows each of 5 launches at "
                      f"{rays} rays){diff}", flush=True)
            if key in K34_CASES:
                bounds = _k34_bounds(key, results["K34_inputs"][key], lib_a._name, k34_sass, device)
                result.setdefault(chain, {}).setdefault(key, {})["A_bounds"] = bounds
                print(f"{key} {chain} flagship (A): byte bound {bounds['bytes_ms']:.4f} ms, issue-slot bound "
                      + ", ".join(f"{p} {v:.4f}" for p, v in bounds["issue_ms"].items())
                      + f" ms ({bounds['kernel']}; warp passes {bounds['warps']})", flush=True)
    deformed = {}
    for kind in ("zernike", "grid"):
        if getattr(args, kind):
            if flat is None:
                shared, per_lib, _results = _problems(int(args.rays), device, "flat")
                flat = (shared, per_lib(lib_a))
            deformed[kind] = _time_deformed(keys, kind, *flat, args, device)
    print(json.dumps({"card": card, "rays": int(args.rays), "kernels": result, "deformed": deformed}),
          flush=True)


def _case_runs(key: str, chain: str) -> bool:
    """Whether K3's or K4's case ``key`` runs on ``chain``: a ``_slopes``
    case on a deformed chain only, the byhand bundle once (on "flat")."""
    _fresh, which, _ignore = K34_CASES[key]
    return (not key.endswith("_slopes") or chain != "flat") and (which != "byhand" or chain == "flat")


def _defect_branch(table) -> int:
    """The DEFECTS instantiation a launch on ``table`` takes (csrc/
    trace_common.cuh with_defects): 2 with a grid map, 1 with Zernike
    defects only, else 0."""
    from ..ops.defects import GridDefect

    found = [d for el in table.elements for d in getattr(el, "defects", ())]
    return 2 if any(isinstance(d, GridDefect) for d in found) else 1 if found else 0


def grid_bytes(elements, n_rays: int, ignore_defects: bool = True) -> int:
    """What a kernel must read of the grid maps of ``elements`` for
    ``n_rays`` rays (the bounds of chip_smoke.py and of K3/K4 here): per
    map, the smaller of its packed bytes (16 per node) and four 32-byte
    sectors per ray and lookup (one lookup, two with the slopes)."""
    from ..ops.defects import GridDefect

    lookups = 1 if ignore_defects else 2
    return sum(min(16 * d.height.numel(), n_rays * lookups * 4 * 32)
               for el in elements for d in getattr(el, "defects", ()) if isinstance(d, GridDefect))


#: the card's memory rate (NVIDIA's data sheet, H100 SXM)
HBM_BYTES_PER_S = 3.35e12


def _k34_bounds(key, inputs, lib_path, sass_cache, device) -> dict:
    """This build's K3 or K4 case ``key`` on ``inputs`` (table, bundle): its
    byte bound (:data:`K34_BYTES_PER_RAY` and the grid maps' bytes) and its
    issue-slot bound (:func:`issue_bound` of its instantiation's SASS by
    stage over :func:`streamed_stage_warps`, counted where the rays die)."""
    fresh, _which, ignore = K34_CASES[key]
    table, bundle = inputs
    kernel = (f"{'streamed_trace_fresh_kernel' if fresh else 'streamed_trace_kernel'}"
              f"ILi{_defect_branch(table)}E")
    if kernel not in sass_cache:
        try:
            sass_cache[kernel] = sass_stages(lib_path, kernel, local=True)
        except (OSError, RuntimeError, subprocess.CalledProcessError) as exc:
            sass_cache[kernel] = f"unavailable ({exc})"
        if not isinstance(sass_cache[kernel], str):
            print(stages_text(f"{kernel} (A)", *sass_cache[kernel]), flush=True)
    if "clock" not in sass_cache:
        sass_cache["clock"] = clock_hz()
    n = bundle.n_rays
    out = {"kernel": kernel, "bytes_ms": (K34_BYTES_PER_RAY[fresh] * n + grid_bytes(table.elements, n, ignore))
           / HBM_BYTES_PER_S * 1e3}
    warps = streamed_stage_warps(table, bundle, fresh, device, ignore)
    out["warps"] = warps
    stages = sass_cache[kernel]
    out["issue_ms"] = ({"unavailable": float("nan")} if isinstance(stages, str)
                       else issue_bound(stages[0], warps, sass_cache["clock"]))
    return out


def _k6_issue_bound(k6_stages, name, chain, k6_warps, lib) -> dict | None:
    """:func:`issue_bound` of build ``name``'s K6 on ``chain`` (its SASS by
    stage, the launch's warp passes), or None where its stages are not
    read."""
    stages = k6_stages.get(name, {}).get(chain)
    if isinstance(stages, str) or stages is None:
        return None
    return issue_bound(stages[0], k6_warps(lib), clock_hz())


def _time_deformed(keys, kind, shared, own_a, args, device):
    """This build's launch-only times of ``keys`` on the ``kind`` flagship
    ("zernike" or "grid") beside the undeformed flagship's, in turns
    (undeformed, deformed, deformed, undeformed) per round: ``{kernel:
    {"ms", "undeformed_ms", "ratio"}}``."""
    d_shared, d_per_lib, _results = _problems(int(args.rays), device, kind)
    d_own = d_per_lib(_cuda.library())
    out = {}
    for key in keys:
        if key in K34_CASES and key not in ("K3", "K4"):
            continue
        launch = {"flat": shared[key] if key in shared else own_a[key][0],
                  "deformed": d_shared[key] if key in d_shared else d_own[key][0]}
        times = {"flat": [], "deformed": []}
        for which in launch:
            launch[which]()
        torch.cuda.synchronize()
        for _ in range(args.rounds):
            for which in ("flat", "deformed", "deformed", "flat"):
                times[which].append(_window_ms(launch[which]))
        flat, deformed = float(np.median(times["flat"])), float(np.median(times["deformed"]))
        out[key] = {"ms": deformed, "undeformed_ms": flat, "ratio": deformed / flat}
        print(f"{key} {kind} flagship (ignore_defects True): {deformed:.4f} ms, undeformed "
              f"{flat:.4f} ms (ratio {deformed / flat:.4f}; {2 * args.rounds} windows each)", flush=True)
    return out


if __name__ == "__main__":
    main()
