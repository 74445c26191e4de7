"""The instruction mix of a kernel's innermost loops, from its SASS.

    python -m toypathtracer_torch.tools.sass_loops [--kernels LABEL,...]
        [--compare DIR [--same HERE=THERE,...]] [--digests] [--out PATH]

Builds csrc/ (ops/_build), disassembles the library with the CUDA
toolkit's `cuobjdump -sass`, and for each named kernel (labels as
ops/_build.ptxas_usage gives them, default the per-thread render kernel
"render_kernel<0>" and the merged one "merged_render_kernel<0>") finds its
innermost loops: the address ranges closed by a backward branch that hold
no other such range.  For each loop it counts the instructions by class --
FP32 (FADD, FMUL, FFMA, FSETP, MUFU, ...), shared-memory loads (LDS),
generic loads (LD), global and constant loads, integer, branch and other
-- lists the MUFU operations and whether the loop makes a CALL (a
subroutine, such as the slow path of an IEEE square root), and keeps the
opcodes in order, so that a loop can be told by its body: the sphere test
of the nearest-hit loop takes a MUFU.RSQ, the occlusion loop none.  The
counts are static: an instruction under a branch inside the loop counts
once, whether or not it runs.

With --compare DIR (the root of another checkout of the repo, e.g. the
parent commit unpacked with `git archive` into a directory that .gitignore
lists) it builds that checkout's library too, in a process of its own, and
lists instead the kernels whose SASS is identical in the two libraries,
those that differ (and of these, those that differ only in the offsets of
the parameters they read: a struct argument that grew moves them), and
those that only one has.  --same HERE=THERE,...
compares a kernel renamed here with its name there (a kernel that became
a template: --same "hit_chunks_kernel<0>=hit_chunks_kernel").

With --digests it lists instead each kernel's SHA-256 over its SASS
(addresses and instructions, as the comparison sees them) and the
toolkit's nvcc version: a record that a later build on the same toolkit
can be held against without the other checkout (chip_smoke.py's
KEPT_SASS).

Needs the CUDA toolkit (nvcc and cuobjdump), so it runs where the kernels
build, on the machine with the card.  Writes build/sass_loops.json at the
root of the checkout (or --out) and prints the same JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from ..ops import _build

OUT = Path(__file__).resolve().parents[2] / "build" / "sass_loops.json"

DEFAULT = ("render_kernel<0>", "merged_render_kernel<0>")

CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FSET",
             "MUFU", "FCHK", "FRND", "FADD32I", "FMUL32I", "FFMA32I",
             "FSWZADD"},
    "lds": {"LDS"},
    "ld_generic": {"LD"},
    "ld_global": {"LDG"},
    "ld_const": {"LDC", "ULDC"},
    "int": {"IADD3", "IMAD", "ISETP", "LOP3", "SHF", "LEA", "SEL", "MOV",
            "IABS", "IMNMX", "PRMT", "POPC", "FLO", "I2F", "F2I", "IMUL",
            "S2R", "CS2R", "S2UR", "VIADD", "VIMNMX", "UIADD3", "UMOV",
            "ULOP3", "USHF", "UISETP", "ULEA", "USEL", "UIMAD", "UPRMT",
            "UFLO", "UPOPC", "IDP", "IADD", "ISCADD", "SGXT", "BMSK",
            "R2UR"},
    "branch": {"BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
               "BREAK", "BMOV", "JMP", "BRX", "JMX", "YIELD", "BPT"},
}

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def find_cuobjdump() -> str:
    nvcc = _build.find_nvcc()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    return tool


def functions(sass: str) -> dict:
    """cuobjdump -sass output -> {kernel label: [(address, instruction
    text)]}."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = _build.kernel_label(m.group(1))
            cur = out.setdefault(label or m.group(1), [])
            continue
        m = LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(text: str) -> str:
    """The opcode of an instruction, its predicate dropped: "MUFU.RSQ"."""
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def classify(op: str) -> str:
    root = op.split(".")[0]
    for name, ops in CLASSES.items():
        if root in ops:
            return name
    return "other"


def innermost_loops(code) -> list:
    """(start, end) address ranges closed by a backward branch and holding
    no other such range."""
    loops = []
    for addr, text in code:
        if opcode(text).split(".")[0] != "BRA":
            continue
        targets = re.findall(r"0x[0-9a-f]+", text.split(None, 2)[-1])
        if targets and int(targets[-1], 16) <= addr:
            loops.append((int(targets[-1], 16), addr))
    return sorted({(a, b) for a, b in loops
                   if not any((c, d) != (a, b) and a <= c and d <= b
                              for c, d in loops)})


def loop_mix(code, start: int, end: int) -> dict:
    body = [opcode(t) for a, t in code if start <= a <= end]
    counts = {name: 0 for name in (*CLASSES, "other")}
    for op in body:
        counts[classify(op)] += 1
    mufu = {}
    for op in body:
        if op.startswith("MUFU"):
            mufu[op] = mufu.get(op, 0) + 1
    return {"start": hex(start), "end": hex(end), "instructions": len(body),
            "by_class": counts, "mufu": mufu,
            "calls": sum(op.startswith("CALL") for op in body),
            "opcodes": body}


def disassemble(lib) -> dict:
    """functions() of a library's cuobjdump -sass output."""
    return functions(subprocess.run([find_cuobjdump(), "-sass", str(lib)],
                                    check=True, capture_output=True,
                                    text=True).stdout)


def compare(funcs: dict, other: Path, same=None) -> dict:
    """sass_diff of `funcs` against the checkout at `other` (its library
    built by its own _build)."""
    lib = subprocess.run(
        [sys.executable, "-c", "from toypathtracer_torch.ops import _build; "
         "print(_build.build())"], cwd=other, check=True,
        capture_output=True, text=True).stdout.strip().splitlines()[-1]
    return {"other": str(other), **sass_diff(funcs, disassemble(lib), same)}


def sass_diff(funcs: dict, theirs: dict, same=None) -> dict:
    """Kernels of `funcs` whose SASS equals, or differs from, that of
    `theirs` (functions() of two libraries); `same` maps a label here to
    the label of the same kernel there."""
    theirs = dict(theirs)
    for here, there in (same or {}).items():
        if there in theirs:
            theirs[here] = theirs.pop(there)
    common = sorted(set(funcs) & set(theirs))
    differ = [k for k in common if funcs[k] != theirs[k]]
    return {"identical": [k for k in common if funcs[k] == theirs[k]],
            "differ": differ,
            "parameter_offsets_only": [
                k for k in differ
                if without_parameter_offsets(funcs[k])
                == without_parameter_offsets(theirs[k])],
            "only_here": sorted(set(funcs) - set(theirs)),
            "only_there": sorted(set(theirs) - set(funcs))}


PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def without_parameter_offsets(code) -> list:
    """A kernel's SASS with every read of its parameter bank,
    c[0x0][offset], made the same: two kernels that differ only where a
    parameter moved (a struct argument grew) are equal here."""
    return [(a, PARAM.sub("c[0x0][PARAM]", t)) for a, t in code]


def digests(funcs: dict) -> dict:
    """{label: SHA-256 of its (address, instruction) lines}: equal
    exactly where sass_diff would call two kernels identical."""
    import hashlib
    return {k: hashlib.sha256("\n".join(f"{a:x} {t}" for a, t in v)
                              .encode()).hexdigest()
            for k, v in sorted(funcs.items())}


def nvcc_version() -> str:
    """The toolkit's release line from `nvcc --version`."""
    out = subprocess.run([_build.find_nvcc(), "--version"], check=True,
                         capture_output=True, text=True).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip().splitlines()[-1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(DEFAULT))
    ap.add_argument("--compare", default=None, metavar="DIR",
                    help="another checkout whose SASS to compare with")
    ap.add_argument("--same", default="", metavar="HERE=THERE,...",
                    help="kernels renamed here, compared with their old "
                         "names there")
    ap.add_argument("--digests", action="store_true",
                    help="each kernel's SASS digest and the nvcc version")
    ap.add_argument("--out", default=None,
                    help=f"output path (default {OUT})")
    args = ap.parse_args(argv)
    lib = _build.build()
    funcs = disassemble(lib)
    if args.digests:
        res = {"library": lib.name, "nvcc": nvcc_version(),
               "digests": digests(funcs)}
    elif args.compare:
        same = dict(p.split("=", 1) for p in args.same.split(",") if p)
        res = {"library": lib.name,
               **compare(funcs, Path(args.compare), same)}
    else:
        res = {"library": lib.name, "kernels": {}}
        for label in args.kernels.split(","):
            if label not in funcs:
                raise SystemExit(f"sass_loops: no kernel {label!r} in "
                                 f"{sorted(funcs)}")
            code = funcs[label]
            res["kernels"][label] = {
                "instructions": len(code),
                "loops": [loop_mix(code, a, b)
                          for a, b in innermost_loops(code)]}
    out = Path(args.out) if args.out else OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
