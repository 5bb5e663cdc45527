"""Instructions per base of the sketch walks and of K13's compares, by
pipe, from the SASS of the built kernel library.

    python -m pgrtk_tpu_torch.kernels.sass_ops [out.txt]

Needs the CUDA toolkit (nvcc, cuobjdump), so it runs on the machine with
the card.  It builds the library (kernels/build.py), disassembles it with
`cuobjdump -sass`, finds each walk's base loop (the loop whose body holds
the walk's sequence loads: one 16-byte load per 16 bases in K1's walks;
for K13 the warp run's loop, which holds its 8-byte shared-memory loads
and compares 16 bases a lane a round) or, for K9, whose threads each walk
16 bases in straight-line code, the instructions from its one 16-byte
sequence load to the block's first barrier after it (the walk, with the
x values' and flags' stores to shared memory), and counts the
instructions per base by the pipe that issues them
on Hopper: the integer ALU pipe (IADD3, LOP3, SHF, ISETP, SEL, ...), the
FMA pipe (IMAD, IMUL: integer multiply-adds issue there), and the rest
(loads, stores, branches).  K1's compact walk skips the blocks that
store a selected mer (taken for about one base in 256 at r = 4); K9's
walk stores every base to shared memory, so all its instructions count.
So do K1's dense walk's, whose loop also holds its staging and
write-back (the stores of each 16-base step, unrolled).  Those two
counts are what the kernels issue, not their bounds, which count the
compact walk's slots and the values the dense planes hold (chip_smoke.py's
OPS_DENSE_VALUES), and for K9 its windows.  A count covers the
loop's own instructions only: it reports the subroutine calls and inner
loops the body holds ("calls", "inner loops"), whose instructions run
more often than once an iteration and are not counted; each walk's loop
holds none, and K9's region none if the compiler keeps the sequence load
after the warm-up's loop.  Each SM issues 64 ALU and 64 FMA-pipe lanes a
clock and one warp instruction a clock per quarter (128 lanes), so a
base costs at least max(alu, fma, (alu + fma + other) / 2) slots at the
64-lane rate: chip_smoke.py's OPS_WALK for the compact walk.  With an output path, the loops' SASS is
written there too.
"""
from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from . import build as kb

FMA_PIPE = ("IMAD", "IMUL")
ALU_PIPE = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IMNMX",
            "IABS", "POPC", "FLO", "BREV", "SGXT", "BMSK", "PLOP3", "P2R",
            "R2P", "ISCADD", "LOP", "SHL", "SHR", "IADD", "ICMP", "VIADD",
            "VIMNMX", "MOV")
# (kernel name fragment, the load opcode that marks the base loop, bases
# a marker load covers, skip the store blocks, and for straight-line code
# the opcode that ends the region begun at the marker, else None)
WALKS = {
    "K1 compact walk": ("sketch_walk_compact_kernel", "LDG.E.128", 16, True,
                        None),
    "K1 dense walk": ("sketch_walk_dense_kernel", "LDG.E.128", 16, False,
                      None),
    "K9 mode-1 walk": ("mode1_kernel", "LDG.E.128", 16, False, "BAR"),
    # K13's warp run: the innermost loop holding its 8-byte loads of the
    # staged t and q, one round of 16 bases a lane (per_marker None:
    # bases an iteration)
    "K13 warp compare": ("wfa_forward_kernel", "LDS.64", None, False, None),
}
WARP_ROUND_BASES = 16
# (marker opcodes match as prefixes: LDG.E.128.CONSTANT and the like)

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)(.*?);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def functions(lib: Path) -> dict:
    """{function name: [(address, opcode, operands)]} of the library."""
    cuobjdump = Path(kb._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(3),
                                  m.group(4)))
    return out


def pipe(opcode: str) -> str:
    root = opcode.split(".")[0]
    if root in FMA_PIPE:
        return "fma"
    if root in ALU_PIPE:
        return "alu"
    return "other"


def base_loop(insns, marker: str):
    """The instructions of the innermost loop (a backward branch's range)
    whose body holds the marker load."""
    best = None
    for i, (addr, op, rest) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(rest)
        if not m or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        body = [x for x in insns if lo <= x[0] <= addr]
        if any(x[1].startswith(marker) for x in body) and (
                best is None or len(body) < len(best)):
            best = body
    if best is None:
        raise RuntimeError(f"no loop holds a {marker}")
    return best


def straight(insns, marker: str, stop: str):
    """The instructions from the first marker load to the first `stop`
    instruction after it."""
    start = next((i for i, x in enumerate(insns) if x[1].startswith(marker)),
                 None)
    if start is None:
        raise RuntimeError(f"no {marker}")
    end = next((i for i in range(start, len(insns))
                if insns[i][1].startswith(stop)), len(insns))
    return insns[start:end]


def blocks(body):
    """The loop body cut into basic blocks (at branch targets and after
    branches)."""
    starts = {body[0][0]}
    for i, (addr, op, rest) in enumerate(body):
        if op.startswith(("BRA", "EXIT", "BSYNC", "RET")):
            if i + 1 < len(body):
                starts.add(body[i + 1][0])
            m = _TARGET.search(rest)
            if m:
                starts.add(int(m.group(1), 16))
    out, cur = [], []
    for x in body:
        if x[0] in starts and cur:
            out.append(cur)
            cur = []
        cur.append(x)
    out.append(cur)
    return out


def count(lib: Path, dump=None) -> dict:
    """{walk: dict(alu, fma, other per base, slots = the bound's slots
    per base)} for the walks of WALKS."""
    fns = functions(lib)
    res = {}
    for label, (frag, marker, per_marker, skip_stores, stop) in (
            WALKS.items()):
        name = next(n for n in fns if frag in n)
        body = (straight(fns[name], marker, stop) if stop
                else base_loop(fns[name], marker))
        kept = [x for blk in blocks(body)
                if not (skip_stores and any(y[1].startswith("STG")
                                            for y in blk))
                for x in blk]
        bases = (per_marker * sum(x[1].startswith(marker) for x in body)
                 if per_marker else WARP_ROUND_BASES)
        c = Counter(pipe(op) for _, op, _ in kept)
        per = {p: c[p] / bases for p in ("alu", "fma", "other")}
        per["slots"] = max(per["alu"], per["fma"],
                           (per["alu"] + per["fma"] + per["other"]) / 2)
        per["bases per iteration"] = bases
        per["calls"] = sum(op.startswith("CALL") for _, op, _ in body)
        per["inner loops"] = sum(
            op.startswith("BRA") and bool(_TARGET.search(rest))
            and body[0][0] < int(_TARGET.search(rest).group(1), 16) <= addr
            for addr, op, rest in body[:-1])
        per["opcodes"] = dict(Counter(op for _, op, _ in kept).most_common())
        res[label] = per
        if dump is not None:
            dump.write(f"== {label}: {name}, {len(body)} instructions, "
                       f"{len(kept)} counted, {bases} bases\n")
            for addr, op, rest in body:
                dump.write(f"{addr:06x} {op}{rest}\n")
    return res


def main(argv) -> int:
    kb.library()
    lib = Path(kb.build_report["path"])
    dump = open(argv[0], "w") if argv else None
    try:
        for label, per in count(lib, dump).items():
            print(f"{label}: " + ", ".join(
                f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in per.items()))
    finally:
        if dump:
            dump.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
