"""Instruction counts of the innermost loops of built kernels, from
``cuobjdump -sass``.

    python3 -m ecologysemanticsegmentation_torch.ops.sass_loops LIB.so [PATTERN ...]

For every kernel of the shared library whose mangled name contains one of
the patterns (all kernels by default), prints each innermost loop (a
backward branch whose range holds no other backward branch) that issues a
``MUFU`` instruction: its SASS instruction count and the count of each
opcode.  A loop issues one ``MUFU.EX2`` per element where the kernel takes
one exponential per element, which gives the elements of one iteration.
Needs the CUDA toolkit's ``cuobjdump`` beside ``nvcc``; nothing in the
package imports this module.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

from ._build import _nvcc

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)")


def _functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """Kernel name -> [(address, opcode, operands)], with branch targets
    resolved from labels to addresses in the operands."""
    funcs, name, insns, labels, pending = {}, None, [], {}, []
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            name, insns, labels, pending = m.group(1), [], {}, []
            funcs[name] = (insns, labels)
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.match(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    out = {}
    for fname, (insns, labels) in funcs.items():
        out[fname] = [(a, op, _TARGET.sub(lambda m: f"0x{labels.get(m.group(1), -1):x}", rest))
                      for a, op, rest in insns]
    return out


def innermost_loops(insns: list[tuple[int, str, str]]) -> list[list[tuple[int, str, str]]]:
    """The bodies [target, branch] of backward branches that contain no
    other backward branch."""
    loops = []
    for addr, op, rest in insns:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any((a, b) != (c, d) and a <= c and d <= b for c, d in loops)]
    return [[i for i in insns if a <= i[0] <= b] for a, b in inner]


def report(lib: str, patterns: list[str]) -> None:
    cuobjdump = str(Path(_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for fname, insns in _functions(sass).items():
        if patterns and not any(p in fname for p in patterns):
            continue
        for body in innermost_loops(insns):
            ops = collections.Counter(op for _, op, _ in body)
            if not any(op.startswith("MUFU") for op in ops):
                continue
            print(f"{fname}: loop 0x{body[0][0]:x}-0x{body[-1][0]:x}, {len(body)} instructions, "
                  f"{ops.get('MUFU.EX2', 0)} MUFU.EX2; {dict(sorted(ops.items()))}", flush=True)


if __name__ == "__main__":
    report(sys.argv[1], sys.argv[2:])
