"""Count the machine instructions in the loops of the built kernels.

    python -m kwave_tpu_torch.ops.sass_count [name-fragment ...]

Builds the library if needed, disassembles it with ``cuobjdump -sass`` (CUDA toolkit), and
for every kernel whose mangled name holds one of the fragments (default: the 40-bit encode
kernels) prints one JSON line per loop: the loop is the span from the target of a backward
branch to that branch; its instructions are counted by class (fp32, integer and logic,
memory, control), with its loads from global memory and whether it holds no other loop.
Then, per kernel, `instructions_per_step`: the encode loops load one sample from global
memory per step, so the largest innermost loop's instructions over its global loads is
what this build spends on one step. `chip_smoke.py` takes that count from the library it
has just built and prints it over the card's instruction rate as ``issue_ms`` beside each
40-bit kernel's time. It is a property of this build, not a lower bound on the function.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

FP32 = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "MUFU", "FCHK")
MEMORY = ("LD", "ST", "ATOM", "RED", "CCTL", "MEMBAR")
CONTROL = ("BRA", "BAR", "EXIT", "NOP", "BSSY", "BSYNC", "CALL", "RET", "WARPSYNC", "YIELD",
           "BREAK", "BMOV", "DEPBAR")

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)\s*([^;]*);")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).exists():
        raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")
    return found


def _classify(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base.startswith(FP32):
        return "fp32"
    if base.startswith(MEMORY):
        return "memory"
    if base.startswith(CONTROL):
        return "control"
    return "integer"


def parse_loops(sass: str, fragments: tuple[str, ...]) -> list[dict]:
    """One entry per (kernel, loop) of the kernels whose name holds a fragment."""
    out, name, instrs = [], None, []

    def flush():
        if name is None or not any(f in name for f in fragments):
            return
        at = {addr: i for i, (addr, _, _) in enumerate(instrs)}
        found = []
        for addr, opcode, rest in instrs:
            target = re.search(r"0x([0-9a-f]+)", rest) if opcode.startswith("BRA") else None
            if not target or int(target.group(1), 16) > addr or \
                    int(target.group(1), 16) not in at:
                continue
            body = instrs[at[int(target.group(1), 16)]:at[addr] + 1]
            if len(body) == 1:  # the branch to itself that pads the end of a kernel
                continue
            counts = {"fp32": 0, "integer": 0, "memory": 0, "control": 0}
            for _, op, _ in body:
                counts[_classify(op)] += 1
            found.append(dict(kernel=name, start=hex(body[0][0]), end=hex(addr),
                              instructions=len(body), **counts,
                              global_loads=sum(op.startswith("LDG") for _, op, _ in body)))
        for loop in found:
            lo, hi = int(loop["start"], 16), int(loop["end"], 16)
            loop["innermost"] = not any(
                other is not loop and lo <= int(other["start"], 16)
                and int(other["end"], 16) <= hi for other in found)
        out.extend(found)

    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            flush()
            name, instrs = head.group(1), []
            continue
        m = _LINE.search(line)
        if m:
            instrs.append((int(m.group(1), 16), m.group(2), m.group(3)))
    flush()
    return out


def instructions_per_step(loops: list[dict], fragment: str) -> float | None:
    """Machine instructions per sampled step of the kernel whose name holds ``fragment``:
    its largest innermost loop with loads from global memory, over those loads (an
    unrolled loop holds one load per step). None where there is no such loop."""
    steps = [loop for loop in loops if fragment in loop["kernel"] and loop["innermost"]
             and loop["global_loads"]]
    if not steps:
        return None
    hot = max(steps, key=lambda loop: loop["instructions"])
    return hot["instructions"] / hot["global_loads"]


def disassemble(library: Path) -> str:
    return subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def main(argv: list[str]) -> int:
    from kwave_tpu_torch.ops import _build

    fragments = tuple(argv) or ("series40", "w40_window")
    loops = parse_loops(disassemble(_build.build()), fragments)
    for loop in loops:
        print(json.dumps(loop))
    for kernel in sorted({loop["kernel"] for loop in loops}):
        print(json.dumps(dict(kernel=kernel,
                              instructions_per_step=instructions_per_step(loops, kernel))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
