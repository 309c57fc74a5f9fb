"""Count the instructions of each loop in a built kernel library's SASS.

    python3 gpuntt_tpu_torch/utils/sass_loops.py LIBRARY PATTERN

Builds LIBRARY (a csrc/ source name, e.g. merge_u64_large) of the
`gpuntt_tpu_torch` on the Python path, disassembles it with the CUDA
toolkit's `cuobjdump -sass`, and for every kernel whose mangled name
contains PATTERN prints its instruction count and each loop (a backward
branch and the instructions it spans) with its count of instructions,
multiply-adds on the IMAD pipe, shared-memory loads and stores, global
loads and stores and barriers.  A butterfly group's cost is a loop body
divided by the butterflies it runs.  An item loop of a register pass
(one with at least 4 IMADs a word it stores; a copy loop has far fewer)
stores each of its item's words once, so its body over the words it
stores (64-bit words, or 32-bit ones for the u32 kernels) is its cost a
word; each kernel's line ends with those costs
summed over its item loops: the instructions and IMADs its passes spend
on a word.  Where a pass stores 16 or 8 bytes at a time by the
operand's alignment, its loop holds both branches: its words are the
larger of the two stores' counts, and its cost counts both branches'
instructions.  Needs nvcc and cuobjdump, so it runs where the kernels
build.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

_KINDS = {k: re.compile(r"\b" + k) for k in ("IMAD", "LDS", "STS", "LDG", "STG", "BAR")}
_STORE = re.compile(r"\bST[SG]?(\.\S+)?\s")


def stored_words(body: list[str]) -> float:
    """Words a loop body stores: those of its 128-bit stores (2 each) or
    of its narrower ones (a 64-bit or 32-bit store 1: a u32 kernel's tile
    holds 32-bit words), whichever is more (the two are a pass's two
    branches)."""
    wide = narrow = 0.0
    for t in body:
        m = _STORE.search(t + " ")
        if m:
            mods = m.group(1) or ""
            if ".128" in mods:
                wide += 2
            else:
                narrow += 1
    return max(wide, narrow)


def functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    out: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur is not None:
            out[cur].append((int(m.group(1), 16), m.group(2)))
    return out


def loops(ins: list[tuple[int, str]]) -> list[tuple[int, int, list[str]]]:
    at = {a: i for i, (a, _) in enumerate(ins)}
    found = []
    for i, (a, text) in enumerate(ins):
        if "BRA" not in text:
            continue
        m = re.search(r"(0x[0-9a-f]+)", text.split("BRA", 1)[1])
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at:
            start = int(m.group(1), 16)
            found.append((start, a, [t for _, t in ins[at[start]:i + 1]]))
    return found


def main(argv: list[str]) -> int:
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    from gpuntt_tpu_torch.ops import _build

    name, pattern = argv[1], argv[2]
    _build.library(name)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build._so_path(name)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    for fn, ins in functions(sass).items():
        if pattern not in fn:
            continue
        per_word = [0.0, 0.0]
        lines = []
        for start, end, body in loops(ins):
            counts = {k: sum(1 for t in body if pat.search(t)) for k, pat in _KINDS.items()}
            words = stored_words(body)
            text = ", ".join(f"{k} {n}" for k, n in counts.items())
            if words and counts["IMAD"] >= 4 * words:
                per_word[0] += len(body) / words
                per_word[1] += counts["IMAD"] / words
                text += (f"; item loop, {words:g} words: {len(body) / words:.1f} "
                         f"instructions and {counts['IMAD'] / words:.1f} IMAD a word")
            lines.append(f"  loop {start:#x}-{end:#x}: {len(body)} instructions; {text}")
        print(f"{fn}: {len(ins)} instructions; item loops {per_word[0]:.1f} instructions "
              f"and {per_word[1]:.1f} IMAD a word")
        print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
