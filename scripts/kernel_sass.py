#!/usr/bin/env python3
"""Static instruction counts of the port's kernels, from the SASS of the
library the card's machine builds.

    python3 scripts/kernel_sass.py [NAME ...]

Builds the kernels as ``chip_smoke.py`` does, disassembles the library
with ``cuobjdump -sass`` (CUDA toolkit) and prints, for every kernel
whose mangled name contains one of NAME (default: kernel 3 at D = 8 on
16-byte-aligned rows, ``fm_demod_kernelILi8ELb1``): its instruction
count, the count before and after its first CTA-wide barrier, and the
opcodes by frequency. The counts are static: what the compiler emitted,
not what a run executes. Needs nvcc and cuobjdump, no card.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)"
                   r"([.\w]*)")


def main() -> int:
    names = sys.argv[1:] or ["fm_demod_kernelILi8ELb1"]
    sys.path.insert(0, str(ROOT))
    from tdoa_tpu_torch.ops.kernels import _build

    lib = _build.build()
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    found = 0
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        fn, _, body = chunk.partition("\n")
        if not any(n in fn for n in names):
            continue
        found += 1
        ops = [m.group(1) + (m.group(2) if m.group(1) in ("LDS", "LDG", "STS",
                                                          "STG") else "")
               for m in map(INSTR.search, body.splitlines()) if m]
        bar = ops.index("BAR") if "BAR" in ops else len(ops)
        hist = collections.Counter(re.sub(r"\.(E|EF|CONSTANT|U32)\b", "", o)
                                   for o in ops)
        print(f"{fn}: {len(ops)} instructions, {bar} before the first "
              f"barrier, {len(ops) - bar} from it on")
        print("  " + ", ".join(f"{k} {v}" for k, v in hist.most_common(24)))
    if not found:
        print(f"no kernel matches {names}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
