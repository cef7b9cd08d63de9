#!/usr/bin/env python3
"""Where a step of kernel X1w's walk spends its clock, on one card.

    python3 tools/x1w_cycles.py [--reads N]

Writes a copy of `csrc/backtrack_windows.cu` whose walker reads `clock64()`
at six points of each step and, after the walk of block 0, prints the
cycles of the walk and of each part of its steps: round 1 (the row's
tables and the held vote), the stage decision, the row's cells, the
predecessors (their cells, the ballots, the first hits), the selection of
the op, and the prefetch rule with the loop's test; and the cycles it
waited for tiles. The copy goes through `tools/x1w_tiles.py --src` (the
same 41-read graph, banded and whole-row planes, every launch == plain),
and the lines are printed once each with their counts. The counters are
in the copy only; the package's kernel has none. Run it from the
repository root on a machine with the card.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "abpoa_tpu_torch", "csrc", "backtrack_windows.cu")

# (anchor in the source, text put after it)
PROBES = [
    ("#include <climits>\n", "#include <cstdio>\n"),
    ("    bar_wait(bars + s, (phases >> s) & 1);\n",
     "    t_wait += clock64() - w0;\n"),
    ("  while (i > 0 && j > 0) {\n", "    long long c0 = clock64();\n"),
    ("    const bool preds_in = __all_sync(kFull, lane >= npre || p0 >= v.b.rlo);\n",
     "    long long c1 = clock64(); tp[0] += c1 - c0;\n"),
    ("    const bool cols = j - 1 >= v.b.clo && j <= v.b.chi;\n",
     "    long long c2 = clock64(); tp[1] += c2 - c1;\n"),
    ("    if (local && H_ij == 0) break;\n",
     "    long long c3 = clock64(); tp[2] += c3 - c2;\n"),
    ("    const bool any_m = first_m >= 0, any_d = first_d >= 0;\n",
     "    long long c4 = clock64(); tp[3] += c4 - c3;\n"),
    ("    if (!m1) look_gap = 0;\n",
     "    long long c5 = clock64(); tp[4] += c5 - c4;\n"),
]
BEFORE = [  # (anchor, text put before it)
    ("  auto wait_stage = [&](int s) {\n",
     "  long long t_wait = 0, tp[6] = {0, 0, 0, 0, 0, 0}, t_start = clock64();\n"),
    ("    bar_wait(bars + s, (phases >> s) & 1);\n",
     "    const long long w0 = clock64();\n"),
    ("  if (pending) wait_stage(cur ^ 1);  // no copy may land after the block ends\n",
     "  if (lane == 0 && blockIdx.x == 0)\n"
     "    printf(\"cycles: steps %d walk %lld waited %lld round1 %lld decision "
     "%lld rowcells %lld preds %lld select %lld prefetch %lld\\n\", n_ops, "
     "clock64() - t_start, t_wait, tp[0], tp[1], tp[2], tp[3], tp[4], tp[5]);\n"),
]
LOOP_END = ("    if (cap) {\n      err = 1;\n      break;\n    }\n",
            "    long long c6 = clock64();\n")


def instrumented(text: str) -> str:
    """The source with the probes in; raises where an anchor is missing."""
    for anchor, add in PROBES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"x1w_cycles: anchor not found once: {anchor!r}")
        text = text.replace(anchor, anchor + add)
    for anchor, add in BEFORE:
        if text.count(anchor) != 1:
            raise RuntimeError(f"x1w_cycles: anchor not found once: {anchor!r}")
        text = text.replace(anchor, add + anchor)
    # the prefetch part ends where the loop body does
    anchor, add = LOOP_END
    if text.count(anchor) != 1:
        raise RuntimeError("x1w_cycles: the loop's cap test not found once")
    body_end = "\n  }\n  if (lane == 0 && blockIdx.x == 0)"
    if text.count(body_end) != 1:
        raise RuntimeError("x1w_cycles: the loop's end not found once")
    text = text.replace(anchor, anchor + add)
    return text.replace(body_end, "\n    tp[5] += clock64() - c6;" + body_end)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=41)
    args = ap.parse_args()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    src = os.path.join(tmp, "backtrack_windows_cycles.cu")
    with open(SRC) as fp:
        text = instrumented(fp.read())
    with open(src, "w") as fp:
        fp.write(text)
    p = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "x1w_tiles.py"),
                        "--cols", "32", "--reads", str(args.reads), "--src", src],
                       capture_output=True, text=True)
    lines = p.stdout.splitlines()
    print("\n".join(ln for ln in lines if not ln.startswith("cycles:")))
    for line, n in collections.Counter(
            ln for ln in lines if ln.startswith("cycles:")).most_common(6):
        print(f"{n} x {line}")
    if p.returncode:
        print(p.stderr[-4000:], file=sys.stderr)
    return p.returncode


if __name__ == "__main__":
    sys.exit(main())
