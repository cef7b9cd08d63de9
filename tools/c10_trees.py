#!/usr/bin/env python3
"""Time `map` at chip_smoke.py's C10 cell on two checkouts of the port in
one call, in alternating turns (A B B A ...): the check of whether map's
K-lane rate changed between two commits.

    python3 tools/c10_trees.py TREE_A TREE_B [--turns ABBA] [--reads 500]
                               [--new-reads 100] [--ref-len 10000]

TREE_A and TREE_B are checkouts of the repository (for example
`git archive a190ac6 | tar -x -C chip_x/a190ac6`) in directories the chip
runner copies. The cell is C10's: C's 500 reads x 10 kb at 10 % error
(seed 7) and their `-r 2` MSA through this checkout's CLI on cuda (phase
C3), the reads' rows restored as the graph (C5's restore_msa.fa), and C5's
100 new reads (seed 12), written under build/c10_trees/. Each turn is a
fresh process in its checkout: the kernels built and one warm-up mapping
of two reads, the graph restored and its tables built once
(`load_static_graph`), then `map_reads_split` at K 1 (the first 20 reads),
8 and 32 (all), each timed alone on the host clock with the card
synchronized before and after (C10's "mapping" without the CLI's reading
and writing). Every turn's GAF at each K must equal the first turn's.
Prints each turn's reads/s, the card's name and power limit, and one JSON
object with every turn and each tree's mean reads/s per K.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, json, sys, time
import numpy as np
import torch
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.io.gaf import gaf_record
from abpoa_tpu_torch.kernels import build
from abpoa_tpu_torch.params import Params
from abpoa_tpu_torch.parallel.map_driver import (load_static_graph,
                                                 map_reads_split)
msa, reads_fa = sys.argv[1:3]
t0 = time.perf_counter()
build.build()
abpt = Params(device="cuda").finalize()
out = {"build_s": time.perf_counter() - t0}
t0 = time.perf_counter()
_ab, static = load_static_graph(msa, abpt)
out["load_s"] = time.perf_counter() - t0
out["rows"] = int(static.n_rows)
recs = read_fastx(reads_fa)
enc = abpt.char_to_code
qs = [enc[np.frombuffer(r.seq.encode(), dtype=np.uint8)].astype(np.uint8)
      for r in recs]
map_reads_split(static, qs[:2], abpt, k_cap=2)  # warm-up
out["runs"] = {}
for k, n in ((1, min(20, len(qs))), (8, len(qs)), (32, len(qs))):
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = map_reads_split(static, qs[:n], abpt, k_cap=k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    gaf = "\n".join(gaf_record(r.name, q, o[0], static.base_by_nid, o[1])
                    for r, q, o in zip(recs, qs, res))
    out["runs"][str(k)] = {"reads": n, "s": dt, "reads_s": n / dt,
                           "gaf": hashlib.sha1(gaf.encode()).hexdigest()}
print(json.dumps(out))
"""


def make_cell(args, out_dir: str) -> tuple:
    """C10's graph (C3's MSA rows of C's reads) and C5's new reads."""
    import numpy as np
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    ref, reads = cs.simulate(args.ref_len, args.reads, 0.10, 7)
    fa = os.path.join(out_dir, "headline.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">read_{i}\n{r}\n" for i, r in enumerate(reads)))
    msa_all = os.path.join(out_dir, "headline_msa.fa")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "abpoa_tpu_torch", fa, "-r", "2",
                    "-o", msa_all], cwd=HERE, check=True)
    print(f"[cell] {args.reads} reads x {args.ref_len} bp, -r 2 on cuda: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rows = cs.read_fasta_rows(msa_all)[:args.reads]
    msa = os.path.join(out_dir, "restore_msa.fa")
    with open(msa, "w") as fp:
        fp.write("".join(f">{nm}\n{row}\n" for nm, row in rows))
    codes = np.searchsorted(np.frombuffer(b"ACGT", dtype=np.uint8),
                            np.frombuffer(ref.encode(), dtype=np.uint8))
    new = [cs.acgt(x) for x in cs.sim_reads(codes, args.new_reads, 0.10,
                                            np.random.default_rng(7 + 5))]
    reads_fa = os.path.join(out_dir, "new_reads.fa")
    with open(reads_fa, "w") as fp:
        fp.write("".join(f">new_{i}\n{r}\n" for i, r in enumerate(new)))
    return msa, reads_fa


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs=2)
    ap.add_argument("--turns", default="ABBA")
    ap.add_argument("--reads", type=int, default=500)
    ap.add_argument("--new-reads", type=int, default=100)
    ap.add_argument("--ref-len", type=int, default=10000)
    args = ap.parse_args()
    out_dir = os.path.join(HERE, "build", "c10_trees")
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    msa, reads_fa = make_cell(args, out_dir)
    trees = dict(zip("AB", (os.path.abspath(t) for t in args.trees)))
    turns, first = [], {}
    for tag in args.turns:
        env = dict(os.environ, PYTHONPATH=trees[tag])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CHILD, msa, reads_fa],
                              cwd=trees[tag], env=env, capture_output=True,
                              text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"c10_trees: turn {tag} failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec.update(tree=tag, path=args.trees["AB".index(tag)],
                   wall_s=time.perf_counter() - t0)
        for k, r in rec["runs"].items():
            if first.setdefault(k, r["gaf"]) != r["gaf"]:
                raise SystemExit(f"c10_trees: turn {tag}'s GAF at K {k} "
                                 "differs from the first turn's")
        turns.append(rec)
        print(f"[turn {len(turns)}] {tag} ({rec['path']}): restore + tables "
              f"{rec['load_s']:.2f} s ({rec['rows']} rows); reads/s "
              + ", ".join(f"K {k} {r['reads_s']:.3f} ({r['reads']} reads in "
                          f"{r['s']:.3f} s)" for k, r in rec["runs"].items()),
              flush=True)
    mean = {tag: {k: sum(t["runs"][k]["reads_s"] for t in turns
                         if t["tree"] == tag)
                  / sum(t["tree"] == tag for t in turns)
                  for k in first} for tag in sorted(set(args.turns))}
    print(json.dumps({"card": card, "trees": args.trees, "turns": turns,
                      "mean_reads_s": mean}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
