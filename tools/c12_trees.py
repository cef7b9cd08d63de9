#!/usr/bin/env python3
"""Time one CLI route on two checkouts of the port in one call, in
alternating turns (A B B A ...): the check of whether a change to the
always-on parts of a route (the run telemetry's hooks, for one) moved its
wall, launches or host syncs.

    python3 tools/c12_trees.py TREE_A TREE_B [--route fused|per_read|split]
                               [--turns ABBA] [--reads 100]
                               [--ref-len 10000] [--set-reads 10]

TREE_A and TREE_B are checkouts of the repository (for example
`git archive HEAD | tar -x -C chip_x/parent`) in directories the chip
runner copies. The cells, written under build/c12_trees/:

- fused: chip_smoke.py's headline shape cut in depth, --reads reads x
  10 kb at 10 % error (seed 7), `READS -o OUT` (the fused loop);
- per_read: the same reads with `-G` (path scores: the per-read route,
  kernels B2 and X1w, the host graph);
- split: chip_smoke.py's C9 list (8 sets of --set-reads + 5 i reads x
  10 kb at 10 %, seeds 11-18), `-l LIST --lockstep on -r 2` with
  ABPOA_TPU_LOCKSTEP_IMPL=split (the split lockstep driver).

Each turn is a fresh process in its checkout: the kernels built, one
warm-up run of the same route on a small input, then the CLI through
`cli.main` on cuda, timed on the host clock with the card synchronized
before and after, with the route's launch counters and host syncs read
just after (fused: B1, X1, S1, K1 and the loop's syncs; per_read and
split: B2 and X1w launches, B2's windows and the split driver's rounds).
Every turn's output must equal the first turn's, and the counts must be
equal across turns. Prints each turn, the card's name and power limit,
and one JSON object with every turn and each tree's mean wall.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, json, os, sys, time
import torch
from abpoa_tpu_torch import cli
from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align import fused_loop as fl
from abpoa_tpu_torch.align.backtrack_kernel import backtrack, backtrack_windows
from abpoa_tpu_torch.align.banded_kernel import banded_dp
from abpoa_tpu_torch.align.edge_sort_kernel import edge_sort
from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp
from abpoa_tpu_torch.align.topo_kernel import topo_sort
from abpoa_tpu_torch.kernels import build
from abpoa_tpu_torch.parallel import lockstep
route, inp, warm, out = sys.argv[1:5]
flags = {"fused": [], "per_read": ["-G"],
         "split": ["--lockstep", "on", "-r", "2"]}[route]
def argv(path):
    return (["-l", path] if route == "split" else [path]) + flags
t0 = time.perf_counter()
build.build()
res = {"build_s": time.perf_counter() - t0}
assert cli.main(argv(warm) + ["-o", out]) == 0
fl.reset_stats()
banded.reset_stats()
lockstep.reset_stats()
for k in (fused_dp, backtrack, edge_sort, topo_sort, banded_dp,
          backtrack_windows):
    k.launches = 0
torch.cuda.synchronize()
t = time.perf_counter()
assert cli.main(argv(inp) + ["-o", out]) == 0
torch.cuda.synchronize()
res["wall_s"] = time.perf_counter() - t
if route == "fused":
    res["counts"] = [fused_dp.launches, backtrack.launches,
                     edge_sort.launches, topo_sort.launches,
                     fl.stats["syncs"]]
else:
    res["counts"] = [banded_dp.launches, backtrack_windows.launches,
                     banded.stats["windows"], lockstep.stats["rounds"]]
res["loop_s"] = fl.stats["wall_s"]
res["download_s"] = fl.stats["download_s"]
res["sync_wait_s"] = fl.stats["host_s"]["sync"]
with open(out, "rb") as fp:
    res["out"] = hashlib.sha1(fp.read()).hexdigest()
print(json.dumps(res))
"""


def write_fa(path: str, reads, tag: str = "read") -> str:
    with open(path, "w") as fp:
        fp.write("".join(f">{tag}_{i}\n{r}\n" for i, r in enumerate(reads)))
    return path


def make_cell(args, cs, out_dir: str) -> tuple:
    """(input, warm-up input) of the route: a FASTA, or a list of them."""
    if args.route != "split":
        _ref, reads = cs.simulate(args.ref_len, args.reads, 0.10, 7)
        return (write_fa(os.path.join(out_dir, "headline.fa"), reads),
                write_fa(os.path.join(out_dir, "warm.fa"), reads[:2]))
    files, warm = [], []
    for i in range(8):
        _ref, reads = cs.simulate(args.ref_len, args.set_reads + 5 * i,
                                  0.10, 11 + i)
        files.append(write_fa(os.path.join(out_dir, f"c9_set{i}.fa"),
                              reads, f"s{i}"))
        if i < 2:
            warm.append(write_fa(os.path.join(out_dir, f"warm{i}.fa"),
                                 reads[:2], f"w{i}"))
    lists = []
    for name, paths in (("c9_list.txt", files), ("warm_list.txt", warm)):
        lists.append(os.path.join(out_dir, name))
        with open(lists[-1], "w") as fp:
            fp.write("".join(f + "\n" for f in paths))
    return tuple(lists)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--route", default="fused",
                    choices=("fused", "per_read", "split"))
    ap.add_argument("--turns", default="ABBA")
    ap.add_argument("--reads", type=int, default=100)
    ap.add_argument("--ref-len", type=int, default=10000)
    ap.add_argument("--set-reads", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("c12_trees: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    out_dir = os.path.join(HERE, "build", "c12_trees", args.route)
    os.makedirs(out_dir, exist_ok=True)
    inp, warm = make_cell(args, cs, out_dir)
    trees = {"A": os.path.abspath(args.tree_a),
             "B": os.path.abspath(args.tree_b)}
    env = dict(os.environ, ABPOA_TPU_ARCHIVE="0")
    if args.route == "split":
        env["ABPOA_TPU_LOCKSTEP_IMPL"] = "split"
    turns = []
    for i, tag in enumerate(args.turns):
        tree = trees[tag]
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, args.route, inp, warm,
             os.path.join(out_dir, f"out_{i}.fa")],
            cwd=tree, env=dict(env, PYTHONPATH=tree), capture_output=True,
            text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(tree=tag, turn=i)
        turns.append(res)
        what = ("launches B1/X1/S1/K1 and syncs" if args.route == "fused"
                else "launches B2/X1w, windows and split rounds")
        print(f"[c12_trees] {args.route} turn {i} {tag}: {res['wall_s']:.3f} "
              f"s (the fused loop {res['loop_s']:.3f}, its host wait in "
              f"syncs {res['sync_wait_s']:.3f}, the download "
              f"{res['download_s']:.3f}), {what} {res['counts']}, build "
              f"{res['build_s']:.1f} s", flush=True)
    if len({t["out"] for t in turns}) != 1:
        print("c12_trees: the trees' outputs differ", file=sys.stderr)
        return 1
    if len({tuple(t["counts"]) for t in turns}) != 1:
        print("c12_trees: launches or host syncs differ", file=sys.stderr)
        return 1
    mean = {tag: sum(t["wall_s"] for t in turns if t["tree"] == tag)
            / max(1, sum(1 for t in turns if t["tree"] == tag))
            for tag in trees}
    cell = (f"C9's list (8 sets from {args.set_reads} reads)"
            if args.route == "split" else f"{args.reads} reads")
    print(f"[c12_trees] {args.route}: card {cs.smi('name,power.limit')}; "
          f"{cell} x {args.ref_len} bp; mean wall A {mean['A']:.3f} s, B "
          f"{mean['B']:.3f} s, B / A {mean['B'] / mean['A']:.4f}", flush=True)
    print(json.dumps({"route": args.route, "turns": [{k: t[k] for k in (
        "turn", "tree", "wall_s", "loop_s", "sync_wait_s", "download_s",
        "counts", "build_s")}
                                for t in turns], "mean_wall_s": mean}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
