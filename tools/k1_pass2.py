#!/usr/bin/env python3
"""Time kernel K1's launch with no walk (`topo_sort(..., walks=0)`: pass 2,
the edge sort of the slots into the sorted outputs, and the BFS block's
set-up) in two checkouts of this repository, on one card, in alternating
turns.

    python3 tools/k1_pass2.py ROOT_A ROOT_B [--reps 20] [--turns 2]

Each ROOT holds an `abpoa_tpu_torch` package (a checkout, or a `git
archive` of one); its kernels build into its own `build/`, both at once
before the timing. Then one child process a turn runs A, B, B, A (--turns
2: A, B, B, A, A, B, B, A), each on the same graph at the headline's
shape, made from a seed: N 103424 rows, E 16 slots, A 8 aligned slots,
node_n 52163, a chain from the source to the sink with a skip edge from
two nodes in three, every row's slots already in weight order, as the fused
loop hands K1 its graph. A turn prints the mean ms of a launch queued behind a sleep kernel
(the card's time alone) and launched as fast as the host queues it (the
wrapper's pace), and a hash of the sorted slots, which must agree across
all turns. The last line is one JSON object with every turn. Run it from
any directory on a machine with the card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

N, E, A, NODE_N = 103424, 16, 8, 52163
SLEEP_CYCLES = 100_000_000  # ~50 ms at 1980 MHz, far past the host's queueing


def graph(dev):
    """The K1 inputs described in the module docstring, on `dev`."""
    import numpy as np
    import torch
    rng = np.random.default_rng(14)
    in_ids = np.zeros((N, E), np.int32)
    in_w = np.zeros((N, E), np.int32)
    out_ids = np.zeros((N, E), np.int32)
    out_w = np.zeros((N, E), np.int32)
    in_cnt = np.zeros(N, np.int32)
    out_cnt = np.zeros(N, np.int32)
    # the source 0, nodes 2.. in order, the sink 1 last
    chain = [0, *range(2, NODE_N), 1]
    skip = rng.random(NODE_N) < 2 / 3
    for i, v in enumerate(chain[:-1]):
        for d, w in ((1, 100), (2, 1 + int(rng.integers(0, 50)))):
            if i + d >= NODE_N or (d == 2 and not skip[i]):
                continue
            t = chain[i + d]
            out_ids[v, out_cnt[v]], out_w[v, out_cnt[v]] = t, w
            out_cnt[v] += 1
            in_ids[t, in_cnt[t]], in_w[t, in_cnt[t]] = v, w
            in_cnt[t] += 1
    for ids, w, cnt in ((in_ids, in_w, in_cnt), (out_ids, out_w, out_cnt)):
        order = np.argsort(-w, axis=1, kind="stable")
        ids[:] = np.take_along_axis(ids, order, 1)
        w[:] = np.take_along_axis(w, order, 1)
    aligned = np.zeros((N, A), np.int32)
    aligned_cnt = np.zeros(N, np.int32)
    arrays = (in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
              aligned_cnt, np.array([NODE_N], np.int32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def turn(root: str, reps: int) -> dict:
    """One turn in this process, with `root`'s package."""
    sys.path.insert(0, root)
    import torch
    from abpoa_tpu_torch.align.topo_kernel import topo_sort
    dev = torch.device("cuda")
    args = graph(dev)
    out = topo_sort(*args, walks=0)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out[:4]:
        h.update(t.cpu().numpy().tobytes())
    launch = lambda: topo_sort(*args, walks=0)  # noqa: E731
    t0 = time.perf_counter()
    for k in range(1000):
        launch()
        torch.cuda.synchronize()
        if k >= 1 and time.perf_counter() - t0 >= 0.3:
            break
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    e0, e1 = ev(), ev()
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for _ in range(reps):
        launch()
    if e0.query():
        raise AssertionError("the card ran out of queued work before the "
                             "host had queued every launch")
    e1.record()
    e1.synchronize()
    queued = e0.elapsed_time(e1) / reps
    e0, e1 = ev(), ev()
    e0.record()
    for _ in range(reps):
        launch()
    e1.record()
    e1.synchronize()
    return {"root": root, "queued_ms": queued,
            "paced_ms": e0.elapsed_time(e1) / reps,
            "sorted_sha256": h.hexdigest()[:16]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.turn), args.reps)),
              flush=True)
        return 0
    roots = [os.path.abspath(r) for r in args.roots]
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from abpoa_tpu_torch.kernels import build; build.load()")
    procs = [subprocess.Popen([sys.executable, "-c", build, r]) for r in roots]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("a build failed")
    order = [0, 1, 1, 0] * args.turns
    rows = []
    for i in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              *args.roots, "--reps", str(args.reps),
                              "--turn", roots[i]],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"the turn on {roots[i]} failed:\n{out.stderr}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["checkout"] = "AB"[i]
        rows.append(row)
        print(f"{row['checkout']} {row['root']}: queued {row['queued_ms']:.4f} "
              f"ms, host-paced {row['paced_ms']:.4f} ms, sorted slots "
              f"{row['sorted_sha256']}", flush=True)
    if len({r["sorted_sha256"] for r in rows}) != 1:
        raise SystemExit("the checkouts' sorted slots differ")
    print(json.dumps({"turns": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
