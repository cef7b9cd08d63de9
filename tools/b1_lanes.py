#!/usr/bin/env python3
"""Time kernels B1 (`fused_dp`) and X1 (`backtrack`) as the single-set fused
loop launches them (one lane) in two checkouts of this repository, on one
card, in alternating turns: the guard that the lane index of the device
lockstep's launches costs the one-set route nothing.

    python3 tools/b1_lanes.py ROOT_A ROOT_B [--reps 5] [--turns 1]
                              [--reads 500] [--ref-len 10000]

Each ROOT holds an `abpoa_tpu_torch` package (a checkout, or a `git
archive` of one); its kernels build into its own `build/`, both at once.
Then, with ROOT_B's package, the fused loop runs on the card over the
first --reads reads of chip_smoke.py's headline set (10 kb at 10 % error,
seed 7, --reads + 1 reads made) and B1's inputs for the held-out read
against its final graph are saved, as phase D of chip_smoke.py builds them
(gn 52163, W 512 at the full size). One child process a turn then runs A,
B, B, A (--turns 2: A, B, B, A, A, B, B, A): B1 on those inputs, then X1
on its planes from the best cell, each timed by CUDA events over --reps
launches after a warm-up, and a hash of each one's outputs (B1 on its
computed rows), which must agree across all turns. A turn prints µs a
computed row of B1 and µs a step of X1; the last line is one JSON object
with every turn. Run it from the repository root on a machine with the
card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(HERE, "build", "b1_lanes", "inputs.pt")


def prepare(root: str, n_reads: int, ref_len: int) -> None:
    """The held-out read's B1 inputs at the fused loop's final graph, with
    `root`'s package, saved to INPUTS."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import numpy as np
    import torch
    import chip_smoke as cs
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.params import Params
    abpt = Params(device="cuda").finalize()
    _, reads = cs.simulate(ref_len, n_reads + 1, 0.10, 7)
    held_out = reads.pop()
    seqs = [cs.encode(abpt, r) for r in reads]
    fl.reset_stats()
    fl.progressive_poa_fused(seqs, [np.ones(len(s), np.int64) for s in seqs],
                             abpt)
    caps = fl.stats["caps"]
    qd = cs.encode(abpt, held_out)
    ad, inf = cs.fused_case(abpt, fl.last_state, qd, caps["W"],
                            caps["plane16"], False)
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    torch.save({"ad": [t.cpu() for t in ad], "qd": qd, "inf": inf,
                "plane16": caps["plane16"], "gap_mode": abpt.gap_mode}, INPUTS)
    print(f"inputs: gn {int(ad[0][8])}, R {ad[1].shape[0]}, W {caps['W']}, "
          f"plane16 {caps['plane16']}", flush=True)


def _events_ms(fn, reps: int) -> float:
    import time
    import torch
    t0 = time.perf_counter()
    for k in range(1000):
        fn()
        torch.cuda.synchronize()
        if k >= 1 and time.perf_counter() - t0 >= 0.3:
            break
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def turn(root: str, reps: int) -> dict:
    """One turn in this process, with `root`'s package."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke as cs
    from abpoa_tpu_torch.align.backtrack_kernel import backtrack
    from abpoa_tpu_torch.align.fused_dp_kernel import computed_rows, fused_dp
    from abpoa_tpu_torch.params import Params
    saved = torch.load(INPUTS, weights_only=False)
    dev = torch.device("cuda")
    ad = [t.to(dev) for t in saved["ad"]]
    kw = dict(gap_mode=saved["gap_mode"], plane16=saved["plane16"])
    out = fused_dp(*ad, **kw)
    torch.cuda.synchronize()
    gn, W = int(ad[0][8]), out[0].shape[1]
    rows = computed_rows(out[5].cpu(), out[6].cpu(), out[7].cpu(), gn, W)
    h = hashlib.sha256()
    for t in out[:5]:
        h.update(t[:rows].cpu().numpy().tobytes())
    for t in out[5:]:
        h.update(t.cpu().numpy().tobytes())
    b1_ms = _events_ms(lambda: fused_dp(*ad, **kw), reps)
    abpt = Params(device="cuda").finalize()
    bta, max_ops = cs.bt_inputs(abpt, ad, out, saved["qd"], saved["inf"],
                                False)
    bkw = dict(max_ops=max_ops, gap_mode=abpt.gap_mode, gap_on_right=False,
               put_gap_at_end=False, local=False)
    ops, res = backtrack(*bta, **bkw)
    torch.cuda.synchronize()
    steps = int(res[0])
    h.update(ops.cpu().numpy().tobytes() + res.cpu().numpy().tobytes())
    x1_ms = _events_ms(lambda: backtrack(*bta, **bkw), reps)
    return {"root": root, "b1_ms": b1_ms, "b1_us_row": b1_ms * 1e3 / (rows - 1),
            "x1_ms": x1_ms, "x1_us_step": x1_ms * 1e3 / max(1, steps),
            "rows": rows, "steps": steps, "sha256": h.hexdigest()[:16]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--reads", type=int, default=500)
    ap.add_argument("--ref-len", type=int, default=10000)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--prepare", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.turn), args.reps)),
              flush=True)
        return 0
    if args.prepare:
        prepare(os.path.abspath(args.prepare), args.reads, args.ref_len)
        return 0
    roots = [os.path.abspath(r) for r in args.roots]
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from abpoa_tpu_torch.kernels import build; build.load()")
    procs = [subprocess.Popen([sys.executable, "-c", build, r]) for r in roots]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("a build failed")
    me = [sys.executable, os.path.abspath(__file__), *args.roots]
    if subprocess.run(me + ["--reads", str(args.reads), "--ref-len",
                            str(args.ref_len), "--prepare", roots[1]]
                      ).returncode != 0:
        raise SystemExit("building the inputs failed")
    rows = []
    for i in [0, 1, 1, 0] * args.turns:
        out = subprocess.run(me + ["--reps", str(args.reps), "--turn",
                                   roots[i]], capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"the turn on {roots[i]} failed:\n{out.stderr}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["checkout"] = "AB"[i]
        rows.append(row)
        print(f"{row['checkout']} {row['root']}: B1 {row['b1_ms']:.3f} ms "
              f"({row['b1_us_row']:.4f} us a row, {row['rows']} rows), X1 "
              f"{row['x1_ms']:.3f} ms ({row['x1_us_step']:.4f} us a step, "
              f"{row['steps']} steps), outputs {row['sha256']}", flush=True)
    if len({r["sha256"] for r in rows}) != 1:
        raise SystemExit("the checkouts' outputs differ")
    print(json.dumps({"turns": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
