#!/usr/bin/env python3
"""Time the two lockstep implementations on chip_smoke.py's C9 list in one
process on one card, in alternating turns: the measurement that sets
`parallel/scheduler.lockstep_impl`'s default on cuda.

    python3 tools/c9_impls.py [--pairs 10] [--warmup 1] [--mode global]
                              [--c9-reads 20] [--ref-len 10000]

The list is C9's (8 sets of 10 kb reads at 10 % error of 8 references,
seeds 11-18, set i of --c9-reads + 5 i reads), written under
build/c9_impls/. Each run is `-l LIST -r 2 --lockstep on` through the CLI
in this process with ABPOA_TPU_LOCKSTEP_IMPL set to "split" or "device"
(`--mode local` adds `-m 1`): --warmup runs of each (not counted), then
--pairs pairs in the order split, device, device, split, ... Every run's
output must be byte-identical to the first. Prints each run's wall and
reads/s (a device run also its rounds, B1 lane launches, extra B1 + X1
passes where the lanes' planes did not fit, caps and peak device memory),
then one JSON object with the runs, each implementation's median wall and
the pairs the device lockstep won. Run it from the repository root on a
machine with the card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--mode", choices=["global", "local"], default="global")
    ap.add_argument("--c9-reads", type=int, default=20)
    ap.add_argument("--ref-len", type=int, default=10000)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from abpoa_tpu_torch import cli
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp_lanes
    if not torch.cuda.is_available():
        raise SystemExit("c9_impls: no CUDA device")
    out_dir = os.path.join(HERE, "build", f"c9_impls_{args.mode}")
    os.makedirs(out_dir, exist_ok=True)
    files, n_reads = [], 0
    for i in range(8):
        _, reads = cs.simulate(args.ref_len, args.c9_reads + 5 * i, 0.10, 11 + i)
        path = os.path.join(out_dir, f"set{i}.fa")
        with open(path, "w") as fp:
            fp.write("".join(f">s{i}_{j}\n{r}\n" for j, r in enumerate(reads)))
        files.append(path)
        n_reads += len(reads)
    lst = os.path.join(out_dir, "list.txt")
    with open(lst, "w") as fp:
        fp.write("".join(f + "\n" for f in files))
    print(f"card: {cs.smi('name,power.limit')}", flush=True)

    mode = ["-m", "1"] if args.mode == "local" else []

    def run(impl: str, tag: str) -> dict:
        out = os.path.join(out_dir, f"{tag}.fa")
        os.environ["ABPOA_TPU_LOCKSTEP_IMPL"] = impl
        fl.reset_stats()
        fused_dp_lanes.launches = fused_dp_lanes.local_launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli.main(["-l", lst, "-r", "2", *mode, "--lockstep", "on",
                     "-o", out]):
            raise SystemExit(f"c9_impls: the {impl} run failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(out) as fp:
            text = fp.read()
        if first and text != first[0]:
            raise SystemExit(f"c9_impls: the {impl} run's output differs")
        if not first:
            first.append(text)
        r = {"impl": impl, "wall_s": wall, "reads_s": n_reads / wall,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if impl == "device":
            r.update(rounds=fl.stats["rounds"],
                     b1_lanes=fused_dp_lanes.launches
                     + fused_dp_lanes.local_launches,
                     plane_splits=fl.stats["plane_splits"],
                     caps=fl.stats["caps"])
        print(f"{tag}: " + ", ".join(f"{k} {v}" for k, v in r.items()),
              flush=True)
        return r

    runs, first = [], []
    for k in range(args.warmup):
        for impl in ("split", "device"):
            run(impl, f"warm{k}_{impl}")
    order = ["split", "device", "device", "split"] * ((args.pairs + 1) // 2)
    for k, impl in enumerate(order[:2 * args.pairs]):
        runs.append(run(impl, f"run{k}_{impl}"))
    med = {impl: statistics.median(r["wall_s"] for r in runs
                                   if r["impl"] == impl)
           for impl in ("split", "device")} if runs else {}
    wins = sum(
        min(a, b, key=lambda r: r["wall_s"])["impl"] == "device"
        for a, b in zip(runs[0::2], runs[1::2]))
    print(json.dumps({"mode": args.mode, "reads": n_reads, "runs": runs,
                      "median_wall_s": med, "device_won_pairs": wins,
                      "pairs": args.pairs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
