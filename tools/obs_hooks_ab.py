#!/usr/bin/env python3
"""Time the run telemetry's always-on hooks on one route, in one process:
turns with the hooks as they are (A) and with them replaced by no-ops (B),
alternating (A B B A ...), so that nothing but the hooks differs.

    python3 tools/obs_hooks_ab.py [--route fused|per_read|split]
                                  [--turns ABBAABBA] [--reads 50]
                                  [--ref-len 10000] [--set-reads 10]
    python3 tools/obs_hooks_ab.py --micro N

The cells are tools/c12_trees.py's (written under build/obs_hooks_ab/).
"The hooks" are every telemetry call a route makes without a flag: the run
report's counters, values, phase timers, DP cell and per-read records
(`RunReport.count`, `observe`, `phase`, `record_dp_cells`, `record_read`),
the rounds timeline (`rounds.begin_round`, `note_dispatch`,
`record_round`), the scheduler's and the drivers' metric publishes and
the trace's spans (already a no-op without `--trace`). A B turn swaps
them for no-ops; the CLI's report, archive (off here) and exporters are
untouched. Each turn is the CLI on cuda, timed on the host clock with the
card synchronized before and after. Every turn's output must equal the
first turn's. Prints each turn, the card's name and power limit, each
arm's walls and their ratio, and one JSON object.

`--micro N` needs no card: it times N rounds of the hooks the per-read
route calls for one read (`record_dp`, the `align` and `fusion` phases,
the `dispatch.<device>` count, the `dp:<device>` and `read:i` spans with
tracing off, `record_read`) on the host clock, and prints microseconds a
read.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))


def _stubs():
    """(owner, attribute, no-op) for every always-on hook."""
    from abpoa_tpu_torch.obs import metrics, rounds
    from abpoa_tpu_torch.obs.report import RunReport

    def nothing(*_a, **_k):
        return None

    @contextlib.contextmanager
    def no_phase(*_a, **_k):
        yield

    out = [(RunReport, name, nothing) for name in (
        "count", "observe", "record_dp_cells", "record_read")]
    out.append((RunReport, "phase", no_phase))
    out += [(rounds, name, nothing) for name in (
        "begin_round", "note_dispatch", "record_round")]
    out += [(metrics, name, nothing) for name in dir(metrics)
            if name.startswith("publish_") or name == "bump_batch_set_done"]
    return out


def micro(n: int) -> float:
    """Host microseconds of one read's per-read-route hooks, over n reads."""
    from abpoa_tpu_torch import obs
    obs.start_run()
    t0 = time.perf_counter()
    for i in range(n):
        t_read = time.perf_counter()
        obs.record_dp(52163, 1025, 1)
        with obs.phase("align"):
            obs.count("dispatch.cuda", 1)
            with obs.span("dp:cuda", "dp", args={"rows": 52163}):
                pass
        with obs.phase("fusion"):
            pass
        obs.record_read(time.perf_counter() - t_read, 10000, 1025, "cuda")
        obs.trace.add_span(f"read:{i}", "read", t_read, 0.0)
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--route", default="per_read",
                    choices=("fused", "per_read", "split"))
    ap.add_argument("--turns", default="ABBAABBA")
    ap.add_argument("--reads", type=int, default=50)
    ap.add_argument("--ref-len", type=int, default=10000)
    ap.add_argument("--set-reads", type=int, default=10)
    ap.add_argument("--micro", type=int, default=0, metavar="N")
    args = ap.parse_args()
    if args.micro:
        us = micro(args.micro)
        print(f"[obs_hooks_ab] micro: {us:.2f} us of hooks a read on the "
              f"per-read route ({args.micro} reads, host clock)")
        return 0
    import torch
    if not torch.cuda.is_available():
        print("obs_hooks_ab: no CUDA device available", file=sys.stderr)
        return 2
    os.environ["ABPOA_TPU_ARCHIVE"] = "0"
    if args.route == "split":
        os.environ["ABPOA_TPU_LOCKSTEP_IMPL"] = "split"
    import c12_trees
    import chip_smoke as cs
    from abpoa_tpu_torch import cli
    from abpoa_tpu_torch.kernels import build
    out_dir = os.path.join(HERE, "build", "obs_hooks_ab", args.route)
    os.makedirs(out_dir, exist_ok=True)
    inp, warm = c12_trees.make_cell(args, cs, out_dir)
    flags = {"fused": [], "per_read": ["-G"],
             "split": ["--lockstep", "on", "-r", "2"]}[args.route]

    def argv(path: str) -> list:
        return (["-l", path] if args.route == "split" else [path]) + flags

    build.build()
    out = os.path.join(out_dir, "out.fa")
    assert cli.main(argv(warm) + ["-o", out]) == 0
    stubs = _stubs()
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in stubs]
    turns, first = [], None
    for i, arm in enumerate(args.turns):
        for owner, name, fn in (stubs if arm == "B" else saved):
            setattr(owner, name, fn)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            assert cli.main(argv(inp) + ["-o", out]) == 0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
        with open(out, "rb") as fp:
            digest = hashlib.sha1(fp.read()).hexdigest()
        if first is None:
            first = digest
        elif digest != first:
            print(f"obs_hooks_ab: turn {i}'s output differs", file=sys.stderr)
            return 1
        turns.append({"turn": i, "arm": arm, "wall_s": wall})
        print(f"[obs_hooks_ab] {args.route} turn {i} "
              f"{'hooks on' if arm == 'A' else 'hooks off'}: {wall:.3f} s",
              flush=True)
    mean = {arm: sum(t["wall_s"] for t in turns if t["arm"] == arm)
            / max(1, sum(t["arm"] == arm for t in turns)) for arm in "AB"}
    print(f"[obs_hooks_ab] {args.route}: card {cs.smi('name,power.limit')}; "
          f"mean wall hooks on {mean['A']:.3f} s, off {mean['B']:.3f} s, "
          f"on / off {mean['A'] / mean['B']:.4f}", flush=True)
    print(json.dumps({"route": args.route, "turns": turns, "mean_wall_s": mean}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
