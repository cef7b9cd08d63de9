#!/usr/bin/env python3
"""On-card smoke run of abpoa_tpu_torch, the PyTorch/CUDA port of abpoa-tpu.

    python3 chip_smoke.py [--reads N] [--ref-len L]

Needs one CUDA card of capability 9.0 (H100). Phases, each a hard failure:
  build  compile every kernel from abpoa_tpu_torch/csrc with nvcc (sm_90a)
  A      the banded DP kernel against its plain PyTorch version on the card,
         on tables of a mid-run graph of tests/data/sim2k.fa, including a
         forced band overflow relaunched up to W > 1024: all outputs equal
  B      `python -m abpoa_tpu_torch tests/data/seq.fa` on cuda reproduces
         tests/golden/ref_consensus.txt byte for byte
  C      the main path at full width: N ONT-like 10 kb reads at 10 % error
         (made here from a fixed seed) through the CLI on cuda; the kernel
         counts are set to 0 before and read after; the consensus must match
         the simulated reference at >= 99 % identity
  D      the kernel against its plain version at the main path's shape
         (the graph phase C left and one more read), with times and bound
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero with no result when there is no
CUDA device or no checkout of the repository beside this script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
INT_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit rate (fp32 figure)


def log(msg: str) -> None:
    print(msg, flush=True)


def simulate(ref_len: int, n_reads: int, err: float, seed: int):
    """ONT-like reads in the shape of tests/make_sim.py: per reference base,
    a substitution (40 % of err), an insertion after it (30 %) or a
    deletion (30 %). Returns (reference, reads) as ACGT strings."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len)
    sub, ins = err * 0.4, err * 0.3
    reads = []
    for _ in range(n_reads):
        x = rng.random(ref_len)
        is_sub = x < sub
        is_ins = (x >= sub) & (x < sub + ins)
        is_del = (x >= sub + ins) & (x < err)
        first = np.where(is_sub, (ref + rng.integers(1, 4, ref_len)) % 4, ref)
        second = rng.integers(0, 4, ref_len)
        pair = np.stack([first, second], 1)
        keep = np.stack([~is_del, is_ins], 1)
        reads.append(pair[keep])
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    return (acgt[ref].tobytes().decode(),
            [acgt[r].tobytes().decode() for r in reads])


def edit_distance(a: str, b: str) -> int:
    """Unit-cost edit distance, one numpy row at a time."""
    import numpy as np
    x = np.frombuffer(a.encode(), dtype=np.uint8)
    y = np.frombuffer(b.encode(), dtype=np.uint8)
    j = np.arange(len(y) + 1, dtype=np.int64)
    prev = j.copy()
    for i in range(1, len(x) + 1):
        t = np.empty_like(prev)
        t[0] = i
        t[1:] = np.minimum(prev[:-1] + (y != x[i - 1]), prev[1:] + 1)
        prev = np.minimum.accumulate(t - j) + j
    return int(prev[-1])


def to_dev(arrays, dev):
    import numpy as np
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in arrays]


def kernel_inputs(abpt, g, query, W):
    from abpoa_tpu_torch.align.tables import build_row_tables, query_tables
    t = build_row_tables(g, 0, 1)
    q = query_tables(abpt, t, query, W)
    return t, [q["scalars"], t.base, t.pre_idx, t.pre_cnt, t.out_idx,
               t.out_cnt, t.remain, t.mpl0, t.mpr0, q["qp_pad"], q["row0"]]


def compare(kernel_out, plain_out) -> int:
    """Max abs difference over all outputs; raises on any mismatch."""
    names = ["H", "E1", "E2", "F1", "F2", "begend", "mplr", "ok"]
    worst = 0
    for name, a, b in zip(names, kernel_out, plain_out):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
        d = int((a.to(b.dtype).long() - b.long()).abs().max().item()) if a.numel() else 0
        worst = max(worst, d)
        if d != 0:
            raise AssertionError(f"kernel and plain version differ on {name} "
                                 f"(max abs diff {d})")
    return worst


def time_cuda(fn, reps: int) -> float:
    """Mean ms of fn() over reps runs, by CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(t, args, out, W: int):
    """(bound_ms, bound_by): the larger of bytes over HBM rate (each input
    read once, each output written once) and the in-band cell operations
    over the 32-bit rate, for this run's data."""
    import numpy as np
    in_bytes = sum(a.size for a in args) * 4
    out_bytes = (5 * t.R * W + 4 * t.R + 1) * 4
    begend = out[5].cpu().numpy().astype(np.int64)
    beg, end = begend[: t.R], begend[t.R:]
    cells = np.clip(end - beg + 1, 0, W)[1: t.gn - 1]
    npre = t.pre_cnt[1: t.gn - 1].astype(np.int64)
    # per cell: 3 maxes per predecessor, then query profile, H-hat, the two
    # F chains (add, max, sub, clamp each), H, the E updates and the argmax
    ops = float((cells * (3 * npre + 22)).sum())
    by_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def grow_graph(abpt, reads, n):
    """A port graph of the first n reads, aligned on abpt's device."""
    import numpy as np
    from abpoa_tpu_torch.align.banded import align_sequence_to_subgraph
    from abpoa_tpu_torch.graph import POAGraph
    g = POAGraph()
    for i in range(n):
        q = abpt.char_to_code[np.frombuffer(reads[i].encode(), dtype=np.uint8)].astype(np.uint8)
        cigar = align_sequence_to_subgraph(g, abpt, 0, 1, q).cigar if g.node_n > 2 else []
        g.add_alignment(abpt, q, None, cigar, True)
    g.topological_sort(abpt)
    return g


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=500)
    ap.add_argument("--ref-len", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(ROOT, "abpoa_tpu_torch", "csrc", "banded_dp.cu")):
        print("chip_smoke: abpoa_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from abpoa_tpu_torch import cli
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.banded_kernel import banded_dp, banded_dp_torch
    from abpoa_tpu_torch.align.tables import initial_band_width
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.kernels import build
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.pipeline import Abpoa, msa_from_file

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- build
    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(build.library_path(), ROOT)}")

    dev = torch.device("cuda")
    abpt = Params(device="cuda").finalize()
    max_err = 0

    # ---- A: kernel vs plain version on sim2k tables
    sim2k = [r.seq for r in read_fastx(os.path.join(ROOT, "tests", "data", "sim2k.fa"))]
    g = grow_graph(abpt, sim2k, 3)
    query = abpt.char_to_code[np.frombuffer(sim2k[3].encode(), dtype=np.uint8)].astype(np.uint8)
    wide = Params(device="cuda", wb=600).finalize()
    cases = [(abpt, initial_band_width(abpt, len(query)), True)]
    W = 512
    while True:  # forced overflow: the relaunch chain of align/banded.py
        cases.append((wide, W, None))
        if W >= len(query) + 1:
            break
        W = banded.next_band_width(W, len(query))
    for p, W, want_ok in cases:
        t, a = kernel_inputs(p, g, query, W)
        ts = to_dev(a, dev)
        got = banded_dp(*ts)
        torch.cuda.synchronize()
        want = banded_dp_torch(*ts)
        max_err = max(max_err, compare(got, want))
        ok = int(got[7].item())
        if want_ok is not None and ok != 1:
            raise AssertionError(f"sim2k W={W}: unexpected band overflow")
        log(f"[A] sim2k R={t.R} gn={t.gn} W={W} ok={ok}: kernel == plain "
            f"(all 8 outputs, tolerance 0)")
    last_ok = int(got[7].item())
    if last_ok != 1 or cases[-1][1] <= 1024 or sum(1 for c in cases if c[2] is None) < 2:
        raise AssertionError("overflow case did not end in a W > 1024 launch that fits")
    ms = time_cuda(lambda: banded_dp(*ts), 5)
    log(f"[A] kernel at R={t.R} W={cases[-1][1]}: {ms:.3f} ms")

    # ---- B: golden consensus on cuda
    out_b = os.path.join(ROOT, "build", "chip_smoke", "seq_cons.fa")
    os.makedirs(os.path.dirname(out_b), exist_ok=True)
    rc = cli.main([os.path.join(ROOT, "tests", "data", "seq.fa"), "-o", out_b])
    with open(out_b) as fp, open(os.path.join(ROOT, "tests", "golden", "ref_consensus.txt")) as gp:
        if rc != 0 or fp.read() != gp.read():
            raise AssertionError("seq.fa consensus on cuda differs from ref_consensus.txt")
    log("[B] seq.fa on cuda == tests/golden/ref_consensus.txt")

    # ---- C: the main path at full width
    # one read more than the run takes: phase D aligns it to the final graph
    ref, reads = simulate(args.ref_len, args.reads + 1, 0.10, args.seed)
    held_out = reads.pop()
    fa = os.path.join(ROOT, "build", "chip_smoke", "sim.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">read_{i}\n{r}\n" for i, r in enumerate(reads)))
    out_c = os.path.join(ROOT, "build", "chip_smoke", "sim_cons.fa")
    # what cli.main does, keeping the Abpoa object for phase D
    ns = cli.build_parser().parse_args([fa, "-o", out_c])
    abpt_c = cli.args_to_params(ns).finalize()
    ab = Abpoa()
    banded_dp.launches = 0
    banded.retries = 0
    for k in banded.stats:
        banded.stats[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(out_c, "w") as fp:
        msa_from_file(ab, abpt_c, ns.input, fp)
    wall = time.perf_counter() - t0
    launches, retries = banded_dp.launches, banded.retries
    st = dict(banded.stats)
    if launches < args.reads - 1:
        raise AssertionError(f"{launches} kernel launches for {args.reads} reads")
    cons = read_fastx(out_c)
    if len(cons) != 1 or not set(cons[0].seq) <= set("ACGT"):
        raise AssertionError("expected one ACGT consensus")
    ident = 1 - edit_distance(cons[0].seq, ref) / len(ref)
    n = args.reads
    log(f"[C] {n} reads x {args.ref_len} bp at 10% error: wall {wall:.2f} s, "
        f"{n / wall:.3f} reads/s")
    log(f"[C] mean R {st['rows'] / max(1, st['reads']):.0f}, W {initial_band_width(abpt, args.ref_len)}, "
        f"launches {launches}, retries {retries}")
    log(f"[C] per read: kernel {st['kernel_s'] / n * 1e3:.2f} ms, D2H "
        f"{st['d2h_s'] / n * 1e3:.2f} ms, host "
        f"{(wall - st['kernel_s'] - st['d2h_s']) / n * 1e3:.2f} ms")
    log(f"[C] final graph {ab.graph.node_n} nodes; consensus length "
        f"{len(cons[0].seq)}, identity to reference {ident:.5f}")
    if ident < 0.99:
        raise AssertionError(f"consensus identity {ident:.5f} < 0.99")

    # ---- D: kernel vs plain version at the main path's shape
    q = abpt.char_to_code[np.frombuffer(held_out.encode(), dtype=np.uint8)].astype(np.uint8)
    W = initial_band_width(abpt, len(q))
    t, a = kernel_inputs(abpt, ab.graph, q, W)
    ts = to_dev(a, dev)
    got = banded_dp(*ts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = banded_dp_torch(*ts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    max_err = max(max_err, compare(got, want))
    kernel_ms = time_cuda(lambda: banded_dp(*ts), 3)
    bound_ms, bound_by = bound(t, a, got, W)
    log(f"[D] R={t.R} gn={t.gn} W={W}: kernel == plain; kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})")

    print(json.dumps({"kernels": [{
        "name": "banded_dp", "route": "cuda",
        "source": "abpoa_tpu_torch/csrc/banded_dp.cu",
        "replaces": "abpoa_tpu/align/pallas_kernel.py:215",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
