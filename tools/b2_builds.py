#!/usr/bin/env python3
"""Time kernel B2's one-window launch across builds of `fused_dp.cu`, in one
process on one card, in alternating turns.

    python3 tools/b2_builds.py NAME=path/to/fused_dp.cu [NAME=...] [--reads N]

Each source is compiled by its own nvcc (the package's flags, with
`-Xptxas -v`: the seeded convex kernel's registers are printed) into a
library of its own. A graph is built from N - 1 simulated 10 kb reads at
10 % error (chip_smoke.py's reads, seed 7) with the port's fused route on
cuda, and B2 aligns the last read against it at W = 512: every build's
outputs must equal the plain version's, then each build is timed with CUDA
events six times, in the order ABC..CBA then reversed, and the median, the
µs a computed row and every time are printed. A source from before the
window batch (its `abpoa_banded_dp` takes no `roff`) is called with the
one-window signature. Run it from the repository root on a machine with
the card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("builds", nargs="+", help="NAME=path of a fused_dp.cu")
    ap.add_argument("--reads", type=int, default=81)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("b2_builds: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from abpoa_tpu_torch.align.banded_kernel import banded_dp_torch
    from abpoa_tpu_torch.align.fused_dp_kernel import launch_shape
    from abpoa_tpu_torch.align.tables import build_row_tables, query_tables
    from abpoa_tpu_torch.kernels import build
    from abpoa_tpu_torch.params import Params

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    builds, procs = {}, []
    for spec in args.builds:
        name, src = spec.split("=", 1)
        with open(src) as fp:
            batched = "const void* roff" in fp.read()
        so = os.path.join(tmp, f"{name}.so")
        procs.append((name, so, batched, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", so, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, so, batched, p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "ILi2ELi2ELb1E" in line:
                print(f"{name}: B2 <CPT 2, convex>: {lines[i + 3].strip()}")
        builds[name] = (ctypes.CDLL(so), batched)

    dev = torch.device("cuda")
    abpt = Params(device="cuda").finalize()
    _, reads = cs.simulate(10000, args.reads, 0.10, 7)
    fa = os.path.join(tmp, "reads.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads[:-1])))
    g = cs.run_pipeline([fa], os.path.join(tmp, "cons.fa")).graph
    g.topological_sort(abpt)
    t = build_row_tables(g, 0, 1)
    W = 512
    qt = query_tables(abpt, t, cs.encode(abpt, reads[-1]), W)
    a = cs.to_dev([qt["scalars"], t.base, t.pre_idx, t.pre_cnt, t.out_idx,
                   t.out_cnt, t.remain, t.mpl0, t.mpr0, qt["qp_pad"],
                   qt["row0"]], dev)
    sc, base, pre_idx, pre_cnt, _, _, remain, mpl0, mpr0, qp, row0 = a
    R, P, QW = base.shape[0], pre_idx.shape[1], qp.shape[1]
    ls = launch_shape(W, P, 2, seeded=True)
    roff = torch.tensor([0, R], dtype=torch.int32, device=dev)
    print(f"graph of {args.reads - 1} reads: gn {t.gn}, W {W}, P {P}; "
          f"{ls['block_warps']} warps, ring D={ls['depth']}")

    def launch(name):
        lib, batched = builds[name]
        planes = torch.empty((5, R, W), dtype=torch.int32, device=dev)
        begend, mplr, lr = (torch.empty(2 * R, dtype=torch.int32, device=dev)
                            for _ in range(3))
        ok = torch.empty(1, dtype=torch.int32, device=dev)
        ext = torch.empty(4, dtype=torch.int32, device=dev)
        ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        outs = [ptr(x) for x in (*planes.unbind(0), begend, mplr, ok, ext, lr)]
        shape = [ls["block_warps"], ls["depth"], ls["smem"], stream]
        tables = [ptr(x) for x in (base, pre_idx, pre_cnt, remain, mpl0, mpr0,
                                   row0, qp)]
        if batched:
            err = lib.abpoa_banded_dp(ptr(sc), ptr(roff), *tables, *outs, 1, W,
                                      P, QW, qp.numel(), 2, *shape)
        else:
            err = lib.abpoa_banded_dp(ptr(sc), *tables, *outs, R, W, P, QW,
                                      *shape)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return planes, begend, mplr, ok

    want = banded_dp_torch(*a)
    rows = t.gn - 1
    for name in builds:
        got = launch(name)
        torch.cuda.synchronize()
        same = (torch.equal(got[0][:, :rows], torch.stack(want[:5])[:, :rows])
                and all(torch.equal(x, y) for x, y in zip(got[1:], want[5:])))
        if not same:
            raise AssertionError(f"{name}: B2 differs from the plain version")
    print(f"every build == the plain version on rows 0..{rows - 1}")
    order = list(builds) + list(builds)[::-1]
    times = {name: [] for name in builds}
    for k in range(3):
        for name in (order if k % 2 == 0 else order[::-1]):
            times[name].append(cs.time_cuda(lambda: launch(name), 5))
    for name, xs in times.items():
        med = float(np.median(xs))
        print(f"{name}: median {med:.3f} ms ({med * 1e3 / (rows - 1):.4f} us a "
              f"computed row); all {sorted(round(x, 3) for x in xs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
