#!/usr/bin/env python3
"""Time kernel X1w across tile widths, in one process on one card, in
alternating turns.

    python3 tools/x1w_tiles.py [--cols 32 64 128] [--reads N] [--src FILE]

`csrc/backtrack_windows.cu` (or --src, a copy of it) is compiled once a
width C (`-DX1W_TILE_COLS=C`,
the package's flags and `-Xptxas -v`, each by its own nvcc) into a library
of its own; the rows a tile holds follow from C (`tile_shape`). A graph is
built from N - 1 simulated 10 kb reads at 10 % error (chip_smoke.py's
reads, seed 7) with the port's fused route on cuda, and B2 aligns the last
read against it twice: banded (W 512, relaunched wider where it overflows)
and on whole rows (`-b -1`, B2u, W = qlen + 1 rounded to 128). On each
launch's planes every build's X1w must equal the plain version (headers,
bands, ops); then each build is timed with CUDA events six times, in the
order of --cols then reversed, three rounds, and the median, the µs a step
and the share of steps its tiles hold (`chip_smoke.tile_replay`) are
printed. Run it from the repository root on a machine with the card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cols", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--reads", type=int, default=41)
    ap.add_argument("--src", help="the source to build (default: the package's)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("x1w_tiles: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.backtrack_kernel import (HEADER,
                                                        backtrack_windows_torch,
                                                        tile_shape)
    from abpoa_tpu_torch.kernels import build
    from abpoa_tpu_torch.params import Params

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    src = args.src or os.path.join(build.CSRC_DIR, "backtrack_windows.cu")
    procs = []
    for c in args.cols:
        so = os.path.join(tmp, f"x1w_c{c}.so")
        procs.append((c, so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
             f"-DX1W_TILE_COLS={c}", "-shared", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for c, so, p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for C = {c}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"C {c}: {line.strip()}")
        lib = ctypes.CDLL(so)
        lib.abpoa_backtrack_windows.argtypes = [vp] * 14 + [ci] * 7 + [vp]
        lib.abpoa_backtrack_windows.restype = ci
        libs[c] = lib

    def launch(lib, inputs, kw):
        dev = inputs[0].device
        packed = torch.empty(kw["size"], dtype=torch.int32, device=dev)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        ps = kw["pre_score"]
        err = lib.abpoa_backtrack_windows(
            *(ptr(t) for t in inputs), ptr(ps) if ps is not None else None,
            ptr(packed), inputs[11].shape[0], inputs[0].shape[1],
            inputs[0].shape[2], inputs[4].shape[1], inputs[9].shape[1],
            kw["gap_mode"], (1 if kw["gap_on_right"] else 0)
            | (2 if kw["put_gap_at_end"] else 0),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        build.check(err, "backtrack_windows launch")
        return packed

    _, reads = cs.simulate(10000, args.reads, 0.10, 7)
    fa = os.path.join(tmp, "reads.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads[:-1])))
    g = cs.run_pipeline([fa], os.path.join(tmp, "cons.fa")).graph
    print(cs.smi("name,power.limit"))
    for tag, fields in (("banded", {}), ("whole rows", {"wb": -1})):
        p = Params(device="cuda", **fields).finalize()
        g.topological_sort(p)
        query = cs.encode(p, reads[-1])
        ts, out, t = cs.tile_launch(p, g, query)
        xin, xkw, layout = banded.walk_inputs(p, ts, out, [t], [query], [0])
        want = backtrack_windows_torch(*xin, **xkw).cpu()
        h, b, o, _ = layout[0]
        n_ops = int(want[h])
        sel = torch.cat([torch.arange(h, h + HEADER),
                         torch.arange(b, b + 2 * t.gn),
                         torch.arange(o, o + 2 * n_ops)])
        for c, lib in libs.items():
            got = launch(lib, xin, xkw)
            torch.cuda.synchronize()
            if not torch.equal(got.cpu()[sel], want[sel]):
                raise AssertionError(f"X1w with C = {c} differs from the plain "
                                     f"version at {tag}")
        times = {c: [] for c in libs}
        order = list(libs) + list(libs)[::-1]
        for _ in range(3):
            for c in order:
                times[c].append(cs.time_cuda(lambda: launch(libs[c], xin, xkw), 1))
        print(f"{tag}: gn {t.gn}, W {xin[0].shape[2]}, {n_ops} steps; every "
              f"build == plain")
        for c in libs:
            shape = tile_shape(xkw["gap_mode"], xin[4].shape[1],
                               xkw["pre_score"] is not None, xin[9].shape[1],
                               cols=c)
            rep = cs.tile_replay(xin, xkw, want, cols=c)
            med = statistics.median(times[c])
            print(f"  C {c:3d} (R {shape['R']}, {shape['smem']} B shared): "
                  f"median {med:.3f} ms, {med * 1e3 / n_ops:.3f} us a step, "
                  f"tiles hold {rep['share'] * 100:.2f} % of the steps "
                  f"({rep['loads']} tiles, {rep['changes']} stage changes); "
                  f"times {' '.join(f'{x:.3f}' for x in times[c])}")
        del ts, out, xin, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
