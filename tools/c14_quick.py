"""chip_smoke.py phase C14 (the server) on its own: the kernels' build,
the inputs C14 takes from earlier phases made here (C9's first sets of 10
kb reads at 10 % error, seeds 11-14, set i of 5 + 5 i reads; 30 headline
reads, seed 7; C12 (a)'s MSA of the first 10 with -r 2), then
`chip_smoke.phase_c14`. Needs one CUDA card:

    python3 tools/c14_quick.py [--c14-sets N]

With --cpu it rehearses (a)-(e) on the CPU at a small size (1 kb reads,
sets of 3-6 reads; the plain versions; children on --device cpu): (f)
needs the card, where a hang loses it.
"""
import argparse
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import faulthandler
    # a hung part prints every thread's stack
    faulthandler.dump_traceback_later(
        float(os.environ.get("C14_QUICK_DUMP_S", "1500")))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--c14-sets", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    os.makedirs(cs.OUT, exist_ok=True)
    os.environ.setdefault("ABPOA_TPU_ARCHIVE_DIR",
                          os.path.join(cs.OUT, "archive"))
    os.environ.setdefault("ABPOA_TPU_LEDGER_DIR",
                          os.path.join(cs.OUT, "ledger"))
    os.environ.setdefault("XDG_CACHE_HOME", os.path.join(cs.OUT, "cache"))
    ref_len, n0 = 10000, 5
    if args.cpu:
        import torch
        from abpoa_tpu_torch import params
        params.resolve_device = lambda name="cuda": torch.device("cpu")
        torch.cuda.synchronize = lambda *a, **k: None
        os.environ["ABPOA_TPU_LOCKSTEP_MIN_QLEN"] = "0"
        os.environ["ABPOA_TPU_LOCKSTEP_IMPL"] = "device"
        cs.C14_FLAGS = ["-r", "2", "--lockstep", "on"]
        cs.C14_CHILD_ARGS = ["--device", "cpu"]
        ref_len, n0 = 1000, 3
    else:
        from abpoa_tpu_torch.kernels import build
        t0 = time.perf_counter()
        build.build()
        cs.log(f"card: {cs.smi('name,power.limit')}; build "
               f"{time.perf_counter() - t0:.1f} s")
    files = []
    for i in range(args.c14_sets):
        _ref, rs = cs.simulate(ref_len, n0 + (5 if ref_len > 1000 else 1) * i,
                               0.10, 11 + i)
        p = os.path.join(cs.OUT, f"c9_set{i}.fa")
        with open(p, "w") as fp:
            fp.write("".join(f">s{i}_{j}\n{r}\n" for j, r in enumerate(rs)))
        files.append(p)
    _ref, reads = cs.simulate(ref_len, 30, 0.10, 7)
    fa = os.path.join(cs.OUT, "sim.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">read_{i}\n{r}\n" for i, r in enumerate(reads)))
    d12 = os.path.join(cs.OUT, "c12")
    os.makedirs(d12, exist_ok=True)
    fa10 = os.path.join(d12, "c12_reads.fa")
    with open(fa10, "w") as fp:
        fp.write("".join(f">read_{i}\n{r}\n" for i, r in
                         enumerate(reads[:10])))
    msa = os.path.join(d12, "a3.fa")
    cs.run_cli([fa10, "-r", "2", "-o", msa] + (["--device", "cpu"]
                                                 if args.cpu else []))
    absorbed = cs.Absorbed()
    absorbed.install()
    t0 = time.perf_counter()
    out = cs.phase_c14(types.SimpleNamespace(c14_sets=args.c14_sets), fa,
                       files, msa, absorbed, card=not args.cpu)
    absorbed.check("C14")
    cs.log(f"[C14 quick] {time.perf_counter() - t0:.1f} s; launches "
           f"{out['launches']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
