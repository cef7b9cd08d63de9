"""chip_smoke.py phase C12 (run telemetry) on its own, at a reduced size:
the kernels' build, an N-read 10 kb set at 10 % error (C's shape; N the
first argument, default 20), C9's first four sets (10-25 reads), then
`chip_smoke.phase_c12` (a)-(d). Needs one CUDA card:

    python3 tools/c12_quick.py [N]
"""
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

os.makedirs(cs.OUT, exist_ok=True)
os.environ.setdefault("ABPOA_TPU_ARCHIVE_DIR", os.path.join(cs.OUT, "archive"))
os.environ.setdefault("XDG_CACHE_HOME", os.path.join(cs.OUT, "cache"))
from abpoa_tpu_torch.kernels import build  # noqa: E402
t0 = time.perf_counter()
build.build()
cs.log(f"card: {cs.smi('name,power.limit')}; build {time.perf_counter() - t0:.1f} s")
n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
ref, reads = cs.simulate(10000, n, 0.10, 7)
fa = os.path.join(cs.OUT, "sim.fa")
with open(fa, "w") as fp:
    fp.write("".join(f">read_{i}\n{r}\n" for i, r in enumerate(reads)))
files = []
for i in range(4):
    _ref, rs = cs.simulate(10000, 10 + 5 * i, 0.10, 11 + i)
    p = os.path.join(cs.OUT, f"c9_set{i}.fa")
    with open(p, "w") as fp:
        fp.write("".join(f">s{i}_{j}\n{r}\n" for j, r in enumerate(rs)))
    files.append(p)
with open(os.path.join(cs.OUT, "c9_list.txt"), "w") as fp:
    fp.write("".join(f + "\n" for f in files))
t0 = time.perf_counter()
out = cs.phase_c12(types.SimpleNamespace(c12_reads=n), fa)
cs.log(f"[C12 quick] {time.perf_counter() - t0:.1f} s: {out['ratio']:.4f}")
