"""chip_smoke.py phase C13 (the resilience envelope) on its own, at a
reduced size: the kernels' build, an N-read 10 kb set at 10 % error (C's
shape; N the first argument, default 20), C9's first two sets (10 and 15
reads), then `chip_smoke.phase_c13_envelope` (a) and `phase_c13` (b)-(d). Needs
one CUDA card:

    python3 tools/c13_quick.py [N]
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
for i in range(2):
    _ref, rs = cs.simulate(10000, 10 + 5 * i, 0.10, 11 + i)
    p = os.path.join(cs.OUT, f"c9_set{i}.fa")
    with open(p, "w") as fp:
        fp.write("".join(f">s{i}_{j}\n{r}\n" for j, r in enumerate(rs)))
    files.append(p)
absorbed = cs.Absorbed()
absorbed.install()
t0 = time.perf_counter()
args = types.SimpleNamespace(c13_reads=n)
files13 = cs.c13_files(args, fa, {"files": files})
ratio = cs.phase_c13_envelope(args, files13, absorbed)
cs.phase_c13(args, files13, absorbed)
absorbed.check("C13")
cs.log(f"[C13 quick] {time.perf_counter() - t0:.1f} s: on / off {ratio:.4f}")
