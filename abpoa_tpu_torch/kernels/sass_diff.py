"""Compare the machine code (SASS) of kernel B1's instantiations between two
versions of `csrc/fused_dp.cu`, for example the parent commit's and the
working tree's:

    git show HEAD~1:abpoa_tpu_torch/csrc/fused_dp.cu > build/old_fused_dp.cu
    python -m abpoa_tpu_torch.kernels.sass_diff build/old_fused_dp.cu

Needs the CUDA toolkit (nvcc, cuobjdump). Each source is compiled to a
cubin with the build's flags; every `fused_dp_kernel<CPT, GAP>` of the old
source is held against the new source's `<CPT, GAP>` (with B2's seeded flag
off where the source has one), with addresses and encodings stripped. One
line per instantiation; exits 1 if any differs or is missing.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

from . import build

_NAME = re.compile(r"fused_dp_kernelILi(\d+)ELi(\d+)E(?:Lb([01])E)?E")


def b1_sass(src: str, workdir: str) -> dict:
    """{(CPT, GAP): SASS lines} of the B1 instantiations in `src`."""
    nvcc = build.find_nvcc()
    cubin = os.path.join(workdir, os.path.basename(src) + ".cubin")
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-cubin", "-o", cubin, src],
                   check=True)
    return parse_b1(subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
        capture_output=True, text=True, check=True).stdout)


def parse_b1(sass: str) -> dict:
    """{(CPT, GAP): instruction lines} of the B1 functions in cuobjdump's
    `-sass` listing."""
    out = {}
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        m = _NAME.search(name)
        if not m or m.group(3) == "1":
            continue
        lines = []
        for line in body.splitlines():
            line = re.sub(r"/\*[0-9a-fx ]+\*/", "", line).strip()
            if line and not line.startswith("."):
                lines.append(line)
        out[(int(m.group(1)), int(m.group(2)))] = lines
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    new_src = argv[1] if len(argv) == 2 else os.path.join(build.CSRC_DIR,
                                                          "fused_dp.cu")
    with tempfile.TemporaryDirectory() as tmp:
        old, new = b1_sass(argv[0], tmp), b1_sass(new_src, tmp)
    differ = 0
    for key in sorted(old):
        same = new.get(key) == old[key]
        differ += not same
        print(f"B1 <CPT {key[0]}, GAP {key[1]}>: "
              f"{'identical' if same else 'DIFFERS'} ({len(old[key])} lines)")
    print(f"{len(old) - differ} of {len(old)} B1 instantiations identical")
    return 1 if differ or not old else 0


if __name__ == "__main__":
    sys.exit(main())
