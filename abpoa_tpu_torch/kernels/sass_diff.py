"""Compare the machine code (SASS) of a kernel source's functions between two
versions, for example the parent commit's and the working tree's:

    git show HEAD~1:abpoa_tpu_torch/csrc/fused_dp.cu > build/old_fused_dp.cu
    python -m abpoa_tpu_torch.kernels.sass_diff build/old_fused_dp.cu
    git show HEAD~1:abpoa_tpu_torch/csrc/backtrack.cu > build/old_backtrack.cu
    python -m abpoa_tpu_torch.kernels.sass_diff build/old_backtrack.cu \
        abpoa_tpu_torch/csrc/backtrack.cu

Needs the CUDA toolkit (nvcc, cuobjdump, cu++filt). Each source is compiled
to a cubin with the build's flags, and the instructions are compared with
addresses and encodings stripped. For `fused_dp.cu` (the default new
source) every `fused_dp_kernel<CPT, GAP>` of the old source is held against
the new source's `<CPT, GAP>` (with B2's seeded flag off where the source
has one); for any other source every function of the old source is held
against the new source's function of the same demangled name (functions
only the new source has are not compared; those only the old one has, say
a kernel moved to a file of its own, are listed as absent). One line per
function; exits 1 if any function both have differs, if a B1
instantiation is missing, or if nothing was compared.
"""
from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
import tempfile

from . import build

_NAME = re.compile(r"fused_dp_kernelILi(\d+)ELi(\d+)E((?:Lb[01]E)*)E")


def b1_sass(src: str, workdir: str) -> dict:
    """{(CPT, GAP): SASS lines} of the B1 instantiations in `src`."""
    return parse_b1(_cubin_sass(src, workdir))


def _cubin_sass(src: str, workdir: str) -> str:
    nvcc = build.find_nvcc()
    cubin = os.path.join(workdir, os.path.basename(src) + ".cubin")
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-cubin", "-o", cubin, src],
                   check=True)
    return subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
        capture_output=True, text=True, check=True).stdout


_TARGET = re.compile(r"\.L_x_\d+|0x[0-9a-f]+(?=\s*;)")
_JUMP = re.compile(r"\b(BRA|BSSY|JMP|CALL)\b")


def _strip(body: str) -> list:
    """The instructions of one function, addresses and encodings dropped
    and branch targets (labels numbered across the whole cubin, or
    addresses that move with any instruction before them) renumbered in
    order of first use, so only the instructions themselves are compared."""
    lines, labels = [], {}
    relabel = lambda m: labels.setdefault(m.group(0), f".L{len(labels)}")  # noqa: E731
    for line in body.splitlines():
        line = re.sub(r"/\*[0-9a-fx ]+\*/", "", line).strip()
        if line and not line.startswith("."):
            if _JUMP.search(line):
                line = _TARGET.sub(relabel, line)
            lines.append(line)
    return lines


def all_sass(src: str, workdir: str) -> dict:
    """{demangled name: SASS lines} of every function in `src` (the
    anonymous namespace's per-file tag dropped)."""
    blocks = [b.split("\n", 1) for b in _cubin_sass(src, workdir).split("Function : ")[1:]]
    filt = os.path.join(os.path.dirname(build.find_nvcc()), "cu++filt")
    names = subprocess.run([filt], input="\n".join(n.strip() for n, _ in blocks),
                           capture_output=True, text=True, check=True).stdout
    return {name: _strip(body)
            for name, (_, body) in zip(names.splitlines(), blocks)}


def parse_b1(sass: str) -> dict:
    """{(CPT, GAP): instruction lines} of the B1 functions in cuobjdump's
    `-sass` listing."""
    out = {}
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        m = _NAME.search(name)
        if not m or "1" in m.group(3):  # a B2 instantiation
            continue
        out[(int(m.group(1)), int(m.group(2)))] = _strip(body)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    new_src = argv[1] if len(argv) == 2 else os.path.join(build.CSRC_DIR,
                                                          "fused_dp.cu")
    b1 = os.path.basename(new_src) == "fused_dp.cu"
    with tempfile.TemporaryDirectory() as tmp:
        get = b1_sass if b1 else all_sass
        # the two sources compile from one directory under one file name,
        # so nothing but their code tells them apart
        old, new = [get(_as(src, tmp, k), os.path.join(tmp, k))
                    for k, src in (("old", argv[0]), ("new", new_src))]
    differ = absent = 0
    for key in sorted(old):
        what = f"B1 <CPT {key[0]}, GAP {key[1]}>" if b1 else key
        if key not in new and not b1:
            absent += 1
            print(f"{what}: not in the new source ({len(old[key])} lines)")
            continue
        same = new.get(key) == old[key]
        differ += not same
        print(f"{what}: {'identical' if same else 'DIFFERS'} ({len(old[key])} lines)")
        if not same and key in new:  # where they part
            diff = difflib.unified_diff(old[key], new[key], lineterm="", n=1)
            print("\n".join(list(diff)[2:42]))
    compared = len(old) - absent
    print(f"{compared - differ} of {compared} "
          f"{'B1 instantiations' if b1 else 'functions'} identical"
          + (f"; {absent} not in the new source" if absent else ""))
    return 1 if differ or not compared else 0


def _as(src: str, tmp: str, tag: str) -> str:
    """`src` copied to tmp/tag/kernel.cu."""
    d = os.path.join(tmp, tag)
    os.makedirs(d, exist_ok=True)
    dst = os.path.join(d, "kernel.cu")
    with open(src) as a, open(dst, "w") as b:
        b.write(a.read())
    return dst


if __name__ == "__main__":
    sys.exit(main())
