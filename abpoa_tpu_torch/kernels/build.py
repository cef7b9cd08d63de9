"""Build the CUDA kernels once, at first use, and bind them with ctypes.

Every `abpoa_tpu_torch/csrc/*.cu` is compiled by its own `nvcc` for sm_90a
(all started together), and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in `build/abpoa_tpu_torch/` beside the package, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. A failed build raises.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "abpoa_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
# seconds the last build in this process took (0.0 when the library was
# already built on disk)
last_build_seconds = 0.0


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as fp:
            h.update(os.path.basename(src).encode() + fp.read())
    return os.path.join(BUILD_DIR, f"libabpoa_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list, verbose: bool) -> None:
    """Run the commands in parallel; raise with the output of the first that
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
        if verbose and out:
            print(out, flush=True)


def build(verbose: bool = False) -> str:
    """Compile the sources into the library if it is not built yet; returns
    its path. `verbose` adds `-Xptxas -v` and prints nvcc's output."""
    global last_build_seconds
    path = library_path()
    if os.path.isfile(path):
        last_build_seconds = 0.0
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(src) + ".o")
                for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", src, "-o", obj]
                  for src, obj in zip(sources(), objs)], verbose)
        tmp = os.path.join(tmpdir, "lib.so")
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]], verbose)
        os.replace(tmp, path)
    last_build_seconds = time.perf_counter() - t0
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with every entry point's
    argument types declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.abpoa_banded_dp.argtypes = [vp] * 21 + [ci] * 9 + [vp]
    lib.abpoa_banded_dp.restype = ci
    lib.abpoa_unbanded_dp.argtypes = [vp] * 21 + [ci] * 11 + [vp]
    lib.abpoa_unbanded_dp.restype = ci
    lib.abpoa_unbanded_max_clusters.argtypes = [ci] * 9 + [vp]
    lib.abpoa_unbanded_max_clusters.restype = ci
    lib.abpoa_fused_dp.argtypes = [vp] * 16 + [ci] * 11 + [vp]
    lib.abpoa_fused_dp.restype = ci
    lib.abpoa_backtrack.argtypes = [vp] * 15 + [ci] * 8 + [vp]
    lib.abpoa_backtrack.restype = ci
    lib.abpoa_backtrack_windows.argtypes = [vp] * 14 + [ci] * 7 + [vp]
    lib.abpoa_backtrack_windows.restype = ci
    lib.abpoa_backtrack_windows_tile.argtypes = [ci] * 4 + [vp]
    lib.abpoa_backtrack_windows_tile.restype = ci
    lib.abpoa_topo_sort.argtypes = [vp] * 19 + [ci] * 6 + [vp]
    lib.abpoa_topo_sort.restype = ci
    lib.abpoa_edge_sort.argtypes = [vp] * 10 + [ci] * 2 + [vp]
    lib.abpoa_edge_sort.restype = ci
    lib.abpoa_cuda_error_string.argtypes = [ci]
    lib.abpoa_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().abpoa_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
