"""Build and load the native host graph (`host_core.cpp`, bound with ctypes).

Counterpart of `abpoa_tpu/native/__init__.py`. The library is compiled by
`g++` at first use into `build/abpoa_tpu_torch/` beside the package, named
by a hash of the source, the flags and the host CPU (a `-march=native`
build must not be reused on another instruction set), so an edited source
or another machine rebuilds and an unchanged one is reused. The same build
serves the CPU and the card machine. A failed build raises; nothing falls
back to the Python graph.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional

from ..kernels.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_core.cpp")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None


def _host_tag() -> str:
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as fp:
            for line in fp:
                if line.startswith(("flags", "Features")):
                    return tag + line
    except OSError:
        pass
    return tag


def library_path() -> str:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS, _host_tag()]).encode())
    with open(SRC, "rb") as fp:
        h.update(fp.read())
    return os.path.join(BUILD_DIR, f"libabpoa_host_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is not built yet; returns its path."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, "lib.so")
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, SRC, "-o", tmp],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the native host graph cannot be built: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}) on {SRC}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built at first use, with its entry points' types."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    c = ctypes
    vp, ci = c.c_void_p, c.c_int
    i32p, i64p = c.POINTER(c.c_int32), c.POINTER(c.c_int64)
    u8p, u64p = c.POINTER(c.c_uint8), c.POINTER(c.c_uint64)
    sigs = {
        "apg_create": ([], vp),
        "apg_destroy": ([vp], None),
        "apg_reset": ([vp], None),
        "apg_node_n": ([vp], ci),
        "apg_is_sorted": ([vp], ci),
        "apg_topological_sort": ([vp, ci, ci], None),
        "apg_add_alignment": ([vp, ci, ci, u8p, i64p, ci, u64p] + [ci] * 8
                              + [i64p], ci),
        "apg_build_tables": ([vp] + [ci] * 6 + [i32p, u8p, i32p, u8p, i32p,
                                                u8p] + [i32p] * 4, ci),
        "apg_write_band": ([vp, ci, ci, i32p, i32p], None),
        "apg_get_index": ([vp, i32p, i32p], ci),
        "apg_get_remain": ([vp, i32p], ci),
        "apg_get_band": ([vp, i32p, i32p], ci),
        "apg_export_sizes": ([vp, i64p], ci),
        "apg_export": ([vp, u8p, i32p, i32p, i64p, i32p, i32p, i64p, i32p,
                        i32p, i64p, i32p, i64p, i32p, i32p, i64p, u64p,
                        i64p], ci),
        "apg_import": ([vp, ci, i32p, i32p, i32p, i64p, i32p, i32p, i64p,
                        i32p, i32p, u64p, ci, i64p, i32p, i64p, i32p, i32p]
                       + [i32p] * 5 + [ci], ci),
        "apg_subgraph_nodes": ([vp, ci, ci, i32p], ci),
        "apg_cons_hb": ([vp, i32p, i32p, i32p, ci], ci),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    _lib = lib
    return lib
