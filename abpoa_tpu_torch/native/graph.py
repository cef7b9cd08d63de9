"""Python facade over the native host graph.

Counterpart of `abpoa_tpu/native/graph.py` `NativePOAGraph`, with the
surface of this package's `graph.POAGraph` that the per-read and seeded
routes use: fusion, topological sort and the DP kernel's row tables run in
C++. A graph is loaded whole from arrays (`load_arrays`: the `-i` restore,
`convert.native_graph_from_numpy`). The outputs that walk nodes (MSA, GFA,
clustering, the `-g` plot) read a `POAGraph` made by `to_python()`, once a
read set; the default consensus comes from C++ (`consensus_hb`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .. import constants as C
from ..graph import Node, POAGraph, _add_read_weight
from ..params import Params
from . import load

_I32, _I64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
_U8, _U64 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64)


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(t)


def _i32(n: int) -> np.ndarray:
    return np.zeros(max(n, 1), dtype=np.int32)


def read_id_bitsets(a: dict) -> list:
    """Each out edge's read-id bitset in `NativePOAGraph.export()`'s arrays
    as a Python int, in export order."""
    words, off, bits = (a["bits_words"].tolist(), a["bits_off"].tolist(),
                        a["bits"].tolist())
    out = [0] * len(words)
    for e, wn in enumerate(words):
        v = 0
        for k in range(wn):
            v |= bits[off[e] + k] << (64 * k)
        out[e] = v
    return out


class NativePOAGraph:
    is_native = True

    def __init__(self) -> None:
        self._lib = load()
        self._h = self._lib.apg_create()
        # bumped by every change of the node order; the index arrays are
        # fetched again after one
        self._version = 0
        self._index_v = -1
        self._i2n = self._n2i = np.zeros(0, dtype=np.int32)

    def __deepcopy__(self, memo):
        """A second C++ graph with this one's state (a copy of the handle
        would free the graph twice)."""
        from ..convert import graph_to_numpy
        g = NativePOAGraph()
        g.load_arrays(graph_to_numpy(self))
        return g

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h is not None:
            lib.apg_destroy(h)

    # ----------------------------------------------------------- properties
    @property
    def node_n(self) -> int:
        return self._lib.apg_node_n(self._h)

    @property
    def is_topological_sorted(self) -> bool:
        return bool(self._lib.apg_is_sorted(self._h))

    def reset(self) -> None:
        self._lib.apg_reset(self._h)
        self._version += 1

    def topological_sort(self, abpt: Params) -> None:
        self._lib.apg_topological_sort(self._h, 1 if abpt.wb >= 0 else 0,
                                       1 if abpt.zdrop > 0 else 0)
        self._version += 1

    def _index_arrays(self):
        if self._index_v != self._version:
            n = self.node_n
            self._i2n = np.zeros(n, dtype=np.int32)
            self._n2i = np.zeros(n, dtype=np.int32)
            self._lib.apg_get_index(self._h, _ptr(self._i2n, _I32),
                                    _ptr(self._n2i, _I32))
            self._index_v = self._version
        return self._i2n, self._n2i

    @property
    def index_to_node_id(self) -> np.ndarray:
        return self._index_arrays()[0]

    @property
    def node_id_to_index(self) -> np.ndarray:
        return self._index_arrays()[1]

    # ------------------------------------------------------------- mutation
    def add_subgraph_alignment(self, abpt: Params, beg_node_id: int,
                               end_node_id: int, seq: np.ndarray,
                               weight: Optional[np.ndarray], cigar: list,
                               inc_both_ends: bool, read_id: int = 0,
                               qpos_to_node_id: Optional[np.ndarray] = None
                               ) -> None:
        """`POAGraph.add_subgraph_alignment` in C++ (apg_add_alignment),
        the sort and the spanning-read counts included."""
        seq = np.ascontiguousarray(seq, dtype=np.uint8)
        seq_l = len(seq)
        if weight is None:
            weight = np.ones(seq_l, dtype=np.int64)
        weight = np.ascontiguousarray(weight, dtype=np.int64)
        cig = np.asarray(cigar, dtype=np.uint64)
        qpos = None
        if qpos_to_node_id is not None:
            qpos = np.ascontiguousarray(qpos_to_node_id, dtype=np.int64)
        rc = self._lib.apg_add_alignment(
            self._h, int(beg_node_id), int(end_node_id), _ptr(seq, _U8),
            _ptr(weight, _I64), seq_l, _ptr(cig, _U64) if len(cig) else None,
            len(cig), int(read_id), int(read_id) + 1,
            1 if abpt.use_read_ids else 0, 1 if _add_read_weight(abpt) else 0,
            1 if inc_both_ends else 0, 1 if abpt.wb >= 0 else 0,
            1 if abpt.zdrop > 0 else 0,
            None if qpos is None else _ptr(qpos, _I64))
        if rc != 0:
            raise RuntimeError("native fusion failed")
        if qpos is not None and qpos is not qpos_to_node_id:
            qpos_to_node_id[:seq_l] = qpos[:seq_l]
        self._version += 1

    def add_alignment(self, abpt: Params, seq: np.ndarray,
                      weight: Optional[np.ndarray], cigar: list,
                      inc_both_ends: bool, read_id: int = 0) -> None:
        self.add_subgraph_alignment(abpt, C.SRC_NODE_ID, C.SINK_NODE_ID, seq,
                                    weight, cigar, inc_both_ends, read_id)

    def subgraph_nodes(self, abpt: Params, inc_beg: int, inc_end: int):
        """The closed subgraph around [inc_beg, inc_end] (abPOA
        abpoa_subgraph_nodes, src/abpoa_graph.c:595-678): (beg id, end id)."""
        if not self.is_topological_sorted:
            self.topological_sort(abpt)
        out2 = np.zeros(2, dtype=np.int32)
        self._lib.apg_subgraph_nodes(self._h, int(inc_beg), int(inc_end),
                                     _ptr(out2, _I32))
        return int(out2[0]), int(out2[1])

    # ----------------------------------------------------- the DP's tables
    def build_tables(self, beg_node_id: int, end_node_id: int,
                     banded: bool = True) -> dict:
        """The row tables of the subgraph [beg_node_id, end_node_id]
        (apg_build_tables), gn rows each: base, row_active, pre_idx/pre_msk
        (gn, maxP), out_idx/out_msk (gn, maxO), remain, mpl0, mpr0, and
        gn, beg_index, remain_end. With `banded` it also seeds the graph's
        mpl/mpr of the first row and its successors, as abPOA does."""
        lib = self._lib
        meta = np.zeros(5, dtype=np.int32)
        b = 1 if banded else 0
        lib.apg_build_tables(self._h, int(beg_node_id), int(end_node_id), 0,
                             0, 0, b, None, None, None, None, None, None,
                             None, None, None, _ptr(meta, _I32))
        P, O, gn = int(meta[0]), int(meta[1]), int(meta[2])
        base, remain, mpl0, mpr0 = _i32(gn), _i32(gn), _i32(gn), _i32(gn)
        row_active = np.zeros(max(gn, 1), dtype=np.uint8)
        pre_idx = np.zeros((gn, P), dtype=np.int32)
        pre_msk = np.zeros((gn, P), dtype=np.uint8)
        out_idx = np.zeros((gn, O), dtype=np.int32)
        out_msk = np.zeros((gn, O), dtype=np.uint8)
        lib.apg_build_tables(self._h, int(beg_node_id), int(end_node_id), gn,
                             P, O, b, _ptr(base, _I32), _ptr(row_active, _U8),
                             _ptr(pre_idx, _I32), _ptr(pre_msk, _U8),
                             _ptr(out_idx, _I32), _ptr(out_msk, _U8),
                             _ptr(remain, _I32), _ptr(mpl0, _I32),
                             _ptr(mpr0, _I32), _ptr(meta, _I32))
        row_active[gn - 1:] = 0  # the end row is not a DP row (JAX's form)
        return dict(base=base[:gn], row_active=row_active[:gn].astype(bool),
                    pre_idx=pre_idx, pre_msk=pre_msk.astype(bool),
                    out_idx=out_idx, out_msk=out_msk.astype(bool),
                    remain=remain[:gn], mpl0=mpl0[:gn], mpr0=mpr0[:gn],
                    gn=gn, beg_index=int(meta[3]), remain_end=int(meta[4]))

    def write_band(self, beg_index: int, gn: int, mpl: np.ndarray,
                   mpr: np.ndarray) -> None:
        """Set the mpl/mpr of rows beg_index..beg_index + gn - 1."""
        mpl = np.ascontiguousarray(mpl, dtype=np.int32)
        mpr = np.ascontiguousarray(mpr, dtype=np.int32)
        self._lib.apg_write_band(self._h, int(beg_index), int(gn),
                                 _ptr(mpl, _I32), _ptr(mpr, _I32))

    # ---------------------------------------------------------------- output
    def consensus_hb(self):
        """Single-cluster heaviest-bundling consensus in C++ (apg_cons_hb):
        (node ids, bases, coverages) as int32 arrays."""
        cap = max(16, self.node_n)
        while True:
            ids, bases, covs = _i32(cap), _i32(cap), _i32(cap)
            n = self._lib.apg_cons_hb(self._h, _ptr(ids, _I32),
                                      _ptr(bases, _I32), _ptr(covs, _I32), cap)
            if n >= 0:
                return ids[:n], bases[:n], covs[:n]
            cap *= 2

    def export(self) -> dict:
        """The whole graph as arrays: apg_export's CSR form (in_off, out_off,
        al_off, rw_off (n + 1,) int64; bits_off, bits_words per out edge),
        plus remain, mpl and mpr (None before a banded sort), the index
        arrays and the sorted flag."""
        lib = self._lib
        counts = np.zeros(6, dtype=np.int64)
        lib.apg_export_sizes(self._h, _ptr(counts, _I64))
        n, tin, tout, tal, trw, tbits = (int(x) for x in counts)
        a = dict(base=np.zeros(n, dtype=np.uint8), n_read=_i32(n)[:n],
                 n_span=_i32(n)[:n], in_off=np.zeros(n + 1, dtype=np.int64),
                 in_ids=_i32(tin), in_w=_i32(tin),
                 out_off=np.zeros(n + 1, dtype=np.int64), out_ids=_i32(tout),
                 out_w=_i32(tout), al_off=np.zeros(n + 1, dtype=np.int64),
                 al_ids=_i32(tal), rw_off=np.zeros(n + 1, dtype=np.int64),
                 rw_ids=_i32(trw), rw_vals=_i32(trw),
                 bits_off=np.zeros(max(tout, 1), dtype=np.int64),
                 bits=np.zeros(max(tbits, 1), dtype=np.uint64),
                 bits_words=np.zeros(max(tout, 1), dtype=np.int64))
        types = (_U8, _I32, _I32, _I64, _I32, _I32, _I64, _I32, _I32, _I64,
                 _I32, _I64, _I32, _I32, _I64, _U64, _I64)
        keys = ("base", "n_read", "n_span", "in_off", "in_ids", "in_w",
                "out_off", "out_ids", "out_w", "al_off", "al_ids", "rw_off",
                "rw_ids", "rw_vals", "bits_off", "bits", "bits_words")
        lib.apg_export(self._h, *(_ptr(a[k], t) for k, t in zip(keys, types)))
        for k, size in (("in_ids", tin), ("in_w", tin), ("out_ids", tout),
                        ("out_w", tout), ("al_ids", tal), ("rw_ids", trw),
                        ("rw_vals", trw), ("bits_off", tout),
                        ("bits_words", tout), ("bits", tbits)):
            a[k] = a[k][:size]
        remain, mpl, mpr = _i32(n)[:n], _i32(n)[:n], _i32(n)[:n]
        has_remain = lib.apg_get_remain(self._h, _ptr(remain, _I32)) == 0
        has_band = lib.apg_get_band(self._h, _ptr(mpl, _I32), _ptr(mpr, _I32)) == 0
        a["remain"] = remain if has_remain else None
        a["mpl"], a["mpr"] = (mpl, mpr) if has_band else (None, None)
        a["sorted"] = self.is_topological_sorted
        a["index_to_node_id"], a["node_id_to_index"] = (
            (x.copy() for x in self._index_arrays()) if a["sorted"]
            else (None, None))
        return a

    def to_python(self) -> POAGraph:
        """This graph as a `POAGraph` (the outputs that walk nodes read
        one), with its sort's arrays and band metadata."""
        a = self.export()
        n = len(a["base"])
        base, n_read, n_span = (a[k].tolist() for k in ("base", "n_read", "n_span"))
        in_off, in_ids, in_w = (a[k].tolist() for k in ("in_off", "in_ids", "in_w"))
        out_off, out_ids, out_w = (a[k].tolist()
                                   for k in ("out_off", "out_ids", "out_w"))
        al_off, al_ids = a["al_off"].tolist(), a["al_ids"].tolist()
        rw_off, rw_ids, rw_vals = (a[k].tolist()
                                   for k in ("rw_off", "rw_ids", "rw_vals"))
        read_ids = read_id_bitsets(a)
        g = POAGraph()
        g.nodes = []
        for i in range(n):
            nd = Node(i, base[i])
            nd.in_ids, nd.in_w = in_ids[in_off[i]: in_off[i + 1]], in_w[in_off[i]: in_off[i + 1]]
            o0, o1 = out_off[i], out_off[i + 1]
            nd.out_ids, nd.out_w, nd.read_ids = out_ids[o0:o1], out_w[o0:o1], read_ids[o0:o1]
            nd.aligned_ids = al_ids[al_off[i]: al_off[i + 1]]
            nd.n_read, nd.n_span_read = n_read[i], n_span[i]
            nd.read_weight = dict(zip(rw_ids[rw_off[i]: rw_off[i + 1]],
                                      rw_vals[rw_off[i]: rw_off[i + 1]]))
            g.nodes.append(nd)
        if a["remain"] is not None:
            g.node_id_to_max_remain = a["remain"]
        if a["mpl"] is not None:
            g.node_id_to_max_pos_left, g.node_id_to_max_pos_right = a["mpl"], a["mpr"]
        if a["sorted"]:
            g.index_to_node_id = a["index_to_node_id"]
            g.node_id_to_index = a["node_id_to_index"]
        g.is_topological_sorted = a["sorted"]
        return g

    def load_arrays(self, a: dict) -> None:
        """Replace this graph by `convert.graph_to_numpy`'s arrays."""
        n = len(a["base"])
        i32 = lambda k: np.ascontiguousarray(a[k], dtype=np.int32)  # noqa: E731
        i64 = lambda k: np.ascontiguousarray(a[k], dtype=np.int64)  # noqa: E731

        def rows(k):  # an (N,) array of the sort, zero past its length
            out = np.zeros(n, dtype=np.int32)
            v = np.asarray(a[k], dtype=np.int32)[:n]
            out[: len(v)] = v
            return out

        bits = np.ascontiguousarray(a["out_read_ids"], dtype=np.uint64)
        words = bits.shape[1] if bits.ndim == 2 else 1
        arrs = dict(base=i32("base"), n_read=i32("n_read"),
                    n_span=i32("n_span_read"), in_off=i64("in_ptr"),
                    in_ids=i32("in_ids"), in_w=i32("in_w"),
                    out_off=i64("out_ptr"), out_ids=i32("out_ids"),
                    out_w=i32("out_w"), bits=bits, al_off=i64("aligned_ptr"),
                    al_ids=i32("aligned_ids"), rw_off=i64("read_weight_ptr"),
                    rw_ids=i32("read_weight_ids"), rw_vals=i32("read_weight_w"),
                    i2n=rows("index_to_node_id"), n2i=rows("node_id_to_index"),
                    remain=rows("remain"), mpl=rows("mpl"), mpr=rows("mpr"))
        # an empty array still needs an address
        arrs = {k: v if v.size else np.zeros(1, dtype=v.dtype)
                for k, v in arrs.items()}
        p = {k: _ptr(v, _U64 if k == "bits" else _I64 if v.dtype == np.int64
                     else _I32) for k, v in arrs.items()}
        rc = self._lib.apg_import(
            self._h, n, p["base"], p["n_read"], p["n_span"], p["in_off"],
            p["in_ids"], p["in_w"], p["out_off"], p["out_ids"], p["out_w"],
            p["bits"], words, p["al_off"], p["al_ids"], p["rw_off"],
            p["rw_ids"], p["rw_vals"], p["i2n"], p["n2i"], p["remain"],
            p["mpl"], p["mpr"], 1 if bool(a["is_topological_sorted"]) else 0)
        if rc != 0:
            raise ValueError("a graph needs at least its source and sink")
        self._version += 1
