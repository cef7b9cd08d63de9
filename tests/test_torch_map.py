"""The map route (`abpoa_tpu_torch/parallel/map_driver.py`) on the CPU: K
reads against one restored graph in one K-lane launch of B2's and X1w's
plain versions a round, GAF text byte-identical to the JAX package's
`map_reads_split`, twins of tests/test_map.py's parity grid: gap regime x
K in {1, 4, 8} x amb-strand (half the reads reverse-complemented, some
mapped to the minus strand), over reads of divergent lengths. The other
map cases are in test_torch_map_cli.py.
"""
import io

import numpy as np
import pytest
import torch

from make_sim import simulate

from abpoa_tpu_torch.align import dp_chunk
from abpoa_tpu_torch.io.gaf import gaf_record
from abpoa_tpu_torch.parallel import map_driver
from abpoa_tpu_torch.params import Params

torch.set_num_threads(1)

REF_LEN = 120
GRAPH_READS = 6
MAP_READS = 8
GAPS = {"linear": dict(gap_open1=0, gap_open2=0),
        "affine": dict(gap_open1=4, gap_ext1=2, gap_open2=0, gap_ext2=0),
        "convex": dict(gap_open1=4, gap_ext1=2, gap_open2=24, gap_ext2=1)}

_RC = str.maketrans("ACGT", "TGCA")


def revcomp(seq: str) -> str:
    return seq.translate(_RC)[::-1]


def port_params(gap="convex", amb=False, **kw):
    abpt = Params(device="cpu", amb_strand=amb, **GAPS[gap], **kw)
    return abpt.finalize()


def jax_params(device, gap="convex", amb=False):
    from abpoa_tpu.params import Params as JP
    abpt = JP()
    abpt.device = device
    for k, v in GAPS[gap].items():
        setattr(abpt, k, v)
    abpt.amb_strand = 1 if amb else 0
    return abpt.finalize()


@pytest.fixture(scope="module")
def sim_graph(tmp_path_factory):
    """tests/test_map.py's fixture: one simulated set split into a GFA
    graph (its first reads, through the JAX package) and a map stream of
    the same reference, every other read cut to 60 %."""
    from abpoa_tpu.io.fastx import read_fastx
    from abpoa_tpu.params import Params as JP
    from abpoa_tpu.pipeline import Abpoa, msa
    tmp = tmp_path_factory.mktemp("map")
    sim = str(tmp / "sim.fa")
    simulate(REF_LEN, GRAPH_READS + MAP_READS, 0.1, 1805, sim)
    recs = read_fastx(sim)
    abpt = JP()
    abpt.device = "numpy"
    abpt.out_cons, abpt.out_gfa = False, True
    abpt = abpt.finalize()
    buf = io.StringIO()
    msa(Abpoa(), abpt, recs[:GRAPH_READS], buf)
    gfa = str(tmp / "graph.gfa")
    with open(gfa, "w") as fp:
        fp.write(buf.getvalue())
    reads = []
    for i, r in enumerate(recs[GRAPH_READS:]):
        seq = r.seq if i % 2 == 0 else r.seq[:int(len(r.seq) * 0.6)]
        reads.append((r.name, seq))
    return gfa, reads


def encode(abpt, seq: str) -> np.ndarray:
    return abpt.char_to_code[np.frombuffer(seq.encode(), dtype=np.uint8)
                             ].astype(np.uint8)


def port_gaf(gfa, reads, abpt, k_cap) -> str:
    _ab, static = map_driver.load_static_graph(gfa, abpt)
    queries = [encode(abpt, s) for _, s in reads]
    out = map_driver.map_reads_split(static, queries, abpt, k_cap=k_cap)
    return "".join(gaf_record(n, q, res[0], static.base_by_nid,
                              strand=res[1]) + "\n"
                   for (n, _), q, res in zip(reads, queries, out))


def jax_gaf(gfa, reads, abpt, k_cap) -> str:
    from abpoa_tpu.io.gaf import gaf_record as jax_record
    from abpoa_tpu.parallel.map_driver import (load_static_graph,
                                               map_reads_split)
    _ab, static = load_static_graph(gfa, abpt)
    queries = [encode(abpt, s) for _, s in reads]
    out = map_reads_split(static, queries, abpt, k_cap=k_cap)
    return "".join(jax_record(n, q, res[0], static.base_by_nid,
                              strand=res[1]) + "\n"
                   for (n, _), q, res in zip(reads, queries, out))


@pytest.mark.parametrize("k_cap", [1, 4, 8])
@pytest.mark.parametrize("gap", list(GAPS))
@pytest.mark.parametrize("amb", [False, True])
def test_map_parity_grid(sim_graph, gap, k_cap, amb):
    gfa, reads = sim_graph
    if amb:
        reads = [(n, s if i % 2 == 0 else revcomp(s))
                 for i, (n, s) in enumerate(reads)]
    rounds = map_driver.stats["rounds"]
    builds = dp_chunk.stats["static_builds"]
    got = port_gaf(gfa, reads, port_params(gap, amb), k_cap)
    assert map_driver.stats["rounds"] - rounds == -(-MAP_READS // k_cap)
    assert dp_chunk.stats["static_builds"] - builds == 1
    assert got == jax_gaf(gfa, reads, jax_params("jax", gap, amb), k_cap)
    if amb:
        assert "\t-\t" in got
