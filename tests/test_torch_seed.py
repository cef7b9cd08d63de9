"""The port's seeding layer (`abpoa_tpu_torch/seed.py`) against the JAX
package's (`abpoa_tpu/seed.py`), function by function, tolerance 0 (every
output is an integer list).

Inputs: tests/data/rcmix.fa, sim2k.fa and aa.fa, and reads made here with
numpy from a seed (a reference, reads of it with 3 % substitutions and
deletions; for `-s` every other one reverse-complemented), with one strand
(`-S`) and both (`-s -S`), and amino-acid reads (`-c`, where k and w become
7 and 4).
Functions: `mm_sketch`, `collect_mm`, `build_guide_tree`,
`collect_anchors`, `dp_chaining` (with its second-level chaining) and
`build_guide_tree_partition`.
"""
import os

import numpy as np
import pytest

from conftest import DATA_DIR

from abpoa_tpu import seed as jseed
from abpoa_tpu.params import Params as JaxParams
from abpoa_tpu_torch import seed as tseed
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.params import Params

# Every test here is exact: tolerance 0.


def _random_reads(aa: bool, rc: bool = False, n: int = 8, length: int = 1500,
                  seed: int = 5):
    """Reads of one random reference as code arrays: 3 % errors, and with
    `rc` every other read reverse-complemented."""
    rng = np.random.default_rng(seed)
    sigma = 20 if aa else 4
    ref = rng.integers(0, sigma, length)
    reads = []
    for i in range(n):
        x = rng.random(length)
        sub = np.where(x < 0.015, (ref + rng.integers(1, sigma, length)) % sigma, ref)
        keep = x >= 0.025  # 1 % deletions
        r = sub[keep]
        if rc and i % 2:
            r = 3 - r[::-1]
        reads.append(r.astype(np.uint8))
    return reads


def _fixture(name: str, aa: bool):
    abpt = Params(device="cpu", m=27 if aa else 5)
    recs = read_fastx(os.path.join(DATA_DIR, name))
    enc = abpt.char_to_code
    return [enc[np.frombuffer(r.seq.encode(), dtype=np.uint8)].astype(np.uint8)
            for r in recs]


def _params(both: bool, aa: bool, min_w: int = 200):
    """The port's and the JAX package's Params for -S [-s] [-c] -n min_w."""
    out = []
    for cls in (Params, JaxParams):
        p = cls(disable_seeding=False, progressive_poa=True, amb_strand=both,
                m=27 if aa else 5, min_w=min_w)
        if cls is Params:
            p.device = "cpu"
        out.append(p.finalize())
    return out


CASES = {
    "rcmix -s": (lambda: _fixture("rcmix.fa", False), True, False),
    "sim2k": (lambda: _fixture("sim2k.fa", False)[:8], False, False),
    "random": (lambda: _random_reads(False), False, False),
    "random -s": (lambda: _random_reads(False, rc=True), True, False),
    "aa -c": (lambda: _random_reads(True), False, True),
    "aa.fa -c": (lambda: _fixture("aa.fa", True), False, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sketch_and_collect_equal_jax(name):
    make, both, aa = CASES[name]
    seqs = make()
    tp, jp = _params(both, aa)
    assert (tp.k, tp.w) == (jp.k, jp.w) == ((7, 4) if aa else (19, 10))
    for rid, s in enumerate(seqs[:3]):
        got, want = [], []
        tseed.mm_sketch(s, tp.w, tp.k, rid, both, got, aa=aa)
        jseed.mm_sketch(s, jp.w, jp.k, rid, both, want, aa=aa)
        assert got == want and got
    assert tseed.collect_mm(seqs, tp) == jseed.collect_mm(seqs, jp)


@pytest.mark.parametrize("name", list(CASES))
def test_guide_tree_equals_jax(name):
    make, both, aa = CASES[name]
    seqs = make()
    tp, jp = _params(both, aa)
    mm, _ = tseed.collect_mm(seqs, tp)
    order = tseed.build_guide_tree(tp, len(seqs), mm)
    assert order == jseed.build_guide_tree(jp, len(seqs), mm)
    assert sorted(order) == list(range(len(seqs)))


@pytest.mark.parametrize("name", list(CASES))
def test_anchors_and_chaining_equal_jax(name):
    """collect_anchors and dp_chaining of each consecutive pair; the random
    reads chain, so the second-level chaining runs."""
    make, both, aa = CASES[name]
    seqs = make()
    tp, jp = _params(both, aa, min_w=50)
    mm, mm_c = tseed.collect_mm(seqs, tp)
    chained = 0
    for tid in range(len(seqs) - 1):
        qid = tid + 1
        t_sorted = sorted(mm[mm_c[tid]: mm_c[tid + 1]], key=lambda t: t[0])
        got = tseed.collect_anchors(mm, mm_c, tid, qid, len(seqs[qid]), tp.k,
                                    t_sorted, {})
        want = jseed.collect_anchors(mm, mm_c, tid, qid, len(seqs[qid]), jp.k,
                                     t_sorted, {})
        assert got == want
        par_t, par_j = [], []
        tseed.dp_chaining(got, tp, len(seqs[tid]), len(seqs[qid]), par_t)
        jseed.dp_chaining(want, jp, len(seqs[tid]), len(seqs[qid]), par_j)
        assert par_t == par_j
        chained += len(par_t)
    if name.startswith("random"):
        assert chained > 0


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("progressive", [False, True])
def test_partition_equals_jax(name, progressive):
    make, both, aa = CASES[name]
    seqs = make()
    tp, jp = _params(both, aa, min_w=100)
    tp.progressive_poa = jp.progressive_poa = progressive
    got = tseed.build_guide_tree_partition(seqs, tp)
    assert got == jseed.build_guide_tree_partition(seqs, jp)
    read_id_map, _, par_c = got
    assert sorted(read_id_map) == list(range(len(seqs)))
    assert len(par_c) == len(seqs)
