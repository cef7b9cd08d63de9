"""The device lockstep (`fused_lanes.progressive_poa_fused_batch`, K read
sets through the fused loop at once) on the CPU, every kernel through its
plain version, against the JAX package's `progressive_poa_fused_batch` (the
vmapped fused loop, XLA on the CPU) and against the port's own
`progressive_poa_fused` set by set: every graph array (through
`convert.graph_to_numpy`), node_n and the strand flags, exactly.
- K = 1, 3 and 8 sets of uneven read counts, one round a read of the
  longest set, every live lane in each round;
- a diverged backtrack raises, as in the single-set loop.
Forced growth and the flag sets `-s`, `-m 2 -z 100` and local mode are in
test_torch_fused_batch_modes.py; read ids, forced collisions, the lane
steps against their single-set functions and the CLI in
test_torch_fused_batch_lanes.py (JAX compiles a vmapped loop for each
configuration, ~15-25 s on the CPU, so each file holds a few).
"""
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

import abpoa_tpu.align.fused_loop as jfl
from abpoa_tpu.params import Params as JaxParams
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.fused_lanes import progressive_poa_fused_batch
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.params import Params

# the suite runs several test processes at once: one torch thread each
torch.set_num_threads(1)


def params(**kw):
    """(port Params on the CPU, JAX Params on its XLA loop) with kw set."""
    tp = Params(device="cpu")
    jp = JaxParams()
    jp.device = "jax"
    for k, v in kw.items():
        setattr(tp, k, v)
        setattr(jp, k, v)
    return tp.finalize(), jp.finalize()


def encode(abpt, seqs):
    out = [abpt.char_to_code[np.frombuffer(s.encode(), dtype=np.uint8)]
           .astype(np.uint8) for s in seqs]
    return out, [np.ones(len(s), dtype=np.int64) for s in out]


def file_set(abpt, fa):
    return encode(abpt, [r.seq for r in read_fastx(os.path.join(DATA_DIR, fa))])


def sim_set(abpt, seed, n, length=150, err=0.1, rc=()):
    """n reads of one random reference at `err` substitutions, the reads
    of `rc` reverse-complemented."""
    r = np.random.default_rng(seed)
    ref = r.integers(0, 4, length)
    reads = ["".join("ACGT"[(b + r.integers(1, 4)) % 4]
                     if r.random() < err else "ACGT"[b] for b in ref)
             for _ in range(n)]
    comp = str.maketrans("ACGT", "TGCA")
    reads = [s.translate(comp)[::-1] if i in rc else s
             for i, s in enumerate(reads)]
    return encode(abpt, reads)


def assert_same_graph(a, b, what):
    a, b = convert.graph_to_numpy(a), convert.graph_to_numpy(b)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def check_sets(sets, tp, jp, init_caps=None, jax=True):
    """The device lockstep over `sets` == JAX's batch (where it returns a
    graph) == the port set by set. Returns the lockstep's outputs."""
    seqs = [s for s, _ in sets]
    wts = [w for _, w in sets]
    got = progressive_poa_fused_batch(seqs, wts, tp, init_caps=init_caps)
    assert len(got) == len(sets)
    stats = dict(tfl.stats)
    want = (jfl.progressive_poa_fused_batch(seqs, wts, jp, use_pallas=False,
                                            _initial_caps=init_caps)
            if jax else [None] * len(sets))
    for i, ((pg, rc), (s, w)) in enumerate(zip(got, sets)):
        solo, _, solo_rc = tfl.progressive_poa_fused(s, w, tp,
                                                     init_caps=init_caps)
        assert_same_graph(pg, solo, f"set {i} vs set by set")
        assert rc == solo_rc, i
        assert pg.node_n == solo.node_n
        if want[i] is not None:
            assert_same_graph(pg, want[i][0], f"set {i} vs JAX")
            assert rc == list(want[i][1]), i
    tfl.stats.update(stats)
    return got


def test_one_set_is_the_single_set_loop():
    tp, jp = params()
    tfl.reset_stats()
    check_sets([file_set(tp, "seq.fa")], tp, jp)


def test_three_sets_one_b1_launch_a_round():
    """Three sets of 10, 4 and 6 reads: rounds = the longest set's reads
    less its seed round, B1 once a round with every live lane in it."""
    tp, jp = params()
    sets = [file_set(tp, "seq.fa"), file_set(tp, "seq4.fa"),
            sim_set(tp, 3, 6)]
    tfl.reset_stats()
    check_sets(sets, tp, jp)
    assert tfl.stats["rounds"] == max(len(s) for s, _ in sets) - 1
    assert tfl.stats["live_lanes"] == sum(len(s) - 1 for s, _ in sets)
    assert tfl.stats["syncs"] == tfl.stats["rounds"] + tfl.stats["kahn_rounds"]


def test_eight_sets_of_uneven_counts():
    tp, jp = params()
    sets = [sim_set(tp, 10 + i, n) for i, n in
            enumerate((2, 9, 3, 7, 4, 6, 5, 8))]
    tfl.reset_stats()
    check_sets(sets, tp, jp)
    assert tfl.stats["rounds"] == 8


def test_lockstep_raises_where_the_single_set_loop_raises(monkeypatch):
    """A diverged backtrack raises; no lane falls back."""
    tp, _ = params()
    sets = [file_set(tp, "seq.fa"), file_set(tp, "seq4.fa")]
    from abpoa_tpu_torch.align import fused_lanes

    real = fused_lanes._align_strand_l

    def diverged(*a, **k):
        out = list(real(*a, **k))
        out[5] = torch.ones_like(out[5])
        return tuple(out)

    monkeypatch.setattr(fused_lanes, "_align_strand_l", diverged)
    with pytest.raises(RuntimeError, match="backtrack found no path"):
        progressive_poa_fused_batch([s for s, _ in sets],
                                        [w for _, w in sets], tp)
