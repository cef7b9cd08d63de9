"""The port's fused progressive loop, as a whole, against the JAX package's.

The port's `progressive_poa_fused` on the CPU (every kernel through its
plain version) must give the same downloaded graph (compared array by array
through `convert.graph_to_numpy`), the same number of Kahn repairs and of
collision fusions, and the same strand flags as
`abpoa_tpu.align.fused_loop.progressive_poa_fused(use_pallas=False)`: over
the three gap regimes and the three align modes on tests/data/seq.fa, the
`-s` strand rescue, aligned groups (heter.fa), capacity growth with Kahn
repairs (sim2k.fa) and the int16 -> int32 promotion with the limit lowered
to 160, as tests/test_fused_loop.py:70-90 drive the JAX loop; and, with
read-id outputs set on both sides, the same per-edge read-id bitsets, which
each loop rebuilds from the read paths it recorded.
"""
import importlib
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

import abpoa_tpu.align.fused_loop as jfl
from abpoa_tpu.params import Params as JaxParams
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.params import Params

# the suite runs several test processes at once: one torch thread each
# keeps the plain versions from competing with the other workers' timings
torch.set_num_threads(1)

CONFIGS = {
    "seq-convex": ("seq.fa", {}),
    "seq-affine": ("seq.fa", {"gap_open2": 0}),
    "seq-linear": ("seq.fa", {"gap_open1": 0, "gap_open2": 0}),
    "seq-local": ("seq.fa", {"align_mode": 1}),
    "seq-extend": ("seq.fa", {"align_mode": 2}),
    "seq-extend-z50": ("seq.fa", {"align_mode": 2, "zdrop": 50}),
    "rcmix-amb": ("rcmix.fa", {"amb_strand": True}),
    "heter": ("heter.fa", {}),
    "sim2k": ("sim2k.fa", {}),
}


def _reads(fa, abpt):
    recs = read_fastx(os.path.join(DATA_DIR, fa))
    seqs = [abpt.char_to_code[np.frombuffer(r.seq.encode(), dtype=np.uint8)].astype(np.uint8)
            for r in recs]
    return seqs, [np.ones(len(s), dtype=np.int64) for s in seqs]


def run_both(fa, kw):
    """(port graph arrays, port kahn, port collisions, port is_rc,
    jax graph arrays, jax kahn, jax collisions, jax is_rc)."""
    tp = Params(device="cpu")
    jp = JaxParams()
    jp.device = "jax"
    for k, v in kw.items():
        setattr(tp, k, v)
        setattr(jp, k, v)
    tp.finalize()
    jp.finalize()
    seqs, w = _reads(fa, tp)
    pg, kahn, is_rc = tfl.progressive_poa_fused(seqs, w, tp)
    st = tfl.last_state
    jax_report = importlib.import_module("abpoa_tpu.obs.report")
    before = dict(jax_report._REPORT.counters)
    jpg, jkahn, jis_rc = jfl.progressive_poa_fused(seqs, w, jp,
                                                   use_pallas=False)
    after = jax_report._REPORT.counters
    jcoll = after.get("fused.collisions", 0) - before.get("fused.collisions", 0)
    return (convert.graph_to_numpy(pg), kahn, st.collisions, is_rc,
            convert.graph_to_numpy(jpg), jkahn, jcoll, jis_rc)


def assert_same_run(res):
    a, kahn, coll, is_rc, b, jkahn, jcoll, jis_rc = res
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (kahn, coll, is_rc) == (jkahn, jcoll, list(jis_rc))


# with read-id outputs on both sides (MSA, `-r 1`): the downloaded graphs'
# `out_read_ids` come from each loop's recorded paths
READ_ID_CONFIGS = ["seq-convex", "seq-local", "seq-extend", "rcmix-amb",
                   "heter", "sim2k"]


@pytest.mark.parametrize("name", READ_ID_CONFIGS)
def test_fused_loop_read_ids_match_jax(name):
    fa, kw = CONFIGS[name]
    res = run_both(fa, dict(kw, out_msa=True))
    assert_same_run(res)
    assert res[0]["out_read_ids"].any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_loop_matches_jax(name):
    fa, kw = CONFIGS[name]
    res = run_both(fa, kw)
    assert_same_run(res)
    if name == "sim2k":
        assert res[1] > 0  # the Kahn repair ran
    if name == "rcmix-amb":
        assert any(res[3])  # some read was fused reverse-complemented


def test_fused_loop_promotion_matches_jax(monkeypatch):
    """Mid-run int16 -> int32 promotion (ERR_PROMOTE) with the limit lowered
    to 160: seq.fa starts on int16 planes and crosses the bound at ~78
    nodes (tests/test_fused_loop.py:79-90)."""
    monkeypatch.setattr(jfl, "int16_score_limit", lambda abpt: 160)
    monkeypatch.setattr(tfl, "int16_score_limit", lambda abpt: 160)
    tfl.reset_stats()
    res = run_both("seq.fa", {})
    assert_same_run(res)
    assert tfl.stats["promotions"] == 1
    assert tfl.stats["grow"] == {tfl.ERR_PROMOTE: 1}
