"""The device lockstep on the CPU against JAX's `progressive_poa_fused_batch`
and the port set by set (`test_torch_fused_batch.check_sets`), in the
configurations that change the loop's path:
- forced growth from caps (192, 8, 8, 128): the stack grows while lanes are
  mid-set; the lanes that committed keep their state and the erring lane
  runs its read again;
- `-s` on sets with reads of both strands: the reverse-strand lanes align
  in one more B1 and X1 launch over those lanes, one more sync a round;
- `-m 2 -z 100` (extend with Z-drop) and local mode (B3);
- B1 and X1 over groups of lanes where the lanes' planes do not fit on the
  card (`plane_groups`), against the set-by-set loop.
"""
import pytest
import torch

from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp_lanes

from test_torch_fused_batch import check_sets, file_set, params, sim_set

torch.set_num_threads(1)


def test_forced_growth_mid_set():
    tp, jp = params()
    sets = [sim_set(tp, 20 + i, n, err=0.15) for i, n in enumerate((5, 3, 4))]
    tfl.reset_stats()
    check_sets(sets, tp, jp, init_caps=(192, 8, 8, 128))
    grown = tfl.stats["grow"]
    assert grown.get(tfl.ERR_NODE_CAP, 0) > 0, grown
    assert tfl.stats["caps"]["N"] > 192


def test_reverse_strand_lanes():
    tp, jp = params(amb_strand=True)
    sets = [sim_set(tp, 5, 6, rc=(1, 4)), file_set(tp, "seq.fa"),
            sim_set(tp, 6, 4, rc=(2,))]
    tfl.reset_stats()
    got = check_sets(sets, tp, jp)
    assert got[0][1] == [False, True, False, False, True, False]
    assert got[2][1] == [False, False, True, False]
    s = tfl.stats
    assert s["rc_rounds"] > 0
    assert s["syncs"] == 2 * s["rounds"] + s["kahn_rounds"]


@pytest.mark.parametrize("kw", [dict(align_mode=2, zdrop=100),
                                dict(align_mode=1)],
                         ids=["extend-z100", "local"])
def test_modes(kw):
    tp, jp = params(**kw)
    sets = [file_set(tp, "seq.fa"), file_set(tp, "seq4.fa"),
            sim_set(tp, 7, 5)]
    b1 = (fused_dp_lanes.launches, fused_dp_lanes.local_launches)
    tfl.reset_stats()
    check_sets(sets, tp, jp)
    # the CPU runs the plain versions: the launch counters stay
    assert (fused_dp_lanes.launches, fused_dp_lanes.local_launches) == b1


@pytest.mark.parametrize("budget, want", [
    (None, [[0, 1, 2, 3, 4]]),
    (10 ** 9, [[0, 1, 2, 3, 4]]),
    (250, [[0, 1], [2, 3], [4]]),
    (10, [[0], [1], [2], [3], [4]])], ids=["cpu", "fits", "two", "none"])
def test_plane_groups(budget, want):
    """Lanes a B1 + X1 pass within the budget, at 100 bytes a lane."""
    from abpoa_tpu_torch.align.fused_lanes import plane_groups
    assert plane_groups([0, 1, 2, 3, 4], 100, budget) == want


@pytest.mark.parametrize("per_pass, kw", [
    (1, {}), (2, dict(amb_strand=True)), (2, dict(align_mode=1))],
    ids=["one-lane", "two-lanes-s", "two-lanes-local"])
def test_lanes_in_groups_of_what_fits(per_pass, kw, monkeypatch):
    """Where the lanes' planes do not fit on the card, B1 and X1 run over
    groups of lanes that do (here `per_pass` lanes a group): the outputs
    equal the set-by-set loop's, and the extra passes are counted."""
    from abpoa_tpu_torch.align import fused_lanes as fla
    real = fla.plane_groups
    monkeypatch.setattr(fla, "plane_groups", lambda todo, lane_bytes, budget:
                        real(todo, lane_bytes, per_pass * lane_bytes))
    tp, jp = params(**kw)
    sets = [sim_set(tp, 30, 5, rc=(2,)), file_set(tp, "seq4.fa"),
            sim_set(tp, 31, 6, rc=(1, 4)), sim_set(tp, 32, 3)]
    tfl.reset_stats()
    check_sets(sets, tp, jp, jax=False)
    assert tfl.stats["plane_splits"] > 0 and tfl.stats["rounds"] > 0
