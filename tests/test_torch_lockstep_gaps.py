"""The split lockstep driver's parity grid in affine and linear gaps (K = 1,
2, 4; its convex third is in test_torch_lockstep.py) and its amb-strand
rescue: rcmix.fa with `-s` as two lanes, each lane's strand flags and
output equal to the JAX package's split driver, with at least one read
flipped, and to the port's set-by-set route."""
import pytest
import torch

from test_torch_lockstep import (data_sets, grid_case, jax_split,
                                 port_split, set_by_set)
from test_torch_dp_chunk import port_params

torch.set_num_threads(1)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("gap", ["affine", "linear"])
def test_split_lockstep_parity_grid_gaps(gap, k):
    grid_case(gap, k)


def test_split_lockstep_amb_strand_rcmix():
    seq_sets, weight_sets = data_sets(port_params(amb_strand=True),
                                      ("rcmix.fa", "rcmix.fa"))
    want, want_outs = jax_split(seq_sets, weight_sets, amb_strand=1)
    texts, got = port_split(seq_sets, weight_sets, amb_strand=True)
    for (_, is_rc), (_, want_rc) in zip(got, want_outs):
        assert is_rc == want_rc and any(is_rc)
    assert texts == want
    assert texts[0] == set_by_set(seq_sets[0], amb_strand=True)
