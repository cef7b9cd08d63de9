"""Kernels S1 (`edge_sort`, and `finish_fusion_` in place below a node_n
with the span update) and K1 (`topo_sort`) against their plain PyTorch
versions on the card, on the graphs made to hit their traps: the tie-heavy
slot rows of `chip_smoke.tie_graph` (E = 8, 16, 32; rows with counts past
the node_n given) and the adversarial graphs of `chip_smoke.k1_graph`, K1
in both degree variants.
test_torch_edge_sort.py holds the plain versions against the JAX package on
the same graphs; this file imports no JAX, so the card machine, which has
none, collects it. Every comparison is exact.

    pytest -m cuda tests/test_torch_sort_twins.py    # on the card
"""
import numpy as np
import pytest
import torch

import chip_smoke
from abpoa_tpu_torch.align.edge_sort_kernel import (edge_sort,
                                                    edge_sort_torch,
                                                    finish_fusion_,
                                                    finish_fusion_torch_)
from abpoa_tpu_torch.align.topo_kernel import topo_sort, topo_sort_torch

TIE_E = (8, 16, 32)


def tensors(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card_equal(got, want):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("E", TIE_E)
def test_edge_sort_kernel_matches_plain_on_card(E):
    dev = _card()
    args = tensors(chip_smoke.tie_graph(E))
    _on_card_equal(edge_sort(*[t.to(dev) for t in args]),
                   edge_sort_torch(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("E", TIE_E)
def test_finish_fusion_kernel_matches_plain_on_card(E):
    dev = _card()
    args = tensors(chip_smoke.tie_graph(E))
    n_span = torch.arange(args[0].shape[0], dtype=torch.int32)
    node_n = torch.tensor([50], dtype=torch.int32)  # counts past it
    gpu = [t.to(dev) for t in args + [node_n, n_span]]
    finish_fusion_(*gpu)
    finish_fusion_torch_(*args, node_n, n_span)
    _on_card_equal(gpu[:4] + gpu[7:], args[:4] + [n_span])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", chip_smoke.K1_GRAPHS)
@pytest.mark.parametrize("variant", ["s8", "g32"])
def test_topo_sort_kernel_matches_plain_on_card(kind, variant):
    dev = _card()
    args = tensors(chip_smoke.k1_graph(kind))
    _on_card_equal(topo_sort(*[t.to(dev) for t in args], variant=variant),
                   topo_sort_torch(*args))
