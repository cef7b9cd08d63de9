"""Entry point of the DP: one backend, the banded kernel on the Params' device
(counterpart of `abpoa_tpu/align/dispatch.py` `align_sequence_to_graph`)."""
from __future__ import annotations

import numpy as np

from .. import constants as C
from ..graph import POAGraph
from ..params import Params
from .banded import align_sequence_to_subgraph
from .result import AlignResult


def align_sequence_to_graph(g: POAGraph, abpt: Params, query: np.ndarray) -> AlignResult:
    if g.node_n <= 2:  # empty graph: nothing to align to
        return AlignResult()
    if not g.is_topological_sorted:
        g.topological_sort(abpt)
    return align_sequence_to_subgraph(g, abpt, C.SRC_NODE_ID, C.SINK_NODE_ID, query)
