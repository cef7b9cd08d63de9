"""Entry points of the DP: one backend, the banded kernel B2 and its
backtrack X1w on the Params' device (counterpart of
`abpoa_tpu/align/dispatch.py` `align_sequence_to_graph` and
`align_windows`)."""
from __future__ import annotations

import numpy as np

from .. import constants as C
from ..graph import POAGraph
from ..params import Params
from .banded import align_windows_banded
from .result import AlignResult


def align_windows(g: POAGraph, abpt: Params, windows) -> list:
    """Align independent subgraph windows [(beg_id, end_id, query), ...]:
    one AlignResult a window, in window order (dispatch.py:245). Every
    window, a single one included, goes through B2's batched launch."""
    if not windows:
        return []
    if g.node_n <= 2:  # empty graph: nothing to align to
        return [AlignResult() for _ in windows]
    if not g.is_topological_sorted:
        g.topological_sort(abpt)
    return align_windows_banded(g, abpt, windows)


def align_sequence_to_graph(g: POAGraph, abpt: Params, query: np.ndarray) -> AlignResult:
    return align_windows(g, abpt, [(C.SRC_NODE_ID, C.SINK_NODE_ID, query)])[0]
