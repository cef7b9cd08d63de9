"""Entry points of the DP: one backend, the banded kernel B2 and its
backtrack X1w on the Params' device (counterpart of
`abpoa_tpu/align/dispatch.py` `align_sequence_to_graph` and
`align_windows`)."""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..graph import POAGraph
from ..params import Params
from .banded import align_windows_banded
from .result import AlignResult


def window_mesh(abpt: Params, n_windows: int):
    """The mesh one read's windows split over (`jax_backend.py:532`
    `_window_mesh_size`): the first n attached cards, n the largest power
    of two <= min(cards, windows); None (no split) on the CPU, on one card
    or for one window."""
    if abpt.torch_device.type != "cuda":
        return None
    n_avail, n = torch.cuda.device_count(), 1
    while n * 2 <= min(n_avail, n_windows):
        n *= 2
    if n < 2:
        return None
    from ..parallel.shard import discover_mesh
    return discover_mesh(n, "cuda")


def align_windows(g: POAGraph, abpt: Params, windows, mesh=None) -> list:
    """Align independent subgraph windows [(beg_id, end_id, query), ...]:
    one AlignResult a window, in window order (dispatch.py:245). Every
    window, a single one included, goes through B2's batched launch, split
    over `mesh` (default `window_mesh`: every attached card where there are
    two or more, as JAX shards a read's windows with no flag)."""
    if not windows:
        return []
    if g.node_n <= 2:  # empty graph: nothing to align to
        return [AlignResult() for _ in windows]
    if not g.is_topological_sorted:
        g.topological_sort(abpt)
    if mesh is None:
        mesh = window_mesh(abpt, len(windows))
    return align_windows_banded(g, abpt, windows, mesh=mesh)


def align_sequence_to_graph(g: POAGraph, abpt: Params, query: np.ndarray) -> AlignResult:
    return align_windows(g, abpt, [(C.SRC_NODE_ID, C.SINK_NODE_ID, query)])[0]
