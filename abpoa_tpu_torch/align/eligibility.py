"""Which configurations the fused route covers.

Counterpart of `abpoa_tpu/align/eligibility.py`. The fused route covers
progressive POA in all three align modes (global and extend banded, local
unbanded) and all three gap regimes, from the empty graph or from the graph
`-i` restored. Outside it stay `-G` path scores, `-b < 0` in global and
extend mode, qv-weighted multi-consensus (`-Q` with `-d > 1`) and
incremental `-i` with read-id outputs (the bitsets of the restored reads
cannot be replayed from the loop's paths): those take the per-read route
(`pipeline.poa`, kernels B2 and X1w), as the JAX package sends them to its
host engine. A single read is never aligned by the loop, and takes the
per-read route too.
"""
from __future__ import annotations

from .. import constants as C
from ..params import Params


def fused_config_eligible(abpt: Params) -> bool:
    return ((abpt.align_mode == C.LOCAL_MODE
             or (abpt.align_mode in (C.GLOBAL_MODE, C.EXTEND_MODE)
                 and abpt.wb >= 0))
            and not abpt.inc_path_score
            and not (abpt.use_qv and abpt.max_n_cons > 1))


def fused_eligible(abpt: Params, n_seq: int) -> bool:
    return (fused_config_eligible(abpt)
            and not (abpt.incr_fn and abpt.use_read_ids)
            and n_seq >= 2)
