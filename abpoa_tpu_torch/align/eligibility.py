"""Which configurations the fused route covers.

Counterpart of `abpoa_tpu/align/eligibility.py`. The fused route covers
progressive POA in all three align modes (global and extend banded, local
unbanded) and all three gap regimes; `-G` path scores and qv-weighted
multi-consensus stay outside it, and so does incremental `-i` with read-id
outputs (the bitsets of the restored reads cannot be replayed from the
loop's paths). `Params.finalize()` already rejects all of those in this
port, so in practice the test reduces to the read count: a single read is
never aligned, and takes the per-read route.
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
