"""Memory admission: price a dispatch in the card's memory before it runs.

Counterpart of `abpoa_tpu/resilience/memory.py`, priced on the H100's HBM
and on the tensors the port really allocates, not on the JAX package's
16 GB TPU and its 6-plane model. A fused or lockstep dispatch holds, a set:

- the loop's state (`fused_loop.init_fused_state`): the graph's slot
  arrays, the order, its inverse and max_remain, and the read-id paths;
- B1's outputs: 5 planes of N x W cells, int16 or int32 as the score bound
  of the gap mode allows (`plane_bytes`), beg/end, ok, ext and the
  kernel's row scratch;
- the kernels' tables (`fused_loop._build_tables`);
- the read batch (`fused_loop._pad_read_set`: reads, weights, the query
  profile) and the scoring matrix.

A dispatch over the budget is chunked into fewer sets or, where even one
set does not fit, sent to the per-read route on the same device, whose
planes are B2's of one read at a time (`per_read_bytes`). On the card a
set that fits neither route stops the run before any allocation
(`pipeline._run_fused_device`), instead of letting the allocator find out
mid-run; nothing goes to the host.

Budget: ``ABPOA_TPU_MEM_BUDGET_MB`` when set (0 turns admission off);
otherwise 90 % of the card's free memory (`torch.cuda.mem_get_info`) on
cuda, and None (no admission) on the CPU and the host rungs. The device
lockstep's plane groups (`fused_lanes.plane_groups`) take their lane bytes
and their budget from this module too, so both use one formula.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

# B1 allocates H, E1, E2, F1 and F2 in every gap mode (fused_dp_kernel.py)
N_PLANES = 5
FREE_SHARE = 0.9


def plane_bytes(R: int, W: int, plane16: bool) -> int:
    """One lane's DP planes: R rows of W cells, five planes."""
    return N_PLANES * R * W * (2 if plane16 else 4)


def dp_bytes(R: int, W: int, plane16: bool, lanes: int = 1) -> int:
    """B1's outputs over `lanes` lanes of R rows: the planes, beg/end, ok,
    ext, and the row scratch the kernel takes on the card."""
    return lanes * (plane_bytes(R, W, plane16) + 2 * R * 4 + 4 + 4 * 4
                    + 2 * R * 4)


def state_bytes(N: int, E: int, A: int, n_reads: int = 0,
                Pcap: int = 0) -> int:
    """`fused_loop.init_fused_state(N, E, A, ..., n_reads, Pcap)`: the
    graph (six node vectors, four N x E slot arrays, N x A aligned ids,
    node_n and ok), order, n2i and remain, and the read-id paths."""
    graph = 4 * (6 * N + 4 * N * E + N * A) + 4 + 1
    paths = 4 * n_reads * (Pcap + 1) if n_reads else 0
    return graph + 3 * 4 * N + paths


def table_bytes(N: int, E: int) -> int:
    """`fused_loop._build_tables`: packed bases, predecessor and successor
    rows with their counts, remain by row."""
    return 4 * (4 * N + 2 * N * E)


def read_bytes(R: int, Qp: int, m: int) -> int:
    """`fused_loop._pad_read_set` over R reads and the scoring matrix:
    reads and weights (R x Qp int32) and the query profile (R x m x Qp)."""
    return 4 * R * Qp * (2 + m) + 4 * m * m


def estimate_bytes(caps: dict) -> int:
    """Device bytes of one fused or lockstep dispatch, from its shapes
    (`fused_loop.plan_dispatch_footprint`)."""
    N, E, A = caps["N"], caps["E"], caps["A"]
    W, Qp, R = caps["W"], caps["Qp"], caps["reads"]
    K, m = caps.get("K", 1), caps.get("m", 5)
    n_paths = R if caps.get("paths") else 0
    per_set = (state_bytes(N, E, A, n_paths, Qp + 2)
               + dp_bytes(N, W, bool(caps.get("plane16")))
               + table_bytes(N, E) + read_bytes(R, Qp, m))
    return K * per_set


def per_set_bytes(caps: dict) -> int:
    return estimate_bytes(dict(caps, K=1))


def per_read_bytes(caps: dict) -> int:
    """Device bytes of the per-read route over one set of `caps`: B2's
    planes (five int32 planes, `banded.walk_inputs`) of one read at the
    set's starting node capacity and B2's first band (`W2`), its row
    tables, and the read. B2's planes are int32 and its band is about
    twice B1's, so this is above `estimate_bytes` at most shapes: the
    per-read route rarely serves a set that B1 cannot."""
    N, E, W2, Qp = caps["N"], caps["E"], caps["W2"], caps["Qp"]
    return (plane_bytes(N, W2, False) + 4 * N * 4 + table_bytes(N, E)
            + read_bytes(1, Qp, caps.get("m", 5)))


def device_budget(dev, need: int, share: int = 1) -> int:
    """90 % of `dev`'s free memory over `share` users; where `need` does
    not fit, the allocator's cached blocks go back to the driver first and
    the free memory is read again (a small tensor carved from a cached
    block would pin it)."""
    import torch
    from . import check_card
    check_card(dev.type)  # a lost card is not asked for its free memory
    free = torch.cuda.mem_get_info(dev)[0]
    if need * share > FREE_SHARE * free:
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
    return int(FREE_SHARE * free) // share


def plane_budget(dev, need: int, share: int = 1) -> Optional[int]:
    """The bytes B1's planes may take in one pass that needs `need` (the
    device lockstep's `plane_groups`): None (no limit) off the card and
    where `need` fits; else `device_budget`. The `share` groups of a
    sharded run placed on `dev` divide its free memory."""
    if dev.type != "cuda":
        return None
    budget = device_budget(dev, need, share)
    return None if need <= budget else budget


def budget_bytes(dev=None, need: int = 0) -> Optional[int]:
    """The admission budget; None = admission off."""
    env = os.environ.get("ABPOA_TPU_MEM_BUDGET_MB")
    if env is not None:
        mb = float(env)
        return int(mb * 1e6) if mb > 0 else None
    if dev is None or dev.type != "cuda":
        return None
    return device_budget(dev, need)


def admit(caps: dict, dev=None) -> Tuple[str, int, Optional[int]]:
    """-> (decision, estimated bytes, budget bytes):

    "ok"     fits (or admission is off)
    "chunk"  the K-set group is over the budget but one set fits:
             dispatch in smaller groups (`max_sets_within`)
    "demote" one set is over the budget: it takes the per-read route
    """
    from ..obs import count, metrics
    est = estimate_bytes(caps)
    budget = budget_bytes(dev, est)
    reg = metrics.registry()
    reg.gauge("abpoa_admission_last_estimate_bytes",
              "Device-byte estimate of the most recent admission "
              "decision").set(est)
    if budget is not None:
        reg.gauge("abpoa_admission_budget_bytes",
                  "Device-memory admission budget").set(budget)
    if budget is None or est <= budget:
        return "ok", est, budget
    count("admission.over_budget")
    if caps.get("K", 1) > 1 and per_set_bytes(caps) <= budget:
        count("admission.chunk")
        return "chunk", est, budget
    count("admission.demote")
    return "demote", est, budget


def max_sets_within(caps: dict, dev=None) -> int:
    """The largest number of sets whose estimate fits the budget (>= 1;
    the port pads no set, so K sets cost K times one)."""
    k_req = max(1, caps.get("K", 1))
    budget = budget_bytes(dev, estimate_bytes(caps))
    if budget is None:
        return k_req
    return max(1, min(k_req, budget // max(1, per_set_bytes(caps))))


def admission_plan(abpt, entries, seqs_of) -> List[Tuple[list, str]]:
    """A same-bucket lockstep group cut into admissible pieces: [(piece,
    action)] in input order, action "dispatch" (on the device) or "demote"
    (every set of it to the host path: not even one set fits, and fewer
    sets cannot help, since the planes scale with the set, not with K).
    `seqs_of(entry)` gives an entry's encoded reads. Where everything fits
    this is one estimate and one piece."""
    from ..align.fused_loop import plan_dispatch_footprint
    dev = abpt.torch_device
    caps = plan_dispatch_footprint(abpt, [seqs_of(e) for e in entries])
    decision, est, budget = admit(caps, dev)
    if decision == "ok":
        return [(list(entries), "dispatch")]
    if decision == "demote":
        return [(list(entries), "demote")]
    k_fit = max_sets_within(caps, dev)
    return [(list(entries[i:i + k_fit]), "dispatch")
            for i in range(0, len(entries), k_fit)]
