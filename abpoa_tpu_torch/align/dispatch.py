"""Entry points of the per-read DP: the backend the run asked for, or the one
the circuit breaker demoted it to, under the resilience envelope
(counterpart of `abpoa_tpu/align/dispatch.py` `_resolve` :101,
`_host_rerun` :168, `_dispatch_resilient` :191 and `align_windows`
:245-300).

The backends (`resilience/breaker.py`'s ladder is `cpu -> native ->
plain`; `cuda` is never demoted):

- `cuda`: kernel B2 (or B2u) batched over the windows and their backtrack
  X1w on the card (`banded.align_windows_banded`);
- `cpu`: the same launches on B2's and X1w's plain versions;
- `native`: the C++ host DP, window by window (`native_backend`), on the
  native graph; a Python graph (`-G`, Z-drop) goes to `plain`;
- `plain`: B2's and X1w's plain versions on CPU tensors, the floor: never
  guarded, never demoted.

A device dispatch runs under `guarded_device_call`; every result passes
the garbage injector and the output guards. On `cpu` a failed dispatch or
a result that breaks a guard is aligned once more on the host (`native`,
then `plain`), with a `faults` record and a stderr line. On `cuda` this is
the card's last rung: once the envelope's retry is used up, or where a
result breaks a guard, the run raises `resilience.CardFailure` (rc 1)
instead of moving the window to the host.
"""
from __future__ import annotations

import copy
import threading

import numpy as np
import torch

from .. import constants as C
from ..graph import POAGraph
from ..params import Params
from .banded import align_windows_banded
from .result import AlignResult


class _Resolved(threading.local):
    """The backend this thread's last resolution or host rerun selected,
    and why it differs from the requested one ("breaker_open",
    "host_rerun"); the per-read records are labelled with it. One a thread:
    a server's requests resolve on their own threads. Reset by
    obs.start_run."""
    name = ""
    reason = None


_LAST_RESOLVED = _Resolved()


def reset_resolved() -> None:
    _LAST_RESOLVED.name = ""
    _LAST_RESOLVED.reason = None


def requested_backend(abpt: Params) -> str:
    """The breaker's name of the run's backend: native, cuda or cpu."""
    return "native" if abpt.device == "native" else abpt.torch_device.type


def telemetry_backend(abpt: Params) -> tuple:
    """(backend, fallback reason) of a per-read record: the Params' device
    and None where the requested backend ran, else the backend that ran
    and why."""
    got = _LAST_RESOLVED.name
    if not got or got == requested_backend(abpt):
        return abpt.device, None
    return got, _LAST_RESOLVED.reason or "rerouted"


def _resolve(abpt: Params) -> str:
    """The backend that serves now: the requested one, or where its
    breaker is open the rung it was demoted to."""
    from ..obs import count
    from ..resilience.breaker import breaker
    name = requested_backend(abpt)
    reason = None
    eff = breaker().effective(name)
    if eff != name:
        count(f"breaker.demoted.{name}")
        name, reason = eff, "breaker_open"
    _LAST_RESOLVED.name = name
    _LAST_RESOLVED.reason = reason
    return name


def host_params(abpt: Params) -> Params:
    """`abpt` on the CPU: the plain versions' run."""
    if abpt.torch_device.type == "cpu":
        return abpt
    p = copy.copy(abpt)
    p.torch_device = torch.device("cpu")
    return p


def _plain(g, abpt: Params, windows) -> list:
    return align_windows_banded(g, host_params(abpt), windows)


def _host_rerun(g, abpt: Params, beg_node_id: int, end_node_id: int,
                query: np.ndarray, exclude: str = "") -> AlignResult:
    """One host rerun of a window after a failed dispatch or a guard
    violation: native where the graph is native and native did not fail,
    else plain."""
    from ..obs import count
    from .native_backend import align_native
    for cand in ("native", "plain"):
        if cand == exclude or (cand == "native"
                               and not getattr(g, "is_native", False)):
            continue
        count(f"dispatch.rerun.{cand}")
        _LAST_RESOLVED.name, _LAST_RESOLVED.reason = cand, "host_rerun"
        if cand == "native":
            return align_native(g, abpt, beg_node_id, end_node_id, query)
        return _plain(g, abpt, [(beg_node_id, end_node_id, query)])[0]
    raise RuntimeError("no host backend available for the rerun")


def _checked(res: AlignResult, g, abpt: Params, window, name: str
             ) -> AlignResult:
    """The garbage injector and the output guards on one result; a
    violation is recorded and counts against the breaker. On `cuda` it
    ends the run (CardFailure); elsewhere the window is aligned again on
    the host."""
    from .. import resilience as rz
    from ..obs import count
    b, e, q = window
    res = rz.inject.corrupt_result(res)
    viol = rz.guards.align_result_violation(res, len(q), g.node_n, abpt)
    if viol is None:
        return res
    count("guard.dp_violation")
    rz.breaker().record_failure(name, "garbage_output")
    if name == "cuda":
        rz.note_abort("garbage_output", name, viol)
        raise rz.CardFailure("garbage_output", f"dp:{name}: a result broke "
                             f"the output guards ({viol})")
    rz.note_absorbed("garbage_output", name, "host_rerun", viol,
                     label=f"dp:{name}")
    return _host_rerun(g, abpt, b, e, q, exclude=name)


def _native_window(g, abpt: Params, window) -> AlignResult:
    """One window on the native rung, guarded (its injector is
    `native_crash`)."""
    from .. import resilience as rz
    from ..obs import count
    from .native_backend import align_native
    b, e, q = window
    if not getattr(g, "is_native", False):
        count("fallback.native_to_plain")
        return _plain(g, abpt, [window])[0]
    if not rz.enabled():
        return align_native(g, abpt, b, e, q)
    try:
        res = rz.guarded_device_call(
            "dp:native", "native", lambda: align_native(g, abpt, b, e, q))
    except rz.DispatchFailed:
        count("fallback.dp_host_rerun")
        return _host_rerun(g, abpt, b, e, q, exclude="native")
    return _checked(res, g, abpt, window, "native")


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


def _device_windows(g, abpt: Params, windows, mesh, name: str) -> list:
    """The windows in one batched launch on the run's device, under the
    envelope, each result guarded; on `cpu` a failed dispatch aligns every
    window again on the host, on `cuda` it raises CardFailure."""
    from .. import resilience as rz
    from ..obs import count
    if mesh is None:
        mesh = window_mesh(abpt, len(windows))
    run = lambda: align_windows_banded(g, abpt, windows, mesh=mesh)  # noqa: E731
    if not rz.enabled():
        return run()
    label = "dp:windows" if len(windows) > 1 else f"dp:{name}"
    try:
        outs = rz.guarded_device_call(label, name, run,
                                      fallback=name != "cuda")
    except rz.DispatchFailed:
        count("fallback.windows_host_rerun" if len(windows) > 1
              else "fallback.dp_host_rerun")
        return [_host_rerun(g, abpt, *w, exclude=name) for w in windows]
    return [_checked(res, g, abpt, w, name) for w, res in zip(windows, outs)]


def align_windows(g: POAGraph, abpt: Params, windows, mesh=None) -> list:
    """Align independent subgraph windows [(beg_id, end_id, query), ...]:
    one AlignResult a window, in window order (dispatch.py:245). On the
    card every window, a single one included, goes through B2's batched
    launch, split over `mesh` (default `window_mesh`: every attached card
    where there are two or more, as JAX shards a read's windows with no
    flag); on the native rung window by window."""
    if not windows:
        return []
    if g.node_n <= 2:  # empty graph: nothing to align to
        return [AlignResult() for _ in windows]
    if not g.is_topological_sorted:
        g.topological_sort(abpt)
    name = _resolve(abpt)
    # the span ends on the launches' host syncs (abpoa_tpu/align/dispatch.py
    # :238, :299); one dispatch count a window
    from ..obs import count, trace
    count("dispatch." + name, len(windows))
    with trace.span("dp:" + name, "dp",
                    args={"rows": g.node_n, "windows": len(windows)}):
        if name == "plain":
            return _plain(g, abpt, windows)
        if name == "native":
            return [_native_window(g, abpt, w) for w in windows]
        return _device_windows(g, abpt, windows, mesh, name)


def align_sequence_to_graph(g: POAGraph, abpt: Params, query: np.ndarray) -> AlignResult:
    return align_windows(g, abpt, [(C.SRC_NODE_ID, C.SINK_NODE_ID, query)])[0]
