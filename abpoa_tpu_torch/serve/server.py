"""The server: HTTP endpoints, worker threads, drain.

Counterpart of `abpoa_tpu/serve/server.py` (`AlignServer` :439,
`_ServeChurnHook` :170, `_ServeMapHook` :300, the handler :1243,
`_build_parser` :1462, `serve_main` :1566) over the port's routes, on the
card by default.

Endpoints (stdlib http.server, one ThreadingHTTPServer):

- ``POST /align``   body = FASTA/FASTQ text, response = the bytes the CLI
                    writes for that input (consensus, MSA or GFA, as the
                    server's flags say). The status codes are the
                    contract: 200 aligned, 400 poisoned set, 413 oversized
                    body, 429 shed (Retry-After), 503 draining, 504
                    deadline expired, 500 a failure of the card.
                    ``X-Abpoa-Deadline-S`` caps this request's deadline
                    below the server's.
- ``POST /map``     (with ``--map-graph``) body = reads, response = one GAF
                    record a read against the graph restored once at start
                    (the `map` subcommand's bytes). The same statuses, and
                    400 for a read over the map length cap.
- ``GET /healthz``  200 while the process lives: status ok | degraded |
                    draining, open breakers, a lost card, queue depth,
                    in-flight and served counts.
- ``GET /readyz``   200 once warmed and admitting; 503 while warming or
                    draining.
- ``GET /metrics``  the Prometheus exposition (`obs/metrics.py`).

Workers: N threads take same-rung groups from the admission queue
(`admission.py`). Routes, decided where the JAX server decides them: a
group of two or more runs `runner.flush_lockstep_group` (on cuda in global
and extend mode the device lockstep: B1, X1, S1, K1 once a round over the
lanes); where the split driver serves (local mode, or
ABPOA_TPU_LOCKSTEP_IMPL=split) a group runs under a churn hook that boards
same-rung arrivals at round boundaries (`flush_lockstep_group_churn`,
ABPOA_TPU_SERVE_CHURN); a lone request runs `pipeline.msa`; a set a group
dropped runs set by set on the same device. `/map` requests stream through
`map_reads_split` with a hook that answers each request the round its last
read retires (every device has that driver: the JAX server's per-request
host path has no twin).

Deadlines and the card. A request's deadline (`call_with_deadline`) answers
504 and abandons its thread; it does not touch the card's state. Work never
moves from the card to the host: there is no `auto` device and no host
probe (a missing card is a startup error, rc 1), and no group is swept to
the host CPU. A `resilience.CardFailure` is a 500 for its request. Where the
card is lost (`breaker().lost`: a dispatch watchdog timeout or a sticky
CUDA error) the server then drains: /readyz 503, /healthz `degraded` naming
the card, new and queued requests 503 with Retry-After, no further call to
the card, and the process exits 1 (the JAX server demotes and serves on).
A card failure that leaves the card sound (its recovery used up, an OOM) is
a 500 and the server serves on.

Every terminal request publishes `abpoa_serve_requests_total{status}` and
the latency sketch and appends one archive record (with its request id, and
with --trace-dir its trace file) for `slo` and `why`. The JAX server's
process pool (`--pool-workers`) and replicas (`--replicas`) come with the
pool and the fleet.
"""
from __future__ import annotations

import argparse
import copy
import io
import json
import os
import re
import signal
import sys
import threading
import time
from typing import Dict, List, Optional

from .. import obs
from .. import resilience as rz
from ..params import Params
from .admission import (AdmissionController, Job, default_deadline_s,
                        map_request_bytes, request_bytes,
                        serve_budget_bytes)

DEFAULT_PORT = 8673


def drain_grace_s() -> float:
    """How long a drain waits for queued and in-flight work; after a lost
    card, also how long the front stays up answering 503 (so that a load
    balancer reads /readyz 503 before the port closes)."""
    return float(os.environ.get("ABPOA_TPU_SERVE_DRAIN_S", "30"))


def max_body_bytes() -> int:
    return int(float(os.environ.get("ABPOA_TPU_SERVE_MAX_BODY_MB", "32"))
               * 1e6)


def map_max_qlen() -> int:
    """The longest read POST /map accepts (400 past it;
    ABPOA_TPU_MAP_MAX_QLEN)."""
    return int(os.environ.get("ABPOA_TPU_MAP_MAX_QLEN", "100000"))


def churn_enabled_env() -> bool:
    """May in-flight groups on the split driver board same-rung arrivals
    at round boundaries? On unless ABPOA_TPU_SERVE_CHURN=0."""
    return os.environ.get("ABPOA_TPU_SERVE_CHURN", "1").strip().lower() \
        not in ("0", "off", "false")


# inbound request ids must look like ours: bounded
# hex-ish tokens; anything else is ignored and a new id minted
_RID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")


def _inbound_rid(hdr: Optional[str]) -> Optional[str]:
    return hdr if hdr and _RID_RE.match(hdr) else None


def _request_record(job: Job, status: str, device: str) -> dict:
    """One archive record a terminal request, in the shapes `obs/slo.py`
    reads (reads, read_wall_ms, faults, total_wall_s). 400, 504 and 500
    count a fault; 429 and 503 are shedding, not faults."""
    wall = job.wall_s()
    per_read_ms = (round(1e3 * wall / job.n_reads, 4) if job.n_reads
                   and status == "ok" else None)
    rec = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "kind": "serve_request",
        "label": job.label,
        "device": device,
        "status": status,
        "total_wall_s": round(wall, 6),
        "deadline_s": job.deadline_s,
        "reads": job.n_reads if status == "ok" else 0,
        "read_wall_ms": ({"p50": per_read_ms, "p95": per_read_ms,
                          "p99": per_read_ms, "amortized": True}
                         if per_read_ms is not None else None),
        "faults": 1 if status in ("poisoned", "timeout", "error") else 0,
        "quarantined": 1 if status == "poisoned" else 0,
    }
    # one delivery a request: the JAX record's key, without a router
    rec["attempt"] = 1
    if job.kind == "map":
        rec["workload"] = "map"
    if job.join_round is not None:
        # this request boarded an in-flight group: `why` names the round
        rec["join_round"] = job.join_round
        rec["join_group"] = job.join_group
    return rec


class _ServeChurnHook:
    """The round-boundary churn of one in-flight group on the split driver
    (`parallel/lockstep.ChurnHook`). A round: lanes whose deadline expired
    are evicted (504 at the boundary), same-rung joiners are claimed from
    the queue onto freed lanes (priced against the live group's bytes),
    and each job is answered the round its lane retires."""

    def __init__(self, server: "AlignServer", abpt: Params, gid: int,
                 rung: int, k_cap: int) -> None:
        import itertools
        self.server = server
        self.abpt = abpt
        self.gid = gid
        self.rung = rung
        self.k_cap = max(1, k_cap)
        self.jobs: Dict[object, Job] = {}    # sid -> live job
        self.abs: Dict[object, object] = {}  # sid -> Abpoa container
        self.fallbacks: List[Job] = []       # for the set-by-set path
        self.closed = False
        self._sids = itertools.count(10_000)  # joiner sids, clear of 0..K-1

    def add_initial(self, sid, job: Job, ab) -> None:
        self.jobs[sid] = job
        self.abs[sid] = ab

    def live_bytes(self) -> int:
        return sum(j.est_bytes for j in self.jobs.values())

    # ------------------------------------------------- ChurnHook protocol
    def on_round(self, round_i: int, live_sids: list) -> tuple:
        server = self.server
        evict = set()
        for sid in live_sids:
            job = self.jobs.get(sid)
            if job is not None and job.remaining_s() <= 0:
                evict.add(sid)
                self.jobs.pop(sid, None)
                self.abs.pop(sid, None)
                obs.record_fault(
                    "request_timeout", detail=job.label,
                    action="evicted_at_round",
                    extra={"request_id": job.rid} if job.rid else None)
                if job.finish("timeout",
                              error="request deadline expired "
                                    f"(evicted at round {round_i})"):
                    server.account(job, "timeout")
                server.admission.mark_done(job)
        free = self.k_cap - (len(live_sids) - len(evict))
        joiners = []
        if free > 0 and not self.closed and not server.admission.closed:
            claimed = server.admission.claim_joiners(
                self.rung, free, live_bytes=self.live_bytes())
            for job in claimed:
                boarded = self._board(job, round_i)
                if boarded is not None:
                    joiners.append(boarded)
        server._open_group_update(
            self.gid, self.rung,
            self.k_cap - (len(live_sids) - len(evict)) - len(joiners),
            round_i, len(live_sids) - len(evict) + len(joiners))
        return evict, joiners

    def _board(self, job: Job, round_i: int):
        """Ingest one claimed joiner onto a lane: the split driver's (sid,
        seqs, weights), or None (a poisoned set, answered 400 here)."""
        from ..obs import metrics
        from ..pipeline import Abpoa, _ingest_records
        server = self.server
        try:
            ab = Abpoa()
            seqs, weights = _ingest_records(ab, self.abpt, job.records)
        except rz.QUARANTINE_EXCEPTIONS as e:
            obs.record_fault("poisoned_set", detail=str(e)[:300],
                             action="rejected_400")
            if job.finish("poisoned", error=f"{type(e).__name__}: {e}"):
                server.account(job, "poisoned")
            server.admission.mark_done(job)
            return None
        sid = next(self._sids)
        self.jobs[sid] = job
        self.abs[sid] = ab
        job.join_round = round_i
        job.join_group = self.gid
        wait = max(0.0, (job.t_pickup or time.perf_counter())
                   - job.t_arrive)
        metrics.publish_join_wait(wait)
        if obs.trace_enabled():
            obs.trace.add_span(
                "admission_wait", "serve", job.t_arrive, wait,
                args={"coalesced_k": len(self.jobs), "rung": job.rung,
                      "join_round": round_i, "join_group": self.gid},
                req=(job.rid, 0) if job.rid else None)
        return (sid, seqs, weights)

    def on_retire(self, sid, result, round_i: int) -> None:
        from ..pipeline import output
        server = self.server
        job = self.jobs.pop(sid, None)
        ab = self.abs.pop(sid, None)
        if job is None:
            return
        service = max(0.0, time.perf_counter()
                      - (job.t_pickup or job.t_arrive))
        if result is None:
            # a joiner off the group's rung: the set-by-set path, swept
            # after the group returns
            self.fallbacks.append(job)
            return
        try:
            pg, is_rc = result
            ab.graph = pg
            if self.abpt.amb_strand:
                ab.is_rc[:len(is_rc)] = is_rc
            buf = io.StringIO()
            output(ab, self.abpt, buf)
            if job.finish("ok", body=buf.getvalue()):
                server.account(job, "ok")
        except Exception as e:  # noqa: BLE001 (host output; the group goes on)
            obs.record_fault("request_error", detail=str(e)[:300],
                             action="rejected_500")
            if job.finish("error", error=f"{type(e).__name__}: {e}"):
                server.account(job, "error")
        finally:
            server.admission.mark_done(job, service)


class _ServeMapHook:
    """The round-boundary stream of one `/map` group
    (`parallel/map_driver.MapHook`). A lane is one read: each request's
    reads queue onto lanes, every lane retires every round, and a request
    is answered the round its last read retires. Between rounds the hook
    claims queued same-rung `/map` requests onto freed lanes."""

    def __init__(self, server: "AlignServer", abpt: Params, gid: int,
                 rung: int, k_cap: int) -> None:
        from collections import deque
        self.server = server
        self.abpt = abpt
        self.gid = gid
        self.rung = rung
        self.k_cap = max(1, k_cap)
        self.states: Dict[int, dict] = {}   # job.id -> per-request state
        self.lane_q = deque()               # (job_id, read_idx) to board
        self.closed = False

    def add_job(self, job: Job) -> None:
        import numpy as np
        encode = self.abpt.char_to_code
        queries = [
            encode[np.frombuffer(r.seq.encode(), dtype=np.uint8)
                   ].astype(np.uint8)
            for r in job.records]
        self.states[job.id] = {"job": job, "queries": queries,
                               "results": [None] * len(queries),
                               "left": len(queries)}
        for idx in range(len(queries)):
            self.lane_q.append((job.id, idx))

    def live_bytes(self) -> int:
        return sum(st["job"].est_bytes for st in self.states.values())

    def _expire(self, job: Job) -> None:
        server = self.server
        obs.record_fault("request_timeout", detail=job.label,
                         action="evicted_at_round",
                         extra={"request_id": job.rid} if job.rid else None)
        if job.finish("timeout", error="request deadline expired "
                                       "(map reads still queued)"):
            server.account(job, "timeout")
        server.admission.mark_done(job)

    def _fill(self, out: list, free_slots: int) -> None:
        while self.lane_q and len(out) < free_slots:
            jid, idx = self.lane_q.popleft()
            st = self.states.get(jid)
            if st is None:
                continue
            job = st["job"]
            if job.remaining_s() <= 0:
                # a boundary 504 drops the whole request: its other queued
                # reads are dead work
                self.states.pop(jid, None)
                self._expire(job)
                continue
            out.append(((jid, idx), st["queries"][idx]))

    # -------------------------------------------------- MapHook protocol
    def on_round(self, round_i: int, free_slots: int) -> list:
        from ..obs import metrics
        server = self.server
        out: list = []
        self._fill(out, free_slots)
        free = free_slots - len(out)
        if free > 0 and not self.closed and not server.admission.closed:
            claimed = server.admission.claim_joiners(
                self.rung, free, live_bytes=self.live_bytes(), kind="map")
            for job in claimed:
                job.join_round = round_i
                job.join_group = self.gid
                self.add_job(job)
                wait = max(0.0, (job.t_pickup or time.perf_counter())
                           - job.t_arrive)
                metrics.publish_join_wait(wait)
                if obs.trace_enabled():
                    obs.trace.add_span(
                        "admission_wait", "serve", job.t_arrive, wait,
                        args={"rung": job.rung, "join_round": round_i,
                              "join_group": self.gid, "kind": "map"},
                        req=(job.rid, 0) if job.rid else None)
            self._fill(out, free_slots)
        server._open_group_update(
            self.gid, self.rung, free_slots - len(out), round_i, len(out),
            kind="map")
        return out

    def on_retire(self, rid, outcome, round_i: int) -> None:
        jid, idx = rid
        st = self.states.get(jid)
        if st is None:
            return
        st["results"][idx] = outcome  # None: off the rung (aligned alone)
        st["left"] -= 1
        if st["left"] > 0:
            return
        self.states.pop(jid, None)
        self._answer(st)

    def _answer(self, st: dict) -> None:
        from ..io.gaf import gaf_record
        from ..parallel import map_read_host
        server = self.server
        job = st["job"]
        static = server._map_static
        service = max(0.0, time.perf_counter()
                      - (job.t_pickup or job.t_arrive))
        try:
            lines = []
            for rec, q, outcome in zip(job.records, st["queries"],
                                       st["results"]):
                # a read off the rung (the request's rung bounds every
                # read, so it cannot happen) runs alone on the same device
                res, strand = (outcome if outcome is not None
                               else map_read_host(static, self.abpt, q))
                lines.append(gaf_record(rec.name, q, res,
                                        static.base_by_nid, strand,
                                        comment=rec.comment or None))
            if job.finish("ok", body="".join(ln + "\n" for ln in lines)):
                server.account(job, "ok")
        except rz.CardFailure as e:
            server._card_failed(job, e)
            raise
        except Exception as e:  # noqa: BLE001 (host output; the group goes on)
            obs.record_fault("request_error", detail=str(e)[:300],
                             action="rejected_500")
            if job.finish("error", error=f"{type(e).__name__}: {e}"):
                server.account(job, "error")
        finally:
            server.admission.mark_done(job, service)


class AlignServer:
    """The admission queue, the worker threads and the HTTP front.
    `start()` warms, plans the routes and admits; `begin_drain()` and
    `drain()` are the SIGTERM path; `stop()` is the tests' teardown."""

    def __init__(self, abpt: Params, host: str = "127.0.0.1", port: int = 0,
                 workers: int = 2, queue_depth: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 trace_dir: Optional[str] = None,
                 map_graph: Optional[str] = None,
                 mesh: Optional[int] = None) -> None:
        if not abpt._finalized:
            abpt = abpt.finalize()
        self.abpt = abpt
        # with --trace-dir every sampled request's spans (ingress,
        # admission wait, execution) export as one Chrome trace, named by
        # its archive record
        self._trace_dir = trace_dir or os.environ.get(
            "ABPOA_TPU_SERVE_TRACE_DIR") or None
        self.deadline_s = (deadline_s if deadline_s is not None
                           else default_deadline_s())
        # --mesh N / ABPOA_TPU_MESH: each group's rounds split over N
        # devices; the byte gate and K caps price the whole mesh
        from ..parallel.shard import requested_mesh_size
        self._mesh_req = requested_mesh_size(mesh)
        self._mesh = None           # tuple of torch devices, set in start()
        self.admission = AdmissionController(abpt, max_depth=queue_depth)
        self.draining = threading.Event()
        self.ready = threading.Event()
        # set by a signal or by a lost card: serve_main's wait ends
        self.stop_requested = threading.Event()
        self.signalled = threading.Event()
        self.lost_card: Optional[Dict[str, str]] = None
        self.lost_at = 0.0
        self._stats: Dict[str, int] = {}
        self._stats_lock = threading.Lock()
        self._workers: List[threading.Thread] = []
        self._n_workers = max(1, workers)
        self._lockstep = False
        self._lockstep_impl = ""    # "split" | "device" once routed
        # groups on the split driver board same-rung arrivals at round
        # boundaries; the open groups back /healthz's `open_groups`
        self._churn = False
        # --map-graph: one graph restored at start, served by POST /map
        self._map_graph = map_graph or os.environ.get(
            "ABPOA_TPU_SERVE_MAP_GRAPH") or None
        self._map_static = None
        self._map_coalesce = False
        self._open_groups: Dict[int, dict] = {}
        self._open_lock = threading.Lock()
        import itertools
        self._group_ids = itertools.count()
        self.t_start = time.time()
        from http.server import ThreadingHTTPServer

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            # the default backlog (5) drops connections under a burst
            # before admission can answer 429
            request_queue_size = 128

        self._httpd = _Server((host, port), _make_handler(self))
        self.host, self.port = self._httpd.server_address[:2]

    # ---------------------------------------------------------- lifecycle
    def start(self, warm: str = "auto") -> None:
        """Serve HTTP (so /healthz answers while warming), warm the
        kernels on the card, find the mesh, set the byte budget, plan the
        routes, restore the map graph, start the workers, then admit.
        warm: "quick" | "full" | "off" | "auto" (quick on cuda, off on the
        host rungs). Raises where the card, the mesh or the kernel library
        cannot serve: a startup error, never a host server."""
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="abpoa-serve-http").start()
        obs.start_run()
        if self._trace_dir:
            os.makedirs(self._trace_dir, exist_ok=True)
            obs.trace_enable()
            # exports read the request's own slice, not the whole ring
            obs.tracer().index_requests = True
            obs.count("serve.traces", 0)
        dev = self.abpt.torch_device
        obs.note_device(dev)
        on_card = dev.type == "cuda"
        if warm == "auto":
            warm = "quick" if on_card else "off"
        if self._mesh_req >= 2:
            # a mesh the devices cannot give is a startup error
            from ..parallel.shard import discover_mesh
            self._mesh = discover_mesh(self._mesh_req, dev)
            obs.metrics.publish_mesh(len(self._mesh), self._mesh[0].type)
        if on_card:
            # the kernel library is built and loaded here, before any
            # worker thread starts
            from ..kernels import build
            build.load()
        if on_card and warm != "off":
            from ..kernels.warm import warm_ladder
            t0 = time.perf_counter()
            summary = warm_ladder(tier=warm, abpt=self.abpt)
            print(f"[abpoa_tpu_torch serve] warm({warm}): "
                  f"{summary['signatures']} entry points, "
                  f"{summary['launches']} launches, "
                  f"{summary['compiled']} library builds in "
                  f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
        # the byte gate, once, after the warm: 90 % of the card's free
        # memory now (ABPOA_TPU_SERVE_MEM_BUDGET_MB overrides)
        self.admission.set_budget(serve_budget_bytes(dev),
                                  mesh=max(self._mesh_req, 1))
        # one decision site with the -l runner: whether groups form and
        # which lockstep implementation runs them
        from ..parallel import (lockstep_group_size, lockstep_impl,
                                plan_route)
        route = plan_route(self.abpt, lockstep_group_size(), serve=True,
                           mesh=self._mesh_req)
        self._lockstep = route.kind in ("lockstep", "sharded")
        self._lockstep_impl = lockstep_impl(self.abpt) if self._lockstep \
            else ""
        # churn needs the split driver's host-side round boundaries (the
        # device lockstep keeps its rounds on the card)
        self._churn = (self._lockstep and self._lockstep_impl == "split"
                       and churn_enabled_env())
        if self._map_graph:
            # the graph is restored once; every /map request maps against
            # its tables (a copy of the Params: the restore sets incr_fn,
            # which /align requests must not see)
            from ..parallel import load_static_graph
            t0 = time.perf_counter()
            _ab, self._map_static = load_static_graph(self._map_graph,
                                                      copy.copy(self.abpt))
            route = plan_route(self.abpt, 1, workload="map",
                               mesh=self._mesh_req)
            self._map_coalesce = route.kind in ("map", "sharded")
            print(f"[abpoa_tpu_torch serve] map graph {self._map_graph}: "
                  f"{self._map_static.n_rows - 2} nodes restored in "
                  f"{time.perf_counter() - t0:.1f}s "
                  f"(route {route.kind}: {route.reason})", file=sys.stderr)
        for i in range(self._n_workers):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"abpoa-serve-worker-{i}")
            t.start()
            self._workers.append(t)
        self.ready.set()

    def begin_drain(self) -> None:
        self.draining.set()
        self.admission.close_intake()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for queued and in-flight work; True when it all ended
        within the grace."""
        if timeout is None:
            timeout = drain_grace_s()
        ok = self.admission.wait_drained(timeout)
        for t in self._workers:
            t.join(timeout=2.0)
        return ok

    def shutdown_http(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def stop(self) -> bool:
        """Full teardown (tests): drain, then close the socket."""
        self.begin_drain()
        ok = self.drain()
        self.shutdown_http()
        return ok

    # ---------------------------------------------------------- the card
    def _card_failed(self, job: Job, e: "rz.CardFailure") -> None:
        """A request the card failed: 500 with its fault record. Where the
        card is lost, the server stops taking work: every queued request
        is answered 503, new ones get 503, and serve_main exits 1."""
        obs.record_fault("request_error", detail=str(e)[:300],
                         action="rejected_500",
                         extra={"request_id": job.rid} if job.rid else None)
        print(f"[abpoa_tpu_torch serve] {job.label}: card failure "
              f"({e.kind}): {e}", file=sys.stderr)
        if job.finish("error", error=f"CardFailure ({e.kind}): {e}"):
            self.account(job, "error")
        lost = dict(rz.breaker().lost)
        if lost and self.lost_card is None:
            self.lost_card = lost
            self.lost_at = time.perf_counter()
            print(f"[abpoa_tpu_torch serve] the card is lost ({lost}): "
                  "draining; no further call goes to it", file=sys.stderr)
            self.begin_drain()
            for queued in self.admission.drop_queued():
                if queued.finish("draining", error="the card was lost"):
                    self.account(queued, "draining")
            self.stop_requested.set()

    # ---------------------------------------------------------- accounting
    def bump(self, status: str, wall_s: float) -> None:
        """A terminal status that never became a job (the handler's 429,
        503, 413, parse 400): stats and metrics, no archive record."""
        from ..obs import metrics
        with self._stats_lock:
            self._stats[status] = self._stats.get(status, 0) + 1
        metrics.publish_serve_request(status, wall_s)

    def account(self, job: Job, status: str) -> None:
        """An admitted job's terminal status: stats, the serve metric
        families and one archive record with the request id and, where
        made, the request's trace file (`slo` and `why` read them)."""
        self.bump(status, job.wall_s())
        rec = _request_record(job, status, self.abpt.device)
        if self._mesh is not None:
            # `why` renders "sharded K=<cap> over mesh=<n>" from these
            rec["mesh"] = len(self._mesh)
            rec["route"] = "sharded"
            from ..parallel import lockstep_group_size
            rec["k_cap"] = self._sharded_k_cap(
                lockstep_group_size(),
                "map" if job.kind == "map" else "lockstep")
            skew = obs.rounds.skew_summary()
            if skew:
                rec["slowest_shard"] = skew["slowest_shard"]
                rec["shard_skew"] = skew["shard_skew"]
                rec["round_wall_ms"] = skew["round_wall_ms"]
        rec["request_id"] = job.rid or None
        tf = self._export_trace(job, status)
        if tf:
            rec["trace_file"] = tf
        obs.archive.append_record(rec)

    def _traced(self, rid: str) -> bool:
        """Is this request traced: the one decision for its registration
        at ingress and its export."""
        return bool(self._trace_dir and rid and obs.sampled(rid))

    def _export_trace(self, job: Job, status: str) -> Optional[str]:
        """Write the request's spans as one Chrome trace under
        --trace-dir, with a `request` span from ingress to its terminal
        status."""
        if not self._traced(job.rid):
            if job.rid:
                obs.tracer().take_request(job.rid)  # drop any indexed slice
            return None
        obs.trace.add_span("request", "serve", job.t_arrive, job.wall_s(),
                           args={"status": status, "reads": job.n_reads,
                                 "deadline_s": job.deadline_s},
                           req=(job.rid, 0))
        taken = obs.tracer().take_request(job.rid)
        evs, idx_dropped = taken if taken is not None else (None, 0)
        meta = {"status": status, "label": job.label,
                "device": self.abpt.device}
        if idx_dropped:
            meta["indexed_events_dropped"] = idx_dropped
        path = obs.export_request_trace(
            self._trace_dir, job.rid, extra_meta=meta, events=evs)
        if path:
            obs.count("serve.traces")
        return path

    def stats(self) -> Dict[str, int]:
        with self._stats_lock:
            return dict(self._stats)

    def health(self) -> dict:
        depth, inflight = self.admission.snapshot()
        # a snapshot: a half-open probe may reclose (delete a key) meanwhile
        degraded = {b: st["to"] for b, st in dict(rz.breaker().open).items()}
        if self.lost_card:
            degraded.update({b: "lost" for b in self.lost_card})
        status = ("degraded" if self.lost_card
                  else "draining" if self.draining.is_set()
                  else "degraded" if degraded else "ok")
        out = {"status": status, "degraded": degraded or None,
               "queue_depth": depth, "inflight": inflight,
               "served": self.stats(), "device": self.abpt.device,
               "uptime_s": round(time.time() - self.t_start, 1)}
        if self.lost_card:
            out["lost"] = {"card": str(self.abpt.torch_device),
                           "faults": dict(self.lost_card)}
        if self._churn or self._map_coalesce:
            # groups a request of the same rung and kind could board
            out["open_groups"] = self.open_groups_snapshot()
        if self._map_static is not None:
            out["map_graph"] = {"path": self._map_graph,
                                "nodes": self._map_static.n_rows - 2,
                                "batched": self._map_coalesce}
        if self._mesh is not None:
            out["mesh"] = {"devices": len(self._mesh),
                           "platform": self._mesh[0].type, "axis": "set"}
        return out

    # ------------------------------------------------- open-group registry
    def _open_group_update(self, gid: int, rung: int, free: int,
                           round_i: int, live: int,
                           kind: str = "consensus") -> None:
        with self._open_lock:
            self._open_groups[gid] = {"id": gid, "rung": rung,
                                      "free": max(0, free),
                                      "round": round_i, "live": live,
                                      "kind": kind}

    def _open_group_close(self, gid: int) -> None:
        with self._open_lock:
            self._open_groups.pop(gid, None)

    def open_groups_snapshot(self) -> List[dict]:
        with self._open_lock:
            return [dict(g) for g in self._open_groups.values()]

    # ---------------------------------------------------------- execution
    def _sharded_k_cap(self, base_k: int, route: str) -> int:
        """A group's K: the idle-lane cap, a device's worth times the
        mesh on the sharded route."""
        from ..parallel import scheduler as _sched
        if self._mesh is not None:
            return (len(self._mesh)
                    * _sched.noop_k_cap(base_k, route="sharded"))
        return _sched.noop_k_cap(base_k, route=route)

    def _worker_loop(self) -> None:
        from ..parallel import lockstep_group_size
        from ..parallel import scheduler as _sched
        coalescing = self._lockstep or self._map_coalesce
        base_k = lockstep_group_size() if coalescing else 1
        route = "map" if (self._map_coalesce
                          and not self._lockstep) else "lockstep"
        while True:
            # the idle-lane share re-caps the next group's K; groups are of
            # one kind (next_group keeps to the head's), so one loop serves
            # /align and /map
            max_k = (self._sharded_k_cap(base_k, route)
                     if coalescing else 1)
            group = self.admission.next_group(
                max_k=max_k, coalesce=coalescing,
                min_qlen=(_sched.lockstep_min_qlen()
                          if self._lockstep else 0))
            if not group:
                # intake closed and the queue empty: no work can come
                if (self.admission.closed
                        and self.admission.snapshot()[0] == 0):
                    return
                continue
            try:
                self._process_group(group)
            except rz.CardFailure as e:
                for job in group:
                    if job.status is None:
                        self._card_failed(job, e)
                    self.admission.mark_done(job)
            except BaseException:  # noqa: BLE001 (the worker must survive)
                import traceback
                traceback.print_exc()
                for job in group:
                    if job.finish("error", error="internal worker error"):
                        self.account(job, "error")
                    self.admission.mark_done(job)

    def _process_group(self, group: List[Job]) -> None:
        """Run one group to terminal status: poisoned 400, deadline 504,
        a card failure 500 (`_card_failed`), anything else 500 with a fault
        record; the worker lives on."""
        # the admission wait ends at pickup: one span a request, with the
        # group's size, before expiry decides anything
        if obs.trace_enabled():
            for job in group:
                end = job.t_pickup or time.perf_counter()
                obs.trace.add_span(
                    "admission_wait", "serve", job.t_arrive,
                    max(0.0, end - job.t_arrive),
                    args={"coalesced_k": len(group), "rung": job.rung},
                    req=(job.rid, 0) if job.rid else None)
        # jobs that aged out in the queue: their client gave up
        live: List[Job] = []
        for job in group:
            if job.remaining_s() <= 0:
                obs.record_fault("request_timeout", detail=job.label,
                                 action="expired_in_queue",
                                 extra={"request_id": job.rid} if job.rid
                                 else None)
                if job.finish("timeout",
                              error="deadline expired in admission queue"):
                    self.account(job, "timeout")
                self.admission.mark_done(job)
            else:
                live.append(job)
        if not live:
            return
        # a Params copy a group: workers run at once
        abpt = copy.deepcopy(self.abpt)
        if live[0].kind == "map":
            self._run_map_group(live, abpt)
            return
        if self._churn and all(j.eligible for j in live):
            from ..parallel import scheduler as _sched
            head = live[0]
            # below the crossover a lane only slows a request down
            if not head.qmax or head.qmax >= _sched.lockstep_min_qlen():
                self._run_lockstep_churn(live, abpt)
                return
        if len(live) > 1:
            self._run_lockstep(live, abpt)
            return
        job = live[0]
        t0 = time.perf_counter()
        try:
            self._finish_single(job, abpt)
        finally:
            self.admission.mark_done(job, time.perf_counter() - t0)

    def _supervised(self, fn, jobs: List[Job], deadline_s: float,
                    label: str):
        """fn() under the request deadline (`call_with_deadline`). Where
        the deadline abandons its thread, the jobs' bytes stay on the
        admission gate until fn returns: the thread goes on allocating on
        the card after the jobs are answered 504 and marked done."""
        from ..resilience.watchdog import DispatchTimeout, call_with_deadline
        hold = self.admission.hold(jobs)

        def run():
            try:
                return fn()
            finally:
                self.admission.release(hold)
        try:
            return call_with_deadline(run, deadline_s=deadline_s,
                                      label=label)
        except DispatchTimeout:
            self.admission.abandon(hold)
            raise

    def _finish_single(self, job: Job, abpt: Params) -> None:
        """One job to terminal status under its deadline, on the server's
        device. The caller owns mark_done."""
        from ..resilience.watchdog import DispatchTimeout
        remaining = job.remaining_s()
        if remaining <= 0:
            # the budget is spent (a group dispatch used it): 504 now, as
            # a deadline <= 0 would mean "unsupervised"
            obs.record_fault("request_timeout", detail=job.label,
                             action="expired_before_fallback")
            if job.finish("timeout", error="request deadline expired"):
                self.account(job, "timeout")
            return
        rid_extra = {"request_id": job.rid} if job.rid else None
        try:
            with obs.request_ctx(job.rid):
                body = self._supervised(
                    lambda: self._run_single(job, abpt), [job],
                    remaining, job.label)
            if job.finish("ok", body=body):
                self.account(job, "ok")
        except DispatchTimeout:
            # the request's deadline: its thread is abandoned, the card's
            # state is untouched
            obs.record_fault("request_timeout", detail=job.label,
                             action="worker_abandoned", extra=rid_extra)
            if job.finish("timeout", error="request deadline expired"):
                self.account(job, "timeout")
        except rz.QUARANTINE_EXCEPTIONS as e:
            # a poisoned set is a 400 for this request, never a crash
            obs.record_fault("poisoned_set", detail=str(e)[:300],
                             action="rejected_400", extra=rid_extra)
            if job.finish("poisoned", error=f"{type(e).__name__}: {e}"):
                self.account(job, "poisoned")
        except rz.CardFailure as e:
            self._card_failed(job, e)
        except Exception as e:  # noqa: BLE001 (the worker must survive)
            obs.record_fault("request_error", detail=str(e)[:300],
                             action="rejected_500", extra=rid_extra)
            print(f"[abpoa_tpu_torch serve] {job.label} failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            if job.finish("error", error=f"{type(e).__name__}: {e}"):
                self.account(job, "error")

    def _run_single(self, job: Job, abpt: Params) -> str:
        from ..pipeline import Abpoa, msa
        with obs.request_ctx(job.rid), \
                obs.span("execute", "serve", args={"label": job.label}):
            buf = io.StringIO()
            msa(Abpoa(), abpt, job.records, buf)
            return buf.getvalue()

    def _ingest(self, jobs: List[Job], abpt: Params) -> tuple:
        """Each job's records into a container of its own: the (i, ab,
        seqs, weights) entries of the jobs that parse and {i: job}; a
        poisoned set is answered 400 here."""
        from ..pipeline import Abpoa, _ingest_records
        entries, by_idx = [], {}
        for i, job in enumerate(jobs):
            try:
                ab = Abpoa()
                seqs, weights = _ingest_records(ab, abpt, job.records)
            except rz.QUARANTINE_EXCEPTIONS as e:
                obs.record_fault("poisoned_set", detail=str(e)[:300],
                                 action="rejected_400")
                if job.finish("poisoned", error=f"{type(e).__name__}: {e}"):
                    self.account(job, "poisoned")
                self.admission.mark_done(job)
                continue
            entries.append((i, ab, seqs, weights))
            by_idx[i] = job
        return entries, by_idx

    def _run_lockstep(self, jobs: List[Job], abpt: Params) -> None:
        """A coalesced same-rung group: each request in a container of
        its own, one `flush_lockstep_group` (the `-l` route, its envelope
        included), each result written on its own. A set the group drops
        runs set by set on the same device."""
        from ..parallel import flush_lockstep_group
        from ..pipeline import output
        from ..resilience.watchdog import DispatchTimeout
        t0 = time.perf_counter()
        entries, by_idx = self._ingest(jobs, abpt)
        if not entries:
            return
        gi = next(self._group_ids)
        # the group runs under its tightest member's deadline; on expiry
        # only the jobs out of budget answer 504, the rest go set by set
        deadline = min(by_idx[i].remaining_s() for i, *_ in entries)
        if deadline <= 0:
            for i, *_ in entries:
                job = by_idx[i]
                try:
                    self._finish_single(job, copy.deepcopy(self.abpt))
                finally:
                    self.admission.mark_done(job)
            return
        try:
            results = self._supervised(
                lambda: flush_lockstep_group(entries, abpt, mesh=self._mesh),
                [by_idx[i] for i, *_ in entries], deadline,
                f"serve_group:{gi}")
        except DispatchTimeout:
            for i, *_ in entries:
                job = by_idx[i]
                try:
                    if job.remaining_s() <= 0:
                        obs.record_fault("request_timeout",
                                         detail=job.label,
                                         action="worker_abandoned")
                        if job.finish("timeout",
                                      error="request deadline expired"):
                            self.account(job, "timeout")
                    else:
                        self._finish_single(job, copy.deepcopy(self.abpt))
                finally:
                    self.admission.mark_done(job)
            return
        except rz.CardFailure as e:
            for i, *_ in entries:
                self._card_failed(by_idx[i], e)
                self.admission.mark_done(by_idx[i])
            return
        share = (time.perf_counter() - t0) / max(1, len(entries))
        for i, ab, _seqs, _weights in entries:
            job = by_idx[i]
            try:
                if i in results:
                    buf = io.StringIO()
                    output(results[i], abpt, buf)
                    if job.finish("ok", body=buf.getvalue()):
                        self.account(job, "ok")
                else:
                    # the group dropped this set: its own route, as the
                    # -l runner does
                    self._finish_single(job, copy.deepcopy(self.abpt))
            finally:
                self.admission.mark_done(job, share)

    def _run_lockstep_churn(self, jobs: List[Job], abpt: Params) -> None:
        """A group on the split driver with a round-boundary churn hook:
        lanes retire (and their jobs are answered) the round they finish,
        expired lanes are evicted as 504s, and same-rung arrivals board
        freed lanes. A lone job opens a group others can join. The
        dispatch watchdog inside the envelope bounds a wedged round; a
        failed dispatch sends the unanswered jobs set by set on the same
        device."""
        from ..parallel import flush_lockstep_group_churn, lockstep_group_size
        gi = next(self._group_ids)
        hook = _ServeChurnHook(self, abpt, gi, jobs[0].rung,
                               self._sharded_k_cap(lockstep_group_size(),
                                                   "lockstep"))
        entries, by_idx = self._ingest(jobs, abpt)
        if not entries:
            return
        for i, ab, _seqs, _weights in entries:
            hook.add_initial(i, by_idx[i], ab)
        self._open_group_update(gi, hook.rung,
                                hook.k_cap - len(entries), 0, len(entries))
        try:
            flush_lockstep_group_churn(entries, abpt, hook, mesh=self._mesh)
        except rz.DispatchFailed as e:
            print(f"Warning: churn lockstep group {gi} failed ({e}); "
                  "sweeping members to the set-by-set path.",
                  file=sys.stderr)
            obs.count("fallback.lockstep_to_sequential")
        except rz.CardFailure as e:
            for job in hook.fallbacks + list(hook.jobs.values()):
                self._card_failed(job, e)
                self.admission.mark_done(job)
            hook.fallbacks, hook.jobs = [], {}
            return
        finally:
            hook.closed = True
            self._open_group_close(gi)
        # the sweep: joiners off the rung and any lane a failed dispatch
        # left unanswered, each set by set under its own deadline
        leftovers = hook.fallbacks + list(hook.jobs.values())
        hook.fallbacks = []
        hook.jobs.clear()
        hook.abs.clear()
        for job in leftovers:
            try:
                self._finish_single(job, copy.deepcopy(self.abpt))
            finally:
                self.admission.mark_done(job)

    # ----------------------------------------------------------- map (/map)
    def _run_map_group(self, jobs: List[Job], abpt: Params) -> None:
        """One `/map` group: every request's reads stream through the
        static-graph driver with a hook that answers a request the round
        its last read retires and claims queued same-rung requests onto
        freed lanes. Every device has the K-lane driver, so the JAX
        server's per-request host path has no caller here: a request a
        failed group leaves unanswered gets 500, never a host rerun."""
        from ..parallel import lockstep_group_size, map_reads_split
        gid = next(self._group_ids)
        hook = _ServeMapHook(self, abpt, gid, jobs[0].rung,
                             self._sharded_k_cap(lockstep_group_size(),
                                                 "map"))
        for job in jobs:
            hook.add_job(job)
        self._open_group_update(gid, hook.rung, hook.k_cap, 0, 0,
                                kind="map")
        try:
            map_reads_split(self._map_static, [], abpt,
                            k_cap=hook.k_cap, hook=hook, Qp=hook.rung,
                            mesh=self._mesh)
        except rz.CardFailure as e:
            for st in hook.states.values():
                self._card_failed(st["job"], e)
                self.admission.mark_done(st["job"])
            hook.states.clear()
        except Exception as e:  # noqa: BLE001 (the worker must survive)
            import traceback
            traceback.print_exc()
            for st in hook.states.values():
                job = st["job"]
                obs.record_fault("request_error", detail=str(e)[:300],
                                 action="rejected_500")
                if job.finish("error", error=f"{type(e).__name__}: {e}"):
                    self.account(job, "error")
                self.admission.mark_done(job)
            hook.states.clear()
        finally:
            hook.closed = True
            self._open_group_close(gid)


def _make_handler(server: AlignServer):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # ------------------------------------------------------ plumbing
        def _send(self, code: int, body: bytes, ctype: str,
                  headers: Optional[dict] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client gave up; its job already ended

        def _json(self, code: int, obj: dict,
                  headers: Optional[dict] = None) -> None:
            self._send(code, (json.dumps(obj) + "\n").encode(),
                       "application/json", headers)

        def log_message(self, *a):  # no request lines on stderr
            pass

        # ------------------------------------------------------ GET
        def do_GET(self):  # noqa: N802 (http.server API)
            path = self.path.rstrip("/")
            if path == "/healthz":
                self._json(200, server.health())
            elif path == "/readyz":
                if server.lost_card:
                    self._json(503, {"status": "card lost",
                                     "lost": server.lost_card})
                elif server.draining.is_set():
                    self._json(503, {"status": "draining"})
                elif not server.ready.is_set():
                    self._json(503, {"status": "warming"})
                else:
                    self._json(200, {"status": "ready"})
            elif path == "/metrics":
                from ..obs import metrics
                self._send(200, metrics.registry().render().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._json(404, {"error": f"unknown path {self.path!r}"})

        # ------------------------------------------------------ POST
        def do_POST(self):  # noqa: N802 (http.server API)
            path = self.path.rstrip("/")
            if path not in ("/align", "/map"):
                self._json(404, {"error": f"unknown path {self.path!r}"})
                return
            is_map = path == "/map"
            # the request id is minted at ingress, before parsing and
            # admission, and every answer carries it; a client may send
            # its own
            rid = (_inbound_rid(self.headers.get("X-Abpoa-Request-Id"))
                   or obs.new_request_id())
            rh = {"X-Abpoa-Request-Id": rid}
            if server.draining.is_set():
                # the body was never read: close the connection, or a
                # keep-alive client's bytes would parse as a request line
                self.close_connection = True
                server.bump("draining", 0.0)
                self._json(503, {"error": "server is draining"},
                           {"Retry-After": "30", **rh})
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                self.close_connection = True
                server.bump("poisoned", 0.0)
                self._json(400, {"error": "malformed Content-Length"}, rh)
                return
            if n > max_body_bytes():
                self.close_connection = True  # body unread, as above
                server.bump("oversized", 0.0)
                self._json(413, {"error": f"body {n} B exceeds the "
                                          f"{max_body_bytes()} B limit"},
                           rh)
                return
            if is_map and server._map_static is None:
                self.close_connection = True  # body unread
                server.bump("poisoned", 0.0)
                self._json(400, {"error": "no map graph loaded; start "
                                          "serve with --map-graph FILE"},
                           rh)
                return
            raw = self.rfile.read(n) if n else b""
            t0 = time.perf_counter()
            try:
                job = (self._parse_map_job(raw, rid) if is_map
                       else self._parse_job(raw, rid))
            except Exception as e:  # noqa: BLE001 (a malformed body: 400)
                server.bump("poisoned", time.perf_counter() - t0)
                obs.record_fault("poisoned_set", detail=str(e)[:300],
                                 action="rejected_400",
                                 extra={"request_id": rid})
                self._json(400, {"error": f"{type(e).__name__}: {e}"}, rh)
                return
            # registered for indexed spans before a worker can see the job
            traced = server._traced(rid)
            if traced:
                obs.tracer().begin_request(rid)
            admitted, reason, retry_after = server.admission.try_admit(job)
            if not admitted:
                if traced:
                    obs.tracer().take_request(rid)   # never dispatched
                status = "draining" if reason == "draining" else "rejected"
                server.bump(status, job.wall_s())
                code = 503 if reason == "draining" else 429
                self._json(code, {"error": f"admission rejected: {reason}"},
                           {"Retry-After": str(int(max(1, retry_after))),
                            **rh})
                return
            # the worker's deadline is authoritative; the slack covers
            # pickup and the watchdog's own bookkeeping
            if not job.done.wait(job.deadline_s + 10.0):
                if job.finish("timeout", error="server lost the request"):
                    server.account(job, "timeout")
            status = job.status
            if status == "ok":
                self._send(200, job.body.encode(),
                           "text/x-gaf" if is_map else "text/x-fasta",
                           {"X-Abpoa-Reads": str(job.n_reads), **rh})
            elif status == "poisoned":
                self._json(400, {"error": job.error}, rh)
            elif status == "timeout":
                self._json(504, {"error": job.error or
                                 "request deadline expired"}, rh)
            elif status == "draining":
                # queued when the card was lost
                self._json(503, {"error": job.error or "server is draining"},
                           {"Retry-After": "30", **rh})
            else:
                self._json(500, {"error": job.error or "internal error"},
                           rh)

        def _deadline(self) -> float:
            deadline = server.deadline_s
            hdr = self.headers.get("X-Abpoa-Deadline-S")
            if hdr:
                try:
                    deadline = min(deadline, float(hdr))
                except ValueError:
                    pass
            return deadline

        def _parse_job(self, raw: bytes, rid: str = "") -> Job:
            from ..align.buckets import qp_rung
            from ..align.eligibility import fused_eligible
            from ..io.fastx import read_fastx_text
            records = read_fastx_text(raw.decode("utf-8", errors="strict"))
            # the -l quarantine's checks: a poisoned set costs a parse
            rz.validate_records(records, server.abpt)
            qmax = max(len(r.seq) for r in records)
            return Job(records, rung=qp_rung(qmax),
                       est_bytes=request_bytes(server.abpt, records),
                       eligible=fused_eligible(server.abpt, len(records)),
                       deadline_s=self._deadline(), rid=rid, qmax=qmax)

        def _parse_map_job(self, raw: bytes, rid: str = "") -> Job:
            from ..align.buckets import qp_rung
            from ..io.fastx import read_fastx_text
            records = read_fastx_text(raw.decode("utf-8", errors="strict"))
            rz.validate_records(records, server.abpt)
            cap = map_max_qlen()
            for r in records:
                if len(r.seq) > cap:
                    raise ValueError(
                        f"read {r.name!r} is {len(r.seq)} bp, over the "
                        f"map read cap {cap} bp "
                        "(ABPOA_TPU_MAP_MAX_QLEN)")
            qmax = max(len(r.seq) for r in records)
            # the reads' bytes only: the graph was priced at the restore
            return Job(records, rung=qp_rung(qmax),
                       est_bytes=map_request_bytes(
                           server.abpt, records,
                           server._map_static.n_rows),
                       eligible=server._map_coalesce,
                       deadline_s=self._deadline(), rid=rid, qmax=qmax,
                       kind="map")

    return Handler


# --------------------------------------------------------------------------- #
# CLI entry                                                                   #
# --------------------------------------------------------------------------- #

def _build_parser() -> argparse.ArgumentParser:
    from .. import constants as C
    ap = argparse.ArgumentParser(
        prog="python -m abpoa_tpu_torch serve",
        description="persistent aligner service on the card: POST "
                    "FASTA/FASTQ to /align (or reads to /map), scrape "
                    "/metrics, watch /healthz and /readyz; admission-"
                    "bounded (429 + Retry-After past the queue or the "
                    "card's memory budget), per-request deadlines (504), "
                    "poisoned-set isolation (400), graceful drain on "
                    "SIGTERM (rc 0), a lost card ends the server (rc 1)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT,
                    help="listen port; 0 picks an ephemeral port "
                         "[%(default)s]")
    ap.add_argument("--workers", type=int,
                    default=min(4, os.cpu_count() or 1),
                    help="alignment worker threads [%(default)s]")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="admission queue bound "
                         "[ABPOA_TPU_SERVE_QUEUE or 64]")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall deadline "
                         "[ABPOA_TPU_SERVE_DEADLINE_S or 30]")
    ap.add_argument("--warm", choices=["auto", "quick", "full", "off"],
                    default="auto",
                    help="build the kernel library and launch each kernel "
                         "once before admitting [auto: quick on cuda]")
    ap.add_argument("--metrics", type=str, nargs="?", metavar="FILE",
                    default=None, const="",
                    help="also maintain the Prometheus textfile exporter "
                         "(the `top` feed) [FILE defaults to "
                         "~/.cache/abpoa_tpu_torch/metrics.prom]")
    ap.add_argument("--trace-dir", type=str, default=None, metavar="DIR",
                    help="write one Perfetto-viewable Chrome trace per "
                         "sampled request (ABPOA_TPU_TRACE_SAMPLE, "
                         "default 1.0) into DIR; `why <id>` renders them "
                         "[ABPOA_TPU_SERVE_TRACE_DIR]")
    ap.add_argument("--map-graph", type=str, default=None, metavar="FILE",
                    help="restore FILE (abPOA GFA or MSA FASTA, the -i "
                         "formats) once at start and serve POST /map: one "
                         "GAF record a read [ABPOA_TPU_SERVE_MAP_GRAPH]")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda | cpu | native (the C++ host DP) "
                         "[%(default)s]")
    ap.add_argument("--lockstep", type=str, default="auto",
                    choices=["auto", "on", "off"],
                    help="coalesce same-rung requests into lockstep groups "
                         "[auto: on cuda]")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="split each group's rounds over N devices (the "
                         "sharded route; K caps and the byte gate scale by "
                         "N) [ABPOA_TPU_MESH]")
    ap.add_argument("-m", "--aln-mode", type=int, default=C.GLOBAL_MODE)
    ap.add_argument("-M", "--match", type=int, default=C.DEFAULT_MATCH)
    ap.add_argument("-X", "--mismatch", type=int, default=C.DEFAULT_MISMATCH)
    ap.add_argument("-O", "--gap-open", type=str, default=None)
    ap.add_argument("-E", "--gap-ext", type=str, default=None)
    ap.add_argument("-r", "--result", type=int, default=C.OUT_CONS)
    ap.add_argument("-a", "--cons-algrm", type=int, default=C.CONS_HB)
    ap.add_argument("-d", "--maxnum-cons", type=int, default=1)
    ap.add_argument("-q", "--min-freq", type=float, default=C.MULTIP_MIN_FREQ)
    return ap


def _params_from_args(args) -> Params:
    # the CLI's -O/-E/-r decoding, so the flags mean what they mean there
    from ..cli import _apply_gap_args, _apply_result_mode
    abpt = Params()
    abpt.align_mode = args.aln_mode
    abpt.match = args.match
    abpt.mismatch = args.mismatch
    _apply_gap_args(abpt, args.gap_open, args.gap_ext)
    _apply_result_mode(abpt, args.result)
    abpt.cons_algrm = args.cons_algrm
    if not 1 <= args.maxnum_cons <= 10:
        raise ValueError("max number of consensus sequences should be 1~10")
    abpt.max_n_cons = args.maxnum_cons
    abpt.min_freq = args.min_freq
    abpt.device = args.device
    abpt.lockstep = args.lockstep
    return abpt


def serve_main(argv) -> int:
    """`python -m abpoa_tpu_torch serve`: serve until SIGTERM, SIGINT or
    SIGHUP, then drain (new requests 503, in-flight ones finish), flush the
    metrics and the archive and exit 0. No usable card, a mesh the devices
    cannot give or a kernel library that cannot load is rc 1 before
    /readyz says 200; a card lost while serving ends the server with rc 1
    after its drain."""
    args = _build_parser().parse_args(argv)
    try:
        abpt = _params_from_args(args).finalize()
    except (ValueError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    metrics_path = None
    try:
        server = AlignServer(abpt, host=args.host, port=args.port,
                             workers=args.workers,
                             queue_depth=args.queue_depth,
                             deadline_s=args.deadline_s,
                             trace_dir=args.trace_dir,
                             map_graph=args.map_graph,
                             mesh=args.mesh)
    except OSError as e:
        print(f"Error: cannot bind {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 1

    def _on_signal(signum, _frame):
        print(f"[abpoa_tpu_torch serve] signal {signum}: draining "
              "(no new admissions; in-flight requests finish)",
              file=sys.stderr)
        server.begin_drain()
        server.signalled.set()
        server.stop_requested.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _on_signal)
    try:
        # printed before the warm: the port is known once bound (--port 0
        # picks one); /readyz answers 503 until the warm ends
        print(f"[abpoa_tpu_torch serve] listening on "
              f"http://{server.host}:{server.port} "
              f"(workers={args.workers}, queue="
              f"{server.admission._max_depth}, "
              f"deadline={server.deadline_s:.0f}s, device={abpt.device})",
              file=sys.stderr, flush=True)
        try:
            server.start(warm=args.warm)
        except (RuntimeError, ValueError, OSError) as e:
            # a card, mesh, kernel library or map graph that cannot serve
            print(f"Error: {type(e).__name__}: {e}", file=sys.stderr)
            server.shutdown_http()
            return 1
        if args.metrics is not None:
            metrics_path = args.metrics or obs.metrics.default_textfile_path()
            os.makedirs(os.path.dirname(metrics_path) or ".", exist_ok=True)
            obs.metrics.start_textfile_exporter(metrics_path)
        server.stop_requested.wait()
        drained = server.drain()
        if server.lost_card:
            # the front answers 503 for the rest of the grace, unless a
            # signal cuts it short
            server.signalled.wait(max(0.0, drain_grace_s() - (
                time.perf_counter() - server.lost_at)))
        server.shutdown_http()
        if not drained:
            print("[abpoa_tpu_torch serve] Warning: drain grace expired "
                  "with work still in flight", file=sys.stderr)
    finally:
        if metrics_path is not None:
            obs.metrics.stop_textfile_exporter()
        # the served window's roll-up, beside its request records
        rep = obs.finalize_report()
        obs.archive.append_report(rep, label="serve", device=abpt.device)
    served = server.stats()
    total = sum(served.values())
    counts = " ".join(f"{k}={v}" for k, v in sorted(served.items()))
    if server.lost_card:
        print(f"[abpoa_tpu_torch serve] the card was lost "
              f"({server.lost_card}): exiting 1 after {total} requests "
              f"{counts}", file=sys.stderr)
        return 1
    print(f"[abpoa_tpu_torch serve] drained clean: {total} requests "
          + counts, file=sys.stderr)
    return 0
