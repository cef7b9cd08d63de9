"""Bounded, memory-priced admission for the server.

Counterpart of `abpoa_tpu/serve/admission.py` (`Job`, `AdmissionController`
:172, `request_caps`, `map_request_bytes`, `default_deadline_s`), priced
with the port's own model. Two limits, both checked before a request costs
anything:

- queue depth (``ABPOA_TPU_SERVE_QUEUE``, default 64): arrivals past a
  full queue are shed as 429, so latency stays bounded instead of a
  backlog building without end.
- device bytes: each request is priced with `resilience/memory.py` over
  the shapes the route it takes would allocate (`request_caps`, from
  `fused_loop.plan_dispatch_footprint`: the fused loop's state, B1's five
  planes, its tables and the read batch; the per-read route's B2 planes
  for a set that route takes; for `/map`, B2's int32 planes over the map
  graph's rows, a read each), and the sum over queued and in-flight
  requests must fit the budget. The server sets the budget once, after
  its warm: ``ABPOA_TPU_SERVE_MEM_BUDGET_MB`` where set (0 turns the gate
  off), else `memory.budget_bytes(dev)`, 90 % of the card's free memory
  (none on the CPU). So two requests cannot both pass the fused route's
  own admission against the same free memory and then run out of it. A
  lone request is always admissible: at dispatch the route's own
  admission still sends it to the per-read route or stops it, so the gate
  bounds concurrency and never wedges the server on one large set.
  A request whose deadline abandoned the thread running it (504) is
  answered and leaves the queue's accounting, but that thread goes on
  allocating on the card: its bytes stay on the gate (`hold`, `abandon`)
  until the thread returns, and while they do no request is lone.

Rejections carry a Retry-After from the observed service rate (queue depth
x the recent mean service time). `claim_joiners` lets an in-flight group
on the split driver take same-rung jobs onto freed lanes at a round
boundary, priced against the group's live bytes.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

from ..resilience import memory


def queue_limit() -> int:
    return max(1, int(os.environ.get("ABPOA_TPU_SERVE_QUEUE", "64")))


def default_deadline_s() -> float:
    """A request's wall deadline (admission wait + execution)."""
    return float(os.environ.get("ABPOA_TPU_SERVE_DEADLINE_S", "30"))


def serve_budget_bytes(dev=None) -> Optional[int]:
    """The byte budget over queued + in-flight requests:
    ABPOA_TPU_SERVE_MEM_BUDGET_MB where set (0: no gate), else
    `memory.budget_bytes(dev)` (90 % of the card's free memory; None off
    the card)."""
    env = os.environ.get("ABPOA_TPU_SERVE_MEM_BUDGET_MB")
    if env is not None:
        mb = float(env)
        return int(mb * 1e6) if mb > 0 else None
    return memory.budget_bytes(dev)


def request_caps(abpt, records) -> dict:
    """The shapes one `/align` request's dispatch starts from: the fused
    planner's (`fused_loop.plan_dispatch_footprint`), so the gate cannot
    drift from what the route allocates."""
    from ..align.fused_loop import plan_dispatch_footprint
    return plan_dispatch_footprint(abpt, [[r.seq for r in records]])


def request_bytes(abpt, records) -> int:
    """A `/align` request's device bytes: the fused route's estimate, or
    the per-read route's where the set does not take the fused route."""
    from ..align.eligibility import fused_eligible
    caps = request_caps(abpt, records)
    if fused_eligible(abpt, len(records)):
        return memory.estimate_bytes(caps)
    return memory.per_read_bytes(caps)


def map_request_bytes(abpt, records, n_rows: int) -> int:
    """A `/map` request's device bytes, its reads' share only: the graph
    half of the map tables is priced once, at the restore. A read costs
    B2's five int32 planes over the graph's `n_rows` rows at its first
    band (`W2`), the rows' beg/end, and the read with its query profile."""
    caps = request_caps(abpt, records)
    per_read = (memory.plane_bytes(n_rows, caps["W2"], False) + 2 * n_rows * 4
                + memory.read_bytes(1, caps["Qp"], abpt.m))
    return len(records) * per_read


class Job:
    """One admitted alignment request moving through the queue."""

    _ids = itertools.count(1)

    __slots__ = ("id", "label", "records", "n_reads", "rung", "est_bytes",
                 "eligible", "deadline_s", "t_arrive", "done", "status",
                 "body", "error", "_lock", "_done_marked",
                 "rid", "t_pickup", "qmax",
                 "join_round", "join_group", "kind")

    def __init__(self, records, rung: int, est_bytes: int, eligible: bool,
                 deadline_s: float, rid: str = "", qmax: int = 0,
                 kind: str = "consensus") -> None:
        self.id = next(self._ids)
        self.label = f"req-{self.id}"
        # the request id minted at ingress: rides the response header,
        # every span and the archive record — `why <rid>` joins them back
        # up
        self.rid = rid
        self.t_pickup: Optional[float] = None   # set when a worker pops us
        # raw max query length (bp): the scheduler's serial-vs-lockstep
        # crossover input — rung alone is too coarse (geom-128 snapped)
        self.qmax = qmax
        # continuous batching: set when this request boarded an
        # in-flight lockstep group at a round boundary instead of being
        # coalesced at pickup — `why` renders "joined group g at round r"
        self.join_round: Optional[int] = None
        self.join_group: Optional[int] = None
        # workload class: "consensus" (POST /align) or "map"
        # (POST /map — fixed-graph read mapping). Groups are kind-
        # homogeneous: a map lane retires every round while a consensus
        # lane drains for many, so mixing them would re-create exactly
        # the divergence the noop K cap exists to suppress.
        self.kind = kind
        self.records = records
        self.n_reads = len(records)
        self.rung = rung
        self.est_bytes = est_bytes
        self.eligible = eligible
        self.deadline_s = deadline_s
        self.t_arrive = time.perf_counter()
        self.done = threading.Event()
        self.status: Optional[str] = None
        self.body = ""
        self.error = ""
        self._lock = threading.Lock()
        self._done_marked = False   # owned by AdmissionController._cv

    def remaining_s(self) -> float:
        return self.deadline_s - (time.perf_counter() - self.t_arrive)

    def wall_s(self) -> float:
        return time.perf_counter() - self.t_arrive

    def finish(self, status: str, body: str = "", error: str = "") -> bool:
        """First writer wins: the worker and the handler's safety-net
        timeout can both try to conclude a job; exactly one does."""
        with self._lock:
            if self.status is not None:
                return False
            self.status = status
            self.body = body
            self.error = error
        self.done.set()
        return True


class ByteHold:
    """The bytes of the jobs one supervised call runs: counted on the gate
    from `abandon` (the deadline gave the call's thread up) until
    `release` (the call returned), and never where it returned first."""

    __slots__ = ("bytes", "state")

    def __init__(self, n_bytes: int) -> None:
        self.bytes = n_bytes
        self.state = "running"   # -> "abandoned" -> "returned"


class AdmissionController:
    """The bounded queue + its accounting. All state under one condition
    variable; every mutation republishes the queue/inflight gauges."""

    def __init__(self, abpt, max_depth: Optional[int] = None,
                 budget_bytes: Optional[int] = None,
                 mesh: int = 1) -> None:
        self._abpt = abpt
        self._cv = threading.Condition()
        self._queue: Deque[Job] = deque()
        self._max_depth = max_depth if max_depth is not None else queue_limit()
        self._budget: Optional[int] = None
        self.set_budget(budget_bytes, mesh)
        self._bytes = 0          # queued + in-flight estimate
        self._abandoned = 0      # bytes of abandoned calls still running
        self._inflight = 0
        self._closed = False
        self._service_ewma_s = 0.05   # Retry-After seed, updated on done

    def set_budget(self, budget_bytes: Optional[int], mesh: int = 1) -> None:
        """The byte gate (None or 0: off). On the sharded route it prices
        the whole mesh: each device holds its slice of the lanes, so the
        budget scales to mesh x a device's."""
        with self._cv:
            self._budget = (budget_bytes * max(1, int(mesh))
                            if budget_bytes else None)

    @property
    def budget(self) -> Optional[int]:
        return self._budget

    # ------------------------------------------------------------- intake
    def try_admit(self, job: Job) -> Tuple[bool, str, float]:
        """-> (admitted, reason, retry_after_s). Reasons: "", "draining",
        "queue_full", "memory"."""
        from ..obs import metrics
        with self._cv:
            if self._closed:
                return False, "draining", 0.0
            if len(self._queue) >= self._max_depth:
                return False, "queue_full", self._retry_after_locked()
            held = self._bytes + self._abandoned
            if (self._budget and held > 0
                    and held + job.est_bytes > self._budget):
                return False, "memory", self._retry_after_locked()
            self._queue.append(job)
            self._bytes += job.est_bytes
            self._publish_locked()
            self._cv.notify()
        metrics.publish_serve_admitted()
        return True, "", 0.0

    def _retry_after_locked(self) -> float:
        # the backlog's expected drain time: what a 429 tells the client
        backlog = len(self._queue) + self._inflight
        return max(1.0, round(backlog * self._service_ewma_s, 1))

    def drop_queued(self) -> List[Job]:
        """Take every queued job out of the queue (the card was lost: they
        are answered 503, never run) and release their bytes."""
        with self._cv:
            jobs = list(self._queue)
            self._queue.clear()
            for job in jobs:
                job._done_marked = True
                self._bytes -= job.est_bytes
            self._publish_locked()
            self._cv.notify_all()
        return jobs

    def close_intake(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------------------- workers
    def next_group(self, max_k: int = 1, coalesce: bool = False,
                   timeout: float = 0.25, min_qlen: int = 0) -> List[Job]:
        """Pop the head job, plus (when coalescing) up to max_k-1 more
        queued jobs sharing its Qp rung — the lockstep pack. Returns []
        on timeout or closed-and-empty so workers can re-check shutdown.

        min_qlen is the scheduler's serial-vs-lockstep crossover: a head
        below it runs serial, so coalescing it into a lockstep pack would
        only slow it down (jobs with unknown qmax=0 are not gated)."""
        with self._cv:
            if not self._queue:
                if self._closed:
                    return []
                self._cv.wait(timeout)
                if not self._queue:
                    return []
            head = self._queue.popleft()
            group = [head]
            # the serial-wins qlen crossover is a consensus-path economy
            # (per-round host fusion to amortize); a map round has no
            # fusion, so short map reads still batch
            if (coalesce and head.kind != "map"
                    and head.qmax and head.qmax < min_qlen):
                coalesce = False
            if coalesce and head.eligible and max_k > 1:
                for job in list(self._queue):
                    if len(group) >= max_k:
                        break
                    if (job.eligible and job.rung == head.rung
                            and job.kind == head.kind):
                        self._queue.remove(job)
                        group.append(job)
            self._inflight += len(group)
            now = time.perf_counter()
            for job in group:
                # admission wait ends here; the server records the
                # admission_wait span from (t_arrive, t_pickup) so queue
                # time is attributable per request
                job.t_pickup = now
            self._publish_locked()
            return group

    def claim_joiners(self, rung: int, max_n: int,
                      live_bytes: int = 0,
                      min_remaining_s: float = 0.5,
                      kind: str = "consensus") -> List[Job]:
        """Continuous batching: pull up to max_n queued jobs onto
        the free lanes of an in-flight lockstep group at its round
        boundary. A joiner must share the group's Qp rung, be lockstep-
        eligible, have at least min_remaining_s of deadline left (a
        near-dead request boarding a multi-round group would just 504 on a
        lane), and fit the byte budget priced against the LIVE group
        (live_bytes = sum over the group's currently-live lanes — early
        retires have already released their share), not the pickup-time
        snapshot. Claimed jobs leave the queue and count in-flight, same
        accounting as next_group."""
        claimed: List[Job] = []
        with self._cv:
            if max_n <= 0:
                return claimed
            priced = live_bytes + self._abandoned
            for job in list(self._queue):
                if len(claimed) >= max_n:
                    break
                if (not job.eligible or job.rung != rung
                        or job.kind != kind):
                    continue
                if job.remaining_s() <= min_remaining_s:
                    continue
                if (self._budget and priced > 0
                        and priced + job.est_bytes > self._budget):
                    continue
                self._queue.remove(job)
                priced += job.est_bytes
                claimed.append(job)
            if claimed:
                self._inflight += len(claimed)
                now = time.perf_counter()
                for job in claimed:
                    job.t_pickup = now
                self._publish_locked()
        return claimed

    def mark_done(self, job: Job, service_s: Optional[float] = None) -> None:
        """Release one job's accounting. Idempotent per job: the worker's
        catch-all sweep can overlap the per-job finally blocks, and a
        double release would drive _inflight/_bytes negative — silently
        disabling the byte gate and wedging wait_drained."""
        with self._cv:
            if job._done_marked:
                return
            job._done_marked = True
            self._bytes -= job.est_bytes
            self._inflight -= 1
            if service_s is not None:
                self._service_ewma_s += 0.2 * (service_s
                                               - self._service_ewma_s)
            self._publish_locked()
            self._cv.notify_all()

    def hold(self, jobs: List[Job]) -> ByteHold:
        """A hold over the bytes of the jobs a supervised call runs; the
        call's thread gives it `release` when it returns."""
        return ByteHold(sum(job.est_bytes for job in jobs))

    def abandon(self, hold: ByteHold) -> None:
        """The deadline gave the call up: its bytes stay on the gate until
        it returns (`release`), after its jobs' `mark_done`."""
        with self._cv:
            if hold.state == "running":
                hold.state = "abandoned"
                self._abandoned += hold.bytes

    def release(self, hold: ByteHold) -> None:
        """The supervised call returned: an abandoned call's bytes leave
        the gate."""
        with self._cv:
            if hold.state == "abandoned":
                self._abandoned -= hold.bytes
                self._cv.notify_all()
            hold.state = "returned"

    # ------------------------------------------------------------- state
    def _publish_locked(self) -> None:
        from ..obs import metrics
        metrics.publish_serve_state(len(self._queue), self._inflight)

    def snapshot(self) -> Tuple[int, int]:
        with self._cv:
            return len(self._queue), self._inflight

    def drained(self) -> bool:
        with self._cv:
            return not self._queue and self._inflight == 0

    def wait_drained(self, timeout: float) -> bool:
        """Block until queue + in-flight are empty (the drain barrier)."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._queue and self._inflight == 0, timeout)
