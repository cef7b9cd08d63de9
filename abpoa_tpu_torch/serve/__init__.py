"""`python -m abpoa_tpu_torch serve`: the aligner as a service on the card.

Counterpart of `abpoa_tpu/serve/` without the fleet and the router: a
stdlib HTTP server (ThreadingHTTPServer) that takes read sets and keeps
its contract under overload and faults.

- **Admission** (admission.py): a bounded queue priced in the card's
  bytes by the port's memory model; past the depth or the budget a
  request is shed as 429 + Retry-After.
- **Deadlines**: every request has one (ABPOA_TPU_SERVE_DEADLINE_S, the
  ``X-Abpoa-Deadline-S`` header caps it); expiry answers 504 and abandons
  the thread.
- **Coalescing** (server.py): queued requests of one `qp_rung` run as one
  lockstep group (the device lockstep on the card), or board an in-flight
  group on the split driver at a round boundary.
- **Isolation**: a poisoned set is a 400, an error a 500 with a fault
  record; the worker lives on.
- **The card**: nothing moves to the host. A card lost while serving ends
  the server (rc 1) after a drain that answers every waiting request.
- **Drain**: SIGTERM, SIGINT or SIGHUP stops admission (503), finishes the
  requests in flight, flushes the metrics and the archive, and exits 0.

Each terminal request lands one `obs/archive.py` record, so `slo`
evaluates the served window and `why <request-id>` explains a request.
"""
from .admission import AdmissionController, Job, request_caps
from .server import AlignServer, serve_main

__all__ = ["AdmissionController", "Job", "request_caps", "AlignServer",
           "serve_main"]
