"""The server's concurrency on the card (`cuda` marker; every test skips
without a card). Two threads share one card there, and each call takes
the page-locked buffer X1w's results come back through from a locked
free list (`banded._take_staging`): two threads in
`align_windows_banded` at once must each get the answer the same call
gives alone. A two-worker server's
concurrent per-read (`-G`) and split-driver requests each equal their
serial answer. This file imports no JAX, so the card machine collects it.

    pytest -m cuda tests/test_torch_serve_twins.py    # on the card
"""
import io
import os
import threading

import numpy as np
import pytest
import torch

from conftest import DATA_DIR
from torch_serve_helpers import base_of, fasta_bytes, post

FILES = ("sim2k.fa", "rcmix.fa", "heter.fa", "seq.fa")


@pytest.fixture(scope="module", autouse=True)
def _card_present():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(autouse=True)
def _no_archive(monkeypatch):
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def _params(**kw):
    from abpoa_tpu_torch.params import Params
    return Params(device="cuda", **kw).finalize()


def _graph_and_queries(abpt, name, n_graph=6, n_q=4):
    """A sorted native graph of the file's first reads and its next reads
    as whole-graph windows."""
    from abpoa_tpu_torch.align.banded import align_sequence_to_subgraph
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.native.graph import NativePOAGraph
    recs = read_fastx(os.path.join(DATA_DIR, name))
    enc = [abpt.char_to_code[np.frombuffer(r.seq.encode(), np.uint8)]
           .astype(np.uint8) for r in recs]
    g = NativePOAGraph()
    for q in enc[:n_graph]:
        cigar = (align_sequence_to_subgraph(g, abpt, 0, 1, q).cigar
                 if g.node_n > 2 else [])
        g.add_alignment(abpt, q, None, cigar, True)
    g.topological_sort(abpt)
    return g, [(0, 1, q) for q in enc[n_graph:n_graph + n_q]]


def _key(results):
    return [(r.best_score, list(map(int, r.cigar)), r.n_aln_bases,
             r.n_matched_bases) for r in results]


@pytest.mark.cuda
def test_two_threads_in_align_windows_banded_at_once():
    """Over 100 rounds two threads (a barrier before each call, and a
    switch interval of 1 us, so that one thread's copy to the host lands
    while the other reads its results) align different graphs' windows;
    each result equals the same call made alone. With one page-locked
    buffer for the process, one thread's X1w results were overwritten by
    the other's."""
    import sys
    from abpoa_tpu_torch.align.banded import align_windows_banded
    abpt = _params()
    cases = [_graph_and_queries(abpt, f, n_q=8)
             for f in ("sim2k.fa", "heter.fa")]
    want = [_key(align_windows_banded(g, abpt, w)) for g, w in cases]
    barrier = threading.Barrier(2, timeout=120)
    bad = []

    def run(i):
        g, w = cases[i]
        for rep in range(100):
            barrier.wait()
            got = _key(align_windows_banded(g, abpt, w))
            if got != want[i]:
                bad.append((i, rep))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not bad, f"{len(bad)} of 200 results differ: {bad[:8]}"


def _serial(abpt, body):
    from abpoa_tpu_torch.io.fastx import read_fastx_text
    from abpoa_tpu_torch.pipeline import Abpoa, msa
    buf = io.StringIO()
    msa(Abpoa(), abpt, read_fastx_text(body.decode()), buf)
    return buf.getvalue().encode()


def _bodies():
    from abpoa_tpu_torch.io.fastx import read_fastx
    return [fasta_bytes(read_fastx(os.path.join(DATA_DIR, f))[:8])
            for f in FILES]


def _concurrent(srv, bodies):
    res = [None] * len(bodies)

    def send(i):
        res[i] = post(base_of(srv), bodies[i], timeout=300)
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["per_read", "split"])
def test_two_worker_server_concurrent_equals_serial(monkeypatch, route):
    """Two workers on one card: per-read requests (-G: B2 and X1w per
    read) or split-driver groups (B2 lanes and X1w, churn on), posted at
    once, each answer the serial run's bytes."""
    from abpoa_tpu_torch.serve import AlignServer
    if route == "split":
        monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", "split")
        monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_MIN_QLEN", "0")
        abpt = _params(lockstep="on")
    else:
        abpt = _params(inc_path_score=True)
    bodies = _bodies()
    want = [_serial(abpt, b) for b in bodies]
    srv = AlignServer(abpt, port=0, workers=2)
    srv.start(warm="off")
    try:
        assert srv._churn == (route == "split")
        res = _concurrent(srv, bodies)
    finally:
        srv.stop()
    assert [r[0] for r in res] == [200] * len(bodies)
    assert [r[1] for r in res] == want
