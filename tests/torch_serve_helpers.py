"""HTTP and process helpers the server tests of the port share
(test_torch_serve*.py, test_torch_why.py)."""
import io
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

from conftest import DATA_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_FA = os.path.join(DATA_DIR, "test.fa")
POISON_FQ = b"@truncated\nACGTACGT\n+\nIII\n"   # qual length != seq length


def post(base, body, path="/align", headers=None, timeout=60):
    req = urllib.request.Request(base + path, data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def get_json(base, path, timeout=10):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_text(base, path, timeout=10):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.read().decode()


def base_of(srv):
    return f"http://127.0.0.1:{srv.port}"


def port_params(device="cpu", **kw):
    from abpoa_tpu_torch.params import Params
    abpt = Params(device=device)
    for k, v in kw.items():
        setattr(abpt, k, v)
    return abpt


def port_server(abpt=None, **kw):
    from abpoa_tpu_torch.serve import AlignServer
    srv = AlignServer(abpt or port_params(), port=0, **kw)
    srv.start(warm="off")
    return srv


def port_bytes(path_or_records, abpt=None):
    """What the port's pipeline writes for one read set on the CPU: the
    CLI's bytes."""
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.pipeline import Abpoa, msa
    records = (read_fastx(path_or_records)
               if isinstance(path_or_records, str) else path_or_records)
    buf = io.StringIO()
    msa(Abpoa(), (abpt or port_params()).finalize(), records, buf)
    return buf.getvalue().encode()


def fasta_bytes(records) -> bytes:
    return "".join(f">{r.name}\n{r.seq}\n" for r in records).encode()


def slow_single(monkeypatch, seconds):
    """Hold each lone request in flight `seconds` longer: the server's
    `_run_single` sleeps first. Returns the dict whose "s" a test may
    change meanwhile."""
    from abpoa_tpu_torch.serve.server import AlignServer
    delay = {"s": seconds}
    run = AlignServer._run_single

    def slowed(self, job, abpt):
        time.sleep(delay["s"])
        return run(self, job, abpt)
    monkeypatch.setattr(AlignServer, "_run_single", slowed)
    return delay


# `serve` in a child whose lone requests sleep argv[1] seconds first
_SLOW_SERVE_CHILD = """
import sys, time
from abpoa_tpu_torch.serve.server import AlignServer
delay, run = float(sys.argv[1]), AlignServer._run_single

def slowed(self, job, abpt):
    time.sleep(delay)
    return run(self, job, abpt)

AlignServer._run_single = slowed
from abpoa_tpu_torch.cli import main
sys.exit(main(["serve"] + sys.argv[2:]))
"""


def start_serve_process(args, env, module="abpoa_tpu_torch", delay_s=0.0):
    """`python -m <module> serve <args>` in a child, or with `delay_s` the
    port's `serve` with each lone request held that long
    (`slow_single`'s patch); returns (proc, port) once it prints its
    listening line."""
    cmd = ([sys.executable, "-c", _SLOW_SERVE_CHILD, str(delay_s)]
           if delay_s else [sys.executable, "-m", module, "serve"])
    proc = subprocess.Popen(
        [*cmd, "--port", "0", *args],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    port = None
    deadline = time.time() + 60
    while time.time() < deadline:
        line = proc.stderr.readline()
        if not line and proc.poll() is not None:
            break
        if "listening on http://" in line:
            port = int(line.split("listening on http://")[1]
                       .split()[0].rsplit(":", 1)[1])
            break
    return proc, port


def wait_ready(base, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if urllib.request.urlopen(base + "/readyz", timeout=2).status \
                    == 200:
                return True
        except (urllib.error.URLError, OSError):
            time.sleep(0.1)
    return False
