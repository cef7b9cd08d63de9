"""`-l` and `msa_batch` in split lockstep on the CPU, through the entry
points a user calls:
- `-l --lockstep on --device cpu` over a list of four sets (three of one
  query rung, heter.fa of another) equals `--lockstep off` (each set on
  its single-set route) and the JAX CLI, byte for byte, in the default
  consensus, `-r 1` (MSA), `-r 3` (GFA), `-m 1` (local, unbanded B2) and
  `-d 2`, with the lockstep groups launched;
- K stays ABPOA_TPU_LOCKSTEP_K for every segment of a list longer than K;
- `-m 2 -z 100` (Z-drop) stays set by set under `--lockstep on` with the
  split driver, and joins the device lockstep (ABPOA_TPU_LOCKSTEP_IMPL=
  device); its output is `--lockstep off`'s either way;
- a malformed set in the list is quarantined as with `--lockstep off`;
- `msa_batch` with lockstep on equals the JAX package's `msa_batch`, with
  and without qscores, and runs its sets in lockstep.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch import cli
from abpoa_tpu_torch import pyapi as tpa
from abpoa_tpu_torch.parallel import lockstep

torch.set_num_threads(1)

SETS = ("seq.fa", "test.fa", "seq4.fa", "heter.fa")


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def list_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("lockstep") / "list.txt"
    path.write_text("".join(os.path.join(DATA_DIR, f) + "\n" for f in SETS))
    return str(path)


@pytest.mark.parametrize("flags", [[], ["-r", "1"], ["-r", "3"], ["-m", "1"],
                                   ["-d", "2"]],
                         ids=["cons", "r1", "r3", "m1", "d2"])
def test_list_lockstep_equals_set_by_set_and_jax(list_file, flags):
    from abpoa_tpu.cli import main as jax_main
    argv = [list_file, "-l", *flags, "--device", "cpu"]
    groups = lockstep.stats["groups"]
    on = _run(cli.main, argv + ["--lockstep", "on"])
    assert lockstep.stats["groups"] - groups == 2   # one a query rung
    off = _run(cli.main, argv + ["--lockstep", "off"])
    assert lockstep.stats["groups"] - groups == 2   # none more
    want = _run(jax_main, [list_file, "-l", *flags, "--device", "numpy"])
    assert on[:2] == off[:2] == want[:2]
    assert on[0] == 0 and on[1]


@pytest.mark.parametrize("k,groups", [(1, 4), (2, 3)], ids=["k1", "k2"])
def test_list_lockstep_keeps_k_fixed(list_file, monkeypatch, k, groups):
    """Segments of K sets, each split by query rung: K 1 gives one group a
    set; K 2 gives (seq, test) and (seq4 | heter.fa's rung)."""
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_K", str(k))
    argv = [list_file, "-l", "-r", "1", "--device", "cpu"]
    before = lockstep.stats["groups"]
    on = _run(cli.main, argv + ["--lockstep", "on"])
    assert lockstep.stats["groups"] - before == groups
    off = _run(cli.main, argv + ["--lockstep", "off"])
    assert on[:2] == off[:2] and on[0] == 0 and on[1]


@pytest.mark.parametrize("impl", ["split", "device"])
def test_list_zdrop_stays_set_by_set(tmp_path, monkeypatch, impl):
    """rcmix.fa's per-read and fused outputs differ under `-m 2 -z 100`
    (ROADMAP.md §C): the split driver would give the per-read route's, so
    with it lockstep leaves Z-drop to the set-by-set route; the device
    lockstep gives the fused route's, so Z-drop joins it, as in JAX. The
    output equals `--lockstep off` either way."""
    from abpoa_tpu_torch.align import fused_loop as tfl
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", impl)
    lst = tmp_path / "list.txt"
    lst.write_text("".join(os.path.join(DATA_DIR, f) + "\n"
                           for f in ("rcmix.fa", "seq.fa")))
    argv = [str(lst), "-l", "-m", "2", "-z", "100", "-r", "1",
            "--device", "cpu"]
    before = lockstep.stats["groups"]
    tfl.reset_stats()
    on = _run(cli.main, argv + ["--lockstep", "on"])
    assert lockstep.stats["groups"] == before
    assert (tfl.stats["rounds"] > 0) == (impl == "device")
    off = _run(cli.main, argv + ["--lockstep", "off"])
    assert on[:2] == off[:2] and on[0] == 0 and on[1]


def test_list_lockstep_quarantines_a_malformed_set(tmp_path):
    bad = tmp_path / "bad.fq"
    bad.write_text("@r\nACGTACGT\n+\nIIII\n")
    lst = tmp_path / "list.txt"
    lst.write_text(f"{os.path.join(DATA_DIR, 'seq.fa')}\n{bad}\n"
                   f"{os.path.join(DATA_DIR, 'test.fa')}\n")
    argv = [str(lst), "-l", "--device", "cpu"]
    on = _run(cli.main, argv + ["--lockstep", "on"])
    off = _run(cli.main, argv + ["--lockstep", "off"])
    assert on[:2] == off[:2] and on[0] == 0
    assert "set 1 (" in on[2] and "quarantined" in on[2]


def _mkset(seed, n=4, L=120):
    r = np.random.default_rng(seed)
    ref = r.integers(0, 4, L)
    return ["".join("ACGT"[(b + r.integers(1, 4)) % 4]
                    if r.random() < 0.1 else "ACGT"[b] for b in ref)
            for _ in range(n)]


@pytest.mark.parametrize("qv", [False, True], ids=["plain", "qscores"])
def test_msa_batch_lockstep_equals_jax(qv):
    import abpoa_tpu.pyapi as jpa
    sets = [_mkset(0), _mkset(1, L=400), _mkset(2), _mkset(3, n=6)]
    qs = None
    if qv:
        r = np.random.default_rng(4)
        qs = [[r.integers(1, 40, len(s)).tolist() for s in ss] for ss in sets]
    groups = lockstep.stats["groups"]
    got = tpa.msa_aligner(device="cpu", lockstep="on").msa_batch(
        sets, out_cons=True, out_msa=True, qscores_sets=qs)
    assert lockstep.stats["groups"] - groups == 2   # two query rungs
    want = jpa.msa_aligner().msa_batch(sets, out_cons=True, out_msa=True,
                                       qscores_sets=qs)
    for g, w in zip(got, want):
        assert vars(g) == vars(w)
