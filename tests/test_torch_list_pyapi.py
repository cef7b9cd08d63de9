"""File lists (`-l`), the graph plot (`-g`) and the Python API on the CPU.

- `-l tests/data/list.txt`, run from the repository root as the list names
  its files, reproduces list_mode.txt; a list holding an empty file, a
  truncated FASTQ record or more reads than the cap gives the JAX CLI's
  stdout, quarantine line and exit code, alone and beside a good file;
  each set by set (`--lockstep auto` on the CPU) and in split lockstep
  (`--lockstep on`);
- `-g`'s .dot file equals the JAX CLI's;
- `pyapi.msa_aligner` equals the JAX package's on the cases of
  tests/test_pyapi.py (consensus, MSA rows, `msa_align` + `msa_add`, two
  consensus sequences, `msa_batch`), and `msa_batch`, set by set or in
  lockstep, equals `msa` set by set; aligners in local and extend mode (B2's local and extend modes)
  equal the JAX package's.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR, GOLDEN_DIR

from abpoa_tpu_torch import cli
from abpoa_tpu_torch import pyapi as tpa
from abpoa_tpu_torch.align import banded

from test_pyapi import _read_seqs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    """(rc, stdout, stderr) of a CLI's main."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _jax_main(argv):
    from abpoa_tpu.cli import main
    return _run(main, argv + ["--device", "numpy"])


def _port_main(argv):
    return _run(cli.main, argv + ["--device", "cpu"])


def _quarantine_lines(err):
    return [ln for ln in err.splitlines() if "quarantined:" in ln]


@pytest.mark.parametrize("lockstep", ["auto", "on"])
def test_list_mode_reproduces_golden(monkeypatch, lockstep):
    """`auto` runs set by set on the CPU, `on` in split lockstep."""
    monkeypatch.chdir(ROOT)
    rc, out, _ = _port_main([os.path.join("tests", "data", "list.txt"), "-l",
                             "--lockstep", lockstep])
    with open(os.path.join(GOLDEN_DIR, "list_mode.txt")) as fp:
        assert (rc, out) == (0, fp.read())


# a set each check of validate_records quarantines: no records, a FASTQ
# record whose quality is shorter than its sequence, more reads than the
# cap (ABPOA_TPU_MAX_READS, set to seq.fa's 10 reads)
POISON = {"empty": "",
          "truncated": "@r\nACGTACGT\n+\nIIII\n",
          "cap": "".join(f">r{i}\nACGTACGT\n" for i in range(11))}


@pytest.mark.parametrize("lockstep", ["auto", "on"])
@pytest.mark.parametrize("files,want_rc", [(["empty.fa"], 1),
                                           (["empty.fa", "seq.fa"], 0)])
@pytest.mark.parametrize("poison", ["empty", "truncated", "cap"])
def test_list_with_an_empty_file_matches_jax_cli(tmp_path, monkeypatch, files,
                                                 want_rc, poison, lockstep):
    (tmp_path / "empty.fa").write_text(POISON[poison])
    if poison == "cap":
        monkeypatch.setenv("ABPOA_TPU_MAX_READS", "10")
    paths = [str(tmp_path / f) if f == "empty.fa" else os.path.join(DATA_DIR, f)
             for f in files]
    lst = tmp_path / "list.txt"
    lst.write_text("".join(p + "\n" for p in paths))
    rc, out, err = _port_main([str(lst), "-l", "--lockstep", lockstep])
    jrc, jout, jerr = _jax_main([str(lst), "-l"])
    assert (rc, out) == (jrc, jout)
    assert rc == want_rc
    assert _quarantine_lines(err) == _quarantine_lines(jerr) != []
    assert "1 of %d read sets quarantined" % len(files) in err


def test_one_empty_file_is_one_error_line(tmp_path):
    path = tmp_path / "empty.fa"
    path.write_text("")
    rc, out, err = _port_main([str(path)])
    jrc, jout, jerr = _jax_main([str(path)])
    assert (rc, out) == (jrc, jout) == (1, "")
    assert err.splitlines()[0] == jerr.splitlines()[0]


def test_graph_plot_dot_matches_jax_cli(tmp_path):
    port, jax = tmp_path / "port.png", tmp_path / "jax.png"
    rc, out, _ = _port_main([os.path.join(DATA_DIR, "seq.fa"), "-g", str(port)])
    jrc, jout, _ = _jax_main([os.path.join(DATA_DIR, "seq.fa"), "-g", str(jax)])
    assert (rc, out) == (jrc, jout) == (0, out)
    text = (tmp_path / "port.png.dot").read_text()
    assert text == (tmp_path / "jax.png.dot").read_text()
    assert "digraph ABPOA_graph" in text and "rank=same" in text


# ---- the Python API ------------------------------------------------------------

def _seqs(fa):
    return _read_seqs(os.path.join(DATA_DIR, fa))


def _pair(**kw):
    import abpoa_tpu.pyapi as jpa
    return tpa.msa_aligner(device="cpu", **kw), jpa.msa_aligner(**kw)


def _same(got, want):
    assert vars(got) == vars(want)


def test_pyapi_consensus_matches_golden_and_jax():
    a, b = _pair()
    b2 = banded.stats["reads"]
    res = a.msa(_seqs("seq.fa"), out_cons=True, out_msa=False)
    assert banded.stats["reads"] - b2 == 9  # B2 aligned every read but the first
    with open(os.path.join(GOLDEN_DIR, "ref_consensus.txt")) as fp:
        assert res.cons_seq == [fp.read().splitlines()[1]]
    _same(res, b.msa(_seqs("seq.fa"), out_cons=True, out_msa=False))


def test_pyapi_msa_rows_match_jax(capsys):
    a, b = _pair()
    res = a.msa(_seqs("seq.fa"), out_cons=True, out_msa=True)
    want = b.msa(_seqs("seq.fa"), out_cons=True, out_msa=True)
    _same(res, want)
    assert res.msa_len > 0 and len(res.msa_seq) == 11
    res.print_msa()
    got = capsys.readouterr().out
    want.print_msa()
    assert got == capsys.readouterr().out


def test_pyapi_incremental_add_matches_jax():
    seqs = _seqs("seq.fa")
    a, b = _pair()
    a.msa_align(seqs[:5], out_cons=True, out_msa=False).msa_add(seqs[5:])
    b.msa_align(seqs[:5], out_cons=True, out_msa=False).msa_add(seqs[5:])
    res = a.msa_output()
    _same(res, b.msa_output())
    assert res.cons_seq == tpa.msa_aligner(device="cpu").msa(
        seqs, out_cons=True, out_msa=False).cons_seq


def test_pyapi_two_consensus_match_jax():
    a, b = _pair()
    res = a.msa(_seqs("heter.fa"), out_cons=True, out_msa=False, max_n_cons=2)
    _same(res, b.msa(_seqs("heter.fa"), out_cons=True, out_msa=False,
                     max_n_cons=2))
    with open(os.path.join(GOLDEN_DIR, "ref_heter.txt")) as fp:
        lines = fp.read().splitlines()
    assert res.cons_seq == [lines[1], lines[3]]


@pytest.mark.parametrize("lockstep", ["off", "on"])
def test_pyapi_msa_batch_equals_msa_set_by_set(lockstep):
    """tests/test_pyapi.py's sets (two length buckets), set by set or in
    split lockstep; an empty read quarantines its set alone."""
    def mkset(seed, n=4, L=120):
        r = np.random.default_rng(seed)
        ref = r.integers(0, 4, L)
        return ["".join("ACGT"[(b + r.integers(1, 4)) % 4]
                        if r.random() < 0.1 else "ACGT"[b] for b in ref)
                for _ in range(n)]

    sets = [mkset(0), mkset(1, L=400), mkset(2), ["ACGT", ""]]
    a, b = _pair(lockstep=lockstep)
    batch = a.msa_batch(sets, out_cons=True, out_msa=True)
    assert batch[3] is None
    for k, ss in enumerate(sets[:3]):
        want = tpa.msa_aligner(device="cpu").msa(ss, out_cons=True, out_msa=True)
        _same(batch[k], want)
        _same(batch[k], b.msa(ss, out_cons=True, out_msa=True))


@pytest.mark.parametrize("kw", [{"aln_mode": "l"}, {"aln_mode": "e"},
                                {"aln_mode": "e", "gap_open1": 0}])
def test_pyapi_outside_b2_raises_before_aligning(kw):
    """Aligners in local and extend mode, once refused, equal the JAX
    package's, every read but the first aligned by B2."""
    a, b = _pair(**kw)
    b2 = banded.stats["reads"]
    res = a.msa(_seqs("seq.fa"), out_cons=True, out_msa=True)
    assert banded.stats["reads"] - b2 == 9
    _same(res, b.msa(_seqs("seq.fa"), out_cons=True, out_msa=True))


def test_pyapi_default_device_is_the_card():
    assert tpa.msa_aligner().abpt.device == "cuda"
