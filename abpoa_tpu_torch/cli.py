"""abpoa-compatible command line, the subset this package supports:
progressive POA with linear, affine or convex gaps (`-O`/`-E`) in global,
local (`-m 1`) or extend (`-m 2`, Z-drop `-z`) mode, writing consensus
(`-r 0`/`-r 5`), row-column MSA (`-r 1`/`-r 2`) or GFA (`-r 3`/`-r 4`), by
heaviest bundling or majority vote (`-a 1`), with up to 10 clustered
consensus sequences (`-d`, `-q`), qv weights (`-Q`), incremental alignment
onto a restored MSA or GFA (`-i`), the graph plot (`-g`), file lists
(`-l`: K sets in lockstep, `--lockstep`, or one set after another),
minimizer-seeded windows (`-S`, `-k`, `-w`, `-n`), the guide-tree order
(`-p`), path scores (`-G`) and unbanded alignment (`-b < 0`); and the
`map` subcommand, which maps reads against a restored graph and writes one
GAF record a read.

    python -m abpoa_tpu_torch reads.fa [--device cuda|cpu] [-o out.fa]
    python -m abpoa_tpu_torch new.fa -i old.gfa [-r 3]
    python -m abpoa_tpu_torch long_reads.fa -S [-p]
    python -m abpoa_tpu_torch -l list.txt [--lockstep auto|on|off] [--mesh N]
    python -m abpoa_tpu_torch map -g graph.gfa reads.fa [-K 8] [-s] [--mesh N]

With no card and no `--device cpu`, the run raises RuntimeError; so does
`--mesh N` with fewer than N cards (on the CPU, N x cpu). A malformed read set ends a one-file run with one
error line and rc 1; in a `-l` run it is quarantined (one stderr line) and
the run returns 1 only when every set was.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__
from . import constants as C
from .params import Params
from .pipeline import Abpoa, msa_from_file
from .quarantine import QUARANTINE_EXCEPTIONS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m abpoa_tpu_torch",
        description="adaptive banded partial-order alignment consensus, "
                    "progressive loop on the card (PyTorch port of "
                    "abpoa-tpu)",
        add_help=False)
    p.add_argument("input", nargs="?", help="input FASTA/FASTQ")
    p.add_argument("-m", "--aln-mode", type=int, default=C.GLOBAL_MODE)
    p.add_argument("-M", "--match", type=int, default=C.DEFAULT_MATCH)
    p.add_argument("-X", "--mismatch", type=int, default=C.DEFAULT_MISMATCH)
    p.add_argument("-t", "--matrix", type=str, default=None)
    p.add_argument("-O", "--gap-open", type=str, default=None)
    p.add_argument("-E", "--gap-ext", type=str, default=None)
    p.add_argument("-b", "--extra-b", type=int, default=C.EXTRA_B)
    p.add_argument("-f", "--extra-f", type=float, default=C.EXTRA_F)
    p.add_argument("-z", "--zdrop", type=int, default=-1)
    p.add_argument("-e", "--bonus", type=int, default=-1)
    p.add_argument("-G", "--inc-path-score", action="store_true")
    p.add_argument("-L", "--sort-by-len", action="store_true")
    p.add_argument("-R", "--gap-on-right", action="store_true")
    p.add_argument("-J", "--gap-at-end", action="store_true")
    p.add_argument("-Q", "--use-qual-weight", action="store_true")
    p.add_argument("-S", "--seeding", action="store_true")
    p.add_argument("-k", "--k-mer", type=int, default=C.DEFAULT_MMK)
    p.add_argument("-w", "--window", type=int, default=C.DEFAULT_MMW)
    p.add_argument("-n", "--min-poa-win", type=int, default=C.DEFAULT_MIN_POA_WIN)
    p.add_argument("-p", "--progressive", action="store_true")
    p.add_argument("-c", "--amino-acid", action="store_true")
    p.add_argument("-l", "--in-list", action="store_true")
    p.add_argument("-i", "--increment", type=str, default=None)
    p.add_argument("-s", "--amb-strand", action="store_true")
    p.add_argument("-o", "--output", type=str, default=None)
    p.add_argument("-r", "--result", type=int, default=C.OUT_CONS)
    p.add_argument("-g", "--out-pog", type=str, default=None)
    p.add_argument("-a", "--cons-algrm", type=int, default=C.CONS_HB)
    p.add_argument("-d", "--maxnum-cons", type=int, default=1)
    p.add_argument("-q", "--min-freq", type=float, default=C.MULTIP_MIN_FREQ)
    p.add_argument("-h", "--help", action="help")
    p.add_argument("-v", "--version", action="version", version=__version__)
    p.add_argument("-V", "--verbose", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run: cuda (the CUDA "
                        "kernels, needs an sm_90 card) or cpu (their plain "
                        "PyTorch versions) [%(default)s]")
    p.add_argument("--lockstep", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="-l: K read sets in lockstep (the device "
                        "lockstep, or the split driver in local mode, on "
                        "the CPU or where ABPOA_TPU_LOCKSTEP_IMPL=split); "
                        "auto = on where the device is cuda [%(default)s]")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="-l: split each lockstep round over N devices (the "
                        "sharded route; K = N x the per-device K; N x cpu "
                        "with --device cpu); 0 or 1 = off "
                        "[ABPOA_TPU_MESH]")
    return p


def _apply_mesh(mesh) -> None:
    """--mesh: checked, then set as ABPOA_TPU_MESH, the one place every
    route plan reads it (`parallel.shard.requested_mesh_size`)."""
    if mesh is None:
        return
    if mesh < 0:
        raise ValueError("--mesh must be >= 0 (0 = off)")
    os.environ["ABPOA_TPU_MESH"] = str(mesh)


def _apply_gap_args(abpt: Params, gap_open, gap_ext) -> None:
    """Parse the -O/-E "o1[,o2]"/"e1[,e2]" forms."""
    if gap_open is not None:
        parts = gap_open.split(",")
        abpt.gap_open1 = int(parts[0])
        abpt.gap_open2 = int(parts[1]) if len(parts) > 1 else 0
    if gap_ext is not None:
        parts = gap_ext.split(",")
        abpt.gap_ext1 = int(parts[0])
        abpt.gap_ext2 = int(parts[1]) if len(parts) > 1 else 0


def _apply_result_mode(abpt: Params, r: int) -> None:
    if r == C.OUT_CONS:
        abpt.out_cons, abpt.out_msa = True, False
    elif r == C.OUT_MSA:
        abpt.out_cons, abpt.out_msa = False, True
    elif r == C.OUT_CONS_MSA:
        abpt.out_cons = abpt.out_msa = True
    elif r == C.OUT_GFA:
        abpt.out_cons, abpt.out_gfa = False, True
    elif r == C.OUT_CONS_GFA:
        abpt.out_cons = abpt.out_gfa = True
    elif r == C.OUT_CONS_FQ:
        abpt.out_cons = abpt.out_fq = True
    else:
        raise ValueError(f"unknown output result mode: {r}")


def args_to_params(args: argparse.Namespace) -> Params:
    if not 1 <= args.maxnum_cons <= 10:
        raise ValueError("max number of consensus sequences should be 1~10")
    abpt = Params()
    abpt.align_mode = args.aln_mode
    abpt.match = args.match
    abpt.mismatch = args.mismatch
    if args.matrix:
        abpt.use_score_matrix = True
        abpt.mat_fn = args.matrix
    _apply_gap_args(abpt, args.gap_open, args.gap_ext)
    abpt.wb = args.extra_b
    abpt.wf = args.extra_f
    abpt.zdrop = args.zdrop
    abpt.end_bonus = args.bonus
    abpt.inc_path_score = args.inc_path_score
    abpt.sort_input_seq = args.sort_by_len
    abpt.put_gap_on_right = args.gap_on_right
    abpt.put_gap_at_end = args.gap_at_end
    abpt.use_qv = args.use_qual_weight
    abpt.disable_seeding = not args.seeding
    abpt.k = args.k_mer
    abpt.w = args.window
    abpt.min_w = args.min_poa_win
    abpt.progressive_poa = args.progressive
    if args.amino_acid:
        abpt.m = 27
    abpt.incr_fn = args.increment
    abpt.amb_strand = args.amb_strand
    _apply_result_mode(abpt, args.result)
    abpt.out_pog = args.out_pog
    abpt.cons_algrm = args.cons_algrm
    abpt.max_n_cons = args.maxnum_cons
    abpt.min_freq = args.min_freq
    abpt.verbose = args.verbose
    abpt.device = args.device
    abpt.lockstep = args.lockstep
    return abpt


def main(argv=None) -> int:
    """Run the CLI. Configuration errors and malformed input print one line
    and return 1; a missing CUDA device raises RuntimeError."""
    raw = sys.argv[1:] if argv is None else list(argv)
    if raw[:1] == ["map"]:
        return map_main(raw[1:])
    args = build_parser().parse_args(raw)
    if args.input is None:
        build_parser().print_help(sys.stderr)
        return 1
    try:
        abpt = args_to_params(args).finalize()
        _apply_mesh(args.mesh)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    t0 = time.time()
    rc = 0
    out_fp = open(args.output, "w") if args.output and args.output != "-" else sys.stdout
    try:
        if args.in_list:
            from .parallel.runner import run_batch
            with open(args.input) as lf:
                files = [ln.strip() for ln in lf if ln.strip()]
            stats = run_batch(files, abpt, out_fp)
            if stats["quarantined"]:
                print(f"[abpoa_tpu_torch::main] {stats['quarantined']} of "
                      f"{stats['sets']} read sets quarantined",
                      file=sys.stderr)
                if stats["quarantined"] >= stats["sets"]:
                    rc = 1  # nothing succeeded
        else:
            try:
                msa_from_file(Abpoa(), abpt, args.input, out_fp)
            except QUARANTINE_EXCEPTIONS as e:
                print(f"Error: {args.input}: {type(e).__name__}: {e}",
                      file=sys.stderr)
                rc = 1
    finally:
        if out_fp is not sys.stdout:
            out_fp.close()
    if abpt.verbose >= C.VERBOSE_INFO:
        print(f"[abpoa_tpu_torch::main] device {abpt.torch_device}, "
              f"{time.time() - t0:.3f} s", file=sys.stderr)
    return rc


def map_main(argv) -> int:
    """`python -m abpoa_tpu_torch map -g GRAPH reads.fa`: restore the graph
    once (GFA S/P lines or an MSA FASTA, the `-i` formats), build its
    tables once, map every read against it in K-lane rounds
    (`parallel/map_driver.py`) and write one GAF record a read
    (`io/gaf.py`). The graph is never changed (abpoa_tpu/cli.py:294)."""
    ap = argparse.ArgumentParser(
        prog="python -m abpoa_tpu_torch map",
        description="map reads against a fixed restored graph; one "
                    "GAF-style record a read on stdout (or -o FILE)")
    ap.add_argument("reads", help="FASTA/FASTQ reads to map")
    ap.add_argument("-g", "--graph", required=True, metavar="FILE",
                    help="graph to map against: abPOA GFA (S/P lines) or "
                         "MSA FASTA with '-' gaps, as -i restores them")
    ap.add_argument("-o", "--output", type=str, default=None,
                    help="GAF output file [stdout]")
    ap.add_argument("-M", "--match", type=int, default=C.DEFAULT_MATCH)
    ap.add_argument("-X", "--mismatch", type=int, default=C.DEFAULT_MISMATCH)
    ap.add_argument("-O", "--gap-open", type=str, default=None)
    ap.add_argument("-E", "--gap-ext", type=str, default=None)
    ap.add_argument("-b", "--extra-b", type=int, default=C.EXTRA_B)
    ap.add_argument("-f", "--extra-f", type=float, default=C.EXTRA_F)
    ap.add_argument("-s", "--amb-strand", action="store_true",
                    help="align a read under the score threshold again as "
                         "its reverse complement (strand '-' in its record)")
    ap.add_argument("-K", "--k-cap", type=int, default=0, metavar="N",
                    help="reads a round, one lane each (0 = the lockstep "
                         "group size, ABPOA_TPU_LOCKSTEP_K, default 8)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda or cpu [%(default)s]")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="split each round's reads over N devices (the "
                         "sharded route; K = N x the per-device K) "
                         "[ABPOA_TPU_MESH]")
    ap.add_argument("-V", "--verbose", type=int, default=0)
    args = ap.parse_args(argv)
    abpt = Params()
    abpt.match = args.match
    abpt.mismatch = args.mismatch
    _apply_gap_args(abpt, args.gap_open, args.gap_ext)
    abpt.wb = args.extra_b
    abpt.wf = args.extra_f
    abpt.amb_strand = args.amb_strand
    abpt.verbose = args.verbose
    abpt.device = args.device
    try:
        abpt.finalize()
        _apply_mesh(args.mesh)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return _map_run(args, abpt)


def _map_run(args, abpt: Params) -> int:
    """Restore, map and write the GAF; rc 1 when the graph or the reads
    cannot be read, or a read is off the planned query rung (skipped with
    one stderr line)."""
    import numpy as np
    from .io.fastx import read_fastx
    from .io.gaf import gaf_record
    from .parallel import (discover_mesh, load_static_graph, map_reads_split,
                           plan_route)
    t0 = time.time()
    rc = 0
    try:
        _ab, static = load_static_graph(args.graph, abpt)
        records = read_fastx(args.reads)
    except QUARANTINE_EXCEPTIONS as e:
        print(f"Error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    t_restore = time.time() - t0
    encode = abpt.char_to_code
    queries = [encode[np.frombuffer(r.seq.encode(), dtype=np.uint8)
                      ].astype(np.uint8) for r in records]
    route = plan_route(abpt, len(queries), workload="map")
    if abpt.verbose:
        print(f"[abpoa_tpu_torch::map] route {route.kind}: {route.reason}",
              file=sys.stderr)
    mesh = (discover_mesh(route.workers, abpt.torch_device)
            if route.kind == "sharded" else None)
    k_cap = args.k_cap if args.k_cap > 0 else route.k_cap
    outcomes = map_reads_split(static, queries, abpt, k_cap=k_cap, mesh=mesh)
    out_fp = (open(args.output, "w")
              if args.output and args.output != "-" else sys.stdout)
    n_mapped = 0
    try:
        for rec, q, outcome in zip(records, queries, outcomes):
            if outcome is None:
                print(f"Warning: read {rec.name!r} ({len(q)} bp) exceeds "
                      "the planned query rung; skipped.", file=sys.stderr)
                rc = 1
                continue
            res, strand = outcome
            out_fp.write(gaf_record(rec.name, q, res, static.base_by_nid,
                                    strand, comment=rec.comment or None)
                         + "\n")
            n_mapped += 1
    finally:
        if out_fp is not sys.stdout:
            out_fp.close()
    print(f"[abpoa_tpu_torch::map] {n_mapped}/{len(records)} reads mapped "
          f"against a {static.n_rows - 2}-node graph on "
          f"{abpt.torch_device}: restore {t_restore:.3f} s, "
          f"{time.time() - t0:.3f} s in all", file=sys.stderr)
    return rc
