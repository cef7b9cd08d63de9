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
    python -m abpoa_tpu_torch reads.fa --report r.json --trace t.json \
        --metrics m.prom [--metrics-port N] [--profile-dir DIR]
    python -m abpoa_tpu_torch report r.json | report --diff a.json b.json
    python -m abpoa_tpu_torch warm [--ladder quick|full]
    python -m abpoa_tpu_torch perf | slo | top
    python -m abpoa_tpu_torch serve [--port N] [--workers N] [--map-graph G]
    python -m abpoa_tpu_torch why <request-id | trace.json | dump.json>

The run-telemetry flags and subcommands are the JAX package's
(abpoa_tpu/cli.py): `--report` writes the versioned JSON run report,
`--trace` a Chrome trace of the run's host spans, `--metrics` a Prometheus
textfile (and `--metrics-port` serves it), `--profile-dir` a
`torch.profiler` trace of the device regions; `report` renders reports,
`warm` builds the kernel library and launches each kernel once, `perf`
renders the ledger, `slo` gates the report archive and `top` shows the
exposition live. `serve` answers `POST /align` and `POST /map` on the card
(`serve/server.py`), and `why` explains one of its requests from the
archive, its trace or a flight dump.

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
from .resilience import CardFailure
from .resilience.quarantine import QUARANTINE_EXCEPTIONS


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
                   help="where the run aligns: cuda (the CUDA kernels, "
                        "needs an sm_90 card), cpu (their plain PyTorch "
                        "versions) or native (the C++ host DP) "
                        "[%(default)s]")
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
    _telemetry_args(p, profile=True)
    return p


def _telemetry_args(p: argparse.ArgumentParser, profile: bool) -> None:
    """--report, --trace, --metrics, --metrics-port and (main parser
    only, as in abpoa_tpu/cli.py) --profile-dir."""
    p.add_argument("--report", type=str, default=None, metavar="FILE",
                   help="write the JSON run report (versioned schema: "
                        "phase walls, counters, DP cells, MFU) to FILE "
                        "('-' for stdout; stderr when stdout carries the "
                        "output)")
    if profile:
        p.add_argument("--profile-dir", type=str, default=None,
                       metavar="DIR",
                       help="capture a torch.profiler trace (CPU and CUDA "
                            "activity, Chrome format) of the device "
                            "regions into DIR")
    p.add_argument("--trace", type=str, default=None, metavar="FILE",
                   help="write a Chrome trace-event timeline of the run's "
                        "host spans (phases, reads, chunks, rounds) to "
                        "FILE ('-' for stdout; stderr when stdout carries "
                        "the output)")
    p.add_argument("--metrics", type=str, nargs="?", metavar="FILE",
                   default=None, const="",
                   help="keep a Prometheus text-exposition file (atomic "
                        "renames, ~1 s refresh) while the run executes "
                        "[FILE defaults to ~/.cache/abpoa_tpu_torch/"
                        "metrics.prom]")
    p.add_argument("--metrics-port", type=int, default=None, metavar="N",
                   help="also serve /metrics on 127.0.0.1:N for the run")


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
    """Run the CLI. Configuration errors, malformed input and a card that
    failed past its own recovery (`resilience.CardFailure`) print one line
    and return 1; a missing CUDA device raises RuntimeError."""
    raw = sys.argv[1:] if argv is None else list(argv)
    if raw[:1] == ["map"]:
        return map_main(raw[1:])
    if raw[:1] == ["report"]:
        return report_main(raw[1:])
    if raw[:1] == ["warm"]:
        return warm_main(raw[1:])
    if raw[:1] == ["perf"]:
        from .obs.perf import perf_main
        return perf_main(raw[1:])
    if raw[:1] == ["slo"]:
        from .obs.slo import slo_main
        return slo_main(raw[1:])
    if raw[:1] == ["top"]:
        from .obs.top import top_main
        return top_main(raw[1:])
    if raw[:1] == ["serve"]:
        from .serve import serve_main
        return serve_main(raw[1:])
    if raw[:1] == ["why"]:
        from .obs.why import why_main
        return why_main(raw[1:])
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
    return _with_exporters(args, lambda: _main_run(args, abpt))


def _with_exporters(args, run) -> int:
    """Start a fresh run report and the metrics exporters `args` asks for,
    run `run()`, and stop the exporters whatever happens
    (abpoa_tpu/cli.py:534-565): an exporter that cannot start is one error
    line and rc 1."""
    from . import obs
    obs.start_run()
    metrics_path = http_srv = None
    try:
        try:
            if args.metrics is not None:
                metrics_path = (args.metrics
                                or obs.metrics.default_textfile_path())
                os.makedirs(os.path.dirname(metrics_path) or ".",
                            exist_ok=True)
                obs.metrics.start_textfile_exporter(metrics_path)
            if args.metrics_port is not None:
                http_srv = obs.metrics.start_http_exporter(
                    args.metrics_port)
        except OSError as e:
            print(f"Error: metrics exporter: {e}", file=sys.stderr)
            return 1
        return run()
    finally:
        if metrics_path is not None:
            obs.metrics.stop_textfile_exporter()
        if http_srv is not None:
            http_srv.shutdown()
            http_srv.server_close()


def _finish_telemetry(args, rep: dict, to_stdout: bool, meta: dict) -> None:
    """Write --report and --trace ('-' goes to stderr where stdout carries
    the run's output) and disarm the tracer after its export."""
    from . import obs
    if args.report:
        if args.report == "-" and to_stdout:
            obs.write_report("-", rep=rep, fp=sys.stderr)
        else:
            obs.write_report(args.report, rep=rep)
    if args.trace:
        if args.trace == "-" and to_stdout:
            obs.export_chrome_trace("-", fp=sys.stderr, extra_meta=meta)
        else:
            obs.export_chrome_trace(args.trace, extra_meta=meta)
        obs.trace_disable()


def _align_run(args, abpt: Params, out_fp) -> int:
    """The `-l` list or the one read set; malformed input is quarantined
    or printed as one error line (rc 1)."""
    rc = 0
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
    return rc


def _main_run(args, abpt: Params) -> int:
    """The alignment run proper, inside the exporters' lifetime."""
    from . import obs
    if args.trace:
        obs.trace_enable()
    obs.set_profile_dir(args.profile_dir)
    t0 = time.time()
    out_fp = open(args.output, "w") if args.output and args.output != "-" else sys.stdout
    try:
        rc = _align_run(args, abpt, out_fp)
    except CardFailure as e:
        # the card failed past its own recovery: an error, never the host
        print(f"Error: {e}", file=sys.stderr)
        rc = 1
    finally:
        if out_fp is not sys.stdout:
            out_fp.close()
        obs.set_profile_dir(None)
    if abpt.verbose >= C.VERBOSE_INFO:
        print(f"[abpoa_tpu_torch::main] device {abpt.torch_device}, "
              f"{time.time() - t0:.3f} s", file=sys.stderr)
    rep = obs.finalize_report()
    # one record a run in the report archive (`slo` reads it; disabled by
    # ABPOA_TPU_ARCHIVE=0, and a failed append never fails the run)
    obs.archive.append_report(rep, label=args.input or "",
                              device=abpt.device)
    _finish_telemetry(args, rep, out_fp is sys.stdout,
                      {"input": args.input, "device": abpt.device})
    return rc


def report_main(argv) -> int:
    """`report FILE ...` renders `--report` JSON as a table; `report
    --diff A B` compares two reports field by field
    (abpoa_tpu/cli.py:235)."""
    import json
    from .obs.report import render_report, render_report_diff
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m abpoa_tpu_torch report FILE [FILE ...]\n"
              "       python -m abpoa_tpu_torch report --diff A B\n\n"
              "render --report JSON run reports as tables ('-' reads "
              "stdin); --diff compares two reports (phase walls, reads/s, "
              "CUPS, compiles, faults) field by field", file=sys.stderr)
        return 0 if argv else 1

    def load(path):
        with (sys.stdin if path == "-" else open(path)) as fp:
            return json.load(fp)

    if argv[0] == "--diff":
        if len(argv) != 3:
            print("Error: --diff needs exactly two report files.",
                  file=sys.stderr)
            return 2
        sys.stdout.write(render_report_diff(load(argv[1]), load(argv[2]),
                                            label_a=argv[1],
                                            label_b=argv[2]))
        return 0
    for i, path in enumerate(argv):
        rep = load(path)
        if len(argv) > 1:
            print(("" if i == 0 else "\n") + f"== {path} ==")
        sys.stdout.write(render_report(rep))
    return 0


def warm_main(argv) -> int:
    """`warm [--ladder quick|full]`: build (or load) the kernel library and
    launch each of its entry points at the tier's shapes on the card
    (`kernels/warm.py`), then append a `warm` record to the ledger. Without
    a card: one error line and rc 1, nothing built or launched."""
    import json
    ap = argparse.ArgumentParser(
        prog="python -m abpoa_tpu_torch warm",
        description="build or load the CUDA kernel library and launch each "
                    "kernel once at the ladder tier's shapes")
    ap.add_argument("--ladder", choices=["quick", "full"], default="quick",
                    help="tier: quick = 2 kb reads; full = + the 10 kb "
                         "headline's W 512, the lane and window forms "
                         "[%(default)s]")
    ap.add_argument("--device", default="cuda",
                    help="the card to warm [%(default)s]")
    ap.add_argument("--report", default=None, metavar="FILE",
                    help="write the warm summary JSON to FILE ('-' for "
                         "stdout)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="no line a kernel")
    args = ap.parse_args(argv)
    import torch
    if not args.device.startswith("cuda") or not torch.cuda.is_available():
        print(f"Error: warm needs a CUDA card (device {args.device!r}, "
              f"{torch.cuda.device_count()} cards); nothing to warm.",
              file=sys.stderr)
        return 1
    from . import obs
    from .kernels.warm import warm_ladder
    obs.start_run()
    abpt = Params()
    abpt.device = args.device
    abpt.finalize()
    summary = warm_ladder(tier=args.ladder, abpt=abpt,
                          verbose=not args.quiet)
    print(f"[abpoa_tpu_torch warm] {summary['signatures']} entry points "
          f"({summary['launches']} launches; library "
          f"{'built' if summary['compiled'] else 'on disk'}, "
          f"{summary['nvcc_build_s']} s in nvcc) in {summary['wall_s']} s; "
          f"cache: {summary['cache_dir']}", file=sys.stderr)
    obs.ledger.append_record(obs.ledger.make_record(
        "warm", workload=f"ladder:{args.ladder}",
        device=obs.ledger.device_label(abpt.torch_device),
        compile_misses=summary["compiled"],
        extra={"signatures": summary["signatures"],
               "launches": summary["launches"],
               "nvcc_build_s": summary["nvcc_build_s"],
               "wall_s": summary["wall_s"]}))
    if args.report:
        fp = sys.stdout if args.report == "-" else open(args.report, "w")
        try:
            json.dump(summary, fp, indent=2)
            fp.write("\n")
        finally:
            if fp is not sys.stdout:
                fp.close()
    return 0


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
    _telemetry_args(ap, profile=False)
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
    return _with_exporters(args, lambda: _map_run(args, abpt))


def _map_run(args, abpt: Params) -> int:
    """Restore, map and write the GAF; rc 1 when the graph or the reads
    cannot be read, or a read is off the planned query rung (skipped with
    one stderr line)."""
    import numpy as np
    from . import obs
    from .io.fastx import read_fastx
    from .io.gaf import gaf_record
    from .parallel import (discover_mesh, load_static_graph, map_reads_split,
                           plan_route)
    if args.trace:
        obs.trace_enable()
    obs.note_device(abpt.torch_device)
    t0 = time.time()
    rc = 0
    try:
        with obs.phase("graph_restore"):
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
    rep = obs.finalize_report()
    rec = obs.archive.summarize_report(rep, label=f"map:{args.reads}",
                                       device=abpt.device)
    rec["workload"] = "map"  # the SLO objectives scoped to map judge it
    obs.archive.append_record(rec)
    _finish_telemetry(args, rep, out_fp is sys.stdout,
                      {"input": args.reads, "graph": args.graph,
                       "device": abpt.device})
    return rc
