#!/usr/bin/env python3
"""On-card smoke run of abpoa_tpu_torch, the PyTorch/CUDA port of abpoa-tpu.

    python3 chip_smoke.py [--reads N] [--ref-len L] [--c2-reads M] [--c4-reads K]
                          [--c5-reads I] [--c6-reads Q] [--c7-reads S]
                          [--c9-reads T] [--c11-sets U]

Needs one CUDA card of capability 9.0 (H100). Phases, each a hard failure:
  build  compile every kernel from abpoa_tpu_torch/csrc with nvcc (sm_90a),
         one nvcc per source, and the native host graph
         (abpoa_tpu_torch/native/host_core.cpp) with g++, all started
         together
  A      kernel B2 (banded_dp, the per-read route; B1's seeded
         instantiation) against its plain PyTorch version on the plane rows
         it computes and on begend, mplr and ok: tables of a mid-run graph
         of tests/data/sim2k.fa, including a forced band overflow relaunched
         up to W > 1024; the `-s` retry's re-seeded launch on rcmix.fa; a
         simulated 20 kb read relaunched up to W > 16384 (32 columns a
         thread); a sweep of B2's column warps at W = 512; B2's affine and
         linear instantiations on the sim2k tables. B2 batched over a read's
         windows (one block a window), in each gap mode: the windows of
         sim2k's 4th read (-S -k 11 -w 5 -n 50: at abPOA's k = 19 sim2k's
         reads get one window each) with a window 100 rows back past the
         ring, one of only its two ends and an empty query (a forced
         adjacent-anchor spec) in one launch, against the plain version
         window by window, at the first W and at W = 64 (some windows
         overflow), and X1w (backtrack_windows) over each launch's ok
         windows against its plain version (headers, bands, ops); those 4
         reads on cuda == on cpu; the read's windows from W = 32 end to
         end, the overflowed part relaunched, cuda == cpu. B2's modes
         (MODE_CASES): local, extend with Z-drop (-z 20), unbanded global
         and extend, with and without -G's path scores, in each gap
         regime, on sim2k's tables (and a read's middle between random
         flanks, where a local walk stops before a zero cell) and on
         rcmix's (where Z-drop fires): B2, or kernel B2u (unbanded_dp, one
         thread-block cluster a window) for the whole-row cases (local,
         unbanded), against the plain version (planes, begend, mplr, ok,
         ext) and X1w's walk from the mode's best cell against its plain
         version (header, band, ops); B2u at 1, 2, 4, 8 and 16 blocks a
         cluster (the first of CLUSTER_CASES, at a W that is no multiple
         of 32), each == plain
  A2     on sim2k tables: kernel B1 (fused_dp) against its plain version in
         every variant (linear/affine/convex x global/extend+Z-drop/local x
         int16/int32), B3 as B1's local instantiation at sim2k's local width
         (2048, where the JAX package picks pallas_fused_dp_local_hbm), X1
         (backtrack) on each variant's planes, and K1 (topo_sort) on a graph
         that needed a Kahn repair and on the adversarial graphs of
         `k1_graph`, each in its two degree variants; S1 on the sim2k
         graphs and on `tie_graph` at E = 8, 16, 32, out of place over every
         row (edge_sort) and in place below node_n with the span update
         (finish_fusion_), timed on fresh copies with its bounds: all
         outputs equal; then B1 and X1 on two synthetic graphs
         (`synthetic_graph`): predecessors 70 rows back, past B1's
         shared-memory ring, and 64 predecessor slots with the backtrack's
         first hit in slot 40. B1/B3 are compared on the plane
         rows they compute (0..gn-2, or to the overflow row). A sweep of
         B1's column warps at W = 128 and of B3's at W = 2048, each shape
         held equal to the plain version
  B      `python -m abpoa_tpu_torch` on cuda, now the fused route,
         reproduces tests/golden byte for byte: consensus (default, -O 4,
         -O 0, -m 1, -m 2) and the read-id outputs (seq.fa -a 1, -r 2, -r 4;
         heter.fa -d 2, -d 2 -r 2; 3alleles.fa -d 3); seq.fa -r 1, -r 3 and
         rcmix.fa -s -r 1 on cuda equal the port's CPU runs; then sim2k -m 1
         on cuda (the B3 width) equals the port's CPU result on its first 4
         reads. Incremental, qv-weighted and list runs on cuda reproduce
         their goldens: seq4.fa -i seq10.gfa and -i seq10.msa (the fused
         loop from the restored state: B1, no B2), heter.fq -d 2 -Q (the
         per-read route: B2, no B1) and -l tests/data/list.txt (run from
         the repository root; by default in the lockstep implementation
         that lockstep_impl picks on cuda: the split driver, B2 and no B1,
         or the device lockstep, B1 over lanes and no B2; with --lockstep
         off set by set, B1 and no B2); seq4.fa
         -i seq10.gfa with -r 1, -r 3 and
         -d 2 (B2, no B1), seq4.fa -i seq10.msa -m 1 (B3 from a restored
         state), seq.fa -g's .dot file and pyapi.msa_aligner().msa on
         seq.fa's reads (B2) equal the port's CPU runs. The seeded route
         (B2 batched, no B1): seq.fa -S -p, rcmix.fa -s -S [-p] -n 200
         reproduce their goldens; sim2k's first 6 reads with -S -n 200
         (and -O 0, -O 4) and -S -p -n 200 -r 1, seq4.fa -i seq10.gfa -S
         -r 1 and seq.fa -p -O 0 equal the port's CPU runs. B2's modes:
         seq.fa -b -1 reproduces seq_noband.txt, and -G, -G -m 1, -m 2 -z
         20 -b -1, -S -G, -S -b -1, -i seq10.gfa -r 1 -m 1, -Q -d 2 -m 2
         and -l with -i -m 1 (a set of one read among the list's) on cuda
         equal the port's CPU runs, each on B2 alone (the `-b -1` and `-m
         1` runs on B2u and no B2, the others on B2 and no B2u); -r 5, -c
         and -c -t BLOSUM62.mtx reproduce their goldens
  C      the main path at full width: N ONT-like 10 kb reads at 10 % error
         (made here from a fixed seed) through the CLI on cuda, the fused
         route; the kernel counts are set to 0 before and read after (S1 at
         most once per read attempt and collision); the consensus must
         match the simulated reference at >= 99 % identity
  C2     the per-read route (pipeline.poa on the native graph, kernels B2
         and X1w) and the fused route on the first M reads of that set give
         byte-identical consensus; the per-read route's time a read split
         into the tables (C++), B2, X1w, the copy of the small results, the
         cigar rebuild and the fusion and sort (C++); X1w launched once a
         B2 launch, and the bytes copied to the host, beside the planes'
         bytes that stay on the card (check_walks; the same in C5-C7);
         the fused route once more with a collision forced on every read
         (forced_collisions): kernel F1's sequential fusion, its S1 and K1
         each read, the consensus byte-identical, no host graph built from
         the card's graph
  C3     phase C's set again with -r 2 (MSA and consensus; the loop records
         each read's path, the read-id bitsets are replayed on the host): the
         consensus equals phase C's, each MSA row without gaps is its read,
         the consensus row without gaps is the consensus, the kernel counts
         and the host syncs equal phase C's; the wall split into the loop,
         the downloads, the replay, the MSA ranks and rows, the consensus and
         the writing
  C4     a diploid set: two haplotypes of --ref-len bp, 1 % apart (SNVs and
         1-3 bp indels, made from --seed), K reads (100) of 10 % error,
         alternating between them, with -d 2 -r 4: one or two consensus
         sequences whose read lists partition the reads, and a GFA whose P
         lines spell the reads; each consensus's identity to both
         haplotypes and its reads by haplotype are printed (C4 is 100 reads,
         not 500, to keep the script within its time)
  C5     incremental at full width: phase C3's MSA without its consensus
         row (the reads' rows) restored and I new reads (100) of the same
         reference, from another seed: (a) -i through the CLI, the fused
         loop from the restored state (the restored graph's node count ==
         the uploaded node_n, consensus identity >= 99 %, the kernel counts
         read as in phase C); (b) the first 20 of those reads through
         pipeline.poa (B2) and through the fused loop from the same restored
         graph give byte-identical consensus; (c) -i -r 1 through the CLI
         with those 20 reads, the per-read route (B2 from the CLI): each
         new row without gaps is its read, each restored row without gaps
         is its restored row; the walls split into the restore's parse,
         the state upload, the loop and the download, and per read as C2
  C6     qv-weighted diploid: phase C4's two haplotypes, Q reads (50, half
         of each, cut as this route runs per read) written as
         FASTQ whose erroneous bases carry lower phred values, -d 2 -Q -r 4
         (the per-read route): the read lists partition the reads, every P
         line spells its read, B2 launches >= Q - 1 and B1 none; purity
         and identity to each haplotype printed; the wall split into the
         per-read loop (as C2) and the clustering
  C7     the seeded user at full width: S reads (200) of phase C's set with
         -S at abPOA's k = 19, w = 10, n = 500 (a), half of them with -S -p
         (b), through the CLI: windows a read, B2 launches (one a read plus
         relaunches, no B1), the per-read split as C2, the guide tree's
         seconds, the
         identity to the reference (>= 0.99) and to phase C's consensus.
         When fewer than half the reads get two windows at 10 % error
         (anchors rarely survive it), C7 runs on reads of the same
         reference at 5 % error, and says so
  C8     B2's and X1w's modes at full width on the first 5 reads of phase
         C's set (phase_c8): the per-read route in -m 1, -m 2 and -m 2 -z
         100 == the fused route (B3/B1), -r 2 byte for byte; the pyapi in
         aln_mode l and e == the fused MSA rows and consensus; -b -1 -r 2
         and -G -r 2 through the CLI (B2 every read): rows are their reads,
         check_walks, consensus identity >= 0.98; per read the split of C2
         and B2's µs a computed row. The whole-row runs (-m 1, pyapi l, -b
         -1) launch B2u and no B2, the others B2 and no B2u
  C9     `-l` at full width (phase_c9): 8 sets of 10 kb reads at 10 %
         error of 8 references (seeds 11-18), set i of T + 5 i reads
         (T = 10), through the CLI with -r 2 and --lockstep off (set by
         set, the fused route), on with the split driver (K = 8: one
         K-lane B2 launch and one X1w launch a round, host fusion) and on
         with the device lockstep (every graph on the card; B1, X1, S1
         and K1 once a round over the lanes), and once more with the
         device lockstep and a collision forced on the even lane
         positions of every round (F1 over a lane list, its S1, K1 and
         the merge into the round's graph): byte-identical outputs; the
         split run launches no B1 (check_walks), the device run no B2 and
         no X1w and B1 once a round, at most one host sync a round beyond
         `-s` and Kahn; the forced run F1 once a round and no host graph
         built from the card's; wall, reads/s, rounds, mean live lanes,
         launches,
         the wall split (by step on the stream and host for the device
         run), consensus identity to each reference; the split run's round
         2 launch (8 lanes, each a graph of one read) against the plain
         version on CPU copies, and X1w's walk of it; the device run's
         mid-run round: its B1, X1 and S1 lane launches against their
         plain versions, with times and bounds
  C10    `map` (phase_c10): C5's restored graph and C5's new reads through
         `python -m abpoa_tpu_torch map` at -K 1 (20 reads), -K 8 and -K 32:
         the GAF byte-identical across them, the tables built once and
         their graph half uploaded once a run, check_walks; restore and
         tables seconds, reads/s, rounds, B2's ms a launch
  C11    the sharded route (phase_c11) over every card, or with one card
         over (cuda:0, cuda:0) passed as the drivers' `mesh=` (the split's
         overhead, not scaling): (a) C9's list (its first U sets,
         --c11-sets, default all 8) through runner.run_batch with -r 2,
         the device lockstep (one group of sets a slot) and the split
         driver (each round's lanes split), each == C9's --lockstep off
         output; B1 and X1 lane launches == the groups' rounds, at most
         one host sync a group a round beyond -s and Kahn, no host graph
         built; the split run check_walks and no B1; (b) C10's -K 8 map
         over the mesh onto C10's restored graph: GAF == C10's, tables
         built once and uploaded once a card, check_walks; (c) 20 of C7's
         reads with -S, every read's windows split over the mesh: the
         consensus == the unsplit run's; (d) `python -m abpoa_tpu_torch
         -l LIST --mesh N+1` on N cards exits non-zero with the mesh's
         RuntimeError, and --mesh 1 == no --mesh (output, launches,
         syncs); each sharded wall beside the unsharded one
  D      at the graph phase C left and one more read: B1, X1, S1 (on the
         read's fused graph before its sort, as the main path hands it
         over; each timed launch on a fresh copy; rows moved
         and the bound of what they need) and K1
         against their plain versions with times and bounds (B1 also per
         computed row, X1 per step, K1 per pass, in both degree variants
         and with its two walks' lengths), the share of predecessor reads
         B1's rings serve (from the tables), a sweep of B1's column warps,
         each held equal to the plain version, the time of the
         sequential fusion a collision read takes (the host walk, F1's
         plain version, held equal to the vectorised fusion) and kernel
         F1 on the same op stream against it (every graph array, ok,
         node_n, the path; time, bound); K1 over two lanes (the final
         graph and the read's sequentially fused graph) in one launch
         against its plain version; B2's kernel time at the graph of C2's per-read
         run, and against its plain version at C5 (b)'s per-read graph
         (C3's restored MSA and 20 new reads, the largest graph the CLI
         launches B2 on, in C5 (c); time, per computed row, bound, ring
         share, warp sweep); the kernel table's B2 row takes its time, plain
         time and bound from the latter; B2 with -G at C8's final graph
         (kernel time, µs a row, bound); B2's modes at C8's
         launch shape (the held-out read on a graph of phase C's first 3
         reads: unbanded global and local at W = qlen + 1 on B2u, -G banded
         on B2 and unbanded on B2u) and at C8's final graph (unbanded and
         local, on B2u) against the plain version (B2u's on the card), with
         time, µs a row, bound, ring share and B2u at 4, 8 and 16 blocks a
         cluster, each == plain, and X1w's walk from each; the kernel
         line's banded_dp[unbanded] row takes C8's unbanded case; B2 batched (the banded_dp[windows] row) against its plain
         version on the first launch of C7 (a)'s last read: its windows at
         the graph the reads before it built, with the longest window alone;
         X1w (the backtrack[windows] row) on that launch's planes, then on
         one window of C5's per-read graph and the held-out read, on C8's
         whole-row planes (B2u, -b -1) and on C9's round-2 launch: each ==
         plain, with its time, µs a step of the longest walk, bound and the
         share of steps its tiles serve from shared memory (tile_replay).
         The plain versions of B1, B3 and B2 (a loop of small torch ops a
         row) run on CPU copies of the kernel's inputs, but for phase A's
         one-read B2 cases (the 20 kb read's wide planes); the others run
         on the card. Those of phase D's B1, B2, B2u and batched-B2 rows
         and of C9's round-2 launch and its device run's B1 lane launch
         (a job a lane) run side by side in seven worker
         processes on the host (PlainPool) from the start of D; the mode
         cases' workers hand back digests of the planes (plane_digest), not
         the planes (2-4 GB a whole-row case), and the main process checks
         each as its worker ends
Quick form (~5 min): --reads 12 --ref-len 2000 --c2-reads 6 --c4-reads 20
--c5-reads 6 --c6-reads 10 --c7-reads 12 --c9-reads 3.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero with no result when there is no
CUDA device or no checkout of the repository beside this script.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
INT32_LANES_PER_SM = 64      # Hopper: 64 INT32 lanes per SM
OUT = os.path.join(ROOT, "build", "chip_smoke")


def log(msg: str) -> None:
    print(msg, flush=True)


def simulate(ref_len: int, n_reads: int, err: float, seed: int):
    """ONT-like reads in the shape of tests/make_sim.py: per reference base,
    a substitution (40 % of err), an insertion after it (30 %) or a
    deletion (30 %). Returns (reference, reads) as ACGT strings."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len)
    return acgt(ref), [acgt(r) for r in sim_reads(ref, n_reads, err, rng)]


def sim_reads(ref, n_reads: int, err: float, rng) -> list:
    """`simulate`'s reads of the 0..3 code array `ref`, as code arrays."""
    import numpy as np
    n = len(ref)
    sub, ins = err * 0.4, err * 0.3
    reads = []
    for _ in range(n_reads):
        x = rng.random(n)
        is_sub = x < sub
        is_ins = (x >= sub) & (x < sub + ins)
        is_del = (x >= sub + ins) & (x < err)
        first = np.where(is_sub, (ref + rng.integers(1, 4, n)) % 4, ref)
        second = rng.integers(0, 4, n)
        pair = np.stack([first, second], 1)
        keep = np.stack([~is_del, is_ins], 1)
        reads.append(pair[keep])
    return reads


def acgt(codes) -> str:
    import numpy as np
    return np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes().decode()


def haplotypes(ref_len: int, rate: float, seed: int):
    """Two haplotypes of one locus as 0..3 code arrays: a random sequence
    and a copy with a variant at a `rate` share of its positions, 70 % SNVs
    and 30 % indels of 1-3 bp (half insertions, half deletions)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    h1 = rng.integers(0, 4, ref_len)
    pos = np.sort(rng.choice(np.arange(50, ref_len - 50), int(ref_len * rate),
                             replace=False))
    out, last = [], 0
    for p in pos.tolist():
        if p < last:  # inside the last deletion
            continue
        out.append(h1[last:p])
        kind, k = rng.random(), int(rng.integers(1, 4))
        if kind < 0.7:
            out.append([(h1[p] + int(rng.integers(1, 4))) % 4])
            last = p + 1
        elif kind < 0.85:
            out.append([h1[p]])
            out.append(rng.integers(0, 4, k))
            last = p + 1
        else:
            last = p + k
    out.append(h1[last:])
    return h1, np.concatenate([np.asarray(x, dtype=h1.dtype) for x in out])


def sim_reads_qual(ref, n_reads: int, err: float, rng) -> list:
    """`sim_reads` with a phred quality per base: (codes, phreds) a read.
    A substituted or inserted base gets phred 3..14, a true one 20..40,
    both drawn from rng."""
    import numpy as np
    n = len(ref)
    sub, ins = err * 0.4, err * 0.3
    out = []
    for _ in range(n_reads):
        x = rng.random(n)
        is_sub = x < sub
        is_ins = (x >= sub) & (x < sub + ins)
        is_del = (x >= sub + ins) & (x < err)
        first = np.where(is_sub, (ref + rng.integers(1, 4, n)) % 4, ref)
        second = rng.integers(0, 4, n)
        keep = np.stack([~is_del, is_ins], 1)
        codes = np.stack([first, second], 1)[keep]
        bad = np.stack([is_sub, np.ones(n, bool)], 1)[keep]
        phred = np.where(bad, rng.integers(3, 15, len(codes)),
                         rng.integers(20, 41, len(codes)))
        out.append((codes, phred))
    return out


def read_fasta_rows(path: str) -> list:
    """(name, sequence) of each record of a FASTA file whose records are one
    line each, as the MSA writer makes them."""
    with open(path) as fp:
        lines = fp.read().split("\n")
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines) - 1, 2)]


def gfa_spells(path: str) -> dict:
    """P-line name -> the sequence its path spells in a GFA file (a path
    walked backwards, `-`, spells the reverse complement)."""
    seg, paths = {}, {}
    with open(path) as fp:
        for line in fp:
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                seg[f[1]] = f[2]
            elif f[0] == "P":
                paths[f[1]] = f[2].split(",") if f[2] else []
    comp = str.maketrans("ACGTN", "TGCAN")
    return {name: "".join(seg[x[:-1]] if x[-1] == "+"
                          else seg[x[:-1]].translate(comp) for x in steps)
            for name, steps in paths.items()}


def edit_distance(a: str, b: str) -> int:
    """Unit-cost edit distance, one numpy row at a time."""
    import numpy as np
    x = np.frombuffer(a.encode(), dtype=np.uint8)
    y = np.frombuffer(b.encode(), dtype=np.uint8)
    j = np.arange(len(y) + 1, dtype=np.int64)
    prev = j.copy()
    for i in range(1, len(x) + 1):
        t = np.empty_like(prev)
        t[0] = i
        t[1:] = np.minimum(prev[:-1] + (y != x[i - 1]), prev[1:] + 1)
        prev = np.minimum.accumulate(t - j) + j
    return int(prev[-1])


def to_dev(arrays, dev):
    import numpy as np
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in arrays]


def encode(abpt, seq: str):
    import numpy as np
    return abpt.char_to_code[np.frombuffer(seq.encode(), dtype=np.uint8)].astype(np.uint8)


def compare(name: str, kernel_out, plain_out) -> int:
    """Max abs difference over all outputs (on the kernel output's device);
    raises on any mismatch."""
    worst = 0
    for k, (a, b) in enumerate(zip(kernel_out, plain_out)):
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise AssertionError(f"{name} output {k}: {tuple(a.shape)} {a.dtype}"
                                 f" vs {tuple(b.shape)} {b.dtype}")
        d = (int((a.long() - b.to(a.device).long()).abs().max().item())
             if a.numel() else 0)
        worst = max(worst, d)
        if d != 0:
            raise AssertionError(f"{name}: kernel and plain version differ on "
                                 f"output {k} (max abs diff {d})")
    return worst


def b2_windows(args, out):
    """Per window of a batched B2 launch (args: banded_dp's 12 tensors):
    (first row, rows, gn, its beg, its end, its ok (1,))."""
    roff = args[11].tolist()
    for b in range(len(roff) - 1):
        r0, R = roff[b], roff[b + 1] - roff[b]
        be = out[5][2 * r0: 2 * (r0 + R)]
        yield r0, R, int(args[0][b][10]), be[:R], be[R:], out[7][b:b + 1]


def dp_rows(args, out) -> list:
    """The plane rows B1/B3 or B2 (args of banded_dp: 11 tensors, one
    window, or 12 or 13, a batch) computed in `out`: (first row, rows) a
    window, 0..last computed (the kernel leaves later rows as allocated)."""
    from abpoa_tpu_torch.align.fused_dp_kernel import computed_rows
    W = out[0].shape[1]
    if len(args) >= 12:  # a batch of windows
        return [(r0, computed_rows(beg.cpu(), end.cpu(), ok.cpu(), gn, W))
                for r0, R, gn, beg, end, ok in b2_windows(args, out)]
    if len(args) == 11:  # B2: begend (2R,), gn at scalars[10]
        R = out[5].shape[0] // 2
        beg, end, gn = out[5][:R], out[5][R:], int(args[0][10])
    else:
        beg, end, gn = out[5], out[6], int(args[0][8])
    return [(0, computed_rows(beg.cpu(), end.cpu(), out[7].cpu(), gn, W))]


def compare_dp(name: str, got, want, args) -> tuple:
    """compare() for B1/B3 outputs, or B2's, over the plane rows the kernel
    defines (dp_rows of the plain version's outputs). Returns (max abs
    difference, rows compared)."""
    import torch
    spans = dp_rows(args, want)
    idx = torch.cat([torch.arange(r0, r0 + rows) for r0, rows in spans])
    cut = lambda out: [t[idx.to(t.device)] if k < 5 else t  # noqa: E731
                       for k, t in enumerate(out)]
    return compare(name, cut(got), cut(want)), len(idx)


def time_cuda(fn, reps: int) -> float:
    """Mean ms of fn() over reps runs, by CUDA events, after a warm-up of at
    least two runs and 0.3 s (a card that sat idle through a plain version
    comes back at a lower clock)."""
    import torch
    t0 = time.perf_counter()
    for k in range(1000):
        fn()
        torch.cuda.synchronize()
        if k >= 1 and time.perf_counter() - t0 >= 0.3:
            break
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


# cycles of the sleep kernel the queued timings start behind (~50 ms at
# the H100's 1980 MHz): far longer than the host takes to queue their runs
SLEEP_CYCLES = 100_000_000


def time_queued(launch, reps: int, warm) -> float:
    """Mean ms of launch(i) for i < reps by CUDA events, after warm() runs
    for at least two calls and 0.3 s. The launches wait behind a sleep
    kernel, so the card runs them back to back and the time is the card's
    alone, not its wrapper's host time as time_cuda's is for a small kernel
    (raises if the card reached them before the host had queued the
    last)."""
    import torch
    t0 = time.perf_counter()
    for k in range(1000):
        warm()
        torch.cuda.synchronize()
        if k >= 1 and time.perf_counter() - t0 >= 0.3:
            break
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for i in range(reps):
        launch(i)
    reached = e0.query()
    e1.record()
    e1.synchronize()
    if reached:
        raise AssertionError("the card ran out of queued work before the "
                             "host had queued every launch")
    return e0.elapsed_time(e1) / reps


def time_s1(slots, cnts, node_n, n_span, reps: int) -> float:
    """Mean ms of one S1 launch (`finish_fusion_`, in place; the span update
    when n_span is given) on fresh copies of the four slot arrays and
    n_span, a stack of reps made before the events, one launch a copy
    (time_queued; the warm-up on a copy of its own, which its first launch
    sorts: the later ones find nothing to move)."""
    import torch
    from abpoa_tpu_torch.align.edge_sort_kernel import finish_fusion_
    stack = torch.stack(list(slots)).unsqueeze(0).repeat(reps, 1, 1, 1)
    spans = (None if n_span is None
             else n_span.unsqueeze(0).repeat(reps, 1))
    warm = [t.clone() for t in slots]
    warm_span = None if n_span is None else n_span.clone()
    return time_queued(
        lambda i: finish_fusion_(*stack[i].unbind(0), *cnts, node_n,
                                 None if spans is None else spans[i]),
        reps, lambda: finish_fusion_(*warm, *cnts, node_n, warm_span))


def check_s1(name, slots, cnts, node_n, n_span):
    """S1 as the loop runs it, on copies, against its plain version on
    copies (on the card): the four slot arrays and n_span. Returns the max
    abs difference (0) and the plain version's ms."""
    import torch
    from abpoa_tpu_torch.align.edge_sort_kernel import (finish_fusion_,
                                                        finish_fusion_torch_)
    copies = lambda: ([t.clone() for t in slots],  # noqa: E731
                      None if n_span is None else n_span.clone())
    p_slots, p_span = copies()
    plain_ms, _ = time_host(lambda: finish_fusion_torch_(
        *p_slots, *cnts, node_n, p_span))
    want = p_slots + ([] if p_span is None else [p_span])
    k_slots, k_span = copies()
    finish_fusion_(*k_slots, *cnts, node_n, k_span)
    torch.cuda.synchronize()
    return compare(name, k_slots + ([] if k_span is None else [k_span]),
                   want), plain_ms


def time_host(fn):
    """(ms, result) of one fn() on the host clock, ended by a device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def time_plain(fn, args, **kw):
    """(ms, outputs on the CPU) of the plain version fn(*args, **kw) run on
    CPU copies of args, on the host clock. B1's and B2's plain versions are
    a loop of small torch ops a row, which the host runs faster than the
    card launches them one by one while a row is narrow (W up to a few
    thousand; compare() and compare_dp() take outputs on either device)."""
    cargs = [a.cpu() for a in args]
    t0 = time.perf_counter()
    out = fn(*cargs, **kw)
    return (time.perf_counter() - t0) * 1e3, out


def _plain_worker(fn, arrays, kw):
    """time_plain in a worker process: numpy in and out (a pipe carries
    them; shared memory may be small in a container)."""
    import torch
    torch.set_num_threads(1)
    ms, out = time_plain(fn, [torch.from_numpy(a) for a in arrays], **kw)
    return ms, [o.numpy() for o in out]


def plane_digest(planes, rows: int):
    """(2, 5, rows) int64 on the CPU: two weighted sums of each of the first
    `rows` rows of the five planes, with random weights below 2^16 (exact in
    int64 up to W = 32768, so the order of the sum does not matter). Two
    rows that differ in one cell always differ here; in more, they collide
    with odds of about 2^-32."""
    import numpy as np
    import torch
    W, dev = planes[0].shape[1], planes[0].device
    w = torch.from_numpy(np.random.default_rng(12).integers(
        1, 1 << 16, (2, W))).to(dev)
    out = torch.empty((2, 5, rows), dtype=torch.int64, device=dev)
    for k, p in enumerate(planes):
        for r in range(0, rows, 1024):
            blk = p[r: min(rows, r + 1024)].long()
            out[:, k, r: r + blk.shape[0]] = (blk[None] * w[:, None, :]).sum(-1)
    return out.cpu()


def _plain_digest_worker(arrays, kw):
    """B2's plain version on one window in a worker process, returning the
    planes as `plane_digest`s of the rows it computes and the other outputs
    whole: (ms, digests, [begend, mplr, ok, ext], rows). A whole-row
    window's planes (2-4 GB at 10 kb) would take longer to cross the pipe
    than to compute."""
    import torch
    from abpoa_tpu_torch.align.banded_kernel import banded_dp_torch
    torch.set_num_threads(1)
    args = [torch.from_numpy(a) for a in arrays]
    ps = args[12] if len(args) > 12 else None
    ms, out = time_plain(banded_dp_torch, args[:12], pre_score=ps, **kw)
    rows = dp_rows(args, out)[0][1]
    return (ms, plane_digest(out[:5], rows).numpy(),
            [o.numpy() for o in out[5:]], rows)


class PlainPool:
    """Plain versions of the kernels on CPU copies of their inputs, in
    worker processes (spawn). `add` queues one and returns a function that
    gives its time_plain's (ms, outputs on the CPU); the first such call
    submits every queued one at once (`start` does so without waiting) and
    waits for them all, so they run side by side on the host's cores while
    the main process measures no kernel. Each time is its worker's host
    clock around the plain call."""

    def __init__(self, workers: int = 4):
        self.workers = workers
        self.pool = None
        self.queued = []
        self.futures = []
        self.jobs = 0

    def add(self, fn, args, **kw):
        import numpy as np
        import torch
        arrays = [a.cpu().numpy() if isinstance(a, torch.Tensor)
                  else np.ascontiguousarray(a) for a in args]
        job = {"call": (_plain_worker, fn, arrays, kw)}
        self.queued.append(job)

        def wait():
            self.run()
            ms, out = job["future"].result()
            return ms, [torch.from_numpy(o) for o in out]
        return wait

    def add_digest(self, arrays, **kw):
        """`add` of B2's plain version on one window (banded_dp's batch-form
        inputs, numpy), returning digests of its planes
        (`_plain_digest_worker`): wait() gives (ms, digests, [begend,
        mplr, ok, ext] as tensors, rows)."""
        import numpy as np
        import torch
        job = self.add_call(_plain_digest_worker,
                            [np.ascontiguousarray(a) for a in arrays], kw)

        def wait():  # this job only: the main process goes on with its case
            ms, dig, small, rows = job()
            return (ms, torch.from_numpy(dig),
                    [torch.from_numpy(o) for o in small], rows)
        return wait

    def add_call(self, worker, *call_args):
        """Queue worker(*call_args) (a module-level function; numpy in and
        out); wait() gives its result, after submitting every queued job."""
        job = {"call": (worker, *call_args)}
        self.queued.append(job)

        def wait():
            self.start()
            return job["future"].result()
        return wait

    def run(self) -> None:
        """Submit every queued plain version and wait for all of them."""
        from concurrent.futures import wait
        self.start()
        wait(self.futures)

    def start(self) -> None:
        """Submit every queued plain version; do not wait."""
        if not self.queued:
            return
        if self.pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            self.pool = ProcessPoolExecutor(
                max_workers=self.workers, mp_context=mp.get_context("spawn"))
        for job in self.queued:
            job["future"] = self.pool.submit(*job.pop("call"))
            self.futures.append(job["future"])
            self.jobs += 1
        self.queued = []

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)


def smi(query: str) -> str:
    p = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader,nounits" if query.startswith("clocks")
                        else "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 else ""


class Rates:
    """The card's peak rates for the bounds: HBM bytes/s, and int32 ops/s
    = SMs x 64 INT32 lanes x the maximum SM clock."""

    def __init__(self):
        import torch
        props = torch.cuda.get_device_properties(0)
        mhz = smi("clocks.max.sm")
        self.sms = props.multi_processor_count
        self.clock_hz = float(mhz) * 1e6 if mhz else 0.0
        if not self.clock_hz:
            raise RuntimeError("nvidia-smi gave no maximum SM clock")
        self.int_ops = self.sms * INT32_LANES_PER_SM * self.clock_hz
        self.bytes = HBM_BYTES_PER_S

    def bound(self, nbytes: float, ops: float):
        by_bytes = nbytes / self.bytes * 1e3
        by_ops = ops / self.int_ops * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dp_bound(rates, args, out):
    """B1/B3, or B2 (args of banded_dp: 11 tensors, or 12 or with `-G`'s
    path scores 13, a batch), over the rows the
    kernel computes, 0 to gn - 2 (or to the row whose band passed W); the
    rows past them are capacity padding. Bytes: those rows of every per-row
    input read once, their plane rows and band ends written once; the
    scalars, row 0, the query profile and the other outputs (ok and ext;
    B2's ok and mplr, every row's final mpl/mpr) once. Operations per
    in-band cell: 3 maxes per predecessor, then the query profile, H-hat,
    the two F chains (add, max, sub, clamp each), H, the E updates and the
    argmax (22)."""
    import numpy as np
    planes = out[:5]
    if len(args) >= 12:  # a batch: each window's computed rows, summed
        W = planes[0].shape[1]
        row_bytes = (sum(t[0].numel() * t.element_size()
                         for t in (*args[1:9], *args[12:]))
                     + sum(W * p.element_size() for p in planes) + 2 * 4)
        rows_all = ops = 0
        for r0, R, gn, beg, end, ok in b2_windows(args, out):
            b, e = [x.cpu().numpy().astype(np.int64) for x in (beg, end)]
            rows = gn - 1
            wide = np.nonzero(e[1:rows] - b[1:rows] + 1 > W)[0]
            if wide.size:
                rows = int(wide[0]) + 2
            cells = np.clip(e[:rows] - b[:rows] + 1, 0, W)
            cells[0] = 0
            npre = args[3][r0: r0 + rows].cpu().numpy().astype(np.int64)
            ops += float((cells * (3 * npre + 22)).sum())
            rows_all += rows
        # scalars, row 0, the query profiles, roff, ok, ext and every row's
        # mplr
        fixed = nbytes((args[0], args[9], args[10], args[11], out[7], out[6],
                        out[8]))
        return rates.bound(fixed + rows_all * row_bytes, ops)
    if len(args) == 11:  # B2: begend (2R,), gn at scalars[10]
        R = out[5].shape[0] // 2
        beg, end, gn = out[5][:R], out[5][R:], int(args[0][10])
        fixed = (args[0], args[10], args[9], out[7], out[6], out[8])
        per_row = args[1:9]  # base .. mpr0
    else:
        beg, end, gn = out[5], out[6], int(args[0][8])
        fixed = (args[0], args[7], args[8], out[7], out[8])
        per_row = args[1:7]  # base_packed .. remain
    b, e = [x.cpu().numpy().astype(np.int64) for x in (beg, end)]
    W = planes[0].shape[1]
    rows = gn - 1
    wide = np.nonzero(e[1:rows] - b[1:rows] + 1 > W)[0]
    if wide.size:
        rows = int(wide[0]) + 2
    cells = np.clip(e[:rows] - b[:rows] + 1, 0, W)
    cells[0] = 0
    npre = per_row[2].cpu().numpy().astype(np.int64)[:rows]  # pre_cnt
    ops = float((cells * (3 * npre + 22)).sum())
    row_bytes = (sum(t[0].numel() * t.element_size() for t in per_row)
                 + sum(W * p.element_size() for p in planes) + 2 * 4)
    return rates.bound(nbytes(fixed) + rows * row_bytes, ops)


def bt_bound(rates, planes, pre_cnt, ops, res):
    """X1: what the walk reads and writes for this run's path: per step the
    cell and its left neighbour in up to 5 planes, 4 cells and 3 band
    ints per predecessor slot, base/query/score; the op written; ~30 + 12
    per predecessor integer operations."""
    import numpy as np
    n_ops = int(res[0])
    rows = ops[:n_ops, 1].cpu().numpy().astype(np.int64)
    npre = pre_cnt.cpu().numpy().astype(np.int64)[rows]
    item = planes[0].element_size()
    nb = float((10 * item + npre * (4 * item + 12) + 12 + 8).sum())
    return rates.bound(nb, float((30 + 12 * npre).sum()))


def topo_bound(rates, g):
    """K1: the graph's node_n rows read once and the sorted rows, order and
    remain written once; per node the exchange sort's comparisons and the
    two BFS visits."""
    n = int(g.node_n)
    E, A = g.in_ids.shape[1], g.aligned.shape[1]
    nb = n * (4 * E + 3 + A + 1) * 4 + n * (4 * E + 3) * 4
    return rates.bound(nb, float(n * (2 * E * E + 4 * E + 2 * A)))


def f1_bound(rates, g, out, n_ops: int, qlen: int):
    """F1: its op stream (n_ops ops and arguments) and the read (qlen bases
    and weights) read once; per op the two slot rows add_edge scans (E ids
    each) read once; every graph entry the fusion changed (input g against
    output `out`) read and written once. Operations: per op the scans'
    compares and ~16 more."""
    E = g.in_ids.shape[-1]
    changed = sum(int((a != b).sum()) for k, (a, b) in enumerate(zip(
        g.tensors().values(), out.tensors().values())))
    nb = 8 * n_ops + 8 * qlen + n_ops * 2 * E * 4 + 2 * 4 * changed
    return rates.bound(nb, float(n_ops * (2 * E + 16)))


def s1_bound(rates, args, n):
    """S1: the node_n = n rows of the four (N, E) slot arrays and two counts
    read once and of the four sorted arrays written once (the rows past
    node_n have count 0: a sort in place would not touch them); per row the
    exchange sort's cnt (cnt - 1) / 2 compare-and-selects."""
    import numpy as np
    ops = sum(float((c * (c - 1) // 2).sum()) for c in
              (np.minimum(t[:n].cpu().numpy().astype(np.int64),
                          args[0].shape[1]) for t in args[4:6]))
    return rates.bound(2 * nbytes(t[:n] for t in args[:4])
                       + nbytes(t[:n] for t in args[4:6]), ops)


def s1_need_bound(rates, args, n):
    """S1 as the loop runs it (`finish_fusion_`, in place, rows below node_n
    = n, span update on), counted from these inputs (args: the four slot
    arrays and two counts). Bytes: both counts and n_span's entries (read
    and written) below node_n; the weights in the counted slots of the rows
    with two or more; the ids of the rows that move read once and their ids
    and weights written once (the scan read their weights). Operations: a
    compare a counted slot past the first of those rows, the exchange sort's
    cnt (cnt - 1) / 2 compare-and-selects a moving row, an add a span
    entry. Returns (bound, rows with count >= 2, rows that move), each side
    summed."""
    import torch
    from abpoa_tpu_torch.align.edge_sort_kernel import moving_rows
    E = args[0].shape[1]
    nb, ops, multi, moved = 4 * 4 * n, float(n), 0, 0
    for w, cnt in ((args[1], args[4]), (args[3], args[5])):
        w, c = w[:n].cpu(), cnt[:n].cpu().clamp(0, E).long()
        m = c >= 2
        mv = moving_rows(w, c)
        cm = c[mv]
        nb += 4 * int(c[m].sum()) + 3 * 4 * int(cm.sum())
        ops += float((c[m] - 1).sum()) + float((cm * (cm - 1) // 2).sum())
        multi += int(m.sum())
        moved += int(mv.sum())
    return rates.bound(nb, ops), multi, moved


def k1_chains(args):
    """K1's two walks at these inputs, replayed in the plain version's
    order: (nodes visited, mean and max look-ahead) each, the look-ahead of
    a visit being how many visits earlier its queue entry was pushed (how
    far ahead of the walk a helper could prefetch it)."""
    import numpy as np
    from abpoa_tpu_torch.align.edge_sort_kernel import edge_sort_torch
    cpu = [t.cpu() for t in args]
    icnt, ocnt, acnt = cpu[4].tolist(), cpu[5].tolist(), cpu[7].tolist()
    oid, aln = cpu[2].tolist(), cpu[6].tolist()
    iid = edge_sort_torch(*cpu[:6])[0].tolist()
    deg, odeg = list(icnt), list(ocnt)

    def kahn(cur):
        pushed = []
        for t in oid[cur][:max(ocnt[cur], 0)] if cur != 1 else ():
            deg[t] -= 1
            grp = aln[t][:max(acnt[t], 0)]
            if deg[t] == 0 and all(deg[m] == 0 for m in grp):
                pushed += [t, *grp]
        return pushed

    def reverse(cur):
        pushed = []
        for t in iid[cur][:max(icnt[cur], 0)] if cur != 0 else ():
            odeg[t] -= 1
            if odeg[t] == 0:
                pushed.append(t)
        return pushed

    out = []
    for first, stop, visit in ((0, int(cpu[8][0]), kahn),
                               (1, len(icnt) + 1, reverse)):
        queue, by, head = [first], [-1], 0
        while head < len(queue) and head < stop:
            pushed = visit(queue[head])
            queue += pushed
            by += [head] * len(pushed)
            head += 1
        ahead = np.arange(1, head) - np.asarray(by[1:head])
        out.append((head, float(ahead.mean()) if ahead.size else 0.0,
                    int(ahead.max()) if ahead.size else 0))
    return out


def fused_case(abpt, st, query, W, plane16, local):
    """B1's inputs for `query` against a fused-loop state, on its device."""
    import numpy as np
    import torch
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.buckets import qp_rung
    from abpoa_tpu_torch.align.oracle import INT16_MIN, INT32_MIN, dp_inf_min
    dev = st.g.base.device
    tables = fl._build_tables(st.g, st.order, st.n2i, st.remain)
    qlen = len(query)
    qp = np.zeros((abpt.m, qp_rung(qlen)), dtype=np.int32)
    qp[:, 1: qlen + 1] = abpt.mat[:, query]
    inf = dp_inf_min(abpt, INT16_MIN if plane16 else INT32_MIN)
    return fl.dp_inputs(abpt, st, tables, torch.from_numpy(qp).to(dev), qlen,
                        W, inf, local), inf


def synthetic_graph(kind: str):
    """A graph in topological order as (preds, bases) plus a query, for the
    shapes no read set reaches at test size. Row 0 is the source, the last
    row the sink, preds[r] the predecessor rows of r.
    far:  a 120-row chain whose rows past 70 also follow the row 70 back,
          so the DP reads predecessors past the kernel's ring (64 rows at
          W = 128) but inside Pallas's 512-row ring;
    wide: 40 decoy rows after the source, each a predecessor of every row
          of a 60-row chain in slots 0-39, with the chain's own predecessor
          in slot 40 (P = 64 once padded), so the backtrack's first hit sits
          past slot 32.
    Each kind has its own seed: the one under which extend mode's Z-drop
    fires in all three gap regimes."""
    import numpy as np
    rng = np.random.default_rng({"far": 1, "wide": 3}[kind])
    if kind == "far":
        L, far = 120, 70
        preds = [[]] + [[r - 1] + ([r - far] if r > far else [])
                        for r in range(1, L + 1)] + [[L]]
        chain = list(range(1, L + 1))
    elif kind == "wide":
        nd, L = 40, 60
        decoys = list(range(1, nd + 1))
        chain = list(range(nd + 1, nd + L + 1))
        preds = [[]] + [[0] for _ in decoys]
        preds += [decoys + [r - 1 if r > chain[0] else 0] for r in chain]
        preds += [[chain[-1]]]
    else:
        raise ValueError(kind)
    bases = rng.integers(0, 4, len(preds))
    bases[0] = bases[-1] = 0
    query = bases[chain].copy()
    flip = rng.random(len(query)) < 0.08
    query[flip] = (query[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
    query[-12:] = rng.integers(0, 4, 12)  # a noisy tail for Z-drop
    return preds, bases, query.astype(np.uint8)


def slot_graph(n, edges, groups=None, N=None, E=4, A=2):
    """K1's inputs (numpy int32, in its argument order) for a graph of n
    nodes in N rows: edges (u, v, w) listed in slot order, aligned groups
    {v: members}, E edge slots and A aligned slots a node."""
    import numpy as np
    N = N or n
    z = lambda *shape: np.zeros(shape, np.int32)  # noqa: E731
    in_ids, in_w, out_ids, out_w = z(N, E), z(N, E), z(N, E), z(N, E)
    in_cnt, out_cnt, aligned, aligned_cnt = z(N), z(N), z(N, A), z(N)
    for u, v, w in edges:
        out_ids[u, out_cnt[u]], out_w[u, out_cnt[u]] = v, w
        out_cnt[u] += 1
        in_ids[v, in_cnt[v]], in_w[v, in_cnt[v]] = u, w
        in_cnt[v] += 1
    for v, members in (groups or {}).items():
        aligned[v, :len(members)] = members
        aligned_cnt[v] = len(members)
    return [in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
            aligned_cnt, np.array([n], np.int32)]


K1_GRAPHS = ("unsorted", "group_later_slot", "queued_twice", "cycle", "hub",
             "wide_groups", "random")


def k1_graph(kind: str):
    """K1's adversarial graphs (`slot_graph` arrays; source 0, sink 1):
    unsorted:         the source's out slots are not in weight order (and
                      2 -> 5 is listed twice), so a pass 1 that sorted first
                      would order the nodes differently;
    group_later_slot: 2 and 3 are aligned and only follow the source; at
                      slot 0 (node 2) the group check sees 3's degree before
                      slot 1 decrements it, so 3 is queued first, then 2;
    queued_twice:     3's group holds 2 but 2's is empty, so 2 is queued on
                      its own and again after 3: the queue passes
                      N = node_n = 6 and 2 is visited twice;
    cycle:            2 and 3 follow each other: ok = 0, and the reverse BFS
                      stops at the cycle as well;
    hub:              the source has 40 out slots (E = 64, two warp chunks)
                      to nodes aligned in pairs, one pair across the chunks;
    wide_groups:      the source has 64 out slots, each target aligned with
                      the same 100 other nodes (E = 64, A = 100), so the
                      source's record places the groups of slots 41-63 past
                      4096 words after its slot table, and every slot
                      queues 101 nodes (the queue passes N = 176 at once);
    random:           a random DAG of 200 nodes, 1-3 out slots each in random
                      order, weights 1-3, neighbours in its order aligned."""
    import numpy as np
    if kind == "unsorted":
        return slot_graph(7, [(0, 2, 1), (0, 3, 5), (0, 4, 3), (2, 5, 2),
                              (2, 5, 2), (3, 6, 2), (4, 6, 1), (5, 1, 1),
                              (6, 1, 4)], N=16)
    if kind == "group_later_slot":
        return slot_graph(4, [(0, 2, 1), (0, 3, 1), (2, 1, 1), (3, 1, 1)],
                          {2: [3], 3: [2]}, N=16)
    if kind == "queued_twice":
        return slot_graph(6, [(0, 2, 1), (0, 3, 1), (2, 4, 1), (3, 5, 1),
                              (4, 1, 1), (5, 1, 1)], {3: [2]})
    if kind == "cycle":
        return slot_graph(5, [(0, 2, 1), (0, 4, 1), (2, 3, 1), (3, 2, 1),
                              (3, 1, 1), (4, 1, 1)], N=16)
    rng = np.random.default_rng({"hub": 5, "wide_groups": 7, "random": 6}[kind])
    if kind == "hub":
        k = 40
        edges = [(0, 2 + i, int(rng.integers(1, 4))) for i in range(k)]
        edges += [(2 + i, 1, 1) for i in range(k)]
        groups = {}
        for i in range(1, k - 1, 2):
            groups[2 + i], groups[3 + i] = [3 + i], [2 + i]
        return slot_graph(k + 2, edges, groups, N=48, E=64, A=2)
    if kind == "wide_groups":
        targets, members = range(2, 66), list(range(66, 166))
        edges = [(0, t, int(rng.integers(1, 4))) for t in targets]
        edges += [(t, 1, 1) for t in targets]
        return slot_graph(166, edges, {t: members for t in targets}, N=176,
                          E=64, A=100)
    if kind != "random":
        raise ValueError(kind)
    n = 200
    order = [0] + [int(v) for v in rng.permutation(np.arange(2, n))] + [1]
    edges, has_in = [], {0}
    for i, u in enumerate(order[:-1]):
        window = order[i + 1: i + 6]
        for v in rng.permutation(window)[:int(rng.integers(1, 4))]:
            edges.append((u, int(v), int(rng.integers(1, 4))))
            has_in.add(int(v))
        nxt = order[i + 1]
        if nxt not in has_in:
            edges.append((u, nxt, 1))
            has_in.add(nxt)
    linked = {(u, v) for u, v, _ in edges}
    groups = {}
    for i in range(1, n - 2, 3):
        a, b = order[i], order[i + 1]
        if (a, b) not in linked and rng.random() < 0.6:
            groups[a], groups[b] = [b], [a]
    return slot_graph(n, edges, groups, E=8, A=4)


def tie_graph(E: int, seed: int = 11, N: int = 96, n: int = 80):
    """S1's inputs (numpy int32): random slot rows with weights 1-3 (many
    ties), counts 0..E with every seventh row full, rows past n with count
    0 and random contents (copied unchanged)."""
    import numpy as np
    rng = np.random.default_rng(seed + E)
    cnt = [rng.integers(0, E + 1, N).astype(np.int32) for _ in range(2)]
    for c in cnt:
        c[::7] = E
        c[n:] = 0
    slots = [rng.integers(lo, hi, (N, E)).astype(np.int32)
             for lo, hi in ((0, N), (1, 4), (0, N), (1, 4))]
    return slots + cnt


def synthetic_inputs(abpt, preds, bases, query, W, plane16, local, P=None,
                     R=None, O=None, dev="cpu"):
    """B1's inputs for `query` against the graph (preds, bases), laid out
    as the fused loop's `_build_tables` lays a state out: out lists the
    transpose of the pre lists, pre_cnt on rows 1..n-1, out_cnt on rows
    1..n-2, remain the longest path to the sink; R rows, P predecessor and
    O successor slots (zero-padded; by default as many as the graph
    needs). Returns (inputs, inf)."""
    import numpy as np
    import torch
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.buckets import qp_rung
    from abpoa_tpu_torch.align.fused_dp_kernel import row0_planes
    from abpoa_tpu_torch.align.oracle import INT16_MIN, INT32_MIN, dp_inf_min
    n = len(preds)
    outs = [[] for _ in range(n)]
    for r, ps in enumerate(preds):
        for p in ps:
            outs[p].append(r)
    P = P or max(len(p) for p in preds)
    O = O or max(len(o) for o in outs)
    R = R or n
    pre_idx = np.zeros((R, P), np.int32)
    out_idx = np.zeros((R, O), np.int32)
    for r in range(n):
        pre_idx[r, :len(preds[r])] = preds[r]
        out_idx[r, :len(outs[r])] = outs[r]
    pre_cnt = np.zeros(R, np.int32)
    out_cnt = np.zeros(R, np.int32)
    pre_cnt[1:n] = [len(p) for p in preds[1:]]
    out_cnt[1:n - 1] = [len(o) for o in outs[1:n - 1]]
    remain = np.zeros(R, np.int32)
    remain[n - 1] = -1
    for r in range(n - 2, -1, -1):
        remain[r] = max(remain[t] + 1 for t in outs[r])
    base_packed = np.zeros(R, np.int32)
    base_packed[:n] = np.asarray(bases, np.int32) | np.array(
        [256 if r > 0 and 0 in preds[r] else 0 for r in range(n)], np.int32)
    qlen = len(query)
    w = fl._band_w(abpt, qlen)
    inf = dp_inf_min(abpt, INT16_MIN if plane16 else INT32_MIN)
    if local:
        end0 = qlen
    else:
        end0 = min(max(qlen - (int(remain[0]) - int(remain[n - 1]) - 1), 0) + w, qlen)
    scalars = np.array([qlen, w, remain[n - 1], inf, abpt.gap_ext1, abpt.gap_oe1,
                        abpt.gap_ext2, abpt.gap_oe2, n, end0,
                        max(abpt.zdrop, 0), 0, 0, 0, 0, 0], np.int32)
    qp = np.zeros((abpt.m, qp_rung(qlen) + W), np.int32)
    qp[:, 1: qlen + 1] = abpt.mat[:, query]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    row0 = row0_planes(W, torch.tensor(end0, dtype=torch.int32), abpt, inf,
                       local, "cpu").to(dev)
    return (t(scalars), t(base_packed), t(pre_idx), t(pre_cnt), t(out_idx),
            t(out_cnt), t(remain), row0, t(qp)), inf


def x1w_check(p, ts, out, tabs, queries, tag: str):
    """Kernel X1w (backtrack_windows) over the ok windows of one batched B2
    launch (its inputs ts, its outputs out, the windows' row tables and
    queries) on the card, against its plain version on the same inputs, on
    what the walk defines: each window's header, band and n_ops ops.
    Returns (max abs diff, X1w's inputs and keywords, the plain output on
    the host)."""
    import torch
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.backtrack_kernel import (
        HEADER, backtrack_windows, backtrack_windows_torch)
    ok = out[7].tolist()
    slots = [k for k, o in enumerate(ok) if o]
    inputs, kw, layout = banded.walk_inputs(p, ts, out, tabs, queries, slots)
    got = backtrack_windows(*inputs, **kw)
    torch.cuda.synchronize()
    want = backtrack_windows_torch(*inputs, **kw).cpu()
    sel = []
    for k, (h, b, o, _) in zip(slots, layout):
        gn, n_ops = tabs[k].gn, int(want[h])
        sel += [torch.arange(h, h + HEADER), torch.arange(b, b + 2 * gn),
                torch.arange(o, o + 2 * n_ops)]
    sel = torch.cat(sel)
    err = compare(f"backtrack_windows {tag}", [got.cpu()[sel]], [want[sel]])
    return err, inputs, kw, want


def x1w_bound(rates, inputs, want):
    """X1w (inputs of backtrack_windows, its plain output): for each walked
    window, X1's walk of its path (`bt_bound`'s bytes and operations a
    step, with int32 planes), its header and ops written and its band (2 gn
    ints) read and written once."""
    import numpy as np
    from abpoa_tpu_torch.align.backtrack_kernel import HEADER
    pre_cnt = inputs[5].cpu().numpy().astype(np.int64)
    scalars, roff = inputs[7].tolist(), inputs[8].tolist()
    nb = ops = 0.0
    for slot, _, h, _, o, _ in inputs[11].tolist():
        n_ops, gn = int(want[h]), scalars[slot][10]
        rows = want[o: o + 2 * n_ops].view(n_ops, 2)[:, 1].numpy().astype(np.int64)
        npre = pre_cnt[roff[slot] + rows]
        nb += float((10 * 4 + npre * (4 * 4 + 12) + 12 + 8).sum())
        nb += 4 * (HEADER + 4 * gn)
        ops += float((30 + 12 * npre).sum())
    return rates.bound(nb, ops)


def tile_replay(inputs, kw, packed, cols=None) -> dict:
    """X1w's tile rule (csrc/backtrack_windows.cu `walk_tiles`) replayed on
    the walks of one launch (`backtrack_windows`' inputs and keywords, and
    its plain output `packed` on the host), from each walk's start cell and
    ops: which tile each step reads, given a tile's rows and columns
    (`backtrack_kernel.tile_shape`; `cols`, another build's C). A step a
    tile holds (row i, every predecessor of row i, columns j - 1 and j)
    reads shared memory. Returns counts over the launch's walks: `steps`;
    `held`, the steps the current tile holds after the stage change; the
    steps the current tile did not hold before it, by what it missed first
    (`rows`: row i; `far`: a predecessor below it; `columns`: column
    j - 1); `changes` of stage; `loads`, tiles asked for (the first of each
    walk included); `passed`, requests the walk passed below or left of
    before it used them (waited for and asked again); and `share`, held /
    steps."""
    import numpy as np
    from abpoa_tpu_torch.align.backtrack_kernel import tile_shape
    pre_idx, pre_cnt, scalars, roff, mat, plan = (
        inputs[4], inputs[5], inputs[7], inputs[8], inputs[9], inputs[11])
    extra = {"cols": cols} if cols else {}
    shape = tile_shape(kw["gap_mode"], pre_idx.shape[1],
                       kw["pre_score"] is not None, mat.shape[1], **extra)
    R, C = shape["R"], shape["C"]
    pre = pre_idx.cpu().numpy()
    cnt = pre_cnt.cpu().numpy()
    pk = np.asarray(packed)
    ro = roff.tolist()
    out = dict(steps=0, held=0, rows=0, columns=0, far=0, changes=0, loads=0,
               passed=0)

    def box(ai, aj):  # rows [rlo, rhi], columns [clo, chi]
        return max(ai - R + 1, 0), ai, aj - C + 1, aj

    def holds(b, i, j, pmin):
        return b[0] <= i <= b[1] and j - 1 >= b[2] and j <= b[3] and pmin >= b[0]

    for slot, _, h, _, o, max_ops in plan.tolist():
        n_ops, fin_i, fin_j = int(pk[h]), int(pk[h + 1]), int(pk[h + 2])
        i, j = int(pk[h + 9]), int(pk[h + 10])
        ops = pk[o: o + 2 * n_ops].reshape(n_ops, 2)
        r0 = ro[slot]
        cur, other = box(i, j), None
        out["loads"] += 1
        for t in range(n_ops):
            if int(ops[t, 1]) != i:
                raise AssertionError(f"tile_replay: op {t} of slot {slot} is "
                                     f"at row {int(ops[t, 1])}, the walk at {i}")
            c = int(cnt[r0 + i])
            pmin = int(pre[r0 + i, :c].min()) if c else 1 << 30
            if not holds(cur, i, j, pmin):
                out["rows" if i < cur[0] else "far" if pmin < cur[0]
                    else "columns"] += 1
                if other is not None and holds(other, i, j, pmin):
                    cur, other = other, None
                    out["changes"] += 1
            out["held"] += holds(cur, i, j, pmin)
            i = int(ops[t + 1, 1]) if t + 1 < n_ops else fin_i
            j -= int(ops[t, 0]) != 1
            if t + 1 >= max_ops or i <= 0 or j <= 0:
                continue
            if other is not None and (i < other[0] or j - 1 < other[2]):
                other = None
                out["passed"] += 1
            if other is None and (i <= cur[1] - R // 2 or j <= cur[3] - C // 2):
                other = box(i, j)
                out["loads"] += 1
        if j != fin_j:
            raise AssertionError(f"tile_replay: slot {slot}'s walk ends at "
                                 f"column {j}, its header says {fin_j}")
        out["steps"] += n_ops
    out["share"] = out["held"] / max(1, out["steps"])
    return out


def x1w_report(rates, inputs, kw, want, tag: str, plain_ms=None) -> dict:
    """X1w on the card at one launch (`backtrack_windows`' inputs and
    keywords, the plain output `want` on the host): its time (CUDA events,
    5 launches), the plain version's (host clock; `plain_ms` where the
    caller timed it), the bound, µs a step of the longest walk and the share
    of steps the tile rule serves from shared memory (`tile_replay`).
    Logs one line; returns {ms, plain_ms, bound, us_step, replay}."""
    from abpoa_tpu_torch.align.backtrack_kernel import (
        backtrack_windows, backtrack_windows_torch, tile_shape)
    ms = time_cuda(lambda: backtrack_windows(*inputs, **kw), 5)
    if plain_ms is None:
        plain_ms, _ = time_host(lambda: backtrack_windows_torch(*inputs, **kw))
    bnd = x1w_bound(rates, inputs, want)
    steps = [int(want[h]) for _, _, h, _, _, _ in inputs[11].tolist()]
    rep = tile_replay(inputs, kw, want)
    shape = tile_shape(kw["gap_mode"], inputs[4].shape[1],
                       kw["pre_score"] is not None, inputs[9].shape[1])
    us = ms * 1e3 / max(1, max(steps))
    log(f"[D] X1w at {tag} ({len(steps)} windows, one block each; W "
        f"{inputs[0].shape[2]}, tile {shape['R']} rows x {shape['C']} columns, "
        f"{shape['smem']} B shared; steps min {min(steps)} / max {max(steps)} / "
        f"sum {sum(steps)}): kernel == plain (headers, bands, ops); kernel "
        f"{ms:.3f} ms ({us:.3f} us a step of the longest walk), plain "
        f"{plain_ms:.1f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}); steps from "
        f"shared memory {rep['share'] * 100:.2f} % (missed by the current tile "
        f"before a stage change: rows {rep['rows']}, far predecessor "
        f"{rep['far']}, columns {rep['columns']}; {rep['changes']} stage "
        f"changes, {rep['loads']} tiles, {rep['passed']} passed)")
    return dict(ms=ms, plain_ms=plain_ms, bound=bnd, us_step=us, replay=rep)


# X1w's tile fixtures (`tile_fixture`): the Params fields of each gap mode
# and of each fixture
TILE_GAPS = {"convex": {}, "affine": {"gap_open2": 0}, "linear": {"gap_open1": 0}}
TILE_FIXTURES = {"bubble": {}, "gaps": {}, "local": {"align_mode": 1},
                 "path scores": {"inc_path_score": True},
                 "whole rows": {"wb": -1}}


def tile_fixture(kind: str, gap: str):
    """A graph and a query built to reach one branch of X1w's tile rule
    (`tile_replay`), through the port's per-read route on the CPU, from an
    800 bp random reference (seed 5) and reads of it at 1 % error:
    - "bubble": two of the four graph reads carry a 300 bp insertion, so
      the row after it has a predecessor 301 rows back, past any tile; the
      query lacks it;
    - "gaps": the query carries a 60 bp insertion and lacks 60 bp, runs
      longer than a tile's columns;
    - "local": local mode, the query's 500 middle bases and 80 random ones
      after them: the walk starts and stops inside the graph;
    - "path scores" and "whole rows": "gaps" with `-G` and with `-b -1`.
    Returns (Params on the CPU, the sorted graph, the query)."""
    import numpy as np
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.pipeline import Abpoa, _select_graph, poa, want_native
    rng = np.random.default_rng(5)

    def mutate(s, err=0.01):
        out = []
        for b in s.tolist():
            r = rng.random()
            if r < err / 3:
                continue
            if r < 2 * err / 3:
                out.append(int(rng.integers(0, 4)))
            out.append(int((b + 1 + rng.integers(0, 3)) % 4) if r < err else b)
        return np.array(out, np.uint8)

    ref = rng.integers(0, 4, 800).astype(np.uint8)
    ins = rng.integers(0, 4, 300).astype(np.uint8)
    if kind == "bubble":
        alt = np.concatenate([ref[:400], ins, ref[400:]])
        reads = [mutate(x) for x in (alt, ref, alt, ref)]
        query = mutate(ref)
    else:
        reads = [mutate(ref) for _ in range(4)]
        if kind == "local":
            query = np.concatenate([ref[150:650], ins[:80]])
        else:
            query = np.concatenate([ref[:300], ins[:60], ref[300:500], ref[560:]])
    p = Params(device="cpu", **TILE_GAPS[gap], **TILE_FIXTURES[kind]).finalize()
    ab = Abpoa()
    _select_graph(ab, want_native(p))
    poa(ab, p, reads, [np.ones(len(r), np.int64) for r in reads], 0)
    ab.graph.topological_sort(p)
    return p, ab.graph, query


def tile_launch(p, g, query):
    """B2 (B2u for whole rows) on the device of Params `p` over one window,
    the whole graph `g` and `query`, from the first band width up to the
    one it fits: (the launch's inputs, its outputs, the row tables)."""
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.banded_kernel import check_ok
    from abpoa_tpu_torch.align.tables import build_row_tables, initial_band_width
    t = build_row_tables(g, 0, 1, p)
    W = initial_band_width(p, len(query))
    while True:
        ts, out = banded.run_windows(p, [t], [query], W)
        if check_ok(out[7])[0]:
            return ts, out, t
        W = banded.next_band_width(W, len(query))


def per_read_split(st: dict, fusion_s: float, n: int) -> str:
    """The per-read and seeded routes' time a read (ms) from `banded.stats`
    and the fusion's timer."""
    per = lambda x: f"{x * 1e3 / max(1, n):.1f}"  # noqa: E731
    return (f"tables (C++, pack, upload) {per(st['tables_s'])}, B2 "
            f"{per(st['kernel_s'])}, X1w {per(st['backtrack_s'])} (CUDA events), "
            f"copy of the small results {per(st['d2h_s'])} "
            f"({st['d2h_bytes'] / max(1, n) / 1024:.1f} KiB a read; the planes, "
            f"{st['planes_bytes'] / max(1, n) / 2**20:.1f} MiB a read, stay on "
            f"the card), band write-back + cigar rebuild {per(st['cigar_s'])}, "
            f"fusion + sort (C++) {per(fusion_s)}")


def check_walks(tag: str, st: dict, b2: int, x1w: int) -> None:
    """X1w ran once a B2 launch with an ok window (at least once a read),
    and what came back to the host is no copy of the planes."""
    if not st["reads"] <= x1w <= b2:
        raise AssertionError(f"{tag}: {x1w} X1w launches for {b2} B2 launches "
                             f"and {st['reads']} aligned reads")
    if st["d2h_bytes"] * 20 > st["planes_bytes"]:
        raise AssertionError(f"{tag}: {st['d2h_bytes']} bytes copied to the "
                             f"host for {st['planes_bytes']} bytes of planes")


def bt_inputs(abpt, args, out, query, inf, tracked):
    """X1's inputs for B1's outputs `out`, as the fused loop builds them."""
    import numpy as np
    import torch
    from abpoa_tpu_torch.align import fused_loop as fl
    dev = out[0].device
    H, E1, E2, F1, F2, beg, end, ok, ext = out
    scalars, base_packed, pre_idx, pre_cnt = args[:4]
    qlen, n = len(query), scalars[8:9]
    bi, bj, _ = fl.best_cell(H, beg, end, pre_idx, pre_cnt, n, ext, qlen, inf,
                             tracked)
    Qp = args[8].shape[1] - H.shape[1]
    q = torch.zeros(Qp, dtype=torch.int32, device=dev)
    q[:qlen] = torch.from_numpy(query.astype(np.int32)).to(dev)
    max_ops = H.shape[0] + Qp + 8
    sc = torch.cat([torch.stack([bi, bj]).to(torch.int32),
                    torch.tensor([abpt.gap_ext1, abpt.gap_oe1, abpt.gap_ext2,
                                  abpt.gap_oe2, inf, max_ops],
                                 dtype=torch.int32, device=dev)])
    mat = torch.from_numpy(abpt.mat.astype(np.int32)).to(dev)
    return ((H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base_packed, q,
             mat, sc), max_ops)


def fused_state(abpt, seqs, n):
    """The port's fused-loop state after the first n reads, on abpt's
    device; also the input of the first Kahn repair that run made."""
    import numpy as np
    from abpoa_tpu_torch.align import fused_loop as fl
    captured = []
    real = fl.topo_sort

    def capture(*a):
        if not captured:
            captured.append([t.clone() for t in a])
        return real(*a)

    fl.topo_sort = capture
    try:
        w = [np.ones(len(s), dtype=np.int64) for s in seqs[:n]]
        fl.progressive_poa_fused(seqs[:n], w, abpt)
        st = fl.last_state
    finally:
        fl.topo_sort = real
    return st, (captured[0] if captured else None)


def sweep_warps(tag, args, kw, want):
    """Times B1/B3 (kw: fused_dp's keywords), or B2 (kw None), at every
    column-warp count that covers the band (at most 16 columns a thread,
    32 for B2), each launch held equal to the plain version's outputs
    `want` on the computed rows; logs µs a computed row."""
    import torch
    from abpoa_tpu_torch import constants as C
    from abpoa_tpu_torch.align.banded_kernel import banded_dp
    from abpoa_tpu_torch.align.fused_dp_kernel import (fused_dp,
                                                       launch_shape,
                                                       table_warps)
    W, P = want[0].shape[1], args[2].shape[1]
    if kw is None:
        run = lambda wp: banded_dp(*args, warps=wp)  # noqa: E731
        shape = lambda wp: launch_shape(W, P, C.CONVEX_GAP, wp, seeded=True)  # noqa: E731
    else:
        run = lambda wp: fused_dp(*args, **kw, warps=wp)  # noqa: E731
        shape = lambda wp: launch_shape(W, P, kw["gap_mode"], wp)  # noqa: E731
    for wp in (1, 2, 4, 8, 16, 32):
        try:
            ls = shape(wp)
        except ValueError:  # too few warps for W
            continue
        got = run(wp)
        torch.cuda.synchronize()
        _, rows = compare_dp(f"{tag} warps={wp}", got, want, args)
        ms = time_cuda(lambda: run(wp), 3)
        log(f"[sweep] {tag} W={W} warps={wp}{' (table)' if wp == table_warps(W) else ''}"
            f" (cpt {ls['cpt']}, ring D={ls['depth']}): {ms:.3f} ms, "
            f"{ms * 1e3 / max(1, rows - 1):.3f} us a computed row, == plain")


def timed(owner, name: str, acc: dict, key: str):
    """Replace owner.name by a wrapper that adds its wall time to acc[key];
    returns the function that puts the original back."""
    real = getattr(owner, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0

    setattr(owner, name, wrapper)
    return lambda: setattr(owner, name, real)


def run_pipeline(argv, out_path: str):
    """The CLI's run of argv (its parser, Params and pipeline), writing to
    out_path; returns the pipeline's Abpoa, which holds the consensus."""
    from abpoa_tpu_torch import cli
    from abpoa_tpu_torch.pipeline import Abpoa, msa_from_file
    ns = cli.build_parser().parse_args(argv)
    ab = Abpoa()
    with open(out_path, "w") as fp:
        msa_from_file(ab, cli.args_to_params(ns).finalize(), ns.input, fp)
    return ab


def forced_collisions(abpt, recs, want: str) -> dict:
    """The fused route on `recs` with `_fuse_vectorized`'s collision flag
    forced on every read (tests/test_torch_read_ids.py forces it so): each
    read takes kernel F1's sequential fusion on the card, its S1 and a Kahn
    repair. Its consensus must equal `want` (the unforced run's), and no
    host graph (`device_graph._HostGraph`, the plain walk's) may be built
    on the card. The counts are set to 0 just before the run and read just
    after. Returns its wall, launches and counters."""
    import torch
    from abpoa_tpu_torch.align import device_graph
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.edge_sort_kernel import edge_sort
    from abpoa_tpu_torch.align.fuse_kernel import fuse_alignment_lanes
    from abpoa_tpu_torch.align.topo_kernel import topo_sort
    from abpoa_tpu_torch.pipeline import (Abpoa, _ingest_records,
                                          _run_fused_device, output)
    real, real_host = fl._fuse_vectorized, device_graph._HostGraph.__init__
    built = []

    def colliding(*a, **k):
        out = list(real(*a, **k))
        out[4] = torch.ones((), dtype=torch.bool, device=out[4].device)
        return tuple(out)

    def host_graph(self, g):
        built.append(g.base.device.type)
        real_host(self, g)

    ab = Abpoa()
    seqs, weights = _ingest_records(ab, abpt, recs)
    fl.reset_stats()
    fuse_alignment_lanes.launches = topo_sort.launches = edge_sort.launches = 0
    fl._fuse_vectorized, device_graph._HostGraph.__init__ = colliding, host_graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        _run_fused_device(ab, abpt, seqs, weights)
    finally:
        fl._fuse_vectorized, device_graph._HostGraph.__init__ = real, real_host
    wall = time.perf_counter() - t0
    out = dict(wall=wall, f1=fuse_alignment_lanes.launches,
               k1=topo_sort.launches, s1=edge_sort.launches,
               collisions=fl.stats["collisions"], syncs=fl.stats["syncs"])
    buf = io.StringIO()
    output(ab, abpt, buf)
    if buf.getvalue() != want:
        raise AssertionError("C2: forced collisions change the consensus")
    if "cuda" in built:
        raise AssertionError(f"C2: {built.count('cuda')} host graphs built "
                             "from the card's graph")
    n = len(recs) - 1
    if out["f1"] < n or out["collisions"] < n or out["k1"] < n:
        raise AssertionError(f"C2: forced collisions: F1 {out['f1']}, K1 "
                             f"{out['k1']}, collisions {out['collisions']} "
                             f"for {n} aligned reads")
    return out


def run_cli(argv):
    from abpoa_tpu_torch import cli
    rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}")


def phase_c5(args, ref: str, rows: list, msa_len: int):
    """Phase C5: `rows` are phase C3's MSA rows of the reads. Returns the
    CLI's B2 and X1w launches and (b)'s per-read graph (the restored MSA
    and the new reads), the largest graph C5 (c) launches B2 on."""
    import numpy as np
    import torch
    from abpoa_tpu_torch import pipeline as pl
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.backtrack_kernel import backtrack
    from abpoa_tpu_torch.align.banded_kernel import banded_dp
    from abpoa_tpu_torch.align.edge_sort_kernel import edge_sort
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp
    from abpoa_tpu_torch.align.topo_kernel import topo_sort
    from abpoa_tpu_torch.align.backtrack_kernel import backtrack_windows
    from abpoa_tpu_torch.io import restore as restore_mod
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.native.graph import NativePOAGraph
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.pipeline import (Abpoa, _ingest_records, _select_graph,
                                          output, poa, want_native)
    n = len(rows)
    m5 = args.c5_reads
    m5b = min(20, m5)
    ref_codes = np.searchsorted(np.frombuffer(b"ACGT", dtype=np.uint8),
                                np.frombuffer(ref.encode(), dtype=np.uint8))
    reads5 = [acgt(x) for x in sim_reads(ref_codes, m5, 0.10,
                                         np.random.default_rng(args.seed + 5))]
    msa5 = os.path.join(OUT, "restore_msa.fa")
    with open(msa5, "w") as fp:
        fp.write("".join(f">{nm}\n{row}\n" for nm, row in rows))
    fa5, fa5b = os.path.join(OUT, "new_reads.fa"), os.path.join(OUT, "new_reads_b.fa")
    for path, k in ((fa5, m5), (fa5b, m5b)):
        with open(path, "w") as fp:
            fp.write("".join(f">new_{i}\n{r}\n" for i, r in enumerate(reads5[:k])))
    # (a) -i through the CLI: the fused loop from the restored state
    split5 = {}
    undo = [timed(restore_mod, "restore_graph", split5, "restore")]
    uploads = []
    real_upload = fl.state_from_host_graph

    def upload(pg, *a, **k):
        st_u = real_upload(pg, *a, **k)
        uploads.append((pg.node_n, int(st_u.g.node_n)))
        return st_u

    fl.state_from_host_graph = upload
    undo.append(lambda: setattr(fl, "state_from_host_graph", real_upload))
    out5 = os.path.join(OUT, "incr_cons.fa")
    fl.reset_stats()
    fl.timing = True
    fused_dp.launches = fused_dp.local_launches = banded_dp.launches = 0
    backtrack.launches = topo_sort.launches = edge_sort.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli([fa5, "-i", msa5, "-o", out5])
    wall5 = time.perf_counter() - t0
    fl.timing = False
    for u in undo:
        u()
    launches5 = {"fused_dp": fused_dp.launches, "backtrack": backtrack.launches,
                 "edge_sort": edge_sort.launches, "topo_sort": topo_sort.launches}
    s5 = dict(fl.stats)
    if len(uploads) != 1 or uploads[0][0] != uploads[0][1] or uploads[0][0] <= 2:
        raise AssertionError(f"restored graph and uploaded node_n: {uploads}")
    if banded_dp.launches or fused_dp.local_launches:
        raise AssertionError("-i on the fused route launched another route's kernel")
    if min(launches5["fused_dp"], launches5["backtrack"],
           launches5["edge_sort"]) < m5:
        raise AssertionError(f"-i launches {launches5} for {m5} new reads")
    if s5["reads"] < m5:
        raise AssertionError(f"-i: {s5['reads']} read attempts for {m5} new reads")
    cons5 = read_fastx(out5)
    if len(cons5) != 1 or not set(cons5[0].seq) <= set("ACGT"):
        raise AssertionError("-i: expected one ACGT consensus")
    ident5 = 1 - edit_distance(cons5[0].seq, ref) / len(ref)
    loop5 = s5["wall_s"] - s5["upload_s"] - s5["download_s"]
    dev5 = s5["device_s"]
    per5 = lambda x: f"{x / m5 * 1e3:.2f}"  # noqa: E731
    log(f"[C5] (a) {m5} new reads onto the restored MSA of phase C3 ({n} rows, "
        f"{msa_len} columns; graph {uploads[0][0]} nodes == uploaded node_n "
        f"{uploads[0][1]}), -i through the CLI, fused route: wall {wall5:.2f} s; "
        f"consensus identity to reference {ident5:.5f}")
    log(f"[C5] (a) wall split (s): restore (parse) {split5['restore']:.2f}, state "
        f"upload {s5['upload_s']:.2f}, loop {loop5:.2f}, download "
        f"{s5['download_s']:.2f}, the rest (topological sort of the restored "
        f"graph, reading, consensus, writing) "
        f"{wall5 - split5['restore'] - s5['wall_s']:.2f}")
    log(f"[C5] (a) per new read (ms): loop {per5(loop5)}; on the stream B1 "
        f"{per5(dev5['fused_dp'])}, X1 {per5(dev5['backtrack'])}, K1 "
        f"{per5(dev5['topo_sort'])}; launches {launches5}; read attempts "
        f"{s5['reads']}, host syncs {s5['syncs']}, Kahn repairs {s5['kahn']}, "
        f"collisions {s5['collisions']}, growths {s5['grow']}, final caps "
        f"{s5['caps']}")
    if ident5 < 0.99:
        raise AssertionError(f"-i consensus identity {ident5:.5f} < 0.99")
    # (b) the first m5b new reads, per-read route and fused route, from one
    # restored graph (the fused run takes a Python copy of it)
    abpt5 = Params(device="cuda", incr_fn=msa5).finalize()
    ab_r = Abpoa()
    _select_graph(ab_r, want_native(abpt5))  # as pipeline.msa gives it
    t0 = time.perf_counter()
    restore_mod.restore_graph(ab_r, abpt5)
    t_restore5 = time.perf_counter() - t0
    exist5 = ab_r.n_seq
    recs5 = read_fastx(fa5b)
    ab_f = Abpoa(graph=ab_r.graph.to_python(), names=list(ab_r.names),
                 comments=list(ab_r.comments), quals=list(ab_r.quals),
                 seqs=list(ab_r.seqs), is_rc=list(ab_r.is_rc))
    outs5, split5b = [], {}
    for route, ab in (("fused", ab_f), ("per-read", ab_r)):
        seqs, weights = _ingest_records(ab, abpt5, recs5)
        banded_dp.launches = fused_dp.launches = backtrack_windows.launches = 0
        banded.reset_stats()
        t0 = time.perf_counter()
        if route == "fused":
            pl._run_fused_device(ab, abpt5, seqs, weights, exist5)
            b1_5b = fused_dp.launches
        else:
            undo = timed(NativePOAGraph, "add_subgraph_alignment", split5b, "fusion")
            try:
                poa(ab, abpt5, seqs, weights, exist5)
            finally:
                undo()
            pr5_wall, pr5 = time.perf_counter() - t0, dict(banded.stats)
            b2_5b, x1w_5b = banded_dp.launches, backtrack_windows.launches
        buf = io.StringIO()
        output(ab, abpt5, buf)
        outs5.append(buf.getvalue())
        log(f"[C5] (b) {route} route, {m5b} new reads from the restored graph: "
            f"{time.perf_counter() - t0:.2f} s")
    if outs5[0] != outs5[1]:
        raise AssertionError("-i: per-read and fused routes give different consensus")
    if b2_5b < m5b or b1_5b < m5b:
        raise AssertionError(f"-i (b): B2 launches {b2_5b}, B1 launches {b1_5b}")
    check_walks("C5 (b)", pr5, b2_5b, x1w_5b)
    n5 = max(1, pr5["reads"])
    log(f"[C5] (b) per-read (B2 launches {b2_5b}, X1w {x1w_5b}) == fused (B1 "
        f"launches {b1_5b}) consensus, byte for byte; restore (native graph) "
        f"{t_restore5:.2f} s; per-read route per read {pr5_wall * 1e3 / n5:.1f} "
        f"ms = {per_read_split(pr5, split5b.get('fusion', 0.0), n5)} "
        f"({pr5['rows']} DP rows launched)")
    graph5 = ab_r.graph
    del ab_r, ab_f
    # (c) -i -r 1 through the CLI: the per-read route, B2 launched by the CLI
    out5c = os.path.join(OUT, "incr_msa.fa")
    split5c = {}
    undo = [timed(restore_mod, "restore_graph", split5c, "restore"),
            timed(pl, "poa", split5c, "poa"),
            timed(NativePOAGraph, "add_subgraph_alignment", split5c, "fusion")]
    banded.reset_stats()
    fused_dp.launches = fused_dp.local_launches = banded_dp.launches = 0
    backtrack_windows.launches = 0
    t0 = time.perf_counter()
    run_cli([fa5b, "-i", msa5, "-r", "1", "-o", out5c])
    wall5c = time.perf_counter() - t0
    for u in undo:
        u()
    b2_c5, x1w_c5 = banded_dp.launches, backtrack_windows.launches
    pr5c = dict(banded.stats)
    check_walks("C5 (c)", pr5c, b2_c5, x1w_c5)
    if pr5c["reads"] < m5b or b2_c5 < m5b or fused_dp.launches \
            or fused_dp.local_launches:
        raise AssertionError(f"-i -r 1: B2 launches {b2_c5}, B1 launches "
                             f"{fused_dp.launches}")
    rows5 = read_fasta_rows(out5c)
    if [nm for nm, _ in rows5] != [nm for nm, _ in rows] + \
            [f"new_{i}" for i in range(m5b)]:
        raise AssertionError("-i -r 1: the MSA's rows are not the restored and new reads")
    for i, (_, row) in enumerate(rows5[:n]):
        if row.replace("-", "") != rows[i][1].replace("-", ""):
            raise AssertionError(f"-i -r 1: restored row {i} changed")
    for i, (_, row) in enumerate(rows5[n:]):
        if row.replace("-", "") != reads5[i]:
            raise AssertionError(f"-i -r 1: new row {i} without gaps is not its read")
    n5c = max(1, pr5c["reads"])
    log(f"[C5] (c) {m5b} new reads, -i -r 1 through the CLI, per-read route: wall "
        f"{wall5c:.2f} s, B2 launches {b2_c5} ({pr5c['rows']} DP rows), B1 none; "
        f"MSA {len(rows5[0][1])} columns, each restored row without gaps == its "
        f"restored row, each new row == its read")
    log(f"[C5] (c) wall split (s): restore (parse, with read ids) "
        f"{split5c['restore']:.2f}, per-read loop {split5c['poa']:.2f}, the rest "
        f"(graph export, MSA ranks, rows, writing) "
        f"{wall5c - split5c['restore'] - split5c['poa']:.2f}; per read (ms): "
        f"{split5c['poa'] * 1e3 / n5c:.1f} = "
        f"{per_read_split(pr5c, split5c.get('fusion', 0.0), n5c)}; X1w launches "
        f"{x1w_c5}; pinned buffer {banded._pinned[0].numel() * 4 / 2**20:.2f} MiB")
    return b2_c5, x1w_c5, graph5


def phase_c6(args, h1, h2) -> int:
    """Phase C6: h1, h2 are phase C4's haplotypes. Returns the CLI's B2
    and X1w launches."""
    import numpy as np
    from abpoa_tpu_torch import pipeline as pl
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.backtrack_kernel import backtrack_windows
    from abpoa_tpu_torch.native.graph import NativePOAGraph
    from abpoa_tpu_torch.align.banded_kernel import banded_dp
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp
    from abpoa_tpu_torch.cons import cluster as cluster_mod
    from abpoa_tpu_torch.params import Params
    abpt = Params(device="cpu").finalize()
    hs = (acgt(h1), acgt(h2))
    m6 = args.c6_reads
    rng6 = np.random.default_rng(args.seed + 6)
    q1, q2 = (sim_reads_qual(h, m6 // 2, 0.10, rng6) for h in (h1, h2))
    reads6 = [x for pair in zip(q1, q2) for x in pair]
    m6 = len(reads6)
    names6 = [f"read_{i}_h{i % 2 + 1}" for i in range(m6)]
    fq6 = os.path.join(OUT, "diploid.fq")
    with open(fq6, "w") as fp:
        fp.write("".join(f"@{nm}\n{acgt(c)}\n+\n{(q + 33).astype(np.uint8).tobytes().decode()}\n"
                         for nm, (c, q) in zip(names6, reads6)))
    out6 = os.path.join(OUT, "diploid_q.gfa")
    split6 = {}
    undo = [timed(cluster_mod, "multip_read_clu_kmedoids", split6, "cluster"),
            timed(pl, "poa", split6, "poa"),
            timed(pl, "generate_gfa", split6, "gfa"),
            timed(NativePOAGraph, "add_subgraph_alignment", split6, "fusion")]
    banded.reset_stats()
    fused_dp.launches = fused_dp.local_launches = banded_dp.launches = 0
    backtrack_windows.launches = 0
    t0 = time.perf_counter()
    ab6 = run_pipeline([fq6, "-d", "2", "-Q", "-r", "4"], out6)
    wall6 = time.perf_counter() - t0
    for u in undo:
        u()
    b2_c6, pr6 = banded_dp.launches, dict(banded.stats)
    x1w_c6 = backtrack_windows.launches
    check_walks("C6", pr6, b2_c6, x1w_c6)
    if pr6["reads"] < m6 - 1 or b2_c6 < m6 - 1 or fused_dp.launches \
            or fused_dp.local_launches:
        raise AssertionError(f"-d 2 -Q: B2 launches {b2_c6}, B1 launches "
                             f"{fused_dp.launches} for {m6} reads")
    abc6 = ab6.cons
    if sorted(r for ids in abc6.clu_read_ids for r in ids) != list(range(m6)):
        raise AssertionError("-d 2 -Q: the clusters' read lists do not partition the reads")
    spells6 = gfa_spells(out6)
    for nm, (c, _) in zip(names6, reads6):
        if spells6.get(nm) != acgt(c):
            raise AssertionError(f"-d 2 -Q -r 4: the GFA path of {nm} does not spell it")
    n6 = max(1, pr6["reads"])
    gfa6 = split6["gfa"] - split6.get("cluster", 0.0)
    log(f"[C6] {m6} reads ({m6 // 2} a haplotype, interleaved) x {args.ref_len} bp "
        f"at 10% error as FASTQ (erroneous bases phred 3-14, the rest 20-40), "
        f"-d 2 -Q -r 4, per-read route: wall {wall6:.2f} s; B2 launches {b2_c6}, "
        f"B1 none; final graph {ab6.graph.node_n} nodes, {pr6['rows'] / n6:.0f} "
        f"DP rows a read; {abc6.n_cons} consensus sequences; the read lists "
        f"partition the reads; every P line spells its read")
    log(f"[C6] wall split (s): per-read loop {split6['poa']:.2f} (per read, ms: "
        f"{split6['poa'] * 1e3 / n6:.1f} = "
        f"{per_read_split(pr6, split6.get('fusion', 0.0), n6)}; X1w launches "
        f"{x1w_c6}), clustering (MSA, het columns, k-medoids) "
        f"{split6.get('cluster', 0.0):.2f}, the rest of the GFA (bundling, walk, "
        f"writing) {gfa6:.2f}, the rest {wall6 - split6['poa'] - split6['gfa']:.2f}")
    for k in range(abc6.n_cons):
        seq6 = "".join(chr(c) for c in abpt.code_to_char[abc6.cons_base[k]])
        idents = [1 - edit_distance(seq6, h) / len(h) for h in hs]
        hap_n = [sum(1 for r in abc6.clu_read_ids[k] if r % 2 == j) for j in (0, 1)]
        log(f"[C6] consensus {k + 1}: {len(seq6)} bp, identity {idents[0]:.5f} "
            f"to haplotype 1, {idents[1]:.5f} to haplotype 2; its "
            f"{len(abc6.clu_read_ids[k])} reads: {hap_n[0]} of haplotype 1, "
            f"{hap_n[1]} of haplotype 2")
    return b2_c6, x1w_c6


# flags of the seeded runs on sim2k's 2 kb reads that give each read several
# windows: at abPOA's k = 19, w = 10 its reads share no chained anchor, so
# -S -n 200 gives one window a read
SIM2K_WINDOWS = ["-S", "-k", "11", "-w", "5", "-n", "50"]


def record_windows():
    """Wrap `dispatch.align_windows` and `banded.run_windows`: returns (calls,
    undo); calls gets, per aligned read, {"windows": [(beg, end, query)],
    "launches": [(tables, queries, W) of each B2 launch]}."""
    from abpoa_tpu_torch.align import banded, dispatch
    calls = []
    real_aw, real_rw = dispatch.align_windows, banded.run_windows

    def aw(g, abpt, windows, mesh=None):
        calls.append({"windows": list(windows), "launches": []})
        return real_aw(g, abpt, windows, mesh)

    def rw(abpt, tabs, queries, W, graph_half=None, **kw):
        if calls:
            calls[-1]["launches"].append((list(tabs), list(queries), W))
        return real_rw(abpt, tabs, queries, W, graph_half, **kw)

    dispatch.align_windows, banded.run_windows = aw, rw

    def undo():
        dispatch.align_windows, banded.run_windows = real_aw, real_rw
    return calls, undo


def far_window(cpu):
    """Row tables and query of a window whose predecessor lies 100 rows
    back, past B2's shared-memory ring: a 400-base chain and a copy of it
    without bases 150..249 fused onto it."""
    import numpy as np
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.tables import build_row_tables
    from abpoa_tpu_torch.graph import POAGraph
    rng = np.random.default_rng(3)
    s1 = rng.integers(0, 4, 400).astype(np.uint8)
    s2 = np.concatenate([s1[:150], s1[250:]])
    g = POAGraph()
    g.add_alignment(cpu, s1, None, [], True)
    g.add_alignment(cpu, s2, None,
                    banded.align_sequence_to_subgraph(g, cpu, 0, 1, s2).cigar, True)
    t = build_row_tables(g, 0, 1)
    rr = np.arange(t.gn)[:, None]
    live = np.arange(t.pre_idx.shape[1])[None, :] < t.pre_cnt[:t.gn, None]
    back = int(((rr - t.pre_idx[:t.gn]) * live).max())
    if back < 100:
        raise AssertionError(f"far window: predecessors {back} rows back")
    return t, s1, back


def two_node_window(g):
    """Row tables of a window with only its two ends (gn = 2): a node and
    its successor next in the topological order."""
    from abpoa_tpu_torch.align.tables import build_row_tables
    i2n = g.index_to_node_id
    nodes = g.to_python().nodes if getattr(g, "is_native", False) else g.nodes
    for i in range(1, g.node_n - 2):
        a, b = int(i2n[i]), int(i2n[i + 1])
        if b in nodes[a].out_ids:
            t = build_row_tables(g, a, b)
            if t.gn == 2:
                return t
    raise AssertionError("no two-node window in the graph")


def phase_a_windows(dev, data_dir, max_err) -> None:
    """Phase A, batched B2: the windows of sim2k's 4th read (SIM2K_WINDOWS)
    in each gap mode, with a window of only its two ends, a window whose
    predecessor is past the ring and an empty query (the forced
    adjacent-anchor spec: the first window's subgraph, no bases), one launch
    held against the plain version window by window; a narrower launch in
    which only some windows overflow; the seeded route on cuda == on cpu;
    the relaunch of the overflowed part of a batch, end to end."""
    import copy
    import numpy as np
    import torch
    from abpoa_tpu_torch import convert
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.banded_kernel import banded_dp, banded_dp_torch
    from abpoa_tpu_torch.align.fused_dp_kernel import launch_shape
    from abpoa_tpu_torch.align.tables import initial_band_width
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.params import Params
    sim2k = read_fastx(os.path.join(data_dir, "sim2k.fa"))
    fa = os.path.join(OUT, "sim2k_4w.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">{r.name}\n{r.seq}\n" for r in sim2k[:4]))
    cpu = Params(device="cpu").finalize()
    far_t, far_q, back = far_window(cpu)
    gaps = {"convex": ([], {}), "affine": (["-O", "4"], {"gap_open2": 0}),
            "linear": (["-O", "0"], {"gap_open1": 0, "gap_open2": 0})}
    for gname, (flags, kw) in gaps.items():
        outs = {}
        for device in ("cuda", "cpu"):
            calls, undo = record_windows()
            try:
                ab = run_pipeline([fa, *SIM2K_WINDOWS, *flags, "--device", device],
                                  os.path.join(OUT, f"sim2k_4w_{gname}.{device}"))
            finally:
                undo()
            with open(os.path.join(OUT, f"sim2k_4w_{gname}.{device}")) as fp:
                outs[device] = fp.read()
            if device == "cuda":
                last, g = calls[-1], ab.graph
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"sim2k {SIM2K_WINDOWS} {flags} on cuda differs from cpu")
        p = Params(device="cuda", **kw).finalize()
        tabs, queries, _ = last["launches"][0]
        tabs = [tabs[0], far_t, *tabs[1:], two_node_window(g), tabs[0]]
        queries = [queries[0], far_q, *queries[1:], queries[0][:7], queries[0][:0]]
        W0 = max(initial_band_width(p, len(q)) for q in queries)
        for W in (W0, 64):
            ts = to_dev(banded.pack_windows(p, tabs, queries, W), dev)
            got = banded_dp(*ts, gap_mode=p.gap_mode)
            torch.cuda.synchronize()
            plain_ms, want = time_plain(banded_dp_torch, ts, gap_mode=p.gap_mode)
            err, rows = compare_dp(f"banded_dp windows {gname} W={W}", got, want, ts)
            max_err["banded_dp[windows]"] = max(max_err["banded_dp[windows]"], err)
            err_w = x1w_check(p, ts, got, tabs, queries, f"{gname} W={W}")[0]
            max_err["backtrack[windows]"] = max(max_err["backtrack[windows]"], err_w)
            ok = got[7].tolist()
            if W == W0 and not all(ok):
                raise AssertionError(f"windows {gname} W={W}: ok {ok}")
            if W != W0 and (all(ok) or not any(ok)):
                raise AssertionError(f"windows {gname} W={W}: ok {ok}, want some overflow")
            ls = launch_shape(W, ts[2].shape[1], p.gap_mode, seeded=True)
            log(f"[A] B2 batched, {gname}: {len(tabs)} windows of sim2k read 4 "
                f"({' '.join(SIM2K_WINDOWS)}; one {back} rows back past the ring "
                f"D={ls['depth']}, one of gn = 2, one empty query), W={W}, "
                f"{ls['block_warps']} warps: kernel == plain on {rows} computed "
                f"rows, begend, mplr, ok {ok} (plain {plain_ms:.1f} ms); X1w "
                f"over its {sum(ok)} ok windows == plain (headers, bands, ops)")
        # the relaunch of the windows that overflowed, end to end, from
        # copies of the final graph, cuda against cpu
        res, mp = [], []
        for p_dev in (p, Params(device="cpu", **kw).finalize()):
            gc = copy.deepcopy(g)
            before = banded.retries
            calls_r, undo = record_windows()
            try:
                calls_r.append({"windows": last["windows"], "launches": []})
                res.append(banded.align_windows_banded(gc, p_dev, last["windows"], 32))
            finally:
                undo()
            sizes = [len(tb) for tb, _, _ in calls_r[-1]["launches"]]
            if banded.retries == before or len(sizes) < 2 or sizes[1] >= sizes[0]:
                raise AssertionError(f"relaunch at W=32: launch sizes {sizes}")
            a_gc = convert.graph_to_numpy(gc)
            mp.append((a_gc["mpl"], a_gc["mpr"]))
        if [(r.cigar, r.best_score) for r in res[0]] != [(r.cigar, r.best_score) for r in res[1]] \
                or not all(np.array_equal(a, b) for a, b in zip(*mp)):
            raise AssertionError(f"relaunch at W=32, {gname}: cuda differs from cpu")
        log(f"[A] seeded route, {gname}: sim2k 4 reads {' '.join(SIM2K_WINDOWS)} "
            f"{' '.join(flags)} on cuda == on cpu; read 4's "
            f"{len(last['windows'])} windows from W=32: launches of {sizes} "
            f"windows (the overflowed part relaunched), results and mpl/mpr on "
            f"cuda == on cpu")


# Phase A's cases of B2's modes: (fixture, gap, mode, -G); the modes are
# MODE_FIELDS' (local is unbanded; "-u" runs without a band: these
# whole-row cases go to kernel B2u)
MODE_FIELDS = {"global": {}, "local": {"align_mode": 1},
               "extend-zdrop": {"align_mode": 2, "zdrop": 20},
               "global-u": {"wb": -1},
               "extend-u": {"align_mode": 2, "wb": -1},
               "extend-zdrop-u": {"align_mode": 2, "zdrop": 20, "wb": -1}}
MODE_CASES = [
    ("flanked", "convex", "local", False), ("flanked", "linear", "local", True),
    ("flanked", "affine", "local", False),
    ("sim2k", "convex", "global-u", True), ("sim2k", "convex", "extend-u", False),
    ("sim2k", "affine", "global-u", False),
    ("rcmix", "convex", "extend-zdrop", True),
    ("rcmix", "convex", "extend-zdrop-u", False),
    ("rcmix", "linear", "extend-zdrop-u", True),
    ("rcmix", "affine", "extend-zdrop", False),
    ("sim2k", "linear", "global-u", False), ("sim2k", "affine", "extend-u", True),
    ("rcmix", "affine", "extend-zdrop-u", True)]
# B2u's cluster sizes are held against the plain version on these (phase A,
# and the cuda tests)
CLUSTER_CASES = [("flanked", "convex", "local", False),
                 ("sim2k", "linear", "global-u", True),
                 ("rcmix", "affine", "extend-zdrop-u", False)]


def mode_graphs(data_dir):
    """Phase A's graphs for B2's modes, built on the CPU: sim2k's first 3
    reads (global) with its 4th read, and with the middle of that read
    between 200 random bases on each side ("flanked": a local walk stops
    before a zero cell), and rcmix's first 5 reads aligned in extend mode with Z-drop
    (reads of both strands: on the 6th read Z-drop fires) with its 6th."""
    import numpy as np
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.params import Params
    out = {}
    for name, fa, n, kw in (("sim2k", "sim2k.fa", 3, {}),
                            ("rcmix", "rcmix.fa", 5, {"align_mode": 2, "zdrop": 20})):
        p = Params(device="cpu", **kw).finalize()
        seqs = [encode(p, r.seq) for r in read_fastx(os.path.join(data_dir, fa))[:n + 1]]
        g = POAGraph()
        for q in seqs[:n]:
            cigar = (banded.align_sequence_to_subgraph(g, p, 0, 1, q).cigar
                     if g.node_n > 2 else [])
            g.add_alignment(p, q, None, cigar, True)
        out[name] = (g, seqs[n])
    flank = np.random.default_rng(10).integers(0, 4, (2, 200)).astype(np.uint8)
    out["flanked"] = (out["sim2k"][0], np.concatenate(
        [flank[0], out["sim2k"][1][400:1600], flank[1]]))
    return out


def whole_row(case) -> bool:
    """A MODE_CASES case whose windows are whole rows (kernel B2u's)."""
    return case[2] == "local" or case[2].endswith("-u")


def ring_share(t, depth: int) -> str:
    """The share of predecessor reads of row tables `t` a ring of `depth`
    rows serves (and the 256-row band ring), with the rows-back spread."""
    import numpy as np
    P = t.pre_idx.shape[1]
    rr = np.arange(t.gn - 1)[:, None]
    live = (np.arange(P)[None, :] < t.pre_cnt[:t.gn - 1, None]) & (rr >= 1)
    dist = (rr - t.pre_idx[:t.gn - 1].astype(np.int64))[live]
    return (f"{dist.size} predecessor reads, rows back p50 "
            f"{np.percentile(dist, 50):.0f}, p99 {np.percentile(dist, 99):.0f}, "
            f"max {dist.max()}; served by the plane ring (D={depth}) "
            f"{(dist < depth).mean() * 100:.3f} %, by the band ring (256 "
            f"rows) {(dist < 256).mean() * 100:.3f} %")


def mode_inputs(dev, graphs, case, W=None):
    """A MODE_CASES case's (Params on dev, on the CPU, row tables, query,
    W, banded_dp's batch-form inputs as numpy) on a copy of its graph."""
    import copy
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.tables import build_row_tables, initial_band_width
    from abpoa_tpu_torch.params import Params
    fixture, gap, mode, ps = case
    gaps = {"convex": {}, "affine": {"gap_open2": 0}, "linear": {"gap_open1": 0}}
    kw = dict(gaps[gap], **MODE_FIELDS[mode], inc_path_score=ps)
    p = Params(device=str(dev), **kw).finalize()
    pc = Params(device="cpu", **kw).finalize()
    if (p.wb < 0) != whole_row(case):
        raise AssertionError(f"mode case {case}: wb = {p.wb}")
    g, query = graphs[fixture]
    g = copy.deepcopy(g)
    g.topological_sort(p)
    t = build_row_tables(g, 0, 1, p)
    W = W or initial_band_width(p, len(query))
    return p, pc, t, query, W, banded.pack_windows(p, [t], [query], W)


def mode_case(dev, graphs, case, rates, W=None, cs=None, sweep=(),
              pooled=None, inputs=None, x1w_tag=None) -> dict:
    """One of MODE_CASES on the card: B2, or B2u for a whole-row case, on
    the whole graph against its plain version (on CPU copies, or in a
    worker of the PlainPool with `pooled`, the wait function of its
    `add_digest` job: then the planes are held equal through
    `plane_digest`s) on the rows it computes and on begend,
    mplr, ok and ext, with its time and bound, then X1w's walk from the
    mode's best cell against its plain version (header, band, ops). `W`
    overrides the band width, `cs` B2u's blocks a cluster; each B2u
    cluster size in `sweep` is held equal to the same plain version and
    timed. `inputs` are the case's `mode_inputs`, where the caller has
    them. With `x1w_tag`, X1w's time, bound and tile share on the case's
    planes are logged under that tag (`x1w_report`). Returns {err, err_w
    (the DP's and X1w's max abs diff), ms, plain_ms, bound, rows, line,
    name (the kernel line's row)}."""
    import torch
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.backtrack_kernel import (
        HEADER, backtrack_windows, backtrack_windows_torch)
    from abpoa_tpu_torch.align.banded_kernel import (banded_dp,
                                                     banded_dp_torch,
                                                     cluster_shape, unbanded_dp)
    from abpoa_tpu_torch.align.fused_dp_kernel import launch_shape
    fixture, gap, mode, ps = case
    p, pc, t, query, W, arrs = inputs or mode_inputs(dev, graphs, case, W)
    unb = p.wb < 0
    ts, tc = to_dev(arrs, dev), to_dev(arrs, "cpu")

    def run(cs=cs):
        if cs is not None:
            return unbanded_dp(*ts, gap_mode=p.gap_mode, cs=cs)
        return banded_dp(*ts, gap_mode=p.gap_mode, unbanded=unb)

    tag = f"{fixture} {gap} {mode}{' -G' if ps else ''}"
    name = "banded_dp[unbanded]" if unb else "banded_dp"
    got = run()
    torch.cuda.synchronize()
    if pooled is not None:
        plain_ms, dig, small, rows = pooled()
        where = "host, a worker; planes by digest"

        def check(out, what):
            if dp_rows(ts, out)[0][1] != rows or not torch.equal(
                    plane_digest(out[:5], rows), dig):
                raise AssertionError(f"{what}: kernel and plain version differ "
                                     f"on the planes")
            return compare(what, out[5:], small)
    else:
        plain_ms, want = time_plain(banded_dp_torch, tc, gap_mode=p.gap_mode)
        where = "host"

        def check(out, what):
            return compare_dp(what, out, want, ts[:12])[0]
        rows = dp_rows(ts, want)[0][1]
    err = check(got, f"{name} {tag}")
    ms = time_cuda(run, 1)
    bnd = dp_bound(rates, ts, got)
    xin, xkw, layout = banded.walk_inputs(p, ts, got, [t], [query], [0])
    xg = backtrack_windows(*xin, **xkw)
    torch.cuda.synchronize()
    if pooled is not None:  # X1w's plain version on the kernel's planes
        cin, ckw, _ = banded.walk_inputs(p, ts, got, [t], [query], [0])
    else:
        cin, ckw, _ = banded.walk_inputs(pc, tc, want, [t], [query], [0])
    xw_ms, xw = time_host(lambda: backtrack_windows_torch(*cin, **ckw).cpu())
    h, b_at, o_at, _ = layout[0]
    n_ops = int(xw[h])
    sel = torch.cat([torch.arange(h, h + HEADER),
                     torch.arange(b_at, b_at + 2 * t.gn),
                     torch.arange(o_at, o_at + 2 * n_ops)])
    err_w = compare(f"backtrack_windows {tag}", [xg.cpu()[sel]], [xw[sel]])
    if x1w_tag is not None:
        x1w_report(rates, xin, xkw, xw, x1w_tag, plain_ms=xw_ms)
    P = t.pre_idx.shape[1]
    if unb:
        ls = cluster_shape(W, P, p.gap_mode, ps, cs)
        shape = (f"B2u: {ls['cs']} blocks a cluster of {ls['threads']} "
                 f"threads, slice {ls['slice']}, {ls['lanes']} lane(s) a "
                 f"thread a run, ring D={ls['depth']}, {ls['smem']} B shared")
    else:
        ls = launch_shape(W, P, p.gap_mode, seeded=True, path_score=ps)
        shape = (f"B2: {ls['block_warps']} warps, cpt {ls['cpt']}, ring "
                 f"D={ls['depth']}")
    head = xw[h: h + HEADER].tolist()
    us = ms * 1e3 / max(1, rows - 1)
    line = (f"{tag} (gn={t.gn}, W={W}, {shape}): kernel == plain on rows "
            f"0..{rows - 1}, begend, mplr, ok, ext {got[8][0].tolist()}; "
            f"kernel {ms:.3f} ms ({us:.3f} us a computed row), plain "
            f"{plain_ms:.1f} ms ({where}), bound {bnd[0]:.4f} ms ({bnd[1]}); "
            f"{ring_share(t, ls['depth'])}; X1w == plain (best ({head[9]}, "
            f"{head[10]}) score {head[8]}, {n_ops} ops, start ({head[5]}, "
            f"{head[6]}), end column {head[2]})")
    del got, xin, xg
    for c in sweep:
        got = run(c)
        torch.cuda.synchronize()
        err = max(err, check(got, f"{name} {tag} cs={c}"))
        del got
        ms_c = time_cuda(lambda: run(c), 1)
        line += (f"; cs={c} == plain, {ms_c:.3f} ms "
                 f"({ms_c * 1e3 / max(1, rows - 1):.3f} us a row)")
    return dict(err=err, err_w=err_w, ms=ms, plain_ms=plain_ms, bound=bnd,
                rows=rows, line=line, name=name)


def phase_a_modes(dev, data_dir, max_err, rates) -> None:
    """Phase A, B2's modes: every case of MODE_CASES (`mode_case`; the
    whole-row ones on B2u), then B2u at 1, 2, 4, 8 and 16 blocks a cluster
    at a W that is no multiple of 32 (the slices' last lanes pass W) on the
    first of CLUSTER_CASES."""
    graphs = mode_graphs(data_dir)
    for case in MODE_CASES:
        r = mode_case(dev, graphs, case, rates)
        max_err[r["name"]] = max(max_err[r["name"]], r["err"])
        max_err["backtrack[windows]"] = max(max_err["backtrack[windows]"], r["err_w"])
        log(f"[A] {r['line']}")
    for case in CLUSTER_CASES[:1]:  # the cuda tests take the others
        W = cluster_width(len(graphs[case[0]][1]))
        r = mode_case(dev, graphs, case, rates, W=W, sweep=(1, 2, 4, 8, 16))
        max_err[r["name"]] = max(max_err[r["name"]], r["err"])
        max_err["backtrack[windows]"] = max(max_err["backtrack[windows]"],
                                            r["err_w"])
        log(f"[A] {r['line']}")


def cluster_width(qlen: int) -> int:
    """A whole-row width past qlen + 1 that is no multiple of 32, so that
    at every cluster size the last block's slice passes W."""
    W = qlen + 14
    return W + 1 if W % 32 == 0 else W


def phase_c8(ref: str, reads: list) -> dict:
    """Phase C8: B2's and X1w's modes at full width on the first 5 reads of
    phase C's set (20 until unbanded B2's time made the script too long,
    12 and then 8 until the device lockstep's checks did). (a) `-m 1`, `-m 2` and
    `-m 2 -z 100`: the per-read route
    (pipeline.poa, as C2 drives it) gives the fused route's (the CLI: B3 or
    B1) consensus and MSA byte for byte (`-r 2`: the `-r 1` rows and the
    consensus row in one output); the pyapi in aln_mode `l` and `e` gives
    the fused MSA rows and consensus. (b) `-b -1 -r 2` and
    `-G -r 2` through the CLI (neither is fused-eligible: B2 every read):
    each MSA row without gaps is its read, X1w once a B2 launch and no
    plane copied (check_walks), consensus identity to the reference >=
    0.98. The whole-row runs (`-m 1`, the pyapi's `l`, `-b -1`) launch
    kernel B2u and no B2, the others B2 and no B2u. Each per-read run's
    time a read is split as C2's, with B2's or B2u's µs a computed row.
    Returns the B2, B2u and X1w launches and the (b) runs' graphs (for
    phase D)."""
    import torch
    from abpoa_tpu_torch import pyapi
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.backtrack_kernel import backtrack_windows
    from abpoa_tpu_torch.align.banded_kernel import banded_dp, unbanded_dp
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.native.graph import NativePOAGraph
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.pipeline import (Abpoa, _ingest_records,
                                          _select_graph, output, poa,
                                          want_native)
    n = min(5, len(reads))
    fa = os.path.join(OUT, "c8.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">read_{i}\n{r}\n" for i, r in enumerate(reads[:n])))
    recs = read_fastx(fa)
    launched = {"b2": 0, "b2u": 0, "x1w": 0}

    def kernels_of(tag, whole):
        """The B2 and B2u launches since the last reset, each run on its
        own kernel: (B2, B2u)."""
        b2, b2u = banded_dp.launches, unbanded_dp.launches
        if (b2 if whole else b2u) or not (b2u if whole else b2):
            raise AssertionError(f"C8 {tag}: B2 {b2}, B2u {b2u} launches; "
                                 f"expected {'B2u' if whole else 'B2'} only")
        launched["b2"] += b2
        launched["b2u"] += b2u
        return b2, b2u

    def per_read(abpt, tag):
        """The per-read route over the reads: (its output, the split)."""
        ab = Abpoa()
        seqs, weights = _ingest_records(ab, abpt, recs)
        _select_graph(ab, want_native(abpt))
        banded.reset_stats()
        banded_dp.launches = unbanded_dp.launches = 0
        backtrack_windows.launches = fused_dp.launches = 0
        split = {}
        undo = [timed(NativePOAGraph, "add_subgraph_alignment", split, "fusion"),
                timed(POAGraph, "add_subgraph_alignment", split, "fusion")]
        t0 = time.perf_counter()
        try:
            poa(ab, abpt, seqs, weights, 0)
        finally:
            for u in undo:
                u()
        wall = time.perf_counter() - t0
        b2 = sum(kernels_of(tag, abpt.wb < 0))
        st, x1w = dict(banded.stats), backtrack_windows.launches
        check_walks(f"C8 {tag}", st, b2, x1w)
        if fused_dp.launches or b2 < n - 1:
            raise AssertionError(f"C8 {tag}: B2/B2u {b2}, B1 {fused_dp.launches} launches")
        launched["x1w"] += x1w
        buf = io.StringIO()
        output(ab, abpt, buf)
        return buf.getvalue(), wall, st, split.get("fusion", 0.0)

    def split_line(tag, wall, st, fusion_s, whole):
        k = max(1, st["reads"])
        kern = "B2u" if whole else "B2"
        log(f"[C8] {tag}: per-read route, {st['reads']} aligned reads, "
            f"{st['launches']} {kern} launches ({st['rows']} DP rows): wall "
            f"{wall * 1e3 / k:.1f} ms a read = {per_read_split(st, fusion_s, k)}; "
            f"{kern} {st['kernel_s'] * 1e6 / max(1, st['rows']):.3f} us a computed row")

    # (a) the per-read route == the fused route, consensus and -r 1 MSA
    from abpoa_tpu_torch import cli
    for flags in (["-m", "1"], ["-m", "2"], ["-m", "2", "-z", "100"]):
        what = " ".join(flags)
        out_f = os.path.join(OUT, f"c8_fused{''.join(flags)}.fa")
        fused_dp.launches = fused_dp.local_launches = 0
        banded_dp.launches = unbanded_dp.launches = 0
        t0 = time.perf_counter()
        run_cli([fa, *flags, "-r", "2", "-o", out_f])
        wall_f = time.perf_counter() - t0
        b1 = fused_dp.launches + fused_dp.local_launches
        if b1 < n - 1 or banded_dp.launches or unbanded_dp.launches:
            raise AssertionError(f"C8 {what}: fused route launched B1/B3 "
                                 f"{b1}, B2 {banded_dp.launches}, B2u "
                                 f"{unbanded_dp.launches} times")
        abpt = cli.args_to_params(cli.build_parser().parse_args(
            [fa, *flags, "-r", "2"])).finalize()
        got, wall, st, fusion_s = per_read(abpt, what)
        with open(out_f) as fp:
            if got != fp.read():
                raise AssertionError(f"C8 {what} -r 2: the per-read and fused "
                                     f"routes differ")
        split_line(f"{what} -r 2 == fused route ({wall_f:.2f} s, B1/B3 {b1}) "
                   f"byte for byte", wall, st, fusion_s, abpt.wb < 0)
        if "-z" in flags:
            continue  # the pyapi has no Z-drop argument
        aln = {"1": "l", "2": "e"}[flags[1]]
        rows_f = [row for _, row in read_fasta_rows(out_f)]
        banded_dp.launches = unbanded_dp.launches = 0
        backtrack_windows.launches = 0
        res = pyapi.msa_aligner(aln_mode=aln).msa([r.seq for r in recs],
                                                   out_cons=True, out_msa=True)
        b2, b2u = kernels_of(f"pyapi aln_mode={aln}", aln == "l")
        launched["x1w"] += backtrack_windows.launches
        if (res.msa_seq[:n] != rows_f[:n]
                or res.cons_seq != [rows_f[n].replace("-", "")]):
            raise AssertionError(f"C8 pyapi aln_mode={aln}: differs from the fused route")
        log(f"[C8] pyapi msa_aligner(aln_mode='{aln}').msa({n} reads, out_cons, "
            f"out_msa) == the fused route's consensus and MSA rows (B2 "
            f"{b2}, B2u {b2u}, X1w {backtrack_windows.launches} launches)")

    # (b) unbanded and -G through the CLI: B2 every read
    graphs = {}
    for flags in (["-b", "-1"], ["-G"]):
        what = " ".join(flags)
        out_b = os.path.join(OUT, f"c8{''.join(flags)}.fa")
        banded.reset_stats()
        banded_dp.launches = unbanded_dp.launches = 0
        backtrack_windows.launches = fused_dp.launches = 0
        split = {}
        undo = [timed(NativePOAGraph, "add_subgraph_alignment", split, "fusion"),
                timed(POAGraph, "add_subgraph_alignment", split, "fusion")]
        t0 = time.perf_counter()
        try:
            ab = run_pipeline([fa, *flags, "-r", "2"], out_b)
        finally:
            for u in undo:
                u()
        wall = time.perf_counter() - t0
        b2 = sum(kernels_of(what, flags[0] == "-b"))
        st, x1w = dict(banded.stats), backtrack_windows.launches
        check_walks(f"C8 {what}", st, b2, x1w)
        if fused_dp.launches or b2 < n - 1:
            raise AssertionError(f"C8 {what}: B2/B2u {b2}, B1 {fused_dp.launches} launches")
        launched["x1w"] += x1w
        rows = read_fasta_rows(out_b)
        if [row.replace("-", "") for _, row in rows[:n]] != reads[:n]:
            raise AssertionError(f"C8 {what}: an MSA row is not its read")
        cons = rows[n][1].replace("-", "")
        ident = 1 - edit_distance(cons, ref) / len(ref)
        split_line(f"{what} -r 2 through the CLI (wall {wall:.2f} s)", wall, st,
                   split.get("fusion", 0.0), flags[0] == "-b")
        log(f"[C8] {what} -r 2: {len(rows) - n} consensus row(s), each of the {n} "
            f"MSA rows without gaps is its read; consensus identity to the "
            f"reference {ident:.5f} (predicted >= 0.98); final graph "
            f"{ab.graph.node_n} nodes")
        if ident < 0.98:
            raise AssertionError(f"C8 {what}: consensus identity {ident:.5f} < 0.98")
        graphs[what] = ab.graph
    return {"launched": launched, "graphs": graphs}


def record_launches():
    """Wrap `banded.run_windows`: returns (launches, undo); launches gets
    (tables, queries, W) of each B2 launch."""
    from abpoa_tpu_torch.align import banded
    launches = []
    real = banded.run_windows

    def rw(abpt, tabs, queries, W, graph_half=None, **kw):
        launches.append((list(tabs), list(queries), W))
        return real(abpt, tabs, queries, W, graph_half, **kw)

    banded.run_windows = rw
    return launches, lambda: setattr(banded, "run_windows", real)


def lanes_check(dev, p, tabs, queries, W, tag, plain=None):
    """One K-lane B2 launch (the lanes' row tables and queries at band width
    W) on the card against its plain version on CPU copies of its inputs
    (planes on the computed rows, begend, mplr, ok, ext), and X1w's walk of
    its ok lanes against X1w's plain version. With `plain` (a PlainPool)
    B2's plain version is queued there. Returns (X1w's max abs diff,
    the launch's inputs, its outputs, and `finish()`, which waits for the
    plain version and gives (B2's max abs diff, its ms, rows compared))."""
    import torch
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.banded_kernel import banded_dp, banded_dp_torch
    arrays = banded.pack_windows(p, tabs, queries, W)
    if plain is not None:
        wait = plain.add(banded_dp_torch, arrays, gap_mode=p.gap_mode)
    ts = to_dev(arrays, dev)
    got = banded_dp(*ts, gap_mode=p.gap_mode)
    torch.cuda.synchronize()
    if plain is None:
        done = time_plain(banded_dp_torch, ts, gap_mode=p.gap_mode)
        wait = lambda: done  # noqa: E731
    err_w = x1w_check(p, ts, got, tabs, queries, f"lanes {tag}")[0]

    def finish():
        plain_ms, want = wait()
        err, rows = compare_dp(f"banded_dp[lanes] {tag}", got, want, ts)
        return err, plain_ms, rows
    return err_w, ts, got, finish


class Tally:
    """A stand-in for Rates whose bound() returns (bytes, operations), so
    that a bound can be summed over lanes before it is turned into ms."""

    @staticmethod
    def bound(nbytes: float, ops: float):
        return nbytes, ops


def lanes_bound(rates, fn, lanes):
    """The bound of a lane launch: fn(Tally, lane) per lane, summed."""
    nb = ops = 0.0
    for l in lanes:
        b, o = fn(Tally, l)
        nb, ops = nb + b, ops + o
    return rates.bound(nb, ops)


def force_lane_collisions():
    """Set the device lockstep's collision flag (`fused_lanes.
    _fuse_vectorized_l`'s) on the even lane positions of every round: the
    stack's first lane always, so F1 runs once a round, over a lane list
    whenever two or more lanes are live. Records the devices of the host
    graphs (`device_graph._HostGraph`, the plain walk's) built meanwhile.
    Returns (built, undo)."""
    import torch
    from abpoa_tpu_torch.align import device_graph
    from abpoa_tpu_torch.align import fused_lanes as fla
    real, real_host = fla._fuse_vectorized_l, device_graph._HostGraph.__init__
    built = []

    def colliding(*a, **k):
        out = list(real(*a, **k))
        even = torch.arange(out[4].shape[0], device=out[4].device) % 2 == 0
        out[4] = out[4] | even
        return tuple(out)

    def host_graph(self, g):
        built.append(g.base.device.type)
        real_host(self, g)

    fla._fuse_vectorized_l, device_graph._HostGraph.__init__ = colliding, host_graph

    def undo():
        fla._fuse_vectorized_l, device_graph._HostGraph.__init__ = real, real_host
    return built, undo


def record_lane_round(target: int):
    """Wrap the device lockstep's lane launches of B1, X1 and S1: returns
    (seen, undo); seen gets each wrapper's (args, kwargs) at its call number
    `target` (1 = the first round's), S1's cloned before its in-place
    launch. The wrappers call the kernels as they are: the counts are the
    run's own."""
    from abpoa_tpu_torch.align import fused_lanes as fla
    seen, calls = {}, {}
    names = ("fused_dp_lanes", "backtrack_lanes", "finish_fusion_lanes_")
    real = {n: getattr(fla, n) for n in names}

    def wrap(name):
        def w(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            if calls[name] == target:
                seen[name] = ([t.clone() if name == names[2] else t
                               for t in a], dict(k))
            return real[name](*a, **k)
        return w

    for n in names:
        setattr(fla, n, wrap(n))
    return seen, lambda: [setattr(fla, n, f) for n, f in real.items()]


def _plain_lanes_worker(arrays, kw):
    """B1's plain version over lanes (`fused_dp_lanes` on the CPU) in a
    worker process, returning each lane's planes as `plane_digest`s of the
    rows it computes and the other outputs whole: (ms, digests, [beg, end,
    ok, ext], rows a lane)."""
    import torch
    from abpoa_tpu_torch.align.fused_dp_kernel import (computed_rows,
                                                       fused_dp_lanes)
    torch.set_num_threads(1)
    args = [torch.from_numpy(a) for a in arrays]
    ms, out = time_plain(fused_dp_lanes, args, **kw)
    W = out[0].shape[2]
    rows = [computed_rows(out[5][l], out[6][l], out[7][l:l + 1],
                          int(args[0][l, 8]), W) for l in range(len(out[7]))]
    digs = [plane_digest([p[l] for p in out[:5]], r).numpy()
            for l, r in enumerate(rows)]
    return ms, digs, [o.numpy() for o in out[5:]], rows


def b1_lanes_check(rates, plain, ts, kw):
    """A captured B1 lane launch (ts, kw on the card): the kernel again, its
    time, and the bound over each lane's computed rows; the plain version
    runs in `plain` (a PlainPool), one job a lane, and returns digests.
    Returns (finish, ms, bound, longest lane's rows): finish() waits for
    the plain version, compares it lane by lane and gives (max abs diff,
    plain ms: the jobs' times summed, the plain version's time on one
    core)."""
    import torch
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp_lanes
    L = ts[0].shape[0]
    waits = [plain.add_call(_plain_lanes_worker,
                            [t[l:l + 1].cpu().numpy() for t in ts], kw)
             for l in range(L)]
    got = fused_dp_lanes(*ts, **kw)
    torch.cuda.synchronize()
    ms = time_cuda(lambda: fused_dp_lanes(*ts, **kw), 3)
    bnd = lanes_bound(rates, lambda r, l: dp_bound(
        r, [t[l] for t in ts], [*(p[l] for p in got[:5]), got[5][l],
                                 got[6][l], got[7][l:l + 1], got[8][l]]),
        range(L))
    gns = [int(ts[0][l, 8]) for l in range(L)]

    def finish():
        err = p_ms = 0
        for l, wait in enumerate(waits):
            ms_l, digs, small, rows = wait()
            p_ms += ms_l
            mine = plane_digest([p[l] for p in got[:5]], rows[0])
            if not torch.equal(mine, torch.from_numpy(digs[0])):
                raise AssertionError(f"fused_dp[lanes] lane {l}: planes "
                                     "differ from the plain version")
            err = max(err, compare(f"fused_dp[lanes] lane {l}",
                                   [got[5][l], got[6][l], got[7][l:l + 1],
                                    got[8][l]],
                                   [torch.from_numpy(small[0][0]),
                                    torch.from_numpy(small[1][0]),
                                    torch.from_numpy(small[2][0:1]),
                                    torch.from_numpy(small[3][0])]))
        return err, p_ms
    return finish, ms, bnd, max(gns) - 1, got


def phase_c9(args, rates, plain) -> dict:
    """Phase C9: `-l` at full width, as users with many small read sets run
    it (per-locus amplicon clusters, UMI groups): 8 sets of reads of 8
    simulated references (--ref-len bp, seeds 11-18) at 10 % error, set i of
    --c9-reads + 5 i reads, so the sets drain at different rounds. The list
    through the CLI with -r 2 four times: --lockstep off (set by set: the
    fused route), --lockstep on with the split driver
    (ABPOA_TPU_LOCKSTEP_IMPL=split; one K-lane B2 launch and one X1w launch
    a round, host fusion) and on with the device lockstep (=device; every
    set's graph on the card, B1, X1, S1 and K1 launched once a round over
    the lanes), then the device lockstep once more with a collision forced
    on the even lane positions of every round (`force_lane_collisions`):
    the four outputs must be byte-identical. The split run launches no B1
    and X1w once a B2 launch (check_walks); the device run no B2 and no
    X1w, and B1 and X1 once a round (the reverse strand adds its rounds);
    the forced run F1 and K1 once a round and builds no host graph from the
    card's; each with the counts set to 0 just before it and read just
    after. Printed: each run's wall and reads/s; the split run's rounds,
    live lanes and wall split; the device run's rounds, mean live lanes,
    launches, host syncs a round and wall split by step (CUDA events and
    the host clock, `fused_loop.timing`); each set's consensus identity to
    its reference. The split run's round-2 K-lane launch (the first: every
    lane's graph is its first read) against its plain version (in `plain`,
    a PlainPool) and X1w's walk of it; the device run's mid-run round:
    its B1 lane launch (plain version in `plain`, planes compared by
    digests), its X1 lane launch and its S1 lane launch (in place, on
    fresh copies) against their plain versions, with times and bounds.
    Returns the runs' launches and those checks' numbers."""
    import torch
    from abpoa_tpu_torch.align import banded, dp_chunk
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.backtrack_kernel import (backtrack_lanes,
                                                        backtrack_windows)
    from abpoa_tpu_torch.align.banded_kernel import banded_dp
    from abpoa_tpu_torch.align.edge_sort_kernel import finish_fusion_lanes_
    from abpoa_tpu_torch.align.fuse_kernel import fuse_alignment_lanes
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp, fused_dp_lanes
    from abpoa_tpu_torch.align.topo_kernel import topo_sort_lanes
    from abpoa_tpu_torch.parallel import lockstep
    from abpoa_tpu_torch.params import Params
    K = 8
    sets, files = [], []
    for i in range(K):
        ref_i, reads_i = simulate(args.ref_len, args.c9_reads + 5 * i, 0.10, 11 + i)
        path = os.path.join(OUT, f"c9_set{i}.fa")
        with open(path, "w") as fp:
            fp.write("".join(f">s{i}_{j}\n{r}\n" for j, r in enumerate(reads_i)))
        sets.append((ref_i, reads_i))
        files.append(path)
    lst = os.path.join(OUT, "c9_list.txt")
    with open(lst, "w") as fp:
        fp.write("".join(f + "\n" for f in files))
    n_reads = sum(len(r) for _, r in sets)
    lane_counters = (fused_dp_lanes, backtrack_lanes, finish_fusion_lanes_,
                     topo_sort_lanes, fuse_alignment_lanes)
    target = max(1, (args.c9_reads + 5 * (K - 1) - 1) // 2)
    runs = {}
    for tag, mode, impl in (("off", "off", None), ("split", "on", "split"),
                            ("device", "on", "device"),
                            ("forced", "on", "device")):
        out = os.path.join(OUT, f"c9_{tag}.fa")
        banded.reset_stats()
        lockstep.reset_stats()
        dp_chunk.reset_stats()
        fl.reset_stats()
        fl.timing = tag == "device"
        banded_dp.launches = backtrack_windows.launches = 0
        fused_dp.launches = fused_dp.local_launches = 0
        for f in lane_counters:
            f.launches = 0
        fused_dp_lanes.local_launches = 0
        if impl:
            os.environ["ABPOA_TPU_LOCKSTEP_IMPL"] = impl
        launches, undo = record_launches()
        seen, undo_lanes = record_lane_round(target)
        built, undo_forced = (force_lane_collisions() if tag == "forced"
                              else ([], lambda: None))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            run_cli(["-l", lst, "-r", "2", "--lockstep", mode, "-o", out])
        finally:
            undo()
            undo_lanes()
            undo_forced()
            os.environ.pop("ABPOA_TPU_LOCKSTEP_IMPL", None)
            fl.timing = False
        wall = time.perf_counter() - t0
        runs[tag] = dict(out=out, wall=wall, b2=banded_dp.launches,
                         x1w=backtrack_windows.launches,
                         b1=fused_dp.launches + fused_dp.local_launches,
                         lanes={f.__name__: f.launches for f in lane_counters},
                         b1_lanes=fused_dp_lanes.launches
                         + fused_dp_lanes.local_launches,
                         st=dict(banded.stats), ls=dict(lockstep.stats),
                         fl=dict(fl.stats), sort_s=dp_chunk.stats["sort_s"],
                         launches=launches, seen=seen, built=built)
        log(f"[C9] --lockstep {mode}{f' ({impl})' if impl else ''}"
            f"{', collisions forced' if tag == 'forced' else ''}: {K} sets, "
            f"{n_reads} reads x {args.ref_len} bp, -r 2: wall {wall:.2f} s, "
            f"{n_reads / wall:.3f} reads/s; B1 launches {runs[tag]['b1']}, "
            f"B1 lane launches {runs[tag]['b1_lanes']}, B2 {runs[tag]['b2']}, "
            f"X1w {runs[tag]['x1w']}")
    off, on, dv = runs["off"], runs["split"], runs["device"]
    text = open(off["out"]).read()
    for tag in ("split", "device", "forced"):
        if open(runs[tag]["out"]).read() != text:
            raise AssertionError(f"C9: -l --lockstep on ({tag}) and off give "
                                 "different output")
    ls, st = on["ls"], on["st"]
    if on["b1"] or on["b1_lanes"] or ls["groups"] < 1 or not on["b2"]:
        raise AssertionError(f"C9: split run launched B1 {on['b1']} + "
                             f"{on['b1_lanes']}, B2 {on['b2']} times in "
                             f"{ls['groups']} groups")
    if off["b2"] or not off["b1"] or off["b1_lanes"]:
        raise AssertionError(f"C9: set-by-set run launched B1 {off['b1']}, B2 "
                             f"{off['b2']} times")
    check_walks("C9", st, on["b2"], on["x1w"])
    s = dv["fl"]
    lanes = dv["lanes"]
    if dv["b2"] or dv["x1w"] or dv["b1"]:
        raise AssertionError(f"C9: device run launched B2 {dv['b2']}, X1w "
                             f"{dv['x1w']}, single-set B1 {dv['b1']}")
    if not (dv["b1_lanes"] == lanes["backtrack_lanes"]
            == s["rounds"] + s["rc_rounds"] > 0):
        raise AssertionError(f"C9: device run: {s['rounds']} rounds, "
                             f"{s['rc_rounds']} reverse-strand rounds, B1 "
                             f"lanes {dv['b1_lanes']}, X1 lanes "
                             f"{lanes['backtrack_lanes']}")
    if lanes["finish_fusion_lanes_"] < s["rounds"] or \
            lanes["topo_sort_lanes"] != s["kahn_rounds"]:
        raise AssertionError(f"C9: device run: S1 lanes "
                             f"{lanes['finish_fusion_lanes_']}, K1 lanes "
                             f"{lanes['topo_sort_lanes']} for {s['rounds']} "
                             f"rounds, {s['kahn_rounds']} with a repair")
    if s["syncs"] > s["rounds"] + s["rc_rounds"] + s["kahn_rounds"]:
        raise AssertionError(f"C9: device run: {s['syncs']} host syncs in "
                             f"{s['rounds']} rounds")
    fc = runs["forced"]
    fs, fln = fc["fl"], fc["lanes"]
    if "cuda" in fc["built"]:
        raise AssertionError(f"C9: forced collisions: {fc['built'].count('cuda')}"
                             " host graphs built from the card's graph")
    if fc["b2"] or fc["x1w"] or fc["b1"] or not (
            fln["fuse_alignment_lanes"] == fln["topo_sort_lanes"]
            == fs["kahn_rounds"] == fs["rounds"] > 0) \
            or fs["collisions"] < fs["rounds"] \
            or fs["live_lanes"] <= fs["rounds"]:
        raise AssertionError(f"C9: forced collisions: {fs['rounds']} rounds, "
                             f"{fs['live_lanes']} live lanes, F1 "
                             f"{fln['fuse_alignment_lanes']}, K1 lanes "
                             f"{fln['topo_sort_lanes']}, Kahn rounds "
                             f"{fs['kahn_rounds']}, collisions "
                             f"{fs['collisions']}, B2 {fc['b2']}, X1w "
                             f"{fc['x1w']}, single-set B1 {fc['b1']}")
    log(f"[C9] device lockstep with a collision forced on the even lane "
        f"positions of every round: == --lockstep off, byte for byte; "
        f"{fs['rounds']} rounds (mean live lanes "
        f"{fs['live_lanes'] / fs['rounds']:.3f}, so F1 took a lane list "
        f"whenever two or more lanes were live), F1 launches "
        f"{fln['fuse_alignment_lanes']}, K1 lane launches "
        f"{fln['topo_sort_lanes']}, S1 lane launches "
        f"{fln['finish_fusion_lanes_']}, collisions {fs['collisions']}, no "
        f"host graph built from the card's; host syncs {fs['syncs']}; wall "
        f"{fc['wall']:.2f} s (unforced {dv['wall']:.2f} s)")
    rounds = max(1, ls["rounds"])
    log(f"[C9] --lockstep on (split and device) == --lockstep off, byte for "
        f"byte; split: {ls['groups']} group(s), {ls['rounds']} rounds, mean "
        f"live lanes a round {ls['live_lanes'] / rounds:.3f}, lanes aligned "
        f"{ls['dp_lanes']} ({st['rows']} DP rows), B2 launches {on['b2']} "
        f"({st['launches']} with relaunches counted), X1w launches "
        f"{on['x1w']}; set by set / split wall {off['wall'] / on['wall']:.3f}, "
        f"set by set / device wall {off['wall'] / dv['wall']:.3f}, split / "
        f"device wall {on['wall'] / dv['wall']:.3f}")
    parts = {"tables (C++, pack, upload)": st["tables_s"], "B2": st["kernel_s"],
             "X1w": st["backtrack_s"], "copy": st["d2h_s"],
             "cigar + band write-back": st["cigar_s"],
             "fusion + sort (C++)": ls["fusion_s"] + on["sort_s"]}
    rest = on["wall"] - sum(parts.values())
    log("[C9] split wall split (s, share of the wall): " + ", ".join(
        f"{k} {v:.2f} ({v / on['wall'] * 100:.1f} %)" for k, v in parts.items())
        + f", the rest (reading, MSA and consensus output, Python) {rest:.2f} "
        f"({rest / on['wall'] * 100:.1f} %); per round "
        f"{on['wall'] * 1e3 / rounds:.1f} ms; copied "
        f"{st['d2h_bytes'] / 2**20:.1f} MiB of {st['planes_bytes'] / 2**20:.1f} "
        f"MiB of planes")
    dr = max(1, s["rounds"])
    log(f"[C9] device lockstep: {s['rounds']} rounds ({s['rc_rounds']} with "
        f"the reverse strand, {s['kahn_rounds']} with a Kahn repair), mean "
        f"live lanes a round {s['live_lanes'] / dr:.3f}; launches: B1 lanes "
        f"{dv['b1_lanes']}, X1 lanes {lanes['backtrack_lanes']}, S1 lanes "
        f"{lanes['finish_fusion_lanes_']}, K1 lanes {lanes['topo_sort_lanes']}, "
        f"F1 {lanes['fuse_alignment_lanes']} (collisions {s['collisions']}), "
        f"B2 {dv['b2']}, X1w {dv['x1w']}; host syncs {s['syncs']} "
        f"({s['syncs'] / dr:.3f} a round); growths {s['grow']}, caps {s['caps']}")
    dev_s, host_s = s["device_s"], s["host_s"]
    log("[C9] device lockstep, per round, each step on the stream (CUDA "
        "events) / on the host (ms): " + ", ".join(
            f"{k} {dev_s[k] * 1e3 / dr:.2f}/{host_s[k] * 1e3 / dr:.2f}"
            for k in fl.STEPS)
        + f"; host waits in syncs {host_s['sync'] * 1e3 / dr:.2f}; the loop "
        f"{s['wall_s']:.2f} s of the {dv['wall']:.2f} s wall (the rest: "
        f"reading, the downloads, MSA and consensus output)")
    cons = [row.replace("-", "") for name, row in read_fasta_rows(dv["out"])
            if name.startswith("Consensus_sequence")]
    if len(cons) != K:
        raise AssertionError(f"C9: {len(cons)} consensus rows for {K} sets")
    idents = [1 - edit_distance(c, ref_i) / len(ref_i)
              for c, (ref_i, _) in zip(cons, sets)]
    log("[C9] consensus identity to each set's reference (predicted >= 0.99 "
        f"at {args.c9_reads}-{args.c9_reads + 5 * (K - 1)} reads a set; "
        "reported, not gated): "
        + ", ".join(f"{x:.5f}" for x in idents))
    # the split run's round-2 launch: K lanes, each a graph of its set's
    # first read
    tabs, queries, W = on["launches"][0]
    p = Params(device="cuda").finalize()
    err_w, ts, got, finish = lanes_check(p.torch_device, p, tabs, queries, W,
                                         "C9 round 2", plain)
    ms = time_cuda(lambda: banded_dp(*ts, gap_mode=p.gap_mode), 3)
    bnd = dp_bound(rates, ts, got)
    gns = [t.gn for t in tabs]
    log(f"[C9] split round 2's launch ({len(tabs)} lanes, gn min {min(gns)} / "
        f"max {max(gns)} / sum {sum(gns)}, W={W}): X1w == plain (headers, "
        f"bands, ops); kernel {ms:.3f} ms ({ms * 1e3 / max(1, max(gns) - 1):.3f} "
        f"us a row of the longest lane), bound {bnd[0]:.4f} ms ({bnd[1]}); B2's "
        f"plain version runs in phase D")
    # the device run's round `target`: its B1, X1 and S1 lane launches
    seen = dv["seen"]
    b1a, b1k = seen["fused_dp_lanes"]
    b1_finish, b1_ms, b1_bnd, b1_rows, b1_out = b1_lanes_check(
        rates, plain, b1a, b1k)
    L = b1a[0].shape[0]
    log(f"[C9] device round {target}'s B1 lane launch ({L} lanes, node_n "
        f"{[int(x) for x in b1a[0][:, 8].tolist()]}, W={b1a[7].shape[2]}, one "
        f"block a lane): kernel {b1_ms:.3f} ms ({b1_ms * 1e3 / max(1, b1_rows):.3f}"
        f" us a row of the longest lane), bound {b1_bnd[0]:.4f} ms "
        f"({b1_bnd[1]}); plain version in phase D's pool")
    xa, xk = seen["backtrack_lanes"]
    got_x = backtrack_lanes(*xa, **xk)
    torch.cuda.synchronize()
    x1_plain_ms, want_x = time_plain(backtrack_lanes, xa, **xk)
    x1_err = compare("backtrack[lanes]", got_x, want_x)
    x1_ms = time_cuda(lambda: backtrack_lanes(*xa, **xk), 3)
    res = got_x[1].cpu()
    x1_bnd = lanes_bound(rates, lambda r, l: bt_bound(
        r, [t[l] for t in xa[:5]], xa[8][l], got_x[0][l], res[l]), range(L))
    steps = int(res[:, 0].max())
    log(f"[C9] device round {target}'s X1 lane launch ({L} walks, steps "
        f"{res[:, 0].tolist()}): kernel == plain; kernel {x1_ms:.3f} ms "
        f"({x1_ms * 1e3 / max(1, steps):.3f} us a step of the longest walk), "
        f"plain {x1_plain_ms:.1f} ms, bound {x1_bnd[0]:.5f} ms ({x1_bnd[1]})")
    sa, sk = seen["finish_fusion_lanes_"]
    fresh = lambda: [t.clone() for t in sa]  # noqa: E731
    got_s = fresh()
    finish_fusion_lanes_(*got_s, **sk)
    torch.cuda.synchronize()
    want_s = [t.cpu() for t in sa]
    t0 = time.perf_counter()
    finish_fusion_lanes_(*want_s, **sk)
    s1_plain_ms = (time.perf_counter() - t0) * 1e3
    s1_err = compare("edge_sort[lanes]", got_s, want_s)
    copies = [fresh() for _ in range(21)]
    s1_ms = time_queued(lambda i: finish_fusion_lanes_(*copies[i], **sk), 20,
                        lambda: finish_fusion_lanes_(*copies[20], **sk))
    s1_bnd = lanes_bound(rates, lambda r, l: s1_need_bound(
        r, [t[l] for t in sa[:6]], int(sa[6][l]))[0], range(L))
    log(f"[C9] device round {target}'s S1 lane launch (in place, span on, "
        f"{L} lanes): kernel == plain; {s1_ms:.4f} ms queued on fresh copies, "
        f"plain {s1_plain_ms:.1f} ms, bound of what these inputs need "
        f"{s1_bnd[0]:.5f} ms ({s1_bnd[1]})")
    return {"b2": on["b2"], "x1w": on["x1w"], "err_w": err_w, "ms": ms,
            "bound": bnd, "finish": finish,
            "lanes": (p, ts, got, tabs, queries),
            "device": dv, "forced": fc,
            "b1_lanes": (b1_finish, b1_ms, b1_bnd),
            "x1_lanes": (x1_err, x1_ms, x1_plain_ms, x1_bnd),
            "s1_lanes": (s1_err, s1_ms, s1_plain_ms, s1_bnd),
            "reads_s": {k: n_reads / r["wall"] for k, r in runs.items()
                        if k != "forced"},
            "walls": {k: r["wall"] for k, r in runs.items()},
            "files": files, "off_out": off["out"], "n_reads": n_reads}


def phase_c10(args) -> dict:
    """Phase C10: `map`, as users mapping reads to a pan-read graph run it:
    phase C5's graph (C3's -r 2 MSA, restored) and C5's new reads through
    `python -m abpoa_tpu_torch map` on cuda at -K 1 (the first 20 reads),
    -K 8 and -K 32 (all of them). The GAF must be byte-identical across the
    three runs on the reads they share; each run builds the graph's tables
    once and uploads their graph half once, and X1w runs once a B2 launch
    (check_walks). Printed: the restore's and the tables' seconds, reads/s,
    rounds and B2's ms a launch. Returns the B2 and X1w launches."""
    from abpoa_tpu_torch.align import banded, dp_chunk
    from abpoa_tpu_torch.align.backtrack_kernel import backtrack_windows
    from abpoa_tpu_torch.align.banded_kernel import banded_dp
    from abpoa_tpu_torch.io import restore as restore_mod
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.parallel import map_driver
    msa5 = os.path.join(OUT, "restore_msa.fa")
    recs = read_fastx(os.path.join(OUT, "new_reads.fa"))
    fa20 = os.path.join(OUT, "c10_20.fa")
    with open(fa20, "w") as fp:
        fp.write("".join(f">{r.name}\n{r.seq}\n" for r in recs[:20]))
    gafs = {}
    launched = {"b2": 0, "x1w": 0}
    from abpoa_tpu_torch import parallel
    real_load = parallel.load_static_graph
    loaded = {}

    def load(path, abpt):  # C11 (b) maps onto -K 8's restored graph again
        ab, loaded[k] = real_load(path, abpt)
        return ab, loaded[k]
    for k, fa, n in ((1, fa20, min(20, len(recs))),
                     (8, os.path.join(OUT, "new_reads.fa"), len(recs)),
                     (32, os.path.join(OUT, "new_reads.fa"), len(recs))):
        out = os.path.join(OUT, f"c10_K{k}.gaf")
        banded.reset_stats()
        dp_chunk.reset_stats()
        map_driver.reset_stats()
        banded_dp.launches = backtrack_windows.launches = 0
        split = {}
        undo = [timed(restore_mod, "restore_graph", split, "restore"),
                timed(dp_chunk.StaticGraphTables, "__init__", split, "tables")]
        parallel.load_static_graph = load
        t0 = time.perf_counter()
        try:
            run_cli(["map", "-g", msa5, fa, "-K", str(k), "-o", out])
        finally:
            parallel.load_static_graph = real_load
            for u in undo:
                u()
        wall = time.perf_counter() - t0
        st, ms = dict(banded.stats), dict(map_driver.stats)
        b2, x1w = banded_dp.launches, backtrack_windows.launches
        check_walks(f"C10 -K {k}", st, b2, x1w)
        if (dp_chunk.stats["static_builds"], dp_chunk.stats["static_uploads"]) != (1, 1):
            raise AssertionError(f"C10 -K {k}: tables built "
                                 f"{dp_chunk.stats['static_builds']} times, "
                                 f"uploaded {dp_chunk.stats['static_uploads']}")
        if ms["reads"] != n or ms["rounds"] != -(-n // k):
            raise AssertionError(f"C10 -K {k}: {ms['reads']} reads in "
                                 f"{ms['rounds']} rounds")
        launched["b2"] += b2
        launched["x1w"] += x1w
        with open(out) as fp:
            gafs[k] = fp.read().splitlines()
        if len(gafs[k]) != n:
            raise AssertionError(f"C10 -K {k}: {len(gafs[k])} GAF records for {n} reads")
        mapping = wall - split["restore"] - split["tables"]
        log(f"[C10] map -K {k}, {n} reads x ~{args.ref_len} bp against the "
            f"restored graph ({st['rows'] // max(1, n)} rows a read): wall "
            f"{wall:.2f} s = restore {split['restore']:.2f} + tables (once) "
            f"{split['tables']:.2f} + mapping {mapping:.2f} s; "
            f"{n / mapping:.3f} reads/s in the mapping ({n / wall:.3f} with the "
            f"restore); {ms['rounds']} rounds, B2 launches {b2} "
            f"({st['kernel_s'] * 1e3 / max(1, st['launches']):.3f} ms a "
            f"launch), X1w launches {x1w} "
            f"({st['backtrack_s'] * 1e3 / max(1, x1w):.3f} ms a launch); per "
            f"round: tables {st['tables_s'] * 1e3 / ms['rounds']:.1f}, copy "
            f"{st['d2h_s'] * 1e3 / ms['rounds']:.1f}, cigar "
            f"{st['cigar_s'] * 1e3 / ms['rounds']:.1f} ms")
    n20 = len(gafs[1])
    if not gafs[1] == gafs[8][:n20] == gafs[32][:n20]:
        raise AssertionError("C10: the GAF differs between -K 1, 8 and 32")
    log(f"[C10] GAF at -K 1, 8 and 32 byte-identical on the {n20} reads they "
        f"share; -K 8 == -K 32 on all {len(gafs[8])}: {gafs[8] == gafs[32]}")
    if gafs[8] != gafs[32]:
        raise AssertionError("C10: the GAF differs between -K 8 and 32")
    launched.update(graph=loaded[8].graph, gaf8=gafs[8],
                    reads=os.path.join(OUT, "new_reads.fa"))
    return launched


def phase_c11(args, c9: dict, c10: dict, mesh=None) -> dict:
    """Phase C11: the sharded route (`parallel/shard.py`) at full width.
    The mesh is every card where two or more are attached, else
    (cuda:0, cuda:0), passed as the drivers' `mesh=` argument: on one card
    it measures the split's overhead, not scaling. Each run with the
    counts set to 0 just before it and read just after.
    (a) C9's list (or its first four sets with --c11-sets 4) through
    `runner.run_batch` with -r 2 on the sharded route, with the device
    lockstep and with the split driver: each output == C9's --lockstep off
    output (reused, not rerun); the device run's B1 and X1 lane launches ==
    the groups' rounds summed (plus `-s` rounds), at most one host sync a
    group a round beyond `-s` and Kahn, no host graph built from the card's
    (`device_graph._HostGraph`); the split run's X1w once a B2 launch
    (check_walks) and no B1. (b) C10's -K 8 map onto C10's restored graph
    over the mesh: the GAF == C10's -K 8 GAF, the tables built once and
    their graph half uploaded once a card, check_walks. (c) the first 20
    reads of C7's set with -S, every read's windows split over the mesh
    (`dispatch.align_windows(..., mesh)`): the consensus == the unsplit
    run's. (d) on one card, `python -m abpoa_tpu_torch -l LIST --mesh 2`
    exits non-zero with discover_mesh's RuntimeError, and `--mesh 1`
    gives the run without --mesh's output and launch counts. Printed:
    each sharded wall beside the unsharded one, the card count, launches
    a slot and syncs a round."""
    import torch
    from abpoa_tpu_torch import cli, parallel
    from abpoa_tpu_torch.align import banded, dispatch, dp_chunk
    from abpoa_tpu_torch.align import device_graph
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.backtrack_kernel import (backtrack_lanes,
                                                        backtrack_windows)
    from abpoa_tpu_torch.align.banded_kernel import banded_dp
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp, fused_dp_lanes
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.io.gaf import gaf_record
    from abpoa_tpu_torch.parallel import lockstep, runner
    from abpoa_tpu_torch.params import Params
    cards = torch.cuda.device_count()
    if mesh is None:
        mesh = (tuple(torch.device("cuda", i) for i in range(cards))
                if cards >= 2 else (torch.device("cuda", 0),) * 2)
    S = len(mesh)
    what = (f"{S} cards" if cards >= 2 else
            "the one card listed twice (overhead of the split, not scaling)")
    log(f"[C11] mesh {[str(d) for d in mesh]}: {what}; cards attached {cards}")
    out = {"mesh": S}

    def zero():
        banded.reset_stats()
        lockstep.reset_stats()
        dp_chunk.reset_stats()
        fl.reset_stats()
        banded_dp.launches = backtrack_windows.launches = 0
        fused_dp.launches = fused_dp.local_launches = 0
        fused_dp_lanes.launches = fused_dp_lanes.local_launches = 0
        backtrack_lanes.launches = 0

    # (a) C9's list on the sharded route, each implementation
    files = c9["files"][:args.c11_sets]
    # the first sets' part of C9's -r 2 output: each set's rows end with
    # its consensus row
    lines = open(c9["off_out"]).read().split("\n")
    ends = [i + 2 for i in range(0, len(lines) - 1, 2)
            if lines[i].startswith(">Consensus_sequence")]
    want = "\n".join(lines[:ends[len(files) - 1]]) + "\n"
    built, real_host = [], device_graph._HostGraph.__init__

    def host_graph(self, g):
        built.append(g.base.device.type)
        real_host(self, g)

    p = cli.args_to_params(cli.build_parser().parse_args(
        ["x", "-l", "-r", "2", "--lockstep", "on"])).finalize()
    for impl in ("device", "split"):
        os.environ["ABPOA_TPU_LOCKSTEP_IMPL"] = impl
        path = os.path.join(OUT, f"c11_{impl}.fa")
        zero()
        built.clear()
        device_graph._HostGraph.__init__ = host_graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with open(path, "w") as fp:
                runner.run_batch(files, p, fp, mesh=mesh)
        finally:
            device_graph._HostGraph.__init__ = real_host
            os.environ.pop("ABPOA_TPU_LOCKSTEP_IMPL", None)
        wall = time.perf_counter() - t0
        text = open(path).read()
        if text != want:
            raise AssertionError(f"C11 (a) {impl}: the sharded -l output "
                                 "differs from C9's --lockstep off output")
        s = dict(fl.stats)
        b1 = fused_dp_lanes.launches + fused_dp_lanes.local_launches
        x1 = backtrack_lanes.launches
        b2, x1w = banded_dp.launches, backtrack_windows.launches
        n_reads = sum(len(read_fastx(f)) for f in files)
        if impl == "device":
            if b2 or x1w or fused_dp.launches or not (
                    b1 == x1 == s["rounds"] + s["rc_rounds"] > 0):
                raise AssertionError(
                    f"C11 (a) device: B1 lanes {b1}, X1 lanes {x1}, rounds "
                    f"{s['rounds']} (+{s['rc_rounds']}), B2 {b2}, X1w {x1w}")
            if s["syncs"] > s["rounds"] + s["rc_rounds"] + s["kahn_rounds"]:
                raise AssertionError(f"C11 (a) device: {s['syncs']} host "
                                     f"syncs in {s['rounds']} group rounds")
            if built:
                raise AssertionError(f"C11 (a) device: {len(built)} host "
                                     "graphs built before the downloads")
            log(f"[C11] (a) device lockstep over the mesh, {len(files)} sets "
                f"({n_reads} reads), -r 2: == C9 --lockstep off; wall "
                f"{wall:.2f} s against C9's unsharded {c9['walls']['device']:.2f}"
                f" s; {s['rounds']} group rounds ({s['kahn_rounds']} with a "
                f"Kahn repair), B1 lane launches {b1}, X1 {x1}, host syncs "
                f"{s['syncs']} ({s['syncs'] / max(1, s['rounds']):.3f} a group "
                f"round), no host graph built; caps {s['caps']}")
            out["device"] = dict(wall=wall, b1=b1, rounds=s["rounds"],
                                 syncs=s["syncs"])
        else:
            st = dict(banded.stats)
            check_walks("C11 (a) split", st, b2, x1w)
            ls = dict(lockstep.stats)
            if b1 or fused_dp.launches or b2 < S or \
                    st["launches"] < ls["rounds"]:
                raise AssertionError(f"C11 (a) split: B2 {b2} in "
                                     f"{ls['rounds']} rounds, B1 {b1}")
            log(f"[C11] (a) split driver over the mesh: == C9 --lockstep "
                f"off; wall {wall:.2f} s against C9's unsharded "
                f"{c9['walls']['split']:.2f} s; {ls['rounds']} rounds, B2 "
                f"launches {b2} ({b2 / max(1, ls['rounds']):.3f} a round), "
                f"X1w {x1w}, relaunches counted {st['launches']}")
            out["split"] = dict(wall=wall, b2=b2, x1w=x1w,
                                rounds=ls["rounds"])

    # (b) C10's -K 8 map over the mesh
    zero()
    p = Params(device="cuda").finalize()
    recs = read_fastx(c10["reads"])
    qs = [encode(p, r.seq) for r in recs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    static = dp_chunk.StaticGraphTables(c10["graph"], p)
    res = parallel.map_reads_split(static, qs, p, k_cap=8, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gaf = [gaf_record(r.name, q, o[0], static.base_by_nid, o[1],
                      comment=r.comment or None)
           for r, q, o in zip(recs, qs, res)]
    if gaf != c10["gaf8"]:
        raise AssertionError("C11 (b): the sharded map's GAF differs from "
                             "C10's -K 8 GAF")
    cards_used = len(set(mesh))
    if (dp_chunk.stats["static_builds"],
            dp_chunk.stats["static_uploads"]) != (1, cards_used):
        raise AssertionError(f"C11 (b): tables built "
                             f"{dp_chunk.stats['static_builds']} times, "
                             f"uploaded {dp_chunk.stats['static_uploads']} "
                             f"for {cards_used} card(s)")
    check_walks("C11 (b)", dict(banded.stats), banded_dp.launches,
                backtrack_windows.launches)
    log(f"[C11] (b) map -K 8 over the mesh, {len(qs)} reads: GAF == C10's; "
        f"tables built once, uploaded {dp_chunk.stats['static_uploads']} "
        f"time(s) for {cards_used} card(s); B2 launches {banded_dp.launches}, "
        f"X1w {backtrack_windows.launches}; {len(qs) / wall:.3f} reads/s "
        f"(tables and mapping, no GAF writing)")
    out["map"] = dict(wall=wall, b2=banded_dp.launches)

    # (c) a seeded read's windows split over the mesh
    recs7 = read_fastx(os.path.join(OUT, "seeded.fa"))[:20]
    fa = os.path.join(OUT, "c11_seeded.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">{r.name}\n{r.seq}\n" for r in recs7))
    real_aw = dispatch.align_windows
    split = []

    def split_windows(g, abpt, windows, mesh_=None):
        split.append(len(windows))
        return real_aw(g, abpt, windows, mesh)

    cons = {}
    for tag in ("unsplit", "split"):
        zero()
        path = os.path.join(OUT, f"c11_seeded_{tag}.fa")
        if tag == "split":
            dispatch.align_windows = split_windows
        t0 = time.perf_counter()
        try:
            run_cli([fa, "-S", "-o", path])
        finally:
            dispatch.align_windows = real_aw
        cons[tag] = (open(path).read(), time.perf_counter() - t0,
                     banded_dp.launches, backtrack_windows.launches)
        check_walks(f"C11 (c) {tag}", dict(banded.stats), banded_dp.launches,
                    backtrack_windows.launches)
    if cons["split"][0] != cons["unsplit"][0]:
        raise AssertionError("C11 (c): the seeded consensus with split "
                             "windows differs from the unsplit run's")
    multi = sum(n >= S for n in split)
    log(f"[C11] (c) -S on {len(recs7)} of C7's reads, every read's windows "
        f"split over the mesh ({multi} reads with >= {S} windows): consensus "
        f"== unsplit; wall {cons['split'][1]:.2f} s against "
        f"{cons['unsplit'][1]:.2f} s; B2 launches {cons['split'][2]} against "
        f"{cons['unsplit'][2]}, X1w {cons['split'][3]} against "
        f"{cons['unsplit'][3]}")
    out["seeded"] = dict(b2=cons["split"][2], unsplit=cons["unsplit"][2])

    # (d) --mesh through the CLI
    lst = os.path.join(OUT, "c11_list.txt")
    with open(lst, "w") as fp:
        fp.write("".join(os.path.join(ROOT, "tests", "data", f) + "\n"
                         for f in ("seq.fa", "heter.fa")))
    proc = subprocess.run([sys.executable, "-m", "abpoa_tpu_torch", "-l", lst,
                           "--mesh", str(cards + 1)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    msg = f"mesh of {cards + 1} devices requested but {cards} CUDA device(s)"
    if proc.returncode == 0 or msg not in proc.stderr or proc.stdout:
        raise AssertionError(f"C11 (d): --mesh {cards + 1} on {cards} card(s):"
                             f" rc {proc.returncode}, stderr "
                             f"{proc.stderr[-300:]!r}")
    runs = {}
    for flags in ([], ["--mesh", "1"]):
        zero()
        path = os.path.join(OUT, f"c11_mesh{len(flags)}.fa")
        try:
            run_cli(["-l", lst, *flags, "-o", path])
        finally:
            os.environ.pop("ABPOA_TPU_MESH", None)
        runs[len(flags)] = (open(path).read(), fused_dp_lanes.launches,
                            backtrack_lanes.launches, banded_dp.launches,
                            fl.stats["syncs"])
    if runs[0] != runs[2]:
        raise AssertionError(f"C11 (d): --mesh 1 gives {runs[2][1:]} "
                             f"(launches B1 lanes, X1 lanes, B2; syncs), "
                             f"without --mesh {runs[0][1:]}")
    log(f"[C11] (d) --mesh {cards + 1} on {cards} card(s): rc "
        f"{proc.returncode}, \"{msg}\"; --mesh 1 == no --mesh (output, "
        f"launches and syncs {runs[0][1:]})")
    return out


def phase_c7(args, ref: str, reads: list, fused_cons: str):
    """Phase C7: the seeded user at full width. (a) the first --c7-reads of
    phase C's set with -S at abPOA's k, w and n; (b) half of them with
    -S -p. Returns (B2 launches of both, X1w launches of both, (row tables,
    queries, W) of the first launch of (a)'s last read, Params of the
    run)."""
    import numpy as np
    import torch
    from abpoa_tpu_torch import seed as seed_mod
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.backtrack_kernel import backtrack_windows
    from abpoa_tpu_torch.align.banded_kernel import banded_dp
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp
    from abpoa_tpu_torch.native.graph import NativePOAGraph
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.params import Params
    n7 = args.c7_reads
    p7 = Params(device="cuda", disable_seeding=False).finalize()
    # windows a read at 10 % error, from the seeding alone
    t0 = time.perf_counter()
    _, _, par_c = seed_mod.build_guide_tree_partition(
        [encode(p7, r) for r in reads[:n7]], p7)
    multi = sum(par_c[i] > par_c[i - 1] for i in range(1, n7))
    err = 0.10
    log(f"[C7] at 10 % error (phase C's reads), k={p7.k} w={p7.w} n={p7.min_w}: "
        f"{multi} of {n7 - 1} reads get >= 2 windows (seeding "
        f"{time.perf_counter() - t0:.2f} s)")
    if multi < (n7 - 1) / 2:
        # too few anchors survive 10 % error in both reads of a pair to
        # chain: the batch would not be exercised. A newer ONT chemistry's
        # 5 % error, same reference (same seed), same k, w and n
        err = 0.05
        ref, reads = simulate(args.ref_len, n7, err, args.seed)
        log("[C7] fewer than half the reads get >= 2 windows at 10 % error: "
            "C7 runs on reads of the same reference at 5 % error")
    fa7 = os.path.join(OUT, "seeded.fa")
    with open(fa7, "w") as fp:
        fp.write("".join(f">read_{i}\n{r}\n" for i, r in enumerate(reads[:n7])))
    total_b2 = total_x1w = 0
    last = None
    for tag, n, flags in (("(a)", n7, ["-S"]), ("(b)", n7 // 2, ["-S", "-p"])):
        fa = fa7
        if n != n7:
            fa = os.path.join(OUT, f"seeded_{n}.fa")
            with open(fa, "w") as fp:
                fp.write("".join(f">read_{i}\n{r}\n" for i, r in enumerate(reads[:n])))
        split = {}
        calls, undo_w = record_windows()
        undo = [undo_w, timed(seed_mod, "build_guide_tree", split, "tree"),
                timed(seed_mod, "build_guide_tree_partition", split, "seeding"),
                timed(NativePOAGraph, "add_subgraph_alignment", split, "fusion")]
        banded.reset_stats()
        retries = banded.retries
        fused_dp.launches = fused_dp.local_launches = banded_dp.launches = 0
        backtrack_windows.launches = 0
        out7 = os.path.join(OUT, f"seeded_cons{tag[1]}.fa")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            run_cli([fa, *flags, "-o", out7])
        finally:
            for u in undo:
                u()
        wall = time.perf_counter() - t0
        st = dict(banded.stats)
        b2, x1w = banded_dp.launches, backtrack_windows.launches
        total_b2 += b2
        total_x1w += x1w
        check_walks(f"C7 {tag}", st, b2, x1w)
        wins = [len(c["windows"]) for c in calls if c["windows"]]
        relaunches = banded.retries - retries
        if fused_dp.launches or fused_dp.local_launches:
            raise AssertionError(f"C7 {tag}: B1 launched on the seeded route")
        if b2 != len(wins) + relaunches or len(wins) < n - 1:
            raise AssertionError(f"C7 {tag}: {b2} B2 launches for {len(wins)} "
                                 f"aligned reads and {relaunches} relaunches")
        cons = read_fastx(out7)
        if len(cons) != 1 or not set(cons[0].seq) <= set("ACGT"):
            raise AssertionError(f"C7 {tag}: expected one ACGT consensus")
        ident = 1 - edit_distance(cons[0].seq, ref) / len(ref)
        ident_c = 1 - edit_distance(cons[0].seq, fused_cons) / len(fused_cons)
        nr = max(1, st["reads"])
        per = lambda x: f"{x * 1e3 / nr:.1f}"  # noqa: E731
        known = (split.get("seeding", 0.0) + split.get("fusion", 0.0)
                 + sum(st[k] for k in ("tables_s", "kernel_s", "backtrack_s",
                                       "d2h_s", "cigar_s")))
        log(f"[C7] {tag} {n} reads x {args.ref_len} bp at {err * 100:.0f} % error, "
            f"{' '.join(flags)} (k={p7.k} w={p7.w} n={p7.min_w}) through the CLI "
            f"on cuda: wall {wall:.2f} s ({n / wall:.3f} reads/s); windows a read "
            f"min {min(wins)} / median {int(np.median(wins))} / max {max(wins)} "
            f"({sum(wins)} in {len(wins)} aligned reads); B2 launches {b2} = "
            f"{len(wins)} reads + {relaunches} relaunches, X1w launches {x1w}, "
            f"B1 none; {st['rows']} DP rows launched")
        log(f"[C7] {tag} per aligned read (ms): "
            f"{per_read_split(st, split.get('fusion', 0.0), nr)}; the rest of "
            f"the run {per(wall - known)}; seeding {split.get('seeding', 0.0):.2f} "
            f"s of which the guide tree {split.get('tree', 0.0):.2f} s; pinned "
            f"buffer {banded._pinned[0].numel() * 4 / 2**20:.2f} MiB")
        log(f"[C7] {tag} consensus length {len(cons[0].seq)}, identity to the "
            f"reference {ident:.5f}, to phase C's fused consensus {ident_c:.5f}")
        if ident < 0.99:
            raise AssertionError(f"C7 {tag}: consensus identity {ident:.5f} < 0.99")
        if tag == "(a)":
            last = calls[-1]["launches"][0]
    return total_b2, total_x1w, last, p7


def longest_window(args):
    """banded_dp's inputs for the window with the most rows of a batch."""
    import torch
    roff = args[11].tolist()
    b = max(range(len(roff) - 1), key=lambda k: roff[k + 1] - roff[k])
    r0, r1 = roff[b], roff[b + 1]
    one = torch.tensor([0, r1 - r0], dtype=torch.int32, device=args[0].device)
    return (args[0][b:b + 1].contiguous(), *(t[r0:r1].contiguous() for t in args[1:9]),
            args[9][b:b + 1].contiguous(), args[10][b:b + 1].contiguous(), one)


def main() -> int:
    """The run (`run`), with its pool of plain-version workers closed at
    the end, whether it passes or fails."""
    plain = PlainPool(workers=7)  # phase D's ~20 jobs; the main process waits
    try:
        return run(plain)
    finally:
        plain.close()


def run(plain) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=500)
    ap.add_argument("--ref-len", type=int, default=10000)
    ap.add_argument("--c2-reads", type=int, default=50)
    ap.add_argument("--c4-reads", type=int, default=100)
    ap.add_argument("--c5-reads", type=int, default=100)
    ap.add_argument("--c6-reads", type=int, default=50)
    ap.add_argument("--c7-reads", type=int, default=200)
    # 20 until C9's run with collisions forced made the script too long
    ap.add_argument("--c9-reads", type=int, default=10)
    ap.add_argument("--c11-sets", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(ROOT, "abpoa_tpu_torch", "csrc", "fused_dp.cu")):
        print("chip_smoke: abpoa_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.backtrack_kernel import (
        backtrack, backtrack_torch, backtrack_windows)
    from abpoa_tpu_torch.align.banded_kernel import (banded_dp, banded_dp_torch,
                                                     unbanded_dp)
    from abpoa_tpu_torch.align.buckets import bucket_pow2, qp_rung
    from abpoa_tpu_torch.align.device_graph import DeviceGraph, fuse_alignment
    from abpoa_tpu_torch.align.fuse_kernel import (fuse_alignment_lanes,
                                                   lane_graph)
    from abpoa_tpu_torch.align.fused_lanes import stack_graphs
    from abpoa_tpu_torch.align.edge_sort_kernel import (edge_sort,
                                                        edge_sort_torch,
                                                        finish_fusion_)
    from abpoa_tpu_torch.align.fused_dp_kernel import (fused_dp,
                                                       fused_dp_lanes,
                                                       fused_dp_torch,
                                                       launch_shape)
    from abpoa_tpu_torch.align.tables import (build_row_tables,
                                              initial_band_width, query_tables)
    from abpoa_tpu_torch.align.topo_kernel import launch_shape as launch_shape_k1
    from abpoa_tpu_torch.align.topo_kernel import (topo_sort, topo_sort_lanes,
                                                   topo_sort_torch)
    from abpoa_tpu_torch.graph import POAGraph
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.kernels import build
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.native import build as build_native
    from abpoa_tpu_torch.native.graph import NativePOAGraph
    from abpoa_tpu_torch.pipeline import (Abpoa, _ingest_records, _rc_encode,
                                          _select_graph, output, poa,
                                          want_native)

    card = smi("name,power.limit") or "nvidia-smi failed"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    rates = Rates()
    log(f"[rates] {rates.sms} SMs x {INT32_LANES_PER_SM} INT32 lanes x "
        f"{rates.clock_hz / 1e6:.0f} MHz max SM clock = "
        f"{rates.int_ops / 1e12:.3f} T int32 op/s; HBM {rates.bytes / 1e12:.2f} TB/s")
    os.makedirs(OUT, exist_ok=True)
    t_start = time.perf_counter()

    def lap(phase):
        log(f"[wall] {phase} ended at {time.perf_counter() - t_start:.1f} s")

    # ---- build: the kernels (one nvcc a source) and the native host graph
    # (g++), all at once
    import threading
    t0 = time.perf_counter()
    native_done = {}

    def native_build():
        try:
            native_done["path"] = build_native()
        except Exception as e:  # raised below, in this thread
            native_done["error"] = e
        native_done["s"] = time.perf_counter() - t0

    th = threading.Thread(target=native_build)
    th.start()
    build.build(verbose=True)
    log(f"[build] nvcc sm_90a, {len(build.sources())} sources in parallel: "
        f"{time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(build.library_path(), ROOT)}")
    th.join()
    if "error" in native_done:
        raise native_done["error"]
    log(f"[build] g++ native host graph: {native_done['s']:.2f} s -> "
        f"{os.path.relpath(native_done['path'], ROOT)}")

    dev = torch.device("cuda")
    abpt = Params(device="cuda").finalize()
    cpu = Params(device="cpu").finalize()
    max_err = {k: 0 for k in ("banded_dp", "banded_dp[windows]",
                              "banded_dp[lanes]", "banded_dp[unbanded]",
                              "fused_dp", "fused_dp[local]", "fused_dp[lanes]",
                              "backtrack", "backtrack[lanes]",
                              "backtrack[windows]", "edge_sort",
                              "edge_sort[lanes]", "topo_sort",
                              "topo_sort[lanes]", "fuse_alignment")}
    sim2k = [r.seq for r in read_fastx(os.path.join(ROOT, "tests", "data", "sim2k.fa"))]

    lap("build")
    # ---- A: B2 vs plain (the per-read route's kernel, B1's seeded
    # instantiation): sim2k tables, the forced relaunch chain, a re-seeded
    # `-s` launch, a 20 kb read past W = 16384, a warp sweep at W = 512
    def b2_case(tag, p, g, query, W, want_ok=None):
        t = build_row_tables(g, 0, 1)
        qt = query_tables(p, t, query, W)
        ts = to_dev([qt["scalars"], t.base, t.pre_idx, t.pre_cnt, t.out_idx,
                     t.out_cnt, t.remain, t.mpl0, t.mpr0, qt["qp_pad"],
                     qt["row0"]], dev)
        got = banded_dp(*ts, gap_mode=p.gap_mode)
        torch.cuda.synchronize()
        # on the card: the 20 kb read's planes (up to 24320 x 19988 ints,
        # five of them) take longer to fill on the host than its rows take
        plain_ms, want = time_host(lambda: banded_dp_torch(*ts, gap_mode=p.gap_mode))
        err, rows = compare_dp(f"banded_dp {tag}", got, want, ts)
        max_err["banded_dp"] = max(max_err["banded_dp"], err)
        ok = int(got[7].item())
        if want_ok is not None and ok != want_ok:
            raise AssertionError(f"B2 {tag} W={W}: ok={ok}, expected {want_ok}")
        ls = launch_shape(W, t.pre_idx.shape[1], p.gap_mode, seeded=True)
        log(f"[A] B2 {tag} R={t.R} gn={t.gn} W={W} P={t.pre_idx.shape[1]} "
            f"({ls['block_warps']} warps, cpt {ls['cpt']}, ring D={ls['depth']}) "
            f"ok={ok}: kernel == plain on rows 0..{rows - 1}, begend, mplr, ok, "
            f"ext (plain {plain_ms:.1f} ms)")
        return ts, got, want, rows, ok

    g = POAGraph()
    for i in range(3):
        q = encode(cpu, sim2k[i])
        cigar = (banded.align_sequence_to_subgraph(g, abpt, 0, 1, q).cigar
                 if g.node_n > 2 else [])
        g.add_alignment(abpt, q, None, cigar, True)
    g.topological_sort(abpt)
    query = encode(cpu, sim2k[3])
    b2_case("sim2k", abpt, g, query, initial_band_width(abpt, len(query)), 1)
    for gname, gkw in (("affine", {"gap_open2": 0}),
                       ("linear", {"gap_open1": 0, "gap_open2": 0})):
        p = Params(device="cuda", **gkw).finalize()
        b2_case(f"sim2k {gname}", p, g, query, initial_band_width(p, len(query)), 1)
    ts512, _, want512, _, _ = b2_case("sim2k", abpt, g, query, 512, 1)
    wide = Params(device="cuda", wb=600).finalize()
    W = 512
    while True:  # forced overflow: the relaunch chain of align/banded.py
        last = W >= len(query) + 1
        ok = b2_case("sim2k wb=600", wide, g, query, W, 1 if last else None)[4]
        if last:
            break
        W = banded.next_band_width(W, len(query))
    if ok != 1 or W <= 1024:
        raise AssertionError("overflow case did not end in a W > 1024 launch that fits")
    # the `-s` retry: the forward launch writes its mpl/mpr back into the
    # unsorted graph, and the reverse complement's tables are seeded from them
    rcmix = [encode(cpu, r.seq) for r in
             read_fastx(os.path.join(ROOT, "tests", "data", "rcmix.fa"))]
    g = POAGraph()
    for q in rcmix[:3]:
        cigar = (banded.align_sequence_to_subgraph(g, abpt, 0, 1, q).cigar
                 if g.node_n > 2 else [])
        g.add_alignment(abpt, q, None, cigar, True)
    g.topological_sort(abpt)
    banded.align_sequence_to_subgraph(g, abpt, 0, 1, rcmix[3])
    rc = _rc_encode(rcmix[3])
    b2_case("rcmix -s re-seeded", abpt, g, rc, initial_band_width(abpt, len(rc)), 1)
    # one ~20 kb read against another's chain, forced past W = 16384 (32
    # columns a thread, no ring; B1 stops at 16384)
    _, long_reads = simulate(20000, 2, 0.10, args.seed + 1)
    g = POAGraph()
    g.add_alignment(abpt, encode(cpu, long_reads[0]), None, [], True)
    q20 = encode(cpu, long_reads[1])
    wide = Params(device="cuda", wb=9000).finalize()
    W = 512
    while True:
        last = W >= len(q20) + 1
        ts20, _, _, rows20, ok = b2_case("20 kb wb=9000", wide, g, q20, W,
                                         1 if last else None)
        if last:
            break
        W = banded.next_band_width(W, len(q20))
    if ok != 1 or W <= 16384:
        raise AssertionError("the 20 kb case did not end in a W > 16384 launch that fits")
    b2_long_ms = time_cuda(lambda: banded_dp(*ts20), 1)
    log(f"[A] B2 20 kb at W={W}: kernel {b2_long_ms:.3f} ms, "
        f"{b2_long_ms * 1e3 / max(1, rows20 - 1):.3f} us a computed row")
    del ts20
    torch.cuda.empty_cache()
    sweep_warps("A B2 sim2k", ts512, None, want512)
    phase_a_windows(dev, os.path.join(ROOT, "tests", "data"), max_err)
    phase_a_modes(dev, os.path.join(ROOT, "tests", "data"), max_err, rates)

    lap("A")
    # ---- A2: B1 (every variant), B3, X1, K1 vs plain on sim2k tables
    sim2k_enc = [encode(cpu, s) for s in sim2k]
    st3, _ = fused_state(abpt, sim2k_enc, 3)
    q4 = sim2k_enc[3]
    gaps = {"convex": {}, "affine": {"gap_open2": 0},
            "linear": {"gap_open1": 0, "gap_open2": 0}}
    modes = {"global": {}, "extend": {"align_mode": 2, "zdrop": 20},
             "local": {"align_mode": 1}}
    local_W = bucket_pow2(len(q4) + 2)
    b3_case = b1_case = None
    for gname, gkw in gaps.items():
        for mname, mkw in modes.items():
            for plane16 in (True, False):
                p = Params(device="cuda", **gkw, **mkw).finalize()
                local = mname == "local"
                W = local_W if local else 128
                a2, inf = fused_case(p, st3, q4, W, plane16, local)
                kw = dict(gap_mode=p.gap_mode, plane16=plane16,
                          extend=mname == "extend",
                          zdrop_on=mname == "extend", local=local)
                got = fused_dp(*a2, **kw)
                torch.cuda.synchronize()
                name = "fused_dp[local]" if local else "fused_dp"
                want = time_plain(fused_dp_torch, a2, **kw)[1]
                err, rows = compare_dp(f"{name} {gname}-{mname}", got, want, a2)
                max_err[name] = max(max_err[name], err)
                bta, max_ops = bt_inputs(p, a2, got, q4, inf, mname != "global")
                bkw = dict(max_ops=max_ops, gap_mode=p.gap_mode,
                           gap_on_right=False, put_gap_at_end=False,
                           local=local)
                bt = backtrack(*bta, **bkw)
                torch.cuda.synchronize()
                max_err["backtrack"] = max(max_err["backtrack"], compare(
                    f"backtrack {gname}-{mname}", bt, backtrack_torch(*bta, **bkw)))
                log(f"[A2] {gname}-{mname}-{'int16' if plane16 else 'int32'} "
                    f"W={W}: B1 kernel == plain on rows 0..{rows - 1} (ok={int(got[7][0])}, "
                    f"ext={got[8].tolist()}); X1 kernel == plain "
                    f"(n_ops={int(bt[1][0])}, err={int(bt[1][5])})")
                if gname == "convex" and not plane16 and mname != "extend":
                    case = (a2, kw, got, want)
                    if local:
                        b3_case = case
                    else:
                        b1_case = case
    # shapes no read set reaches at this size: predecessors 70 rows back,
    # past the kernel's shared-memory ring, and 64 predecessor slots with
    # the backtrack's first hit in slot 40
    for kind in ("far", "wide"):
        preds, bases, qs = synthetic_graph(kind)
        for gname, gkw in gaps.items():
            for mname in ("global", "extend"):
                p = Params(device="cuda", **gkw, **(
                    {"align_mode": 2, "zdrop": 5} if mname == "extend" else {})).finalize()
                a2, inf = synthetic_inputs(p, preds, bases, qs, 128, False, False,
                                           P=64 if kind == "wide" else None, dev=dev)
                kw = dict(gap_mode=p.gap_mode, plane16=False,
                          extend=mname == "extend", zdrop_on=mname == "extend")
                got = fused_dp(*a2, **kw)
                torch.cuda.synchronize()
                err, rows = compare_dp(f"fused_dp {kind} {gname}-{mname}", got,
                                       fused_dp_torch(*a2, **kw), a2)
                max_err["fused_dp"] = max(max_err["fused_dp"], err)
                bta, max_ops = bt_inputs(p, a2, got, qs, inf, mname != "global")
                bkw = dict(max_ops=max_ops, gap_mode=p.gap_mode,
                           gap_on_right=False, put_gap_at_end=False, local=False)
                bt = backtrack(*bta, **bkw)
                torch.cuda.synchronize()
                max_err["backtrack"] = max(max_err["backtrack"], compare(
                    f"backtrack {kind} {gname}-{mname}", bt,
                    backtrack_torch(*bta, **bkw)))
                ls = launch_shape(128, a2[2].shape[1], p.gap_mode)
                log(f"[A2] {kind} {gname}-{mname} (P={a2[2].shape[1]}, W=128, "
                    f"ring D={ls['depth']}): B1 kernel == plain on rows 0..{rows - 1} "
                    f"(ext={got[8].tolist()}); X1 kernel == plain "
                    f"(n_ops={int(bt[1][0])}, err={int(bt[1][5])})")
    # the JAX package picks B3 where B1's three 512-row rings of W int32
    # columns, the plane blocks and the query profile pass 11 MB of VMEM
    # (pallas_fused.py:678-690)
    vmem = 3 * 512 * local_W * 4 + 10 * 32 * local_W * 4 + 5 * (qp_rung(len(q4)) + local_W) * 4
    log(f"[A2] B3 width: local W = {local_W}, B1's VMEM need {vmem / 2**20:.1f} MB "
        f"> 11 MB -> B3 in the JAX package: {vmem > 11 * 2**20}")
    b3_ms = time_cuda(lambda: fused_dp(*b3_case[0], **b3_case[1]), 3)
    b3_plain_ms, _ = time_plain(fused_dp_torch, b3_case[0], **b3_case[1])
    b3_bound = dp_bound(rates, b3_case[0], b3_case[2])
    log(f"[A2] B3 (local, gn={int(b3_case[0][0][8])}, R={b3_case[0][1].shape[0]}, "
        f"W={local_W}): kernel "
        f"{b3_ms:.3f} ms, plain {b3_plain_ms:.1f} ms, bound {b3_bound[0]:.4f} ms "
        f"({b3_bound[1]})")
    sweep_warps("A2 B1 convex-global-int32", b1_case[0], b1_case[1], b1_case[3])
    sweep_warps("A2 B3 convex-local-int32", b3_case[0], b3_case[1], b3_case[3])
    st_k, kahn_in = fused_state(abpt, sim2k_enc, 12)
    if kahn_in is None:
        raise AssertionError("sim2k made no Kahn repair")
    got = topo_sort(*kahn_in)
    torch.cuda.synchronize()
    max_err["topo_sort"] = compare("topo_sort", got, topo_sort_torch(*kahn_in))
    log(f"[A2] K1 on the first repaired sim2k graph ({int(kahn_in[8][0])} "
        f"nodes): kernel == plain (ok={int(got[7][0])})")
    # K1's degree variants, and the graphs made for its traps
    for kind, ka in [("sim2k", kahn_in)] + [(k, to_dev(k1_graph(k), dev))
                                            for k in K1_GRAPHS]:
        want = topo_sort_torch(*ka)
        for variant in ("s8", "g32"):
            got = topo_sort(*ka, variant=variant)
            torch.cuda.synchronize()
            max_err["topo_sort"] = max(max_err["topo_sort"], compare(
                f"topo_sort {kind} {variant}", got, want))
        log(f"[A2] K1 {kind} (N={ka[0].shape[0]}, E={ka[0].shape[1]}, "
            f"A={ka[6].shape[1]}, node_n={int(ka[8][0])}, ok={int(want[7][0])}): "
            f"kernel == plain in the s8 and g32 variants")
    # S1 on the sim2k graphs and the tie-heavy rows: out of place over every
    # row (`edge_sort`), and in place below node_n with the span update as
    # the loop runs it (`finish_fusion_`), each on fresh copies
    s1_cases = [(name, (g.in_ids, g.in_w, g.out_ids, g.out_w, g.in_cnt,
                        g.out_cnt), int(g.node_n), g.n_span)
                for name, g in (("sim2k 3 reads", st3.g),
                                ("sim2k 12 reads", st_k.g))]
    s1_cases.append(("sim2k Kahn input", kahn_in[:6], int(kahn_in[8][0]),
                     None))
    s1_cases += [(f"ties E={E}", to_dev(tie_graph(E), dev), 80, None)
                 for E in (8, 16, 32)]
    for name, sa, n_rows, span in s1_cases:
        got = edge_sort(*sa)
        torch.cuda.synchronize()
        max_err["edge_sort"] = max(max_err["edge_sort"], compare(
            f"edge_sort {name}", got, edge_sort_torch(*sa)))
        if span is None:
            span = torch.arange(sa[0].shape[0], dtype=torch.int32, device=dev)
        nn = torch.tensor([n_rows], dtype=torch.int32, device=dev)
        err, _ = check_s1(f"finish_fusion_ {name}", sa[:4], sa[4:6], nn, span)
        max_err["edge_sort"] = max(max_err["edge_sort"], err)
        ms = time_s1(sa[:4], sa[4:6], nn, span, 20)
        bnd = s1_bound(rates, sa, n_rows)
        need, multi, moved = s1_need_bound(rates, sa, n_rows)
        log(f"[A2] S1 {name} (N={sa[0].shape[0]}, E={sa[0].shape[1]}, node_n "
            f"{n_rows}; {multi} rows with 2+ slots, {moved} move): kernel == "
            f"plain (out of place; in place with span); in place on fresh "
            f"copies, queued: {ms:.4f} ms; bound of what it needs "
            f"{need[0]:.5f} ms ({need[1]}), of a copy of every row "
            f"{bnd[0]:.4f} ms ({bnd[1]})")

    lap("A2")
    # ---- B: goldens through the CLI on cuda (the fused route)
    data = lambda f: os.path.join(ROOT, "tests", "data", f)  # noqa: E731
    golden = [("seq.fa", [], "ref_consensus"), ("seq.fa", ["-O", "4"], "seq_affine"),
              ("seq.fa", ["-O", "0"], "seq_linear"), ("seq.fa", ["-m", "1"], "seq_m1"),
              ("seq.fa", ["-m", "2"], "seq_m2"), ("seq.fa", ["-a", "1"], "ref_msa"),
              ("seq.fa", ["-r", "2"], "seq_r2"), ("seq.fa", ["-r", "4"], "seq_r4"),
              ("heter.fa", ["-d", "2"], "ref_heter"),
              ("heter.fa", ["-d", "2", "-r", "2"], "heter_d2r2"),
              ("3alleles.fa", ["-d", "3"], "3alleles_d3"),
              ("seq.fa", ["-r", "5"], "seq_r5"), ("aa.fa", ["-c"], "aa_cons"),
              ("aa.fa", ["-c", "-t", data("BLOSUM62.mtx")], "aa_blosum62")]
    for fa_b, flags, name in golden:
        out_b = os.path.join(OUT, f"{name}.fa")
        fl.reset_stats()
        run_cli([data(fa_b), "-o", out_b, *flags])
        with open(out_b) as fp, open(os.path.join(ROOT, "tests", "golden", f"{name}.txt")) as gp:
            if fp.read() != gp.read():
                raise AssertionError(f"{fa_b} {flags} on cuda differs from {name}.txt")
        log(f"[B] {fa_b} {' '.join(flags) or '(default)'} on cuda == tests/golden/{name}.txt "
            f"({fl.stats['reads']} reads on the fused route)")
    # read-id outputs with no golden: cuda against the port's CPU run
    for fa_b, flags in (("seq.fa", ["-r", "1"]), ("seq.fa", ["-r", "3"]),
                        ("rcmix.fa", ["-s", "-r", "1"])):
        outs_b = []
        for device in ("cuda", "cpu"):
            outs_b.append(os.path.join(OUT, f"{fa_b}{''.join(flags)}.{device}"))
            run_cli([data(fa_b), "--device", device, "-o", outs_b[-1], *flags])
        with open(outs_b[0]) as a, open(outs_b[1]) as b:
            if a.read() != b.read():
                raise AssertionError(f"{fa_b} {flags} on cuda differs from cpu")
        log(f"[B] {fa_b} {' '.join(flags)} on cuda == on cpu")
    fa4 = os.path.join(OUT, "sim2k_4.fa")
    with open(fa4, "w") as fp:
        fp.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(sim2k[:4])))
    fused_dp.local_launches = 0
    run_cli([fa4, "-m", "1", "-o", os.path.join(OUT, "m1_cuda.fa")])
    b3_launches = fused_dp.local_launches
    run_cli([fa4, "-m", "1", "--device", "cpu", "-o", os.path.join(OUT, "m1_cpu.fa")])
    with open(os.path.join(OUT, "m1_cuda.fa")) as a, open(os.path.join(OUT, "m1_cpu.fa")) as b:
        if a.read() != b.read():
            raise AssertionError("sim2k -m 1 on cuda differs from the CPU result")
    log(f"[B] sim2k -m 1 (4 reads, W={local_W}) on cuda == on cpu; "
        f"B3 launches {b3_launches}")
    if b3_launches < 3:
        raise AssertionError("the -m 1 run did not launch the local kernel")

    # incremental, qv-weighted and list runs: goldens on cuda, B1 and B2
    # each on its own route ("B2" counts kernel B2u's whole-row launches
    # too; `whole_rows` checks which of the two a run took)
    kinds = {}

    def launches_of(fn):
        """(B1 launches, single-set and over lanes; B2 and B2u launches)
        of fn()."""
        fused_dp.launches = fused_dp.local_launches = 0
        fused_dp_lanes.launches = fused_dp_lanes.local_launches = 0
        banded_dp.launches = unbanded_dp.launches = 0
        fn()
        kinds["b2"], kinds["b2u"] = banded_dp.launches, unbanded_dp.launches
        return (fused_dp.launches + fused_dp.local_launches
                + fused_dp_lanes.launches + fused_dp_lanes.local_launches,
                banded_dp.launches + unbanded_dp.launches)

    def whole_rows(tag, argv):
        """`-b -1` and `-m 1` runs launch B2u and no B2, the others B2
        and no B2u (the last `launches_of`)."""
        pairs = list(zip(argv, argv[1:]))
        whole = ("-b", "-1") in pairs or ("-m", "1") in pairs
        if (kinds["b2"] if whole else kinds["b2u"]):
            raise AssertionError(f"{tag}: B2 {kinds['b2']}, B2u {kinds['b2u']} "
                                 f"launches; expected {'B2u' if whole else 'B2'} only")
        return f" (B2u {kinds['b2u']})" if whole else ""

    def same_files(a, b, what):
        with open(a) as x, open(b) as y:
            if x.read() != y.read():
                raise AssertionError(f"{what} differ")

    def check_route(tag, b1, b2, route, argv=()):
        if (b1 > 0, b2 > 0) != (route == "B1", route == "B2"):
            raise AssertionError(f"{tag}: B1 launches {b1}, B2 launches {b2}, "
                                 f"expected {route} only")
        kind = whole_rows(tag, list(argv)) if route == "B2" else ""
        log(f"[B] {tag}: B1 launches {b1}, B2 launches {b2}{kind}")

    for args_b, name, route in (
            (["seq4.fa", "-i", "seq10.gfa"], "incr_gfa", "B1"),
            (["seq4.fa", "-i", "seq10.msa"], "incr_msa", "B1"),
            (["heter.fq", "-d", "2", "-Q"], "heterq_d2Q", "B2")):
        out_b = os.path.join(OUT, f"{name}.fa")
        argv = [data(a) if "." in a else a for a in args_b] + ["-o", out_b]
        b1, b2 = launches_of(lambda: run_cli(argv))
        same_files(out_b, os.path.join(ROOT, "tests", "golden", f"{name}.txt"),
                   f"{' '.join(args_b)} on cuda and {name}.txt")
        check_route(f"{' '.join(args_b)} on cuda == tests/golden/{name}.txt",
                    b1, b2, route, args_b)
    cwd = os.getcwd()
    os.chdir(ROOT)  # list.txt names its files from the repository root
    # --lockstep auto takes the implementation lockstep_impl picks on cuda:
    # the split driver launches B2 and no B1, the device lockstep B1 over
    # lanes and no B2
    from abpoa_tpu_torch.parallel.scheduler import lockstep_impl
    auto = ("B1" if lockstep_impl(Params(device="cuda").finalize()) == "device"
            else "B2")
    try:
        for mode, route in (("auto", auto), ("off", "B1")):
            out_l = os.path.join(OUT, f"list_mode_{mode}.fa")
            b1, b2 = launches_of(lambda: run_cli(
                ["-l", os.path.join("tests", "data", "list.txt"),
                 "--lockstep", mode, "-o", out_l]))
            same_files(out_l, os.path.join(ROOT, "tests", "golden",
                                           "list_mode.txt"),
                       f"-l list.txt --lockstep {mode} on cuda and list_mode.txt")
            check_route(f"-l tests/data/list.txt --lockstep {mode} on cuda "
                        "== tests/golden/list_mode.txt", b1, b2, route)
    finally:
        os.chdir(cwd)
    for args_b, route in ((["-r", "1"], "B2"), (["-r", "3"], "B2"),
                          (["-d", "2"], "B2")):
        argv = [data("seq4.fa"), "-i", data("seq10.gfa"), *args_b]
        outs_b = [os.path.join(OUT, f"incr{''.join(args_b)}.{d}")
                  for d in ("cuda", "cpu")]
        b1, b2 = launches_of(lambda: run_cli(argv + ["-o", outs_b[0]]))
        run_cli(argv + ["--device", "cpu", "-o", outs_b[1]])
        same_files(*outs_b, f"seq4.fa -i seq10.gfa {' '.join(args_b)} cuda and cpu")
        check_route(f"seq4.fa -i seq10.gfa {' '.join(args_b)} on cuda == on cpu",
                    b1, b2, route, args_b)
    argv = [data("seq4.fa"), "-i", data("seq10.msa"), "-m", "1"]
    outs_b = [os.path.join(OUT, f"incr_m1.{d}") for d in ("cuda", "cpu")]
    fused_dp.local_launches = 0
    b1, b2 = launches_of(lambda: run_cli(argv + ["-o", outs_b[0]]))
    local_b = fused_dp.local_launches
    run_cli(argv + ["--device", "cpu", "-o", outs_b[1]])
    same_files(*outs_b, "seq4.fa -i seq10.msa -m 1 cuda and cpu")
    check_route("seq4.fa -i seq10.msa -m 1 on cuda == on cpu (B3 launches "
                f"{local_b})", b1, b2, "B1")
    if local_b < 2:
        raise AssertionError("-i -m 1 did not launch B3 for both new reads")
    dots = []
    for d in ("cuda", "cpu"):
        png = os.path.join(OUT, f"plot_{d}.png")
        run_cli([data("seq.fa"), "--device", d, "-g", png,
                 "-o", os.path.join(OUT, f"plot_{d}.fa")])
        dots.append(png + ".dot")
    same_files(*dots, "seq.fa -g .dot files of cuda and cpu")
    log("[B] seq.fa -g: the .dot file on cuda == on cpu")
    from abpoa_tpu_torch import pyapi
    seqs_b = [r.seq for r in read_fastx(data("seq.fa"))]
    res_b = []
    b1, b2 = launches_of(lambda: res_b.append(pyapi.msa_aligner().msa(
        seqs_b, out_cons=True, out_msa=True)))
    res_b.append(pyapi.msa_aligner(device="cpu").msa(seqs_b, out_cons=True,
                                                      out_msa=True))
    if vars(res_b[0]) != vars(res_b[1]):
        raise AssertionError("pyapi msa on cuda differs from cpu")
    check_route("pyapi.msa_aligner().msa(seq.fa, out_cons, out_msa) on cuda == "
                "on cpu", b1, b2, "B2")
    # the seeded route (-S, -p): B2 batched over each read's windows
    for fa_b, flags, name in (
            ("seq.fa", ["-S", "-p"], "seq_Sp"),
            ("rcmix.fa", ["-s", "-S", "-n", "200"], "rcmix_sS"),
            ("rcmix.fa", ["-s", "-S", "-p", "-n", "200"], "rcmix_sSp")):
        out_b = os.path.join(OUT, f"{name}.fa")
        b1, b2 = launches_of(lambda: run_cli([data(fa_b), "-o", out_b, *flags]))
        same_files(out_b, os.path.join(ROOT, "tests", "golden", f"{name}.txt"),
                   f"{fa_b} {' '.join(flags)} on cuda and {name}.txt")
        check_route(f"{fa_b} {' '.join(flags)} on cuda == tests/golden/{name}.txt",
                    b1, b2, "B2", flags)
    fa6 = os.path.join(OUT, "sim2k_6.fa")
    with open(fa6, "w") as fp:
        fp.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(sim2k[:6])))
    for k_b, argv in enumerate((
            [fa6, "-S", "-n", "200"], [fa6, "-S", "-n", "200", "-O", "0"],
            [fa6, "-S", "-n", "200", "-O", "4"],
            [fa6, "-S", "-p", "-n", "200", "-r", "1"],
            [data("seq4.fa"), "-i", data("seq10.gfa"), "-S", "-r", "1"],
            [data("seq.fa"), "-p", "-O", "0"])):
        what = " ".join(os.path.basename(a) for a in argv)
        outs_b = [os.path.join(OUT, f"seeded_{k_b}.{d}") for d in ("cuda", "cpu")]
        b1, b2 = launches_of(lambda: run_cli(argv + ["-o", outs_b[0]]))
        run_cli(argv + ["--device", "cpu", "-o", outs_b[1]])
        same_files(*outs_b, f"{what} on cuda and cpu")
        check_route(f"{what} on cuda == on cpu", b1, b2, "B2", argv)

    # B2's modes: -b -1's golden, then the flag sets
    # with no golden on cuda == on cpu, each on B2 or on B2u alone
    out_b = os.path.join(OUT, "seq_noband.fa")
    b1, b2 = launches_of(lambda: run_cli([data("seq.fa"), "-b", "-1", "-o", out_b]))
    same_files(out_b, os.path.join(ROOT, "tests", "golden", "seq_noband.txt"),
               "seq.fa -b -1 on cuda and seq_noband.txt")
    check_route("seq.fa -b -1 on cuda == tests/golden/seq_noband.txt", b1, b2,
                "B2", ["-b", "-1"])
    lst = os.path.join(OUT, "list_local.txt")
    one = os.path.join(OUT, "one_read.fa")
    with open(one, "w") as fp:
        fp.write(">r\nCGTCAATCTATCGAAGCATACGCGGCAGAGCCGAAGACC\n")
    with open(lst, "w") as fp:
        fp.write(f"{data('seq4.fa')}\n{one}\n")
    for k_b, argv in enumerate((
            [data("seq.fa"), "-G"], [data("heter.fa"), "-G", "-m", "1"],
            [data("rcmix.fa"), "-m", "2", "-z", "20", "-b", "-1"],
            [data("seq.fa"), "-S", "-G"],
            [data("rcmix.fa"), "-S", "-b", "-1", "-n", "200"],
            [data("seq4.fa"), "-i", data("seq10.gfa"), "-r", "1", "-m", "1"],
            [data("heter.fq"), "-Q", "-d", "2", "-m", "2"],
            [lst, "-l", "-i", data("seq10.gfa"), "-m", "1", "-r", "1"])):
        what = " ".join(os.path.basename(a) for a in argv)
        outs_b = [os.path.join(OUT, f"modes_{k_b}.{d}") for d in ("cuda", "cpu")]
        b1, b2 = launches_of(lambda: run_cli(argv + ["-o", outs_b[0]]))
        run_cli(argv + ["--device", "cpu", "-o", outs_b[1]])
        same_files(*outs_b, f"{what} on cuda and cpu")
        check_route(f"{what} on cuda == on cpu", b1, b2, "B2", argv)

    lap("B")
    # ---- C: the main path at full width, the fused route
    ref, reads = simulate(args.ref_len, args.reads + 1, 0.10, args.seed)
    held_out = reads.pop()
    fa = os.path.join(OUT, "sim.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">read_{i}\n{r}\n" for i, r in enumerate(reads)))
    out_c = os.path.join(OUT, "sim_cons.fa")
    fl.reset_stats()
    fl.timing = True
    fused_dp.launches = fused_dp.local_launches = 0
    backtrack.launches = topo_sort.launches = banded_dp.launches = 0
    edge_sort.launches = unbanded_dp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli([fa, "-o", out_c])
    wall = time.perf_counter() - t0
    fl.timing = False
    launches = {"fused_dp": fused_dp.launches, "backtrack": backtrack.launches,
                "edge_sort": edge_sort.launches, "topo_sort": topo_sort.launches}
    if banded_dp.launches or unbanded_dp.launches or fused_dp.local_launches:
        raise AssertionError("the fused route launched another route's kernel")
    s = dict(fl.stats)
    n = args.reads
    if launches["fused_dp"] < n - 1 or launches["backtrack"] < n - 1 \
            or launches["topo_sort"] < 1 or launches["edge_sort"] < n - 1:
        raise AssertionError(f"main-path launches {launches} for {n} reads")
    if launches["edge_sort"] > s["reads"] + s["collisions"]:
        raise AssertionError(f"{launches['edge_sort']} S1 launches for "
                             f"{s['reads']} read attempts")
    cons = read_fastx(out_c)
    if len(cons) != 1 or not set(cons[0].seq) <= set("ACGT"):
        raise AssertionError("expected one ACGT consensus")
    ident = 1 - edit_distance(cons[0].seq, ref) / len(ref)
    dev_s, host_s = s["device_s"], s["host_s"]
    log(f"[C] {n} reads x {args.ref_len} bp at 10% error, fused route: wall "
        f"{wall:.2f} s, {n / wall:.3f} reads/s (loop {s['wall_s']:.2f} s; the "
        f"rest is reading, the graph download and the consensus)")
    per = lambda x: f"{x / n * 1e3:.2f}"  # noqa: E731
    log(f"[C] per read (ms): B1 {per(dev_s['fused_dp'])}, X1 "
        f"{per(dev_s['backtrack'])}, K1 {per(dev_s['topo_sort'])}, host/torch "
        f"rest {per(wall - dev_s['fused_dp'] - dev_s['backtrack'] - dev_s['topo_sort'])}")
    log("[C] per read, each step on the stream (CUDA events) / on the host (ms): "
        + ", ".join(f"{k} {per(dev_s[k])}/{per(host_s[k])}" for k in fl.STEPS)
        + f"; host waits in syncs {per(host_s['sync'])}; stream time outside "
        f"the steps {per(s['wall_s'] - sum(dev_s.values()))}")
    log(f"[C] edge_sort (span update and S1) per read: "
        f"{dev_s['edge_sort'] / n * 1e3:.4f} ms on the stream, "
        f"{host_s['edge_sort'] / n * 1e3:.4f} ms on the host ({launches['edge_sort']} "
        f"S1 launches); topo_sort {per(dev_s['topo_sort'])} ms on the stream")
    log(f"[C] launches {launches}; read attempts {s['reads']}, host syncs "
        f"{s['syncs']} ({s['syncs'] / max(1, s['reads']):.3f} per attempt); "
        f"Kahn repairs {s['kahn']}, collisions {s['collisions']}")
    log(f"[C] growths by error code {s['grow']}, promotions {s['promotions']}, "
        f"final caps {s['caps']}")
    log(f"[C] consensus length {len(cons[0].seq)}, identity to reference {ident:.5f}")
    if ident < 0.99:
        raise AssertionError(f"consensus identity {ident:.5f} < 0.99")
    st_c, caps_c = fl.last_state, s["caps"]

    lap("C")
    # ---- C2: per-read route (B2) and fused route on the first M reads
    m = args.c2_reads
    recs = read_fastx(fa)[:m]
    outs, ab_pr = [], None
    split2 = {}
    for route in ("per-read", "fused"):
        ab = Abpoa()
        seqs, weights = _ingest_records(ab, abpt, recs)
        banded_dp.launches = backtrack_windows.launches = 0
        banded.reset_stats()
        t0 = time.perf_counter()
        if route == "per-read":
            _select_graph(ab, want_native(abpt))  # as pipeline.msa gives it
            undo = timed(NativePOAGraph, "add_subgraph_alignment", split2, "fusion")
            try:
                poa(ab, abpt, seqs, weights, 0)
            finally:
                undo()
            b2_launches, ab_pr = banded_dp.launches, ab
            x1w_c2 = backtrack_windows.launches
            pr_wall, pr_stats = time.perf_counter() - t0, dict(banded.stats)
        else:
            from abpoa_tpu_torch.pipeline import _run_fused_device
            _run_fused_device(ab, abpt, seqs, weights)
        buf = io.StringIO()
        output(ab, abpt, buf)
        outs.append(buf.getvalue())
        log(f"[C2] {route} route, {m} reads: {time.perf_counter() - t0:.2f} s")
    n_pr = max(1, pr_stats["reads"])
    log(f"[C2] per-read route, per aligned read ({pr_stats['reads']} reads, "
        f"{pr_stats['rows']} DP rows launched, {b2_launches} B2 launches, "
        f"{x1w_c2} X1w launches): wall {pr_wall * 1e3 / n_pr:.1f} ms = "
        f"{per_read_split(pr_stats, split2.get('fusion', 0.0), n_pr)}; the POA "
        f"loop {pr_wall:.2f} s")
    if b2_launches < m - 1:
        raise AssertionError(f"per-read route: {b2_launches} B2 launches for {m} reads")
    check_walks("C2", pr_stats, b2_launches, x1w_c2)
    if outs[0] != outs[1]:
        raise AssertionError("per-read and fused routes give different consensus")
    log(f"[C2] per-read (B2 launches {b2_launches}) == fused consensus, byte for byte")
    f1c2 = forced_collisions(abpt, recs, outs[1])
    log(f"[C2] fused route with a collision forced on every read ({m} reads): "
        f"== the unforced run, byte for byte; wall {f1c2['wall']:.2f} s; F1 "
        f"launches {f1c2['f1']}, K1 {f1c2['k1']}, S1 {f1c2['s1']}, collisions "
        f"{f1c2['collisions']}, host syncs {f1c2['syncs']}; host graphs built 0")

    lap("C2")
    # ---- C3: the read-id outputs at full width: the headline set with -r 2
    from abpoa_tpu_torch import pipeline as pl
    from abpoa_tpu_torch.cons import msa as msa_mod
    split = {}
    undo = [timed(POAGraph, "set_msa_rank", split, "rank"),
            timed(msa_mod, "collect_msa", split, "rank"),
            timed(msa_mod, "generate_consensus", split, "consensus"),
            timed(pl, "output_rc_msa", split, "write")]
    out_c3 = os.path.join(OUT, "sim_msa.fa")
    fl.reset_stats()
    fused_dp.launches = fused_dp.local_launches = 0
    backtrack.launches = topo_sort.launches = banded_dp.launches = 0
    edge_sort.launches = unbanded_dp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ab3 = run_pipeline([fa, "-r", "2"], out_c3)
    wall3 = time.perf_counter() - t0
    for u in undo:
        u()
    launches3 = {"fused_dp": fused_dp.launches, "backtrack": backtrack.launches,
                 "edge_sort": edge_sort.launches, "topo_sort": topo_sort.launches}
    s3 = dict(fl.stats)
    if (launches3 != launches or banded_dp.launches or unbanded_dp.launches
            or fused_dp.local_launches):
        raise AssertionError(f"-r 2 launches {launches3}, the consensus run's {launches}")
    if (s3["syncs"], s3["reads"]) != (s["syncs"], s["reads"]):
        raise AssertionError(f"-r 2: {s3['syncs']} host syncs in {s3['reads']} read "
                             f"attempts, the consensus run {s['syncs']} in {s['reads']}")
    cons3 = "".join(chr(c) for c in abpt.code_to_char[ab3.cons.cons_base[0]])
    if cons3 != cons[0].seq:
        raise AssertionError("-r 2's consensus differs from the consensus run's")
    rows = read_fasta_rows(out_c3)
    if [name for name, _ in rows] != [f"read_{i}" for i in range(n)] + ["Consensus_sequence"]:
        raise AssertionError("-r 2: the MSA's rows are not the reads and the consensus")
    for i, (_, row) in enumerate(rows[:n]):
        if row.replace("-", "") != reads[i]:
            raise AssertionError(f"-r 2: MSA row {i} without gaps is not read {i}")
    if rows[n][1].replace("-", "") != cons3:
        raise AssertionError("-r 2: the MSA's consensus row is not the consensus")
    msa_len = len(rows[0][1])
    if any(len(row) != msa_len for _, row in rows):
        raise AssertionError("-r 2: MSA rows of different lengths")
    loop3 = s3["wall_s"] - s3["download_s"] - s3["replay_s"]
    known = loop3 + s3["download_s"] + s3["replay_s"] + sum(split.values())
    log(f"[C3] {n} reads x {args.ref_len} bp, -r 2 (MSA and consensus), fused "
        f"route: wall {wall3:.2f} s ({n / wall3:.3f} reads/s); MSA {msa_len} "
        f"columns; each row without gaps == its read, the consensus row == the "
        f"consensus == phase C's; launches == phase C's {launches3}; host syncs "
        f"{s3['syncs']} in {s3['reads']} attempts == phase C's")
    log(f"[C3] wall split (s): loop {loop3:.2f}, graph download "
        f"{s3['download_s']:.2f}, paths download + read-id replay "
        f"{s3['replay_s']:.2f}, set_msa_rank + collect_msa "
        f"{split.get('rank', 0.0):.2f}, consensus "
        f"{split.get('consensus', 0.0):.2f}, writing the MSA "
        f"{split.get('write', 0.0):.2f}, the rest (reading, encoding) "
        f"{wall3 - known:.2f}")

    lap("C3")
    # ---- C4: clustering at a diploid user's scale: two haplotypes, -d 2 -r 4
    m4 = args.c4_reads
    h1, h2 = haplotypes(args.ref_len, 0.01, args.seed + 2)
    rng = np.random.default_rng(args.seed + 3)
    r1, r2 = sim_reads(h1, m4 // 2, 0.10, rng), sim_reads(h2, m4 // 2, 0.10, rng)
    reads4 = [acgt(x) for pair in zip(r1, r2) for x in pair]
    names4 = [f"read_{i}_h{i % 2 + 1}" for i in range(len(reads4))]
    fa_c4 = os.path.join(OUT, "diploid.fa")
    with open(fa_c4, "w") as fp:
        fp.write("".join(f">{nm}\n{r}\n" for nm, r in zip(names4, reads4)))
    out_c4 = os.path.join(OUT, "diploid.gfa")
    from abpoa_tpu_torch.cons import cluster as cluster_mod
    from abpoa_tpu_torch.cons import consensus as cons_mod
    split4 = {}
    undo = [timed(cluster_mod, "multip_read_clu_kmedoids", split4, "cluster"),
            timed(cons_mod, "heaviest_bundling", split4, "bundling"),
            timed(pl, "generate_gfa", split4, "gfa")]
    fl.reset_stats()
    fused_dp.launches = backtrack.launches = edge_sort.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ab4 = run_pipeline([fa_c4, "-d", "2", "-r", "4"], out_c4)
    wall4 = time.perf_counter() - t0
    for u in undo:
        u()
    s4 = dict(fl.stats)
    m4 = len(reads4)
    if min(fused_dp.launches, backtrack.launches, edge_sort.launches) < m4 - 1:
        raise AssertionError("-d 2 -r 4: the fused route did not run every read")
    abc4 = ab4.cons
    if abc4.n_cons not in (1, 2):
        raise AssertionError(f"-d 2 gave {abc4.n_cons} consensus sequences")
    if sorted(r for ids in abc4.clu_read_ids for r in ids) != list(range(m4)):
        raise AssertionError("-d 2: the clusters' read lists do not partition the reads")
    spells = gfa_spells(out_c4)
    for nm, r in zip(names4, reads4):
        if spells.get(nm) != r:
            raise AssertionError(f"-d 2 -r 4: the GFA path of {nm} does not spell it")
    hs = (acgt(h1), acgt(h2))
    log(f"[C4] {m4} reads ({m4 // 2} a haplotype, interleaved) x {args.ref_len} bp "
        f"at 10% error, haplotypes {len(hs[0])} and {len(hs[1])} bp "
        f"({edit_distance(hs[0], hs[1])} edits apart), -d 2 -r 4, fused route: "
        f"wall {wall4:.2f} s; {abc4.n_cons} consensus sequences; the read "
        f"lists partition the reads; every P line spells its read")
    loop4 = s4["wall_s"] - s4["download_s"] - s4["replay_s"]
    gfa_only = split4["gfa"] - split4.get("cluster", 0.0) - split4.get("bundling", 0.0)
    rest4 = wall4 - s4["wall_s"] - split4["gfa"]
    log(f"[C4] wall split (s): loop {loop4:.2f}, graph download "
        f"{s4['download_s']:.2f}, paths download + read-id replay "
        f"{s4['replay_s']:.2f}, clustering (MSA, het columns, k-medoids) "
        f"{split4.get('cluster', 0.0):.2f}, heaviest bundling of the clusters "
        f"{split4.get('bundling', 0.0):.2f}, the GFA's walk and writing "
        f"{gfa_only:.2f}, the rest {rest4:.2f}")
    for k in range(abc4.n_cons):
        seq4 = "".join(chr(c) for c in abpt.code_to_char[abc4.cons_base[k]])
        idents = [1 - edit_distance(seq4, h) / len(h) for h in hs]
        hap_n = [sum(1 for r in abc4.clu_read_ids[k] if r % 2 == j) for j in (0, 1)]
        log(f"[C4] consensus {k + 1}: {len(seq4)} bp, identity {idents[0]:.5f} "
            f"to haplotype 1, {idents[1]:.5f} to haplotype 2; its "
            f"{len(abc4.clu_read_ids[k])} reads: {hap_n[0]} of haplotype 1, "
            f"{hap_n[1]} of haplotype 2")

    lap("C4")
    b2_c5, x1w_c5, graph5 = phase_c5(args, ref, rows[:n], msa_len)
    lap("C5")
    b2_c6, x1w_c6 = phase_c6(args, h1, h2)
    lap("C6")
    b2_c7, x1w_c7, c7_last, p7 = phase_c7(args, ref, reads, cons[0].seq)
    lap("C7")
    c8 = phase_c8(ref, reads)

    lap("C8")
    # phase D's inputs of B1 (the headline's final graph and a held-out
    # read), B2 (C5's per-read graph) and batched B2 (C7 (a)'s last
    # launch): their plain versions and C9's run side by side in worker
    # processes at the start of D
    qd = encode(cpu, held_out)
    W, plane16 = caps_c["W"], caps_c["plane16"]
    ad, inf = fused_case(abpt, st_c, qd, W, plane16, False)
    kw = dict(gap_mode=abpt.gap_mode, plane16=plane16, extend=False,
              zdrop_on=False, local=False)
    W2 = initial_band_width(abpt, len(qd))

    def b2_tables(gp):
        """B2's inputs (numpy) for the held-out read at graph gp, and its
        row tables."""
        gp.topological_sort(abpt)
        t = build_row_tables(gp, 0, 1)
        qt = query_tables(abpt, t, qd, W2)
        return [qt["scalars"], t.base, t.pre_idx, t.pre_cnt, t.out_idx,
                t.out_cnt, t.remain, t.mpl0, t.mpr0, qt["qp_pad"],
                qt["row0"]], t

    a5 = b2_tables(graph5)
    tabs7, q7, W7 = c7_last
    a7 = banded.pack_windows(p7, tabs7, q7, W7)
    b1_plain = plain.add(fused_dp_torch, ad, **kw)
    b2_plain = plain.add(banded_dp_torch, a5[0])
    b2w_plain = plain.add(banded_dp_torch, a7, gap_mode=p7.gap_mode)
    # B2's modes at C8's launch shape, the held-out read on a graph of phase
    # C's first 3 reads ("10 kb", which keeps the plain version's row loop
    # short) and on C8's final graph (the -G run's, the largest C8's
    # whole-row runs align to): unbanded, local and -G unbanded on B2u,
    # -G banded on B2. Their plain versions run in the pool too, each
    # handing back digests of its planes
    g10 = POAGraph()
    for r in reads[:3]:
        q = encode(cpu, r)
        cigar = (banded.align_sequence_to_subgraph(g10, abpt, 0, 1, q).cigar
                 if g10.node_n > 2 else [])
        g10.add_alignment(abpt, q, None, cigar, True)
    graphs_d = {"10 kb": (g10, qd), "C8": (c8["graphs"]["-G"], qd)}
    cases_d = [("10 kb", "convex", "global-u", False),
               ("10 kb", "convex", "local", False),
               ("10 kb", "convex", "global", True),
               ("10 kb", "convex", "global-u", True),
               ("C8", "convex", "global-u", False), ("C8", "convex", "local", False),
               ("C8", "convex", "global", True)]
    inputs_d = [mode_inputs(dev, graphs_d, case) for case in cases_d]
    plain_d = [plain.add_digest(m[5], gap_mode=m[0].gap_mode) for m in inputs_d]
    c9 = phase_c9(args, rates, plain)
    max_err["backtrack[windows]"] = max(max_err["backtrack[windows]"], c9["err_w"])
    max_err["backtrack[lanes]"] = c9["x1_lanes"][0]
    max_err["edge_sort[lanes]"] = c9["s1_lanes"][0]
    lap("C9")
    c10 = phase_c10(args)
    torch.cuda.empty_cache()
    lap("C10")
    phase_c11(args, c9, c10)
    torch.cuda.empty_cache()
    lap("C11")
    # ---- D: kernels vs plain at the main path's shape. The pool's plain
    # versions start first; the main process checks B2's modes against
    # theirs as each ends (with B2u at 4, 8 and 16 blocks a cluster in the
    # whole-row cases, and X1w's walk from each)
    plain.start()
    b2u_row = None
    for case, pooled, inputs in zip(cases_d, plain_d, inputs_d):
        whole = whole_row(case)
        r = mode_case(dev, graphs_d, case, rates, pooled=pooled, inputs=inputs,
                      sweep=(4, 8, 16) if whole else (),
                      x1w_tag="C8's whole-row planes (B2u, -b -1)"
                      if case == ("C8", "convex", "global-u", False) else None)
        max_err[r["name"]] = max(max_err[r["name"]], r["err"])
        max_err["backtrack[windows]"] = max(max_err["backtrack[windows]"], r["err_w"])
        log(f"[D] {r['line']}")
        if case[0] == "C8" and case[2] == "global-u":
            b2u_row = r  # the kernel line's B2u numbers: -b -1 at C8's graph
        torch.cuda.empty_cache()
    del g10, graphs_d, inputs_d
    t_wait = time.perf_counter()
    got = fused_dp(*ad, **kw)
    torch.cuda.synchronize()
    b1_plain_ms, want = b1_plain()
    log(f"[D] the pool's plain versions ({plain.jobs} in {plain.workers} "
        f"worker processes; the host has {os.cpu_count()} CPUs) ended "
        f"{time.perf_counter() - t_wait:.1f} s after the mode checks")
    err, rows_d = compare_dp("fused_dp D", got, want, ad)
    max_err["fused_dp"] = max(max_err["fused_dp"], err)
    b1_ms = time_cuda(lambda: fused_dp(*ad, **kw), 3)
    b1_bound = dp_bound(rates, ad, got)
    gn = int(ad[0][8])
    P_d = ad[2].shape[1]
    shape_d = launch_shape(W, P_d, abpt.gap_mode)
    log(f"[D] B1 at the final graph (gn={gn}, R={ad[1].shape[0]}, W={W}, P={P_d}, "
        f"{'int16' if plane16 else 'int32'}; {shape_d['warps']} column warps + "
        f"the control warp, {shape_d['cpt']} columns a thread, ring D={shape_d['depth']}, "
        f"{shape_d['smem']} B shared): kernel == plain on rows 0..{rows_d - 1}; "
        f"kernel {b1_ms:.3f} ms ({b1_ms * 1e3 / max(1, rows_d - 1):.3f} us a "
        f"computed row), plain {b1_plain_ms:.1f} ms, bound {b1_bound[0]:.4f} ms "
        f"({b1_bound[1]})")
    # the share of predecessor reads each ring serves, from the tables
    pre_np = ad[2][:gn - 1].cpu().numpy().astype(np.int64)
    cnt_np = ad[3][:gn - 1].cpu().numpy()
    rr = np.arange(gn - 1)[:, None]
    live = (np.arange(P_d)[None, :] < cnt_np[:, None]) & (rr >= 1)
    dist = (rr - pre_np)[live]
    log(f"[D] predecessor reads at the final graph: {dist.size}; rows back "
        f"p50 {np.percentile(dist, 50):.0f}, p99 {np.percentile(dist, 99):.0f}, "
        f"max {dist.max()}; served by the plane ring (D={shape_d['depth']}) "
        f"{(dist < shape_d['depth']).mean() * 100:.3f} %, by the band ring "
        f"(256 rows) {(dist < 256).mean() * 100:.3f} %")
    sweep_warps("D B1", ad, kw, [t.to(dev) for t in want])
    bta, max_ops = bt_inputs(abpt, ad, got, qd, inf, False)
    bkw = dict(max_ops=max_ops, gap_mode=abpt.gap_mode, gap_on_right=False,
               put_gap_at_end=False, local=False)
    bt = backtrack(*bta, **bkw)
    torch.cuda.synchronize()
    x1_plain_ms, want = time_host(lambda: backtrack_torch(*bta, **bkw))
    max_err["backtrack"] = max(max_err["backtrack"], compare("backtrack D", bt, want))
    x1_ms = time_cuda(lambda: backtrack(*bta, **bkw), 5)
    x1_bound = bt_bound(rates, bta[:5], bta[8], bt[0], bt[1].tolist())
    log(f"[D] X1 on those planes (n_ops={int(bt[1][0])}): kernel == plain; "
        f"kernel {x1_ms:.3f} ms ({x1_ms * 1e3 / max(1, int(bt[1][0])):.3f} us a "
        f"step), plain {x1_plain_ms:.1f} ms, bound "
        f"{x1_bound[0]:.5f} ms ({x1_bound[1]})")
    # what a collision read adds: the sequential fusion of that read's ops
    # (the graph's node_n rows down, fused in Python, back up) and the edge
    # sort after it; it must give the vectorised fusion's graph here
    qlen_d = len(qd)
    fwd_op, fwd_arg, n_fwd = fl.forward_ops(bt[0], bt[1], st_c.order, bta[12][1],
                                            qlen_d, max_ops)
    q_d, w_d = bta[10], torch.ones_like(bta[10])
    coll_ms, g_seq = time_host(lambda: fl._finish_fusion(fuse_alignment(
        st_c.g, fwd_op, fwd_arg, min(int(n_fwd), max_ops), q_d, qlen_d,
        w_d)[0], st_c.g))
    vec = fl._fuse_vectorized(st_c.g, fwd_op, fwd_arg, n_fwd, q_d, qlen_d, w_d)
    # S1's input on the main path: the held-out read fused, before its sort
    g_un = vec[0]
    s1_slots = [t.clone() for t in (g_un.in_ids, g_un.in_w, g_un.out_ids,
                                    g_un.out_w)]
    s1_cnts, s1_nn = (g_un.in_cnt, g_un.out_cnt), g_un.node_n.reshape(1)
    s1_span = g_un.n_span.clone()
    same = "the read collides, so no comparison"
    if not bool(vec[4]):
        g_vec = fl._finish_fusion(vec[0], st_c.g)
        for k, t in g_vec.tensors().items():
            if not torch.equal(t, g_seq.tensors()[k]):
                raise AssertionError(f"sequential and vectorised fusion differ on {k}")
        same = "== the vectorised fusion"
    log(f"[D] sequential (collision) fusion of that read at the final graph "
        f"by F1's plain version, the host walk ({int(st_c.g.node_n)} rows down "
        f"and up, {int(n_fwd)} ops): {coll_ms:.1f} ms on the host clock, {same}")
    # kernel F1 on the same graph and op stream (the collision path's
    # sequential fusion; it runs whatever the collision flag says), against
    # its plain version on CPU copies
    Pcap_d = q_d.shape[0] + 2
    f1_in = (fl._stacked(st_c.g), fwd_op[None], fwd_arg[None],
             n_fwd.reshape(1), q_d[None], w_d[None],
             torch.tensor([qlen_d], dtype=torch.int32, device=dev))
    got_f = fuse_alignment_lanes(*f1_in, Pcap_d)
    torch.cuda.synchronize()
    f1_cpu = (DeviceGraph(**{k: v.cpu() for k, v in f1_in[0].tensors().items()}),
              *(t.cpu() for t in f1_in[1:]))
    f1_plain_ms, want_f = time_host(lambda: fuse_alignment_lanes(*f1_cpu, Pcap_d))
    flat = lambda o: [*o[0].tensors().values(), o[1], o[2]]  # noqa: E731
    max_err["fuse_alignment"] = compare("fuse_alignment D", flat(got_f),
                                        flat(want_f))
    f1_ms = time_cuda(lambda: fuse_alignment_lanes(*f1_in, Pcap_d), 5)
    f1_bnd = f1_bound(rates, st_c.g, lane_graph(got_f[0], 0), int(n_fwd),
                      qlen_d)
    log(f"[D] F1 on that graph and op stream ({int(n_fwd)} ops, one thread "
        f"a lane): kernel == plain (every graph array, ok, node_n, the path); "
        f"{f1_ms:.3f} ms with the wrapper's copy of the graph "
        f"({f1_ms * 1e3 / max(1, int(n_fwd)):.3f} us an op), plain "
        f"{f1_plain_ms:.1f} ms, bound {f1_bnd[0]:.5f} ms ({f1_bnd[1]}); the "
        f"host walk it replaces {coll_ms:.1f} ms")
    g = st_c.g
    ka = (g.in_ids, g.in_w, g.out_ids, g.out_w, g.in_cnt, g.out_cnt,
          g.aligned, g.aligned_cnt, g.node_n.reshape(1))
    # S1 as the main path runs it: in place on the held-out read's fused
    # graph, span update on; each timed launch on a fresh copy
    sa = (*s1_slots, *s1_cnts)
    n_d = int(s1_nn[0])
    err, s1_plain_ms = check_s1("finish_fusion_ D", s1_slots, s1_cnts, s1_nn,
                                s1_span)
    max_err["edge_sort"] = max(max_err["edge_sort"], err)
    s1_ms = time_s1(s1_slots, s1_cnts, s1_nn, s1_span, 50)
    # as the out-of-place kernel's figure was taken: launches as fast as the
    # host queues them, on one copy (its first launch sorts it; the later
    # ones find nothing to move)
    paced = [t.clone() for t in (*s1_slots, s1_span)]
    s1_paced = time_cuda(lambda: finish_fusion_(*paced[:4], *s1_cnts, s1_nn,
                                                paced[4]), 50)
    s1_bound_d = s1_bound(rates, sa, n_d)
    s1_need_d, s1_multi, s1_moved = s1_need_bound(rates, sa, n_d)
    # a yardstick only, a different function: a stable descending torch.sort
    # of each side's weights and the gather of its ids (abPOA's exchange sort
    # is unstable: no single torch call gives its tie order)
    def torch_sort():
        for ids, w in ((sa[0], sa[1]), (sa[2], sa[3])):
            _, idx = torch.sort(w, dim=1, descending=True, stable=True)
            torch.gather(ids, 1, idx)
    ts_ms = time_cuda(torch_sort, 20)
    log(f"[D] S1 on the held-out read's fused graph before its sort (N="
        f"{sa[0].shape[0]}, E={sa[0].shape[1]}): {n_d} rows below node_n, "
        f"{s1_multi} with 2+ slots (both sides), {s1_moved} that the sort "
        f"moves (plain version); kernel == plain (span on); in place on "
        f"fresh copies, queued: {s1_ms:.4f} ms (on one copy as fast as the "
        f"host queues it {s1_paced:.4f} ms); plain {s1_plain_ms:.1f} ms; bound of "
        f"what these inputs need {s1_need_d[0]:.5f} ms ({s1_need_d[1]}), of "
        f"a copy of every row below node_n {s1_bound_d[0]:.4f} ms "
        f"({s1_bound_d[1]}); torch.sort + gather of both sides (a different "
        f"function) {ts_ms:.4f} ms")
    got = topo_sort(*ka)
    torch.cuda.synchronize()
    k1_plain_ms, want = time_host(lambda: topo_sort_torch(*ka))
    max_err["topo_sort"] = max(max_err["topo_sort"], compare("topo_sort D", got, want))
    k1_ms = time_cuda(lambda: topo_sort(*ka), 3)
    k1_bound = topo_bound(rates, g)
    k1_shape = launch_shape_k1(*g.caps)
    (v1, a1, m1), (v3, a3, m3) = k1_chains(ka)
    log(f"[D] K1 on the final graph ({int(g.node_n)} nodes, N={g.caps[0]}; "
        f"{k1_shape['variant']} degrees, cache of {k1_shape['cache']} records, "
        f"{k1_shape['smem']} B shared): kernel == plain; kernel {k1_ms:.3f} ms, "
        f"plain {k1_plain_ms:.1f} ms, bound {k1_bound[0]:.5f} ms ({k1_bound[1]}); "
        f"pass 1 visits {v1} nodes in order (look-ahead mean {a1:.2f}, max {m1}), "
        f"pass 3 {v3} (mean {a3:.2f}, max {m3}); "
        f"{k1_ms * 1e3 / max(1, v1 + v3):.3f} us a visit")
    k1_walks = {name: time_cuda(lambda: topo_sort(*ka, walks=mask), 3)
                for name, mask in (("neither", 0), ("pass 1", 1),
                                   ("pass 3", 2))}
    k1_pass2 = time_queued(lambda i: topo_sort(*ka, walks=0), 20,
                           lambda: topo_sort(*ka, walks=0))
    log("[D] K1 by pass (ms): the launch with no walk (pass 2: the slots "
        "copied and S1 in place on the copies, which are sorted already; the "
        "BFS block's set-up) {:.4f} as fast as the host queues it, {:.4f} "
        "queued; pass 1 {:.3f}, pass 3 {:.3f} (each the launch with that "
        "walk alone, less the launch with neither)".format(
            k1_walks["neither"], k1_pass2,
            k1_walks["pass 1"] - k1_walks["neither"],
            k1_walks["pass 3"] - k1_walks["neither"]))
    # K1 over two lanes in one launch: the final graph, and the held-out
    # read's sequentially fused graph after its S1 (what K1 gets on a
    # collision read), one BFS block a lane
    k1g = stack_graphs([g, g_seq])
    ka_l = (k1g.in_ids, k1g.in_w, k1g.out_ids, k1g.out_w, k1g.in_cnt,
            k1g.out_cnt, k1g.aligned, k1g.aligned_cnt, k1g.node_n)
    got_k = topo_sort_lanes(*ka_l)
    torch.cuda.synchronize()
    k1l_plain_ms, want_k = time_host(
        lambda: topo_sort_lanes(*[t.cpu() for t in ka_l]))
    max_err["topo_sort[lanes]"] = compare("topo_sort[lanes] D", got_k, want_k)
    k1l_ms = time_cuda(lambda: topo_sort_lanes(*ka_l), 3)
    k1l_bnd = lanes_bound(rates, lambda r, l: topo_bound(r, lane_graph(k1g, l)),
                          range(2))
    log(f"[D] K1 over two lanes (node_n {[int(x) for x in k1g.node_n.tolist()]}"
        f"): kernel == plain on both; {k1l_ms:.3f} ms (one lane alone: "
        f"{k1_ms:.3f}), plain {k1l_plain_ms:.1f} ms, bound {k1l_bnd[0]:.5f} ms "
        f"({k1l_bnd[1]})")
    got = topo_sort(*ka, variant="g32")
    torch.cuda.synchronize()
    max_err["topo_sort"] = max(max_err["topo_sort"], compare(
        "topo_sort D g32", got, want))
    log(f"[D] K1 with int32 degrees in device memory (g32, cache of "
        f"{launch_shape_k1(*g.caps, 'g32')['cache']}): kernel == plain; "
        f"{time_cuda(lambda: topo_sort(*ka, variant='g32'), 3):.3f} ms")
    def b2_at(tag, a2, t):
        """B2 on the held-out read at a graph (b2_tables' inputs a2 and row
        tables t): its time, bound and the share of predecessor reads its
        rings serve. Returns (ms, bound, inputs, outputs)."""
        ts = to_dev(a2, dev)
        got = banded_dp(*ts)
        torch.cuda.synchronize()
        rows_b2 = dp_rows(ts, got)[0][1]
        ms = time_cuda(lambda: banded_dp(*ts), 3)
        bnd = dp_bound(rates, ts, got)
        P2 = t.pre_idx.shape[1]
        shape_b2 = launch_shape(W2, P2, abpt.gap_mode, seeded=True)
        log(f"[D] B2 at {tag} (R={t.R}, gn={t.gn}, W={W2}, P={P2}; "
            f"{shape_b2['block_warps']} warps, cpt {shape_b2['cpt']}, ring "
            f"D={shape_b2['depth']}, {shape_b2['smem']} B shared): {rows_b2} "
            f"computed rows; kernel {ms:.3f} ms ({ms * 1e3 / max(1, rows_b2 - 1):.3f} "
            f"us a computed row), bound {bnd[0]:.4f} ms ({bnd[1]}; "
            f"all R rows and every output: "
            f"{rates.bound(nbytes(ts) + nbytes(got), 0)[0]:.4f} ms)")
        rr = np.arange(t.gn - 1)[:, None]
        live = (np.arange(P2)[None, :] < t.pre_cnt[:t.gn - 1, None]) & (rr >= 1)
        dist = (rr - t.pre_idx[:t.gn - 1].astype(np.int64))[live]
        log(f"[D] B2 predecessor reads at {tag}: {dist.size}; rows back p50 "
            f"{np.percentile(dist, 50):.0f}, p99 {np.percentile(dist, 99):.0f}, "
            f"max {dist.max()}; served by the plane ring (D={shape_b2['depth']}) "
            f"{(dist < shape_b2['depth']).mean() * 100:.3f} %, by the band ring "
            f"(256 rows) {(dist < 256).mean() * 100:.3f} %")
        return ms, bnd, ts, got

    b2_at(f"the {m}-read per-read graph of C2", *b2_tables(ab_pr.graph))
    # the row's numbers: the largest graph the CLI launches B2 on (C5 (c)),
    # held against the plain version there
    tag5 = "C5's per-read graph (C3's restored MSA and the new reads)"
    b2_ms, b2_bnd, ts, got = b2_at(tag5, *a5)
    b2_plain_ms, want = b2_plain()
    err, rows_b2 = compare_dp(f"banded_dp D {tag5}", got, want, ts)
    max_err["banded_dp"] = max(max_err["banded_dp"], err)
    log(f"[D] B2 at {tag5}: kernel == plain on rows 0..{rows_b2 - 1}, begend, "
        f"mplr, ok, ext; plain {b2_plain_ms:.1f} ms")
    sweep_warps("D B2", ts, None, [t.to(dev) for t in want])
    del ts, got, want
    log(f"[D] launches in C8: B2 {c8['launched']['b2']}, B2u "
        f"{c8['launched']['b2u']}")
    # B2 batched over a read's windows: the first launch of C7 (a)'s last
    # read, at the graph the reads before it built
    ts = to_dev(a7, dev)
    got = banded_dp(*ts, gap_mode=p7.gap_mode)
    torch.cuda.synchronize()
    b2w_plain_ms, want = b2w_plain()
    err, rows_w = compare_dp("banded_dp D windows", got, want, ts)
    max_err["banded_dp[windows]"] = max(max_err["banded_dp[windows]"], err)
    b2w_ms = time_cuda(lambda: banded_dp(*ts, gap_mode=p7.gap_mode), 3)
    b2w_bnd = dp_bound(rates, ts, got)
    gns = [t.gn for t in tabs7]
    shape_w = launch_shape(W7, ts[2].shape[1], p7.gap_mode, seeded=True)
    log(f"[D] B2 batched at C7 (a)'s graph (its last read's {len(tabs7)} "
        f"windows, {len(tabs7)} blocks; gn min {min(gns)} / max {max(gns)} / "
        f"sum {sum(gns)}, W={W7}, P={ts[2].shape[1]}; {shape_w['block_warps']} "
        f"warps, cpt {shape_w['cpt']}, ring D={shape_w['depth']}): kernel == "
        f"plain on {rows_w} computed rows, begend, mplr, ok; kernel "
        f"{b2w_ms:.3f} ms ({b2w_ms * 1e3 / max(1, rows_w - len(tabs7)):.3f} us a "
        f"computed row), plain {b2w_plain_ms:.1f} ms, bound {b2w_bnd[0]:.4f} ms "
        f"({b2w_bnd[1]}); the longest window alone "
        f"{time_cuda(lambda: banded_dp(*longest_window(ts), gap_mode=p7.gap_mode), 3):.3f} ms")

    # X1w on those planes (the row's numbers), then on one window of C5's
    # per-read graph and the held-out read
    def x1w_at(tag, p, ts, got, tabs, queries):
        err, xin, xkw, xwant = x1w_check(p, ts, got, tabs, queries, f"D {tag}")
        max_err["backtrack[windows]"] = max(max_err["backtrack[windows]"], err)
        return x1w_report(rates, xin, xkw, xwant, tag)

    x1w_row = x1w_at("C7 (a)'s last read (the batched B2 above)", p7, ts, got,
                     tabs7, q7)
    del ts, want, got
    t5 = build_row_tables(graph5, 0, 1)
    ts = to_dev(banded.pack_windows(abpt, [t5], [qd], W2), dev)
    got = banded_dp(*ts, gap_mode=abpt.gap_mode)
    x1w_at("C5's per-read graph (one window, the held-out read)", abpt, ts,
           got, [t5], [qd])
    del ts, got
    x1w_at("C9's round-2 launch (8 lanes)", *c9["lanes"])
    # C9's round-2 launch against its plain version
    err, c9_plain_ms, rows9 = c9["finish"]()
    max_err["banded_dp[lanes]"] = err
    log(f"[D] C9's round-2 launch: B2 == plain on {rows9} computed rows, "
        f"begend, mplr, ok, ext; plain {c9_plain_ms:.1f} ms")
    b1l_finish, b1l_ms, b1l_bnd = c9["b1_lanes"]
    max_err["fused_dp[lanes]"], b1l_plain_ms = b1l_finish()
    log(f"[D] C9's device-lockstep B1 lane launch: kernel == plain on every "
        f"lane's computed rows (digests), beg, end, ok, ext; plain "
        f"{b1l_plain_ms:.1f} ms")
    lap("D")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    def entry(name, source, replaces, launched, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    print(json.dumps({"kernels": [
        entry("banded_dp", "abpoa_tpu_torch/csrc/fused_dp.cu",
              "abpoa_tpu/align/pallas_kernel.py:215",
              b2_launches + b2_c5 + b2_c6 + c8["launched"]["b2"], b2_ms,
              b2_plain_ms, b2_bnd),
        entry("banded_dp[unbanded]", "abpoa_tpu_torch/csrc/unbanded_dp.cu",
              "abpoa_tpu/align/jax_backend.py:54", c8["launched"]["b2u"],
              b2u_row["ms"], b2u_row["plain_ms"], b2u_row["bound"]),
        entry("banded_dp[windows]", "abpoa_tpu_torch/csrc/fused_dp.cu",
              "abpoa_tpu/align/jax_backend.py:512", b2_c7, b2w_ms,
              b2w_plain_ms, b2w_bnd),
        entry("banded_dp[lanes]", "abpoa_tpu_torch/csrc/fused_dp.cu",
              "abpoa_tpu/align/dp_chunk.py:61", c9["b2"] + c10["b2"], c9["ms"],
              c9_plain_ms, c9["bound"]),
        entry("fused_dp", "abpoa_tpu_torch/csrc/fused_dp.cu",
              "abpoa_tpu/align/pallas_fused.py:696", launches["fused_dp"],
              b1_ms, b1_plain_ms, b1_bound),
        entry("fused_dp[local]", "abpoa_tpu_torch/csrc/fused_dp.cu",
              "abpoa_tpu/align/pallas_fused.py:615", b3_launches, b3_ms,
              b3_plain_ms, b3_bound),
        entry("backtrack", "abpoa_tpu_torch/csrc/backtrack.cu",
              "abpoa_tpu/align/fused_loop.py:601", launches["backtrack"],
              x1_ms, x1_plain_ms, x1_bound),
        entry("backtrack[windows]", "abpoa_tpu_torch/csrc/backtrack_windows.cu",
              "abpoa_tpu/align/jax_backtrack.py:29",
              x1w_c2 + x1w_c5 + x1w_c6 + x1w_c7 + c8["launched"]["x1w"]
              + c9["x1w"] + c10["x1w"],
              x1w_row["ms"], x1w_row["plain_ms"], x1w_row["bound"]),
        entry("edge_sort", "abpoa_tpu_torch/csrc/topo_sort.cu",
              "abpoa_tpu/align/fused_loop.py:145", launches["edge_sort"],
              s1_ms, s1_plain_ms, s1_need_d),
        entry("topo_sort", "abpoa_tpu_torch/csrc/topo_sort.cu",
              "abpoa_tpu/align/device_graph.py:210", launches["topo_sort"],
              k1_ms, k1_plain_ms, k1_bound),
        # the device lockstep's lane launches (C9's device run) and F1 (C9's
        # run with collisions forced: the main path's reads collide at no
        # size yet)
        entry("fused_dp[lanes]", "abpoa_tpu_torch/csrc/fused_dp.cu",
              "abpoa_tpu/align/pallas_fused.py:696", c9["device"]["b1_lanes"],
              b1l_ms, b1l_plain_ms, b1l_bnd),
        entry("backtrack[lanes]", "abpoa_tpu_torch/csrc/backtrack.cu",
              "abpoa_tpu/align/fused_loop.py:601",
              c9["device"]["lanes"]["backtrack_lanes"], c9["x1_lanes"][1],
              c9["x1_lanes"][2], c9["x1_lanes"][3]),
        entry("edge_sort[lanes]", "abpoa_tpu_torch/csrc/topo_sort.cu",
              "abpoa_tpu/align/fused_loop.py:145",
              c9["device"]["lanes"]["finish_fusion_lanes_"], c9["s1_lanes"][1],
              c9["s1_lanes"][2], c9["s1_lanes"][3]),
        entry("topo_sort[lanes]", "abpoa_tpu_torch/csrc/topo_sort.cu",
              "abpoa_tpu/align/device_graph.py:210",
              c9["device"]["lanes"]["topo_sort_lanes"], k1l_ms, k1l_plain_ms,
              k1l_bnd),
        entry("fuse_alignment", "abpoa_tpu_torch/csrc/fuse_alignment.cu",
              "abpoa_tpu/align/device_graph.py:120",
              c9["forced"]["lanes"]["fuse_alignment_lanes"], f1_ms,
              f1_plain_ms, f1_bnd)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
