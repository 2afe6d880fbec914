#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unicycler_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--reads 200]

Phases (every failed check raises, so the exit code is nonzero):
  1. device: the card's name and power limit;
  2. build: nvcc builds the kernels of csrc/ (build seconds, the -Xptxas
     -v register / shared-memory / spill lines, the wave kernels'
     resident blocks per SM and the row forward's resident clusters of 1,
     2, 4 and 8 blocks at W = 4096 and 8192);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, with shortened tasks; outputs must be bit-equal (the wave
     forward's over each track's real groups); CUDA-event times. The wave
     kernels run in the JAX package's layout (W = 512 and 1024, 8 and 32
     tracks) and in the card's (one task a track, 264 tracks of mixed
     lengths at W = 128, 512, 1024 and 2048); then an A/B of the two
     layouts on 300 polish-shaped tasks (N50 ~16 kbp, W = 512): each
     kernel's device time in each (JAX, card, card, JAX), and equal
     per-task scores, ends and CIGARs; then the retry pair (kernels 3 and
     6) at W = 128, 512, 1024, 2048, 4096 and 16384 on 32 drifting tasks:
     kernel 3's score, ends and moves rows [0, n_act) and kernel 6's
     records and finals bit-equal to their plain versions, each launch
     timed alone (kernel 3 at each lanes-a-thread template that fits), us
     per real row (rows up to the launch's longest n_act) and per step;
  4. the slice: align_jobs on a synthetic 5 Mbp chromosome + 100 kbp
     plasmid with 200 long reads (N50 ~15 kb, ~8% errors) at sensitivity 0
     plus 20 reads at sensitivity 2; checks true placement and that every
     CIGAR re-tallies to its raw score; counts kernel launches and the
     tracks of each wave launch (at least min(tasks, 132) unless the moves
     budget cannot hold that many);
  5. the retry path: _align_banded_moves_path on the card (the banded
     kernel, its moves walked on the card) against the host-decode route
     and the CPU route; the walker against its plain version at W = 512,
     1024 and 2048; align_banded on FULLY_GLOBAL tasks with zigzag
     corridors, some of which the wave route finds no path for and
     retries inside the call (all four kernels of the route), in the
     card's layout and in the JAX package's (where a NEG task's walk
     overwrites a neighbour's records, and the neighbour's retry is
     walked on the card into a CIGAR), both equal to the host-decode
     retry path, with the CIGARs re-tallied and the walker held to its
     plain version at the call's width; bytes copied back by both retry
     routes; the retry path at the row route's W = 4096 on bridging-
     shaped tasks (1,300-5,200 bp) equal to the CPU route, and
     align_banded at W = 4096 with every other row walk forced to end in
     a band escape, so those tasks retry on kernels 3 and 6 inside the
     call, equal to the CPU route;
  6. row-tape kernels: the forward kernel (at each cluster size 1, 2, 4
     and 8 that fits the band, each launch timed alone) and walker of
     bands W > 2048 against their plain versions at W = 4096 and 8192 in
     the JAX package's layout (8 and 32 tracks), and in the card's (12
     one-task tracks) at W = 4096, 8192, 16384 (C >= 2) and 32768
     (C >= 4), and one short task at W = 131072 (the tiled kernel, one
     block a track), bit-equal over each track's real groups; an A/B of
     the two layouts on 84
     bridging-shaped tasks at W = 4096 (JAX, card, card, JAX) with equal
     per-task results; then the full-matrix DP kernel (csrc/pairwise.cu)
     against its plain version (align_batch_plain): a 1,300 bp repeat's
     consensus (12 pairs) under every AlignConfig with band None, 20 and
     1000 and without moves, 12 pairs of 100-2,000 bp in one call, pairs
     with n_act 0 and m_act 0, and the two widest pairs the full DP takes
     (n_pad 131,072 x m_pad 128 and 128 x 131,072, two pairs each):
     score and ends bit-equal, moves on each pair's real region; the
     launch's CUDA-event time beside the plain version's and the bound;
     on every call with moves the walker (csrc/pairwise_walk.cu) over the
     kernel's outputs against its plain version (walk_full_plain, the
     host decode): headers and runs equal, its CUDA-event time beside the
     plain version's and its bound;
  7. bridging: the 5 Mbp + 100 kbp genome with 7 copies of a 5,000 bp and
     12 of a 1,300 bp repeat planted in the chromosome (each with a 250 bp
     indel allele in about half of its copies), its collapsed overlap-0
     GFA, 12 long reads around each copy, aligned by
     semi_global_align_long_reads and bridged by create_long_read_bridges;
     checks that every planted adjacency is bridged, that >= 95% of the
     bridges take the true allele's path, that every CIGAR of consensus and
     path scoring re-tallies to its score, and that the row-tape kernels
     and the full-matrix DP kernel and its walker ran; lists every row
     forward launch
     (tracks, blocks a track, SMs busy, time, bound), fails on a row
     launch under min(tasks, 132) tracks that the budget could hold,
     replays every banded call of W > 2048 in the JAX package's row
     layout (the parent commit's) with equal results, replays every
     full-matrix DP call
     (pairwise.align_pairs) through align_batch_plain and
     walk_full_plain (the host decode) with equal PairAlignments, prints
     the bytes the full DP fetched beside the moves bytes of its calls
     (what a host decode copies), and prints a digest of the bridges;
  9. the per-task wavefront forward (wavefront_batch_corridor) at the
     shapes of scripts/wavefront_microbench.py (8 tasks of 2,048 rows, W =
     512 and 1024, drift 0 and 4 per 16 rows), at W = 4096 and 16384 (8
     tasks of 256 rows) and on 160 tasks of 1,024 rows at W = 1024:
     bit-equal to its plain version, up to W 2048 (score, end_i, end_j)
     equal to the wave route's; us per DP row beside the wave forward's,
     us per group of 32 wavefronts;
 10. long-read-only assembly through the command line (pipeline.main.main,
     as `python -m unicycler_tpu_torch -l reads.fastq -o out` runs it) on
     a 1 Mbp + 100 kbp genome (both circular) with reads at 15x written
     to a FASTQ (ASSEMBLY_CHROMOSOME, ASSEMBLY_DEPTH: the slice's 5 Mbp
     at 20x cut to the time limit): all-vs-all overlaps, OLC string
     graph, unitigs, up to 5 polish rounds on the card, rotation of the
     circular replicons (the host start-gene search), assembly.gfa and
     assembly.fasta; checks that every polish CIGAR re-tallies, that
     assembly.fasta (cut into 10 kb pieces and aligned by
     align_reads_to_refs) aligns to the truth at >= 99% identity over
     >= 90% of the genome, every piece aligned and at most 10% of them
     under 99%, that the best polish round's mapping quality is above
     round 0's (polish_unitigs keeps the best round), and that each
     circular replicon was rotated as rotation.find_start_gene /
     canonical_rotation say; lists the pieces under 99%, the rotation
     span, the wave launches with their tracks and each kernel's device
     time beside its bound; the outputs stay in chiprun_out/cli/;
 11. hybrid assembly through the command line (`python -m
     unicycler_tpu_torch --short_read_graph G.gfa -l reads.fastq -o out`)
     on phase 7's repeat genome cut to a 1 Mbp chromosome
     (HYBRID_CHROMOSOME) + 100 kbp plasmid: its collapsed overlap-0 GFA
     (copy counts as depths) is the short-read graph, and reads of the
     slice's model at 8x (HYBRID_DEPTH) over both replicons are the long
     reads; the JAX
     defaults (--mode normal, 3 bridging rounds) with --keep 0: copy
     depth, cleaning, anchors, the four bridge kinds (miniasm with the
     contigs placed in the polished unitigs), long-read alignment to the
     graph, bridge application, merging, final clean, rotation; checks
     that every CIGAR of the phase re-tallies, that assembly.fasta (10 kb
     pieces) aligns to the truth at >= 99% identity over >= 99% of the
     genome with no misjoin (consecutive pieces one piece apart on one
     replicon and strand), that at least 18 of the 19 planted copies are
     resolved (their flanks in one sequence, on the true allele's
     distance), that the plasmid is one circular contig rotated as
     rotation.py says and that kernels 1, 2, 4 and 5 and the full-matrix
     DP kernel and its walker ran; prints the
     spans, each bridge kind's count and seconds, each kernel's device
     time beside the wall and the peak device memory; the outputs stay in
     chiprun_out/hybrid/;
 12. Unicycler's default command line (`python -m unicycler_tpu_torch -1
     r1.fastq -2 r2.fastq -l long.fastq`) on a 200 kbp chromosome (two
     copies of a 5,000 bp and four of a 1,300 bp repeat planted, each with
     a 250 bp indel allele in about half of its copies) and a 30 kbp
     plasmid, both circular (SHORTREAD_CHROMOSOME, SHORTREAD_PLASMID):
     2 x 150 bp pairs at 40x (SHORTREAD_DEPTH; 400 +- 40 bp inserts, 0.5%
     errors) and long reads at HYBRID_DEPTH, written to
     chiprun_out/reads12/ (deleted after the run); the JAX defaults
     (--mode normal, 8 k values, read correction, 3 bridging rounds) with
     --keep 0: the de Bruijn build (correction, the k ladder, pair
     resolution) on the host, then phase 11's pipeline and the final
     short-read polish where the last bridging round made bridges; checks
     phase 11's gates (every CIGAR re-tallied, >= 99% identity over >= 99%
     of the genome with no misjoin, all copies but one resolved, the
     plasmid one rotated circle), the de Bruijn spans (correction, each
     k's k-mer count, pair resolution), that kernels 1 and 2 and the
     full-matrix DP kernel and its walker ran, and that
     kmer_count.count_spectrum on the card over the corrected reads at
     k = 21 and 31 equals np.unique; prints the wall, the spans, the k
     ladder's scores and the best k, each kernel's device time beside its
     bound, the peak device memory and the peak host memory (the process's
     resident set, sampled through the run); the outputs stay in
     chiprun_out/shortread/;
 13. parallel: align_banded_multi over [cuda:0, cuda:0] (and over every
     card when there are several) on 300 polish-shaped tasks at W 512, 84
     bridging-shaped tasks at W 4096 and phase 5's zigzag tasks (retries
     on kernels 3 and 6), each task equal to one device's
     align_banded_tape, with each partition's tasks, rows and launches and
     both walls; sharded_banded_align on a planted and a random batch,
     bit-equal to one unsharded launch of kernel 3 and to its plain
     version, and sharded_align_stats equal to numpy; every align/compat
     function on seeded pairs on the card equal to its CPU route (two 5
     kbp global pairs through the wave kernels); two spawned ranks on the
     one card meeting over gloo on localhost, each running
     distributed_align_long_reads on phase 4's genome with 400 reads (its
     full map equal to a single-process align_reads_to_refs on the card)
     and then the command line (`-1 -2 -l`) on the 9.8 kbp genome of
     tests/test_distributed_pipeline.py (both assembly.fasta files
     byte-equal to a single-process run on the card); per-rank walls,
     local reads, allgather bytes and seconds;
  8. summary (printed last): one {"kernels": [...]} line with the seven
     twins of the Pallas kernels, the full-matrix DP kernel (the twin of
     the JAX package's lax.scan in ops/pairwise.py) and its walker (the
     twin of the host function decode_traceback; both with phase 7's
     launches), each also with its launches on phase 11's, phase 12's and
     phase 13's paths, then the card's line.

Prints nothing of the result and exits nonzero without a CUDA device or
without the package beside this script. Details go to
chiprun_out/chip_smoke.json.
"""

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 67 TFLOP/s
# fp32 CUDA-core rate as the ceiling for the kernels' scalar int32 work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# int32 operations per DP cell / walker step, counted from the kernels'
# inner loops (loads and stores excluded)
OPS_PER_CELL_WAVE = 45
OPS_PER_STEP_WALK = 30   # the full DP's walker too (csrc/pairwise_walk.cu)
OPS_PER_CELL_BANDED = 45
OPS_PER_CELL_ROW = 45
# the full-matrix DP's inner loop (csrc/pairwise.cu): F, the substitution,
# the diagonal, G, E's recurrence, H, the band mask, the two extension
# bits, the H source, the moves byte, its share of the 16-byte stores and
# of the strip's hand-off and captures
OPS_PER_CELL_FULL = 45
# the per-task wavefront forward's inner loop: F, E (with its clamp), the
# substitution, the row / column masks, diagonal, boundary cells, H and
# the row-n / column-m captures
OPS_PER_CELL_WAVEFRONT = 40
# bytes a row-tape walker step reads: the row's band offset, region base
# and moves word
BYTES_PER_STEP_ROW_WALK = 12
# bytes a banded walker step reads: the moves word and the band offset
BYTES_PER_STEP_BANDED_WALK = 8
# the assembly phase's scale: 20x over a 5 Mbp chromosome, cut in depth
# and then in length to keep the run inside its time limit (PERF.md
# section 4)
ASSEMBLY_DEPTH = 15.0
ASSEMBLY_CHROMOSOME = 1_000_000
# the hybrid phase's long-read depth (users run 20-100x) and chromosome
# (phase 7's 5 Mbp), both cut to the time limit (PERF.md section 4)
HYBRID_DEPTH = 8.0
HYBRID_CHROMOSOME = 1_000_000
# the default command line's genome (a chromosome and a plasmid with six
# planted repeat copies, cut from 300 kbp to the time limit) and its
# pairs' depth; its long reads are at HYBRID_DEPTH (PERF.md section 4)
SHORTREAD_CHROMOSOME = 200_000
SHORTREAD_PLASMID = 30_000
SHORTREAD_DEPTH = 40.0


def log(msg=''):
    print(msg, flush=True)


def bound_ms(n_bytes, n_ops):
    return 1e3 * max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S)


def cuda_time(fn, reps=1):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = None
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def kernel_time(fn, reps=1):
    """Mean device time of the kernel launches fn makes, from the CUDA
    events cuda_lib.timed records around each launch alone (so the
    wrapper's host work between launches is not counted), and fn's last
    output."""
    import torch
    from unicycler_tpu_torch.ops import cuda_lib
    cuda_lib.TIMINGS = []
    try:
        out = None
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        ms = [e0.elapsed_time(e1) for _, e0, e1, _ in cuda_lib.TIMINGS]
    finally:
        cuda_lib.TIMINGS = None
    return sum(ms) / len(ms), out


def exact(name, a, b):
    """Max |a - b| over int arrays; raises unless shapes match and a == b."""
    import torch
    if a.shape != b.shape:
        raise AssertionError('%s: shape %s vs %s' % (name, tuple(a.shape),
                                                     tuple(b.shape)))
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0
    if err != 0:
        raise AssertionError('%s: kernel and plain version differ '
                             '(max |diff| %d)' % (name, err))
    return err


def walk_steps(records):
    """Path steps a walk took, from its records: one per M record, a run
    record op | len << 2 stands for len steps."""
    import torch
    rec = records.to(torch.int64)
    return int((rec == 1).sum()) + int((rec[rec >= 6] >> 2).sum())


def wave_fwd_cost(q, r, plane, ngt, moves, best):
    """(bytes, ops, cells) of one wavefront forward launch, counting each
    track's real groups only (ngt; the padding of either layout is not
    the function's work): G * W cells a group at OPS_PER_CELL_WAVE; the
    tapes read once, and a real group's plane row, moves and best once."""
    from unicycler_tpu_torch.ops.wavetape import G
    groups = int(ngt.to('cpu').sum())
    W = moves.shape[2]
    cells = groups * G * W
    per_group = (plane.shape[2] + best.shape[2]) * 4 + (G // 8) * W * 4
    nbytes = q.numel() + r.numel() + ngt.numel() * 4 + groups * per_group
    return nbytes, cells * OPS_PER_CELL_WAVE, cells


def wave_walk_cost(records, fin):
    """(bytes, ops, steps) of one wavefront walk: 8 bytes read a step,
    one record written per run."""
    steps = walk_steps(records)
    nbytes = steps * 8 + int((records != 0).sum()) * 4 + fin.numel() * 4
    return nbytes, steps * OPS_PER_STEP_WALK, steps


def row_walk_steps(records):
    """Path steps a row-tape walk took: one M or I step per record with
    move bits, plus the D steps counted in each record's upper bits."""
    import torch
    rec = records.to(torch.int64)
    return int(((rec & 7) != 0).sum()) + int((rec >> 3).sum())


def tape_fwd_cost(rowinfo, gplane, r_flat, ngt, moves, hatn, best, C):
    """(bytes, ops, cells) of one row-tape forward launch, counting each
    track's real groups only (ngt; the kernel stops there): the inputs
    read once, a real group's moves and best and each capture row's H
    written once; the band cells of the active rows (W each) at
    OPS_PER_CELL_ROW."""
    from unicycler_tpu_torch.ops.tape import MAX_SHIFT
    from unicycler_tpu_torch.ops.tape_kernels import G
    GWp = hatn.shape[-1]
    W = GWp - G * MAX_SHIFT
    groups = int(ngt.to('cpu').sum())
    caps = int(((rowinfo >> 8) & 1).sum())
    nbytes = sum(x.numel() * x.element_size() for x in
                 (rowinfo, gplane, r_flat, ngt)) \
        + groups * ((G // 8) * GWp * 4 + 8) \
        + caps * GWp * 4
    cells = int(((rowinfo >> 9) & 1).sum()) * W
    return nbytes, cells * OPS_PER_CELL_ROW, cells


def tape_walk_cost(records, fin):
    """(bytes, ops, steps) of one row-tape walk, from its records."""
    steps = row_walk_steps(records)
    nbytes = steps * BYTES_PER_STEP_ROW_WALK \
        + int((records != 0).sum()) * 4 + fin.numel() * 4
    return nbytes, steps * OPS_PER_STEP_WALK, steps


def banded_cost(q, r_ext, c, n_acts, moves):
    """(bytes, ops, cells) of one banded launch with moves, over each
    task's real rows (the kernel stops at n_act): the inputs once, the
    real rows' moves once; n_act * W cells a task at
    OPS_PER_CELL_BANDED."""
    rows = int(n_acts.sum())
    W = moves.shape[2] * 8
    cells = rows * W
    nbytes = sum(x.numel() * x.element_size() for x in (q, r_ext, c, n_acts)) \
        + rows * moves.shape[2] * 4
    return nbytes, cells * OPS_PER_CELL_BANDED, cells



def kernel_costs(timings):
    """Device time, bytes, operations, work (cells of a forward kernel,
    steps of a walker) and bound per kernel over a run's timed launches
    (cuda_lib.TIMINGS entries)."""
    costs = {'wavetape_fwd': wave_fwd_cost, 'wavetape_walk': wave_walk_cost,
             'tape_walk': tape_walk_cost, 'banded': banded_cost,
             'banded_walk': banded_walk_cost, 'tape_fwd': tape_fwd_cost,
             'pairwise': pairwise_cost, 'pairwise_walk': walk_full_cost}
    totals = {}
    for name, ev0, ev1, outs in timings:
        agg = totals.setdefault(name, {'ms': 0.0, 'bytes': 0, 'ops': 0,
                                       'work': 0})
        agg['ms'] += ev0.elapsed_time(ev1)
        if name in costs and all(x is not None for x in outs):
            nbytes, ops, work = costs[name](*outs)
            agg['bytes'] += nbytes
            agg['ops'] += ops
            agg['work'] += work
    for agg in totals.values():
        agg['bound_ms'] = bound_ms(agg['bytes'], agg['ops']) \
            if agg['ops'] else None
    return totals


def wave_launch_shapes(timings, counters):
    """Tracks of each wave forward launch of a run (from its timed
    launches), logged with the short-launch counters of
    ops/banded._wavetape_dispatch. Raises on a launch with fewer than
    min(tasks of its call, 132) tracks that the moves budget could have
    held (wave.short.*); a launch the budget forced short is named
    (wave.budget_short.*) and allowed."""
    tracks = [outs[2].shape[0] for name, _, _, outs in timings
              if name == 'wavetape_fwd']
    short = {k: v for k, v in sorted(counters.items())
             if k.startswith(('wave.short', 'wave.budget_short'))}
    log('wave launches: %d; tracks per launch %s; short launches %s'
        % (len(tracks), tracks, json.dumps(short) if short else 'none'))
    if counters.get('wave.short_launches', 0):
        raise AssertionError('wave launches below min(tasks, 132) tracks '
                             'that the moves budget could hold: %s' % short)
    return tracks


def log_kernel_times(per_kernel, launches):
    for name, agg in sorted(per_kernel.items()):
        bound = 'bound %.3f ms' % agg['bound_ms'] \
            if agg['bound_ms'] is not None else 'no bound counted'
        log('  %s: %.2f ms device time over %d launches (%s)'
            % (name, agg['ms'], launches[name], bound))


def retally(q, r, pa, scoring):
    """Score of pa's CIGAR walked over the code arrays q (s1) and r (s2)
    from its start cell, or None when it does not end at its end cell."""
    i, j, total = int(pa.s1_start), int(pa.s2_start), 0
    for count, op in pa.cigar:
        count = int(count)
        if op == 'M':
            a, b = q[i:i + count], r[j:j + count]
            same = int((a == b).sum())
            total += same * scoring.match + (count - same) * scoring.mismatch
            i += count
            j += count
        else:
            total += scoring.gap_open + (count - 1) * scoring.gap_extend
            if op == 'I':
                i += count
            else:
                j += count
    if (i, j) != (int(pa.s1_end), int(pa.s2_end)):
        return None
    return total


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('error: no CUDA device')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log('== phase 1: device')
    log('torch %s, CUDA %s, %d device(s): %s'
        % (torch.__version__, torch.version.cuda, torch.cuda.device_count(),
           name))
    return name, smi[0]


def phase_build():
    from unicycler_tpu_torch.ops import cuda_lib
    log('== phase 2: build')
    t0 = time.time()
    path = cuda_lib.build()
    cuda_lib.lib()
    secs = time.time() - t0
    log('built %s in %.1f s' % (os.path.relpath(path, HERE), secs))
    with open(os.path.join(os.path.dirname(path), 'ptxas.log')) as f:
        ptxas = f.read()
    for line in ptxas.splitlines():
        if 'Compiling entry' in line or 'registers' in line \
                or 'spill' in line or line.startswith('=='):
            log('  ' + line.strip())
    occ = cuda_lib.occupancy()
    log('resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor'
        '): wavetape_fwd %s; wavetape_walk %d blocks of %d tracks'
        % (', '.join('W %d: %d x %d threads' % (W, b, t)
                     for W, (b, t) in sorted(occ['wavetape_fwd'].items())),
           occ['wavetape_walk'][0], occ['wavetape_walk'][1]))
    from unicycler_tpu_torch.ops import tape_kernels as tk
    occ['tape_fwd_clusters'] = {
        W: {C: tk.resident_clusters(C, W) for C in tk.CLUSTER_SIZES}
        for W in (4096, 8192)}
    log('tape_fwd resident clusters (cudaOccupancyMaxActiveClusters), by W '
        'and blocks a cluster: %s' % json.dumps(occ['tape_fwd_clusters']))
    return secs, occ


def wave_kernels_against_plain(tp, W, scoring, config, dev, results,
                               layout):
    """Both wave kernels on one WaveLaunch against their plain versions:
    moves and best bit-equal over each track's real groups, records and
    fin bit-equal; CUDA-event times; one result row each."""
    import torch
    from unicycler_tpu_torch.ops import wavetape_kernels as wk
    from unicycler_tpu_torch.ops.wavetape import forward_inputs
    up = [torch.from_numpy(x).to(dev) for x in forward_inputs(tp)]
    q, r = up[0], up[1]
    bt = q.shape[0]
    plane, _ = wk.group_plane(*up[2:11], q.shape[1], r.shape[1], W)
    ngt = wk.track_groups(up[11])
    fwd = lambda: wk.wavetape_forward_cuda(q, r, plane, ngt, scoring, config,
                                           W, True)
    fwd()
    ms, out_k = kernel_time(fwd, reps=5)
    plain_ms, out_p = cuda_time(
        lambda: wk.wavetape_forward_plain(q, r, plane, scoring, config, W,
                                          True))
    (mv_k, best_k), (mv_p, best_p) = (wk.real_groups(*out_k, ngt),
                                      wk.real_groups(*out_p, ngt))
    del out_p
    err = max(exact('wavetape_fwd moves', mv_k, mv_p),
              exact('wavetape_fwd best', best_k, best_p))
    del mv_p, best_p
    nbytes, ops, cells = wave_fwd_cost(q, r, plane, ngt, mv_k, best_k)
    results.append({'name': 'wavetape_fwd', 'W': W, 'bt': bt,
                    'layout': layout, 'ms': ms, 'plain_ms': plain_ms,
                    'bound_ms': bound_ms(nbytes, ops), 'bytes': nbytes,
                    'cells': cells, 'max_abs_err': err})

    score, ei, ej, _, db_rows = wk.wavetape_forward(
        *up, scoring=scoring, config=config, W=W, need_moves=False)
    valid = up[4] > 0
    zero = torch.zeros_like(ei)
    wargs = [x.to(torch.int32).contiguous() for x in
             (mv_k, db_rows, torch.from_numpy(tp.n_tasks).to(dev),
              torch.where(valid, ei, zero), torch.where(valid, ej, zero),
              torch.where(valid, torch.from_numpy(tp.abase).to(dev), zero))]
    walk = lambda: wk.wavetape_traceback_cuda(*wargs, W)
    walk()
    wms, (rec_k, fin_k) = kernel_time(walk, reps=3)
    wplain_ms, (rec_p, fin_p) = cuda_time(
        lambda: wk.wavetape_traceback_plain(*wargs, W))
    werr = max(exact('wavetape_walk records', rec_k, rec_p),
               exact('wavetape_walk fin', fin_k, fin_p))
    wbytes, wops, steps = wave_walk_cost(rec_k, fin_k)
    results.append({'name': 'wavetape_walk', 'W': W, 'bt': bt,
                    'layout': layout, 'ms': wms, 'plain_ms': wplain_ms,
                    'bound_ms': bound_ms(wbytes, wops), 'bytes': wbytes,
                    'steps': steps, 'max_abs_err': werr})
    log('%s layout W=%4d tracks=%3d groups=%6d  fwd %.3f ms (plain %.0f '
        'ms, bound %.4f ms)  walk %.3f ms (plain %.0f ms, %d steps)  '
        'bit-equal' % (layout, W, bt, cells // (32 * W), ms, plain_ms,
                       bound_ms(nbytes, ops), wms, wplain_ms, steps))


def wave_fwd_scaling(rng, dev, scoring, config, report, W=512):
    """The forward kernel's time on the card's layout as the tracks of a
    launch grow (66 to 528 short tasks of the same length mix), each
    launch timed alone five times: how the time follows the blocks per
    SM."""
    import torch
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import wavetape_kernels as wk
    from unicycler_tpu_torch.ops.wavetape import (build_wave_launches,
                                                  forward_inputs)
    sizes = [int(x) for x in rng.integers(300, 1500, 528)]
    pool = [bo.BandedTask(*t) for t in
            synth.banded_tasks(rng, sizes, drift=True)]
    rows = []
    for tracks in (66, 132, 264, 528):
        tp = build_wave_launches(pool[:tracks], W, bo.build_corridor)[0]
        up = [torch.from_numpy(x).to(dev) for x in forward_inputs(tp)]
        plane, _ = wk.group_plane(*up[2:11], up[0].shape[1],
                                  up[1].shape[1], W)
        ngt = wk.track_groups(up[11])
        fwd = lambda: wk.wavetape_forward_cuda(up[0], up[1], plane, ngt,
                                               scoring, config, W, True)
        fwd()
        cuda_lib.TIMINGS = []
        times = [cuda_time(fwd)[0] for _ in range(5)]
        launch_ms = [e0.elapsed_time(e1) for _, e0, e1, _ in cuda_lib.TIMINGS]
        cuda_lib.TIMINGS = None
        groups = int(ngt.sum())
        rows.append({'tracks': tracks, 'groups': groups,
                     'max_groups': int(ngt.max()), 'ms': times,
                     'launch_ms': launch_ms})
        log('W=%d %3d tracks (%6d groups, longest %d): fwd %s ms (kernel '
            'alone %s ms)' % (W, tracks, groups, int(ngt.max()),
                              ' '.join('%.3f' % t for t in times),
                              ' '.join('%.3f' % t for t in launch_ms)))
    report['wave_fwd_scaling'] = {'W': W, 'rows': rows}


def polish_like_tasks(rng, n_tasks, n50=16000, sigma=0.6):
    """Tasks shaped like the assembly's polish alignments: log-normal read
    lengths with N50 ~ n50 (synth.simulate_reads' distribution), each a
    mutated copy of its reference window under the reads' error model,
    with a corridor bent at the middle."""
    import numpy as np
    from unicycler_tpu_torch import synth
    mu = np.log(n50) - sigma ** 2
    sizes = [int(x) for x in np.clip(rng.lognormal(mu, sigma, n_tasks),
                                     1000, 60000)]
    return synth.banded_tasks(rng, sizes, drift=True, sub=0.04, ins=0.02,
                              dele=0.02)


def wave_layout_ab(rng, dev, scoring, config, report, n_tasks=300, W=512):
    """One set of polish-shaped tasks through both wave kernels in the JAX
    package's layout (tape.choose_bt tracks) and in the card's (one task a
    track): device time of each kernel in each, and equal per-task score,
    ends and decoded CIGARs."""
    import torch
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops.wavetape import (build_wave_launches,
                                                  build_wavetapes)
    tasks = [bo.BandedTask(*t) for t in polish_like_tasks(rng, n_tasks)]
    lens = sorted((len(t.q) for t in tasks), reverse=True)
    acc = n50 = 0
    for length in lens:
        acc += length
        if acc >= sum(lens) / 2:
            n50 = length
            break
    rows = {}
    for layout, build in (('jax', build_wavetapes),
                          ('task', build_wave_launches),
                          ('task', build_wave_launches),
                          ('jax', build_wavetapes)):
        launches = build(tasks, W, bo.build_corridor)
        results = [None] * len(tasks)
        cuda_lib.TIMINGS = []
        torch.cuda.synchronize()
        t0 = time.time()
        pending = bo._wave_queue(launches, scoring, config, W, True, dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        timings, cuda_lib.TIMINGS = cuda_lib.TIMINGS, None
        grouped = bo._tape_collect(pending)
        retry = bo._tape_decode(results, list(range(len(tasks))), pending,
                                grouped, True, config)
        per = kernel_costs(timings)
        row = {'launches': len(launches),
               'tracks': [tp.q_tape.shape[0] for tp in launches],
               'fwd_ms': per['wavetape_fwd']['ms'],
               'walk_ms': per['wavetape_walk']['ms'],
               'fwd_bound_ms': per['wavetape_fwd']['bound_ms'],
               'walk_bound_ms': per['wavetape_walk']['bound_ms'],
               'queue_wall_s': wall, 'retry': len(retry)}
        if layout in rows:
            rows[layout]['repeat'] = row
            if results != rows[layout]['results']:
                raise AssertionError('%s layout: two runs differ' % layout)
            continue
        row['results'] = results
        rows[layout] = row
    a, b = rows['jax'].pop('results'), rows['task'].pop('results')
    same = sum(x == y for x, y in zip(a, b))
    log('A/B on %d polish-shaped tasks (N50 %d, %d bp, W %d): JAX layout %d '
        'launches of %s tracks: fwd %.2f ms, walk %.2f ms; card layout %d '
        'launches of %s tracks: fwd %.2f ms, walk %.2f ms (bound %.2f / '
        '%.4f ms); repeats %.2f / %.2f and %.2f / %.2f ms; %d/%d tasks '
        'equal (score, ends, CIGAR)'
        % (len(tasks), n50, sum(lens), W, rows['jax']['launches'],
           rows['jax']['tracks'], rows['jax']['fwd_ms'],
           rows['jax']['walk_ms'], rows['task']['launches'],
           rows['task']['tracks'], rows['task']['fwd_ms'],
           rows['task']['walk_ms'], rows['task']['fwd_bound_ms'],
           rows['task']['walk_bound_ms'], rows['task']['repeat']['fwd_ms'],
           rows['task']['repeat']['walk_ms'], rows['jax']['repeat']['fwd_ms'],
           rows['jax']['repeat']['walk_ms'], same, len(tasks)))
    report['wave_ab'] = dict(rows, tasks=len(tasks), n50=n50,
                             bases=sum(lens), W=W, equal=same)
    if same != len(tasks):
        raise AssertionError('the two layouts differ on %d tasks'
                             % (len(tasks) - same))


def phase_kernels(rng, dev, results, report):
    """Each kernel against its plain version on the card."""
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    from unicycler_tpu_torch.ops.wavetape import (build_wave_launches,
                                                  build_wavetapes)

    log('== phase 3: kernels against their plain versions')
    scoring = Scoring(3, -6, -5, -2)
    config = SEMI_GLOBAL
    # the JAX package's layout (several tasks a track) at 8 and 32 tracks
    for W, bt, size in ((512, 8, 1500), (512, 32, 1500), (1024, 8, 1200),
                        (1024, 32, 1200)):
        tasks = [bo.BandedTask(*t) for t in
                 synth.banded_tasks(rng, [size] * bt, drift=True)]
        tp = build_wavetapes(tasks, W, bo.build_corridor, bt=bt)[0]
        wave_kernels_against_plain(tp, W, scoring, config, dev, results,
                                   'jax')
    # the card's layout (one task a track): 264 tracks of mixed lengths,
    # two resident blocks on each of the 132 SMs
    for W in (128, 512, 1024, 2048):
        sizes = [int(x) for x in rng.integers(300, 1500, 264)]
        tasks = [bo.BandedTask(*t) for t in
                 synth.banded_tasks(rng, sizes, drift=True)]
        launches = build_wave_launches(tasks, W, bo.build_corridor)
        if len(launches) != 1 or launches[0].q_tape.shape[0] != len(tasks):
            raise AssertionError('264 short tasks did not make one launch '
                                 'of 264 tracks')
        wave_kernels_against_plain(launches[0], W, scoring, config, dev,
                                   results, 'task')
    wave_fwd_scaling(rng, dev, scoring, config, report)
    wave_layout_ab(rng, dev, scoring, config, report)

    retry_kernels_against_plain(rng, dev, scoring, config, results)


def retry_kernels_against_plain(rng, dev, scoring, config, results):
    """Kernels 3 and 6 (the retry pair) against their plain versions at the
    wave route's widths and the row route's: 32 drifting tasks a launch,
    kernel 3's score, ends and moves rows [0, n_act) and kernel 6's
    records and finals bit-equal; each launch timed alone; us per real
    row (rows up to the launch's longest n_act) and per walk step. At the
    fast kernel's widths, each lanes-a-thread template is timed too."""
    import torch
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import banded_kernel as bk
    from unicycler_tpu_torch.ops import traceback_kernels as tbk
    for W, size in ((128, 1500), (512, 1500), (1024, 1200), (2048, 1200),
                    (4096, 1200), (16384, 1200)):
        tasks = [bo.BandedTask(*t) for t in
                 synth.banded_tasks(rng, [size] * bk.BT, drift=True)]
        n_pad = bo.bucket_length(max(len(t.q) for t in tasks))
        m_pad = bo.bucket_length(max(len(t.r) for t in tasks))
        host = bo._pack_bucket(tasks, list(range(len(tasks))), n_pad, m_pad,
                               W, bk.BT)
        args = [torch.from_numpy(x).to(dev) for x in host]
        n_acts = args[3]
        rows = int(n_acts.max())
        plain_ms, out_p = cuda_time(
            lambda: bk.banded_batch_plain(*args, scoring, config, W, True))
        want_moves = bk.moves_rows_real(out_p[3], n_acts)
        sweep = [0] if W > bk.FAST_MAX_W else \
            [0] + [ln for ln in (2, 4, 8) if (W + 128) // ln <= 576]
        line = []
        for ln in sweep:
            run = lambda: bk.banded_batch_cuda(*args, scoring, config, W,
                                               True, lanes=ln)
            run()
            ms, out_k = kernel_time(run, reps=3)
            err = max(exact('banded W %d lanes %d %s' % (W, ln, n), a, b)
                      for n, a, b in zip(('score', 'end_i', 'end_j'),
                                         out_k[:3], out_p[:3]))
            err = max(err, exact('banded W %d lanes %d moves' % (W, ln),
                                 bk.moves_rows_real(out_k[3], n_acts),
                                 want_moves))
            nbytes, ops, cells = banded_cost(*args[:4], out_k[3])
            results.append({'name': 'banded', 'W': W, 'bt': bk.BT,
                            'n_pad': n_pad, 'rows': rows, 'lanes': ln,
                            'summary': W == 1024 and ln == 0, 'ms': ms,
                            'us_per_row': 1e3 * ms / rows,
                            'plain_ms': plain_ms,
                            'bound_ms': bound_ms(nbytes, ops),
                            'bytes': nbytes, 'cells': cells,
                            'max_abs_err': err})
            line.append('%s %.3f ms (%.3f us/row)'
                        % ('default' if ln == 0 else '%d lanes' % ln, ms,
                           1e3 * ms / rows))
            if ln == 0:
                score, ei, ej, moves = out_k
            del out_k
        del out_p, want_moves
        crow = args[2][:, 1:].contiguous()
        walk = lambda: tbk.banded_traceback_cuda(moves, crow, ei, ej, W)
        walk()
        wms, (rec_k, fin_k) = kernel_time(walk, reps=3)
        wplain_ms, (rec_p, fin_p) = cuda_time(
            lambda: tbk.banded_traceback_plain(moves, crow, ei, ej, W))
        werr = max(exact('banded_walk W %d records' % W, rec_k, rec_p),
                   exact('banded_walk W %d final' % W, fin_k, fin_p))
        wbytes, wops, steps = banded_walk_cost(rec_k, fin_k)
        results.append({'name': 'banded_walk', 'W': W, 'bt': bk.BT,
                        'n_pad': n_pad, 'ms': wms, 'plain_ms': wplain_ms,
                        'bound_ms': bound_ms(wbytes, wops), 'bytes': wbytes,
                        'steps': steps, 'us_per_step': 1e3 * wms / steps,
                        'max_abs_err': werr})
        log('W=%5d B=%2d n_pad=%d rows=%d  banded %s (plain %.0f ms)  '
            'banded_walk %.3f ms, %d steps, %.4f us/step (plain %.0f ms)  '
            'bit-equal' % (W, bk.BT, n_pad, rows, ', '.join(line), plain_ms,
                           wms, steps, 1e3 * wms / steps, wplain_ms))
        del moves, args


def _load_genome(seed, n_reads):
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.io.fastx import Read, Reference
    rng = __import__('numpy').random.default_rng(seed)
    reps = synth.random_replicons(rng, [5_000_000, 100_000])
    sim = synth.simulate_reads(rng, reps, n_reads)
    refs = [Reference('chromosome', reps[0]), Reference('plasmid', reps[1])]
    return refs, sim, Read


def phase_slice(args, dev, report):
    import torch
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.align.semi_global import AlignJob, align_jobs
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.utils import trace

    log('== phase 4: the slice (align_jobs on %s)' % dev)
    t0 = time.time()
    refs, sim, Read = _load_genome(args.seed, args.reads)
    reads0 = [Read(n, s, None) for n, s, _ in sim]
    n_sens2 = min(20, len(sim))
    reads2 = [Read(n, s, None) for n, s, _ in sim[:n_sens2]]
    lens = sorted((len(s) for _, s, _ in sim), reverse=True)
    half, acc, n50 = sum(lens) / 2, 0, 0
    for length in lens:
        acc += length
        if acc >= half:
            n50 = length
            break
    log('genome %s bp, %d reads, %d bp, N50 %d (set-up %.1f s)'
        % ('+'.join(str(r.get_length()) for r in refs), len(sim), sum(lens),
           n50, time.time() - t0))
    scheme = AlignmentScoringScheme('3,-6,-5,-2')
    jobs = [AlignJob(reads0, refs, scheme, sensitivity_level=0),
            AlignJob(reads2, refs, scheme, sensitivity_level=2)]
    random.seed(args.seed)
    trace.reset()
    trace.enable()
    cuda_lib.TIMINGS = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.time()
    align_jobs(jobs, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    timings, cuda_lib.TIMINGS = cuda_lib.TIMINGS, None
    trace.disable()
    peak = torch.cuda.max_memory_allocated()

    per_kernel = kernel_costs(timings)
    cells = per_kernel.get('wavetape_fwd', {}).get('work', 0)

    # checks: placement of each read's best alignment, CIGAR tallies
    placed, tally_bad, n_aln = 0, 0, 0
    for read, (_, _, truth) in zip(reads0, sim):
        for a in read.alignments:
            n_aln += 1
            if a.raw_score != a._pair.score:
                tally_bad += 1
        if not read.alignments:
            continue
        best = max(read.alignments, key=lambda a: a.raw_score)
        if best.ref is refs[truth.replicon] \
                and bool(best.rev_comp) == truth.rev_comp \
                and abs(best.ref_start_pos - truth.start) <= 100:
            placed += 1
    for read in reads2:
        for a in read.alignments:
            n_aln += 1
            if a.raw_score != a._pair.score:
                tally_bad += 1
    frac = placed / len(reads0)
    n_reads = len(reads0) + len(reads2)
    log('align_jobs: %.2f s wall, %.2f reads/s, %.3g DP cells/s of wall '
        '(%d cells), peak device memory %.1f MiB'
        % (wall, n_reads / wall, cells / wall, cells, peak / 2 ** 20))
    log('kernel launches: %s' % json.dumps(launches))
    log_kernel_times(per_kernel, launches)
    log('placement: %d/%d best alignments on the true replicon and strand '
        'within 100 bp (%.1f%%); %d alignments, %d CIGAR tally mismatches'
        % (placed, len(reads0), 100 * frac, n_aln, tally_bad))
    spans = trace.as_dict()['spans']
    log('host spans (s): %s' % json.dumps(
        {k: v['seconds'] for k, v in spans.items()}))
    counters = trace.as_dict()['counters']
    log('trace counters: %s' % json.dumps(
        {k: v for k, v in sorted(counters.items())
         if k.startswith(('wave.', 'tape.'))}))
    tracks = wave_launch_shapes(timings, counters)
    if launches['wavetape_fwd'] <= 0 or launches['wavetape_walk'] <= 0:
        raise AssertionError('the slice did not go through the wave kernels')
    if frac < 0.95:
        raise AssertionError('only %.1f%% of reads placed correctly'
                             % (100 * frac))
    if tally_bad:
        raise AssertionError('%d CIGARs do not re-tally to their score'
                             % tally_bad)
    report.update({'wall_s': wall, 'reads': n_reads, 'reads_per_s':
                   n_reads / wall, 'cells': cells, 'cells_per_s':
                   cells / wall, 'peak_bytes': peak, 'placed_fraction': frac,
                   'alignments': n_aln, 'launches': launches,
                   'per_kernel': per_kernel, 'n50': n50, 'spans': spans,
                   'counters': counters, 'wave_tracks': tracks})
    return launches, per_kernel


def phase_small_reference(dev):
    """The wave route on the card against the same route on the CPU (the
    kernels' plain versions) on a few small tasks."""
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    import numpy as np
    rng = np.random.default_rng(5)
    tasks = [bo.BandedTask(*t) for t in
             synth.banded_tasks(rng, [300, 900, 1700, 2500], drift=True)]
    scoring = Scoring(3, -6, -5, -2)
    got = bo.align_banded_tape(tasks, scoring, SEMI_GLOBAL, 512, True,
                               device=dev)
    want = bo.align_banded_tape(tasks, scoring, SEMI_GLOBAL, 512, True,
                                device='cpu')
    for g, w in zip(got, want):
        if g != w:
            raise AssertionError('wave route differs from the CPU route: '
                                 '%r vs %r' % (g[:5], w[:5]))
    log('small reference: %d tasks, wave route on the card == CPU route'
        % len(tasks))


def banded_walk_cost(records, final):
    """(bytes, ops, steps) of one banded walk: 4 B of moves word and 4 B of
    band offset read a step, one record written per visited row."""
    steps = row_walk_steps(records)
    nbytes = steps * BYTES_PER_STEP_BANDED_WALK \
        + int((records != 0).sum()) * 4 + final.numel() * 4
    return nbytes, steps * OPS_PER_STEP_WALK, steps


def retry_counters(fn):
    """Run fn with tracing on; returns (its result, the trace counters)."""
    from unicycler_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.as_dict()['counters']


def phase_retry(args, dev, results, report):
    """The band-escape retry path: the banded kernel (3) with the walk on
    the card (6) against the host-decode route and the CPU route; kernel
    6 against its plain version; align_banded on FULLY_GLOBAL tasks with
    zigzag corridors, which retry inside the call."""
    import functools
    import torch
    import numpy as np
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import banded_kernel as bk
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import traceback_kernels as tbk
    from unicycler_tpu_torch.ops import wavetape
    from unicycler_tpu_torch.ops.encode import bucket_length
    from unicycler_tpu_torch.ops.pairwise import (FULLY_GLOBAL, SEMI_GLOBAL,
                                                  Scoring)

    log('== phase 5: retry path (_align_banded_moves_path)')
    rng = np.random.default_rng(args.seed + 1)
    tasks = [bo.BandedTask(*t) for t in
             synth.banded_tasks(rng, [3000, 2600, 3400, 1800, 2200, 3100,
                                      900, 2900], drift=True)]
    scoring = Scoring(3, -6, -5, -2)
    retry = lambda **kw: bo._align_banded_moves_path(
        tasks, scoring, SEMI_GLOBAL, 512, True, **kw)
    cuda_lib.reset_launches()
    t0 = time.time()
    got, walk_ctr = retry_counters(lambda: retry(device=dev))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: cuda_lib.LAUNCHES[k] for k in ('banded', 'banded_walk')}
    host, host_ctr = retry_counters(lambda: retry(device=dev,
                                                  device_walk=False))
    want = retry(device='cpu')
    for g, h, w in zip(got, host, want):
        if not g == h == w:
            raise AssertionError('retry path differs between the device '
                                 'walk, the host decode and the CPU route')
    bad = sum(retally(t.q, t.r, pa, scoring) != pa.score
              for t, pa in zip(tasks, got) if pa.cigar)
    log('retry path: %d tasks, launches %s, %.2f s, equal to the host-decode '
        'route and the CPU route; %d CIGARs, %d off their score; bytes '
        'copied back: %d with the walk on the card, %d with the host decode'
        % (len(tasks), json.dumps(launches), wall,
           sum(1 for p in got if p.cigar), bad,
           walk_ctr['retry.fetch_bytes'], host_ctr['retry.fetch_bytes']))
    if bad:
        raise AssertionError('%d retry CIGARs do not re-tally' % bad)
    if min(launches.values()) <= 0 or walk_ctr['retry.device_walk'] <= 0:
        raise AssertionError('the retry path did not launch kernels 3 and 6')

    def walk_against_plain(task_list, config, W, summary=False):
        """Kernel 6 against its plain version on kernel 3's moves of
        task_list, packed into one bucket at width W."""
        n_pad = bucket_length(max(len(t.q) for t in task_list))
        m_pad = bucket_length(max(len(t.r) for t in task_list))
        B = -(-len(task_list) // bk.BT) * bk.BT
        host_in = bo._pack_bucket(task_list, list(range(len(task_list))),
                                  n_pad, m_pad, W, B)
        up = [torch.from_numpy(x).to(dev) for x in host_in]
        _, ei, ej, moves = bk.banded_batch_cuda(*up, scoring, config, W,
                                                True)
        crow = up[2][:, 1:].contiguous()
        walk = lambda: tbk.banded_traceback_cuda(moves, crow, ei, ej, W)
        walk()
        ms, (rec_k, fin_k) = kernel_time(walk, reps=3)
        plain_ms, (rec_p, fin_p) = cuda_time(
            lambda: tbk.banded_traceback_plain(moves, crow, ei, ej, W))
        err = max(exact('banded_walk records', rec_k, rec_p),
                  exact('banded_walk final', fin_k, fin_p))
        nbytes, ops, steps = banded_walk_cost(rec_k, fin_k)
        results.append({'name': 'banded_walk', 'W': W, 'bt': B,
                        'n_pad': n_pad, 'summary': summary, 'ms': ms,
                        'plain_ms': plain_ms,
                        'bound_ms': bound_ms(nbytes, ops), 'bytes': nbytes,
                        'steps': steps, 'us_per_step': 1e3 * ms / steps,
                        'max_abs_err': err})
        log('W=%4d B=%2d n_pad=%d  banded_walk %.3f ms (plain %.0f ms, %d '
            'steps, %.4f us/step)  bit-equal'
            % (W, B, n_pad, ms, plain_ms, steps, 1e3 * ms / steps))

    # kernel 6 against its plain version on the phase's tasks
    for W in (512, 1024, 2048):
        walk_against_plain(tasks, SEMI_GLOBAL, W, summary=W == 2048)

    # align_banded on FULLY_GLOBAL tasks whose corridors zigzag: the wave
    # route (kernels 1, 2) finds no path for some, which retry (kernels 3,
    # 6) in the per-row band; all inside one call. In the card's layout
    # those tasks have no path in the per-row band either. In the JAX
    # package's layout (several tasks a track) a NEG task's walk from its
    # unreachable corner also overwrites a neighbour's records, so that
    # neighbour retries too and is walked on the card into a CIGAR; both
    # layouts give the same results.
    grng = np.random.default_rng(args.seed + 5)
    gtasks = [bo.BandedTask(*t) for t in synth.zigzag_tasks(
        grng, [int(x) for x in grng.integers(300, 1500, 24)])]
    band = 40
    call = lambda: bo.align_banded(gtasks, scoring, FULLY_GLOBAL, band,
                                   True, device=dev)
    inner = bo._align_banded_moves_path
    card_layout = wavetape.build_wave_launches
    retried = []

    def observed(task_list, *a, **kw):
        out = inner(task_list, *a, **kw)
        retried.extend(zip(task_list, out))
        return out

    bo._align_banded_moves_path = observed
    cuda_lib.reset_launches()
    try:
        gwalk, gctr = retry_counters(call)
        torch.cuda.synchronize()
        glaunch = dict(cuda_lib.LAUNCHES)
        card_walked = sum(1 for _, pa in retried if pa.cigar)
        del retried[:]
        wavetape.build_wave_launches = \
            lambda t, W, corridor, budget: wavetape.build_wavetapes(
                t, W, corridor)
        gjax, gjctr = retry_counters(call)
        wavetape.build_wave_launches = card_layout
        bo._align_banded_moves_path = functools.partial(inner,
                                                        device_walk=False)
        ghost, ghctr = retry_counters(call)
    finally:
        bo._align_banded_moves_path = inner
        wavetape.build_wave_launches = card_layout
    if not gwalk == ghost == gjax:
        raise AssertionError('align_banded differs between the walk on the '
                             'card, the host-decode retry path and the JAX '
                             'package\'s layout')
    gbad = sum(retally(t.q, t.r, pa, scoring) != pa.score
               for t, pa in zip(gtasks, gwalk) if pa.cigar)
    walked = sum(1 for _, pa in retried if pa.cigar)
    used = ('wavetape_fwd', 'wavetape_walk', 'banded', 'banded_walk')
    log('align_banded (FULLY_GLOBAL, zigzag corridors, band %d, W %d): %d '
        'tasks; card layout: %d retried, retry.device_walk %d (%d left to '
        'the host traceback), %d walked into CIGARs, launches %s; JAX '
        'layout: %d retried, %d walked on the card into CIGARs; equal to '
        'each other and to the host-decode retry path; %d CIGARs, %d off '
        'their score; retry bytes copied back: %d with the walk on the '
        'card, %d with the host decode'
        % (band, bo.band_width(band), len(gtasks), gctr.get('tape.retry', 0),
           gctr.get('retry.device_walk', 0),
           gctr.get('retry.host_decode', 0), card_walked,
           json.dumps({k: glaunch[k] for k in used}),
           gjctr.get('tape.retry', 0), walked,
           sum(1 for p in gwalk if p.cigar), gbad,
           gctr.get('retry.fetch_bytes', 0),
           ghctr.get('retry.fetch_bytes', 0)))
    if gbad:
        raise AssertionError('%d CIGARs do not re-tally' % gbad)
    if gctr.get('retry.device_walk', 0) <= 0 \
            or min(glaunch[k] for k in used) <= 0:
        raise AssertionError('align_banded did not run kernels 1, 2, 3 and '
                             '6 with the walk on the card')
    if walked <= 0:
        raise AssertionError('no retried task of align_banded was walked '
                             'into a CIGAR')
    # kernel 6 against its plain version at the call's own width, on the
    # tasks the call retried in the JAX package's layout
    walk_against_plain([t for t, _ in retried], FULLY_GLOBAL,
                       bo.band_width(band))
    report['retry_wide'] = retry_wide(args, dev, scoring)
    report['retry'] = {
        'tasks': len(tasks), 'launches': launches, 'wall_s': wall,
        'fetch_bytes_walk': walk_ctr['retry.fetch_bytes'],
        'fetch_bytes_host': host_ctr['retry.fetch_bytes'],
        'align_banded': {'tasks': len(gtasks),
                         'retried': gctr.get('tape.retry', 0),
                         'device_walk': gctr.get('retry.device_walk', 0),
                         'host_decode': gctr.get('retry.host_decode', 0),
                         'walked_cigars': card_walked,
                         'jax_layout_retried': gjctr.get('tape.retry', 0),
                         'jax_layout_walked_cigars': walked,
                         'launches': {k: glaunch[k] for k in used},
                         'fetch_bytes_walk': gctr.get('retry.fetch_bytes', 0),
                         'fetch_bytes_host': ghctr.get('retry.fetch_bytes',
                                                       0)}}
    return {k: glaunch[k] for k in ('banded', 'banded_walk')}


def retry_wide(args, dev, scoring):
    """The retry path at the row route's W 4096: _align_banded_moves_path
    on bridging-shaped tasks (kernels 3 and 6 on the card) equal to the
    CPU route; and align_banded at W 4096 (the row kernels) with every
    other track's walk forced to end in a band escape, so those tasks
    retry inside the call, equal to the CPU route."""
    import numpy as np
    import torch
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import tape_kernels as tk
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL
    W, band = 4096, 1500
    rng = np.random.default_rng(args.seed + 6)
    tasks = [bo.BandedTask(*t) for t in bridging_like_tasks(rng, 4)]
    cuda_lib.reset_launches()
    t0 = time.time()
    got, ctr = retry_counters(lambda: bo._align_banded_moves_path(
        tasks, scoring, SEMI_GLOBAL, W, True, device=dev))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: cuda_lib.LAUNCHES[k] for k in ('banded', 'banded_walk')}
    t0 = time.time()
    want = bo._align_banded_moves_path(tasks, scoring, SEMI_GLOBAL, W, True,
                                       device='cpu')
    cpu_wall = time.time() - t0
    bad = sum(retally(t.q, t.r, pa, scoring) != pa.score
              for t, pa in zip(tasks, got) if pa.cigar)
    log('retry path at W %d: %d bridging-shaped tasks (%s bp), launches %s, '
        '%.2f s on the card (CPU route %.1f s); %d CIGARs, %d off their '
        'score; equal to the CPU route'
        % (W, len(tasks), [len(t.q) for t in tasks], json.dumps(launches),
           wall, cpu_wall, sum(1 for p in got if p.cigar), bad))
    if got != want:
        raise AssertionError('the retry path at W %d differs from the CPU '
                             'route' % W)
    if bad or min(launches.values()) <= 0 \
            or ctr.get('retry.device_walk', 0) <= 0:
        raise AssertionError('the retry path at W %d did not walk on the '
                             'card into CIGARs that re-tally' % W)

    inner = tk.tape_traceback

    def forced(*a, **kw):
        records, fin = inner(*a, **kw)
        fin = fin.clone()
        fin[::2, :, 2] = 2
        return records, fin

    ftasks = [bo.BandedTask(*t) for t in bridging_like_tasks(rng, 6)]
    tk.tape_traceback = forced
    cuda_lib.reset_launches()
    try:
        fgot, fctr = retry_counters(lambda: bo.align_banded(
            ftasks, scoring, SEMI_GLOBAL, band, True, device=dev))
    finally:
        tk.tape_traceback = inner
    flaunch = dict(cuda_lib.LAUNCHES)
    fwant = bo.align_banded(ftasks, scoring, SEMI_GLOBAL, band, True,
                            device='cpu')
    used = ('tape_fwd', 'tape_walk', 'banded', 'banded_walk')
    log('align_banded at W %d, every other walk forced to a band escape: '
        '%d tasks, %d retried, retry.device_walk %d, launches %s; equal to '
        'the CPU route' % (W, len(ftasks), fctr.get('tape.retry', 0),
                           fctr.get('retry.device_walk', 0),
                           json.dumps({k: flaunch[k] for k in used})))
    if fgot != fwant:
        raise AssertionError('align_banded with forced band escapes differs '
                             'from the CPU route')
    if fctr.get('tape.retry', 0) <= 0 or min(flaunch[k] for k in used) <= 0:
        raise AssertionError('the forced band escapes did not retry on '
                             'kernels 3 and 6')
    return {'W': W, 'tasks': len(tasks), 'launches': launches,
            'wall_s': wall, 'cpu_wall_s': cpu_wall,
            'forced': {'tasks': len(ftasks),
                       'retried': fctr.get('tape.retry', 0),
                       'device_walk': fctr.get('retry.device_walk', 0),
                       'launches': {k: flaunch[k] for k in used}}}


def sync(dev):
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def row_kernels_against_plain(tp, W, scoring, config, dev, results,
                              layout):
    """Both row kernels on one TapeLaunch against their plain versions:
    the forward at each cluster size C that fits the band (the tiled
    kernel where none does; each launch timed alone), moves,
    hatn and best bit-equal over each track's real groups; the walker's
    records and fin bit-equal. One result row each (the forward's one per
    C, the launch's own C flagged)."""
    import torch
    from unicycler_tpu_torch.ops import tape_kernels as tk
    from unicycler_tpu_torch.ops.tape import forward_inputs
    up = [torch.from_numpy(x).to(dev) for x in forward_inputs(tp)]
    bt = up[0].shape[0]
    rowinfo, gplane, _, _ = tk.tape_prolog(up[0], up[1], up[2], up[3],
                                           up[5], up[7], up[8], W)
    ngt = tk.track_groups(up[11])
    plain_ms, want = cuda_time(
        lambda: tk.tape_forward_plain(rowinfo, gplane, up[1], scoring,
                                      config, W, True, ngt=ngt))
    own = tk.launch_cluster(bt, W, dev)
    rows_real = 32 * int(ngt.max())
    line = []
    # every cluster size whose blocks fit the band; the tiled kernel (C 1)
    # where none does
    clusters = [C for C in tk.CLUSTER_SIZES
                if tk.region_width(W) // C <= tk.MAX_BLOCK_LANES] or [1]
    for C in clusters:
        fwd = lambda: tk.tape_forward_cuda(rowinfo, gplane, up[1], ngt,
                                           scoring, config, W, True,
                                           cluster=C)
        fwd()
        ms, out_k = kernel_time(fwd, reps=3)
        err = max(exact('tape_fwd %s C=%d %s' % (layout, C, n), a, b)
                  for n, a, b in zip(('moves', 'hatn', 'best'),
                                     tk.real_rows(*out_k, ngt), want))
        nbytes, ops, cells = tape_fwd_cost(rowinfo, gplane, up[1], ngt,
                                           *out_k, C)
        del out_k
        results.append({'name': 'tape_fwd', 'W': W, 'bt': bt, 'L': tp.L,
                        'layout': layout, 'C': C, 'own_C': C == own,
                        'ms': ms, 'us_per_row': 1e3 * ms / rows_real,
                        'plain_ms': plain_ms,
                        'bound_ms': bound_ms(nbytes, ops), 'bytes': nbytes,
                        'cells': cells, 'max_abs_err': err})
        line.append('C=%d %.3f ms (%.3f us/row)%s'
                    % (C, ms, 1e3 * ms / rows_real, '*' if C == own else ''))
    del want

    score, ei, ej, moves, (c_rel, jr_rows) = tk.tape_forward(
        *up, scoring=scoring, config=config, W=W, need_moves=True)
    valid = up[6] > 0
    zero = torch.zeros_like(ei)
    wargs = [x.to(torch.int32).contiguous() for x in
             (moves, c_rel, jr_rows, torch.from_numpy(tp.n_tasks).to(dev),
              torch.where(valid, up[8] + ei, zero),
              torch.where(valid, ej, zero),
              torch.where(valid, up[8], zero))]
    walk = lambda: tk.tape_traceback_cuda(*wargs, W)
    walk()
    wms, (rec_k, fin_k) = kernel_time(walk, reps=3)
    wplain_ms, (rec_p, fin_p) = cuda_time(
        lambda: tk.tape_traceback_plain(*wargs, W))
    werr = max(exact('tape_walk records', rec_k, rec_p),
               exact('tape_walk fin', fin_k, fin_p))
    wbytes, wops, steps = tape_walk_cost(rec_k, fin_k)
    results.append({'name': 'tape_walk', 'W': W, 'bt': bt, 'L': tp.L,
                    'layout': layout, 'ms': wms, 'plain_ms': wplain_ms,
                    'bound_ms': bound_ms(wbytes, wops), 'bytes': wbytes,
                    'steps': steps, 'max_abs_err': werr})
    log('%s layout W=%4d tracks=%2d L=%5d (longest %d rows)  fwd %s (plain '
        '%.0f ms)  walk %.3f ms (plain %.0f ms, %d steps)  bit-equal'
        % (layout, W, bt, tp.L, rows_real, ', '.join(line), plain_ms, wms,
           wplain_ms, steps))


def bridging_like_tasks(rng, n_tasks):
    """Tasks shaped like phase 7's banded pairs: a read's stretch against
    a repeat-and-flank window of 1,300-5,200 bp, the reads' error model,
    with a corridor bent at the middle."""
    from unicycler_tpu_torch import synth
    sizes = [int(x) for x in rng.integers(1300, 5200, n_tasks)]
    return synth.banded_tasks(rng, sizes, drift=True, sub=0.04, ins=0.02,
                              dele=0.02)


def row_layout_ab(rng, dev, scoring, config, report, n_tasks=84, W=4096):
    """One set of bridging-shaped tasks through both row kernels in the JAX
    package's layout (tape.choose_bt tracks) and in the card's (one task a
    track): device time of each kernel in each (JAX, card, card, JAX), and
    equal per-task score, ends and decoded CIGARs."""
    import torch
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import tape_kernels as tk
    from unicycler_tpu_torch.ops.tape import build_row_launches, build_tapes
    tasks = [bo.BandedTask(*t) for t in bridging_like_tasks(rng, n_tasks)]
    rows = {}
    for layout, build in (('jax', build_tapes), ('card', build_row_launches),
                          ('card', build_row_launches), ('jax', build_tapes)):
        launches = build(tasks, W, bo.build_corridor)
        results = [None] * len(tasks)
        cuda_lib.TIMINGS = []
        torch.cuda.synchronize()
        t0 = time.time()
        pending = bo._row_queue(launches, scoring, config, W, True, dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        timings, cuda_lib.TIMINGS = cuda_lib.TIMINGS, None
        grouped = bo._tape_collect(pending)
        retry = bo._tape_decode(results, list(range(len(tasks))), pending,
                                grouped, True, config)
        per = kernel_costs(timings)
        row = {'launches': len(launches),
               'tracks': [tp.qf.shape[0] for tp in launches],
               'clusters': [tk.launch_cluster(tp.qf.shape[0], W, dev)
                            for tp in launches],
               'rows': [tp.L for tp in launches],
               'fwd_ms': per['tape_fwd']['ms'],
               'walk_ms': per['tape_walk']['ms'],
               'fwd_bound_ms': per['tape_fwd']['bound_ms'],
               'walk_bound_ms': per['tape_walk']['bound_ms'],
               'queue_wall_s': wall, 'retry': len(retry)}
        if layout in rows:
            rows[layout]['repeat'] = row
            if results != rows[layout]['results']:
                raise AssertionError('%s layout: two runs differ' % layout)
            continue
        row['results'] = results
        rows[layout] = row
    a, b = rows['jax'].pop('results'), rows['card'].pop('results')
    same = sum(x == y for x, y in zip(a, b))
    bases = sum(len(t.q) for t in tasks)
    log('A/B on %d bridging-shaped tasks (%d bp, W %d): JAX layout %d '
        'launches of %s tracks: fwd %.2f ms, walk %.2f ms; card layout %d '
        'launches of %s tracks, clusters of %s: fwd %.2f ms, walk %.2f ms '
        '(bound %.3f / %.5f ms); repeats %.2f / %.2f and %.2f / %.2f ms; '
        '%d/%d tasks equal (score, ends, CIGAR)'
        % (len(tasks), bases, W, rows['jax']['launches'],
           rows['jax']['tracks'], rows['jax']['fwd_ms'],
           rows['jax']['walk_ms'], rows['card']['launches'],
           rows['card']['tracks'], rows['card']['clusters'],
           rows['card']['fwd_ms'], rows['card']['walk_ms'],
           rows['card']['fwd_bound_ms'], rows['card']['walk_bound_ms'],
           rows['card']['repeat']['fwd_ms'],
           rows['card']['repeat']['walk_ms'], rows['jax']['repeat']['fwd_ms'],
           rows['jax']['repeat']['walk_ms'], same, len(tasks)))
    report['row_ab'] = dict(rows, tasks=len(tasks), bases=bases, W=W,
                            equal=same)
    if same != len(tasks):
        raise AssertionError('the two row layouts differ on %d tasks'
                             % (len(tasks) - same))


def phase_tape_kernels(rng, dev, results, report):
    """The row-tape forward kernel (at each cluster size) and walker
    against their plain versions at the bridging path's widths, in both
    layouts; an A/B of the layouts on bridging-shaped tasks; the
    full-matrix DP kernel against its plain version
    (full_dp_against_plain)."""
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import pairwise as pw
    from unicycler_tpu_torch.ops.tape import build_row_launches, build_tapes

    log('== phase 6: row-tape and full-matrix DP kernels against their '
        'plain versions')
    scoring = pw.Scoring(3, -6, -5, -2)
    config = pw.FULLY_GLOBAL
    # the JAX package's layout (several tasks a track) at 8 and 32 tracks
    for W, bt, size in ((4096, 8, 1200), (4096, 32, 1200), (8192, 8, 1200),
                        (8192, 32, 900)):
        tasks = [bo.BandedTask(*t) for t in
                 synth.banded_tasks(rng, [size] * bt, drift=True)]
        tp = build_tapes(tasks, W, bo.build_corridor, bt=bt)[0]
        row_kernels_against_plain(tp, W, scoring, config, dev, results,
                                  'jax')
    # the card's layout (one task a track): 12 tracks of mixed lengths,
    # about a bridging call's banded pairs, up to W 32768 (C >= 2 at W
    # 16384, C >= 4 at 32768); then one short task at W 131072, too wide
    # for every cluster size (the tiled kernel)
    for W, n_tasks in ((4096, 12), (8192, 12), (16384, 12), (32768, 12),
                       (131072, 1)):
        sizes = [int(x) for x in rng.integers(600, 1300, n_tasks)] \
            if n_tasks > 1 else [230]
        tasks = [bo.BandedTask(*t) for t in
                 synth.banded_tasks(rng, sizes, drift=True)]
        launches = build_row_launches(tasks, W, bo.build_corridor)
        if len(launches) != 1 or launches[0].qf.shape[0] != len(tasks):
            raise AssertionError('%d short tasks did not make one launch '
                                 'of %d tracks' % (n_tasks, n_tasks))
        row_kernels_against_plain(launches[0], W, scoring, config, dev,
                                  results, 'card')
    row_layout_ab(rng, dev, scoring, config, report)

    full_dp_against_plain(rng, dev, results, report)


def pairwise_cost(n_acts, m_acts, n_pad, m_pad, need_moves):
    """(bytes, ops, cells) of one full-matrix DP launch over each pair's
    real region (the kernel stops at row n_act and column m_act): the real
    bases and the lengths read once, the score and ends and the real
    region's moves (one byte a cell) written once; n_act * (m_act + 1)
    cells a pair at OPS_PER_CELL_FULL."""
    import torch
    n = n_acts.to('cpu', torch.int64).clamp(0, n_pad)
    m = m_acts.to('cpu', torch.int64).clamp(0, m_pad)
    cells = int((n * (m + 1)).sum())
    nbytes = int(n.sum() + m.sum()) + 8 * len(n) + 12 * len(n) \
        + (cells if need_moves else 0)
    return nbytes, cells * OPS_PER_CELL_FULL, cells


def walk_full_cost(out):
    """(bytes, ops, steps) of one full-DP walker launch from its output:
    a moves byte a step of each pair's path (its runs' counts summed, the
    row-0 and column-0 stops included), the score and ends read, the
    header and runs written; OPS_PER_STEP_WALK a step."""
    from unicycler_tpu_torch.ops import pairwise as pw
    host = out.cpu().numpy()
    steps = sum(sum(runs[0::2]) for _, runs in pw.walk_records(host))
    n_runs = int(host[:, 3].sum()) if len(host) else 0
    nbytes = steps + 12 * len(host) + 4 * (pw.WALK_HEAD * len(host)
                                           + 2 * n_runs)
    return nbytes, steps * OPS_PER_STEP_WALK, steps


def full_dp_against_plain(rng, dev, results, report):
    """csrc/pairwise.cu (align_batch_cuda) against align_batch_plain on
    the same inputs: score, end_i and end_j bit-equal, and the moves on
    each pair's real region [0, n_act) x [0, m_act]; CUDA-event time of
    the launch alone beside the plain version's and the bound. Shapes: a
    1,300 bp repeat's consensus (12 reads against one) under every
    AlignConfig with band None, 20 and 1000 and without moves; 12 pairs
    of mixed lengths (100-2,000 bp) in one call; pairs with n_act 0 and
    m_act 0 beside real ones; and the widest pairs dispatch.batch_align
    sends here (2^24 bucketed cells): n_pad 131,072 x m_pad 128 and 128 x
    131,072, two pairs each. The tall shape's plain version runs on the
    CPU (its 131,072-row loop of small ops is faster there). Every call
    with moves also holds the walker (walk_full_cuda, over the kernel's
    own outputs) to walk_full_plain on the same inputs (the host decode,
    timed on the host clock with its moves copy), headers and runs
    equal."""
    import torch
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import pairwise as pw
    from unicycler_tpu_torch.ops.encode import pack_pairs

    scoring = pw.Scoring(3, -6, -5, -2)
    configs = {'semi': pw.SEMI_GLOBAL, 'global': pw.FULLY_GLOBAL,
               'path': pw.PATH_CONFIG, 'overlap': pw.OVERLAP_CONFIG,
               'end': pw.END_CONFIG}
    pairs = synth.banded_tasks(rng, [1300] * 12)
    consensus = ([p[0] for p in pairs], [p[1] for p in pairs])
    mixed = synth.sized_pairs(rng, [(int(x), int(x * rng.uniform(0.9, 1.1)))
                                    for x in rng.integers(100, 2000, 12)])
    empty = synth.sized_pairs(rng, [(0, 500), (500, 0), (0, 0), (300, 320)])
    tall = synth.sized_pairs(rng, [(131072, 128), (131000, 120)])
    wide = synth.sized_pairs(rng, [(128, 131072), (120, 131000)])
    cases = [('consensus', consensus, c, band, True, 'cuda')
             for c in configs for band in (None, 20, 1000)]
    cases += [('consensus', consensus, c, None, False, 'cuda')
              for c in configs]
    cases += [('mixed', mixed, 'semi', None, True, 'cuda'),
              ('mixed', mixed, 'global', 1000, True, 'cuda')]
    cases += [('empty', empty, c, None, True, 'cuda') for c in configs]
    cases += [('tall', tall, 'semi', None, True, 'cpu'),
              ('wide', wide, 'semi', None, True, 'cuda'),
              ('wide', wide, 'global', 20, True, 'cuda')]
    line = []
    # score and ends do not depend on need_moves: the cases without moves
    # are held to the plain version's run with moves on the same inputs
    plain_runs = {}
    for shape, (qs, rs), cname, band, need_moves, plain_dev in cases:
        host = pack_pairs(qs, rs, max(max(len(q) for q in qs), 1),
                          max(max(len(r) for r in rs), 1))
        if band is not None:
            diffs = host[3].astype('int64') - host[1].astype('int64')
            diags = [(-band - diffs.clip(0)).astype('int32'),
                     (band + (-diffs).clip(0)).astype('int32')]
        else:
            diags = [None, None]
        up = [None if x is None else torch.from_numpy(x).to(dev)
              for x in list(host) + diags]
        args = up[:4] + [scoring, configs[cname], need_moves] + up[4:]
        launch = lambda: pw.align_batch_cuda(*args)
        launch()
        ms, got = kernel_time(launch, reps=3)
        pdev = torch.device(plain_dev) if plain_dev == 'cpu' else dev
        pargs = [None if x is None else x.to(pdev) for x in up]
        plain = lambda: pw.align_batch_plain(
            *pargs[:4], scoring, configs[cname], need_moves, *pargs[4:])
        key = (shape, cname, band)
        if key in plain_runs:
            plain_ms, want = plain_runs[key]
        elif plain_dev == 'cpu':
            t0 = time.time()
            want = plain()
            plain_ms = 1e3 * (time.time() - t0)
        else:
            plain_ms, want = cuda_time(plain)
        if need_moves:
            plain_runs[key] = (plain_ms, tuple(want[:3]) + (None,))
        tag = 'pairwise %s %s band %s%s' % (shape, cname, band,
                                            '' if need_moves else ' no moves')
        err = max(exact(tag + ' ' + n, a.cpu(), b.cpu())
                  for n, a, b in zip(('score', 'end_i', 'end_j'), got, want))
        walk = None
        if need_moves:
            km, pm = got[3].cpu(), want[3].cpu()
            for b, (q, r) in enumerate(zip(qs, rs)):
                err = max(err, exact('%s moves pair %d' % (tag, b),
                                     km[b, :len(q), :len(r) + 1],
                                     pm[b, :len(q), :len(r) + 1]))
            del km, pm
            walk = walk_against_plain(got, configs[cname], tag)
        elif got[3] is not None:
            raise AssertionError(tag + ': moves returned without need_moves')
        del got, want
        nbytes, ops, cells = pairwise_cost(up[1], up[3], host[0].shape[1],
                                           host[2].shape[1], need_moves)
        rows = max(len(q) for q in qs)
        results.append({'name': 'pairwise', 'shape': shape, 'config': cname,
                        'band': band, 'need_moves': need_moves,
                        'pairs': len(qs), 'n_pad': host[0].shape[1],
                        'm_pad': host[2].shape[1], 'ms': ms,
                        'us_per_row': 1e3 * ms / max(rows, 1),
                        'plain_ms': plain_ms, 'plain_device': plain_dev,
                        'plain_with_moves': not need_moves,
                        'bound_ms': bound_ms(nbytes, ops), 'bytes': nbytes,
                        'cells': cells, 'max_abs_err': err,
                        'summary': (shape, cname, band, need_moves)
                        == ('consensus', 'semi', None, True)})
        line.append('%s %s band %s%s: %d pairs of %d x %d, %.3f ms (%.3f us '
                    'a row; plain %.1f ms on %s%s; bound %.4f ms)'
                    % (shape, cname, band, '' if need_moves else ' no moves',
                       len(qs), host[0].shape[1], host[2].shape[1], ms,
                       1e3 * ms / max(rows, 1), plain_ms, plain_dev,
                       '' if need_moves else ', its run with moves',
                       bound_ms(nbytes, ops)))
        if walk is not None:
            walk.update({'shape': shape, 'config': cname, 'band': band,
                         'pairs': len(qs), 'n_pad': host[0].shape[1],
                         'm_pad': host[2].shape[1],
                         'summary': results[-1]['summary']})
            results.append(walk)
            line.append('  walk: %.3f ms (%d steps, %.4f us a step; plain '
                        '%.1f ms on the host; bound %.6f ms)'
                        % (walk['ms'], walk['steps'],
                           1e3 * walk['ms'] / max(walk['longest'], 1),
                           walk['plain_ms'], walk['bound_ms']))
    report['full_dp'] = [r for r in results
                         if r['name'] in ('pairwise', 'pairwise_walk')]
    log('full-matrix DP kernel (csrc/pairwise.cu) bit-equal to its plain '
        'version on %d calls, its walker (csrc/pairwise_walk.cu) equal to '
        'its plain version on every call with moves:'
        % len([r for r in results if r['name'] == 'pairwise']))
    for text in line:
        log('  ' + text)


def walk_against_plain(fwd, config, tag):
    """The full DP's walker over a forward's outputs (score, end_i, end_j,
    moves on the card) against walk_full_plain: headers and runs equal.
    Returns its result row: the launch's CUDA-event time (3 runs), the
    plain version's host time, steps, the longest walk and the bound."""
    from unicycler_tpu_torch.ops import pairwise as pw
    score, end_i, end_j, moves = fwd
    launch = lambda: pw.walk_full_cuda(moves, score, end_i, end_j, config)
    launch()
    ms, got = kernel_time(launch, reps=3)
    t0 = time.time()
    want = pw.walk_full_plain(moves, score, end_i, end_j, config)
    plain_ms = 1e3 * (time.time() - t0)
    g, w = pw.walk_records(got), pw.walk_records(want)
    if g != w:
        bad = [b for b, (x, y) in enumerate(zip(g, w)) if x != y]
        raise AssertionError('%s: the walker differs from its plain version '
                             'on pairs %s' % (tag, bad[:10]))
    nbytes, ops, steps = walk_full_cost(got)
    longest = max((sum(runs[0::2]) for _, runs in g), default=0)
    return {'name': 'pairwise_walk', 'ms': ms, 'plain_ms': plain_ms,
            'plain_device': 'cpu', 'bound_ms': bound_ms(nbytes, ops),
            'bytes': nbytes, 'steps': steps, 'longest': longest,
            'max_abs_err': 0}


def bridging_workload(seed, genome=5_000_000, plasmid=100_000,
                      families=((5000, 7, 250), (1300, 12, 250)),
                      per_copy=12, min_flank=1000):
    """The repeat genome of phase 7: a chromosome of `genome` bp with the
    families' copies planted between unique stretches (the anchors), a
    circular plasmid as one more segment, the collapsed overlap-0 GFA, and
    `per_copy` reads of the slice's length and error model around each
    copy. Returns (gfa_text, copies, reads, anchor segment numbers)."""
    from unicycler_tpu_torch import synth
    rng, chrom, _, gfa, copies, anchors = repeat_replicons(
        seed, genome, plasmid, families)
    reads = synth.reads_around(rng, chrom, copies, per_copy,
                               min_flank=min_flank)
    return gfa, copies, reads, anchors


def repeat_replicons(seed, genome, plasmid, families):
    """The replicons of phases 7 and 11 from `seed`: the chromosome with
    the families' copies planted (synth.repeat_genome) and the plasmid,
    with their collapsed overlap-0 GFA (the plasmid one segment linked to
    itself). Returns (the generator, to draw reads from next; chromosome;
    plasmid; gfa_text; copies; anchor segment numbers)."""
    import numpy as np
    from unicycler_tpu_torch import synth
    rng = np.random.default_rng(seed)
    n_copies = sum(c for _, c, _ in families)
    unique = (genome - sum(n * c for n, c, _ in families)) // (n_copies + 1)
    chrom, gfa, copies = synth.repeat_genome(rng, [unique] * (n_copies + 1),
                                             list(families))
    lines = gfa.splitlines(keepends=True)
    n_seg = sum(line.startswith('S\t') for line in lines)
    pnum = n_seg + 1
    pseq = synth.random_replicons(rng, [plasmid])[0]
    gfa = ''.join(lines[:n_seg]) + 'S\t%d\t%s\tDP:f:1.0\n' % (pnum, pseq) \
        + ''.join(lines[n_seg:]) + 'L\t%d\t+\t%d\t+\t0M\n' % (pnum, pnum)
    return (rng, chrom, pseq, gfa, copies,
            list(range(1, n_copies + 2)) + [pnum])


def phase_bridging(args, dev, report, workload=None):
    """Long-read bridging on the card: align, bridge, check."""
    from unicycler_tpu_torch import misc
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.align.semi_global import \
        semi_global_align_long_reads
    from unicycler_tpu_torch.bridges.long_read import \
        create_long_read_bridges
    from unicycler_tpu_torch.graph.assembly_graph import AssemblyGraph
    from unicycler_tpu_torch.io.fastx import Read, Reference
    from unicycler_tpu_torch.ops import banded, cuda_lib, dispatch
    from unicycler_tpu_torch.ops import pairwise as pw
    from unicycler_tpu_torch.ops import tape as tape_ops
    from unicycler_tpu_torch.utils import trace

    log('== phase 7: bridging (create_long_read_bridges on %s)' % dev)
    t0 = time.time()
    gfa, copies, reads, anchor_nums = workload or bridging_workload(
        args.seed)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    gfa_path = os.path.join(os.path.dirname(args.out), 'bridging.gfa')
    with open(gfa_path, 'w') as f:
        f.write(gfa)
    graph = AssemblyGraph(gfa_path, 0)
    os.remove(gfa_path)
    refs = [Reference(str(n), s.forward_sequence)
            for n, s in sorted(graph.segments.items())]
    read_dict = {n: Read(n, s, None) for n, s, _ in reads}
    names = [n for n, _, _ in reads]
    scheme = AlignmentScoringScheme('3,-6,-5,-2')
    log('graph: %d segments, %d bp; %d repeat copies; %d reads, %d bp '
        '(set-up %.1f s)'
        % (len(graph.segments), sum(len(s.forward_sequence) for s in
                                    graph.segments.values()), len(copies),
           len(reads), sum(len(s) for _, s, _ in reads), time.time() - t0))

    random.seed(args.seed)
    sync(dev)
    cuda_lib.reset_launches()
    t0 = time.time()
    semi_global_align_long_reads(refs, None, read_dict, names, None, 1,
                                 scheme, [None], False, 50, None, None, 0, 0,
                                 None, device=dev)
    sync(dev)
    align_wall = time.time() - t0
    align_launches = dict(cuda_lib.LAUNCHES)
    min_scaled = misc.get_percentile(
        [a.scaled_score for n in names for a in read_dict[n].alignments],
        5.0)
    anchors = [graph.segments[n] for n in anchor_nums]

    # observe every alignment of consensus and path scoring, and every
    # banded and full-matrix DP call with its results
    captured = []
    banded_calls = []
    pair_calls = []
    inner = dispatch.batch_align
    inner_banded = banded.align_banded
    inner_pairs = pw.align_pairs

    def observed_pairs(q_list, r_list, **kw):
        out = inner_pairs(q_list, r_list, **kw)
        pair_calls.append((q_list, r_list, kw, out))
        return out

    def observed_banded(tasks, scoring, config=None, band=25,
                        need_cigar=True, device=None):
        out = inner_banded(tasks, scoring, config=config, band=band,
                           need_cigar=need_cigar, device=device)
        banded_calls.append((tasks, scoring, config, band, need_cigar, out))
        return out

    def observed(q_list, r_list, scoring, config, band=1000, need_cigar=True,
                 device=None):
        out = inner(q_list, r_list, scoring, config, band, need_cigar,
                    device=device)
        if need_cigar:
            captured.extend((q, r, pa, scoring)
                            for q, r, pa in zip(q_list, r_list, out))
        return out

    trace.reset()
    trace.enable()
    cuda_lib.TIMINGS = []
    dispatch.batch_align = observed
    banded.align_banded = observed_banded
    pw.align_pairs = observed_pairs
    sync(dev)
    cuda_lib.reset_launches()
    t0 = time.time()
    try:
        bridges = create_long_read_bridges(graph, read_dict, names, anchors,
                                           0, min_scaled, 1, scheme, 50,
                                           False, 10.0, device=dev)
        sync(dev)
    finally:
        dispatch.batch_align = inner
        banded.align_banded = inner_banded
        pw.align_pairs = inner_pairs
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    timings, cuda_lib.TIMINGS = cuda_lib.TIMINGS, None
    trace.disable()
    counters = trace.as_dict()['counters']
    spans = trace.as_dict()['spans']

    per_kernel = kernel_costs(timings)

    truth = {(cp.left, cp.right): list(cp.path) for cp in copies}
    found, right = set(), 0
    for b in bridges:
        start, end = b.start_segment, b.end_segment
        graph_path = list(b.graph_path)
        if start < 0:
            start, end = -end, -start
            graph_path = [-x for x in reversed(graph_path)]
        if (start, end) in truth:
            found.add((start, end))
            right += graph_path == truth[(start, end)]
    missing = sorted(set(truth) - found)
    frac = right / max(len(bridges), 1)
    tally_bad = degenerate = 0
    for q, r, pa, scoring in captured:
        if not pa.cigar:
            degenerate += 1
        elif retally(q, r, pa, scoring) != pa.score:
            tally_bad += 1
    widths = {k[len('tape.rows.'):]: v for k, v in counters.items()
              if k.startswith('tape.rows.W')}
    busy = sum(a['ms'] for a in per_kernel.values())
    # every row forward launch: tracks, cluster size, SMs busy, time
    row_launches = [
        {'tracks': outs[0].shape[0], 'C': outs[7],
         'sms': outs[0].shape[0] * outs[7], 'L': outs[0].shape[1],
         'ms': e0.elapsed_time(e1),
         'bound_ms': bound_ms(*tape_fwd_cost(*outs)[:2])}
        for name, e0, e1, outs in timings if name == 'tape_fwd']
    # the banded calls again in the JAX package's row layout (the parent
    # commit's), on the card: per-task results must not change
    row_calls = [c for c in banded_calls
                 if not banded.use_wavetape(banded.band_width(c[3]))]
    card_layout = tape_ops.build_row_launches
    tape_ops.build_row_launches = \
        lambda t, W, corridor, budget=None: tape_ops.build_tapes(t, W,
                                                                 corridor)
    try:
        replay_same = sum(
            inner_banded(t, sc, config=cf, band=bd, need_cigar=nc,
                         device=dev) == out
            for t, sc, cf, bd, nc, out in row_calls)
    finally:
        tape_ops.build_row_launches = card_layout
    # every full-matrix DP call again through the plain versions of the
    # forward (on the card) and the walker (the host decode): every
    # PairAlignment must be equal
    t1 = time.time()
    kernel_route = pw.align_batch_device, pw.walk_full_cuda
    pw.align_batch_device = pw.align_batch_plain
    pw.walk_full_cuda = pw.walk_full_plain
    try:
        pairs_same = sum(inner_pairs(q, r, **kw) == out
                         for q, r, kw, out in pair_calls)
    finally:
        pw.align_batch_device, pw.walk_full_cuda = kernel_route
    pairs_replay_s = time.time() - t1
    # the moves bytes the calls made: what a host decode copies back
    moves_bytes = sum(
        len(q) * max(max(len(x) for x in q), 1)
        * (max(max(len(x) for x in r), 1) + 1)
        for q, r, kw, _ in pair_calls if kw.get('need_cigar', True))
    fetch_bytes = int(counters.get('full_dp.fetch_bytes', 0))
    digest = hashlib.sha256(json.dumps(sorted(
        (b.start_segment, b.end_segment, list(b.graph_path),
         round(float(b.quality), 6)) for b in bridges)).encode()).hexdigest()
    log('alignment: %.2f s wall, launches %s'
        % (align_wall, json.dumps(align_launches)))
    log('bridging: %.2f s wall, %d bridges, kernel launches %s'
        % (wall, len(bridges), json.dumps(launches)))
    log('row-tape padded rows by W: %s; row forward launches (tracks, '
        'blocks a track, SMs busy, L, ms, bound ms): %s'
        % (json.dumps(widths), json.dumps(
            [(r['tracks'], r['C'], r['sms'], r['L'], round(r['ms'], 3),
              round(r['bound_ms'], 4)) for r in row_launches])))
    log('row-tape counters: %s' % json.dumps(
        {k: v for k, v in sorted(counters.items())
         if k.startswith('tape.')}))
    log('banded calls of W > 2048 replayed in the JAX package\'s row layout '
        '(the parent commit\'s): %d/%d give the same results; bridges '
        'sha256 %s' % (replay_same, len(row_calls), digest))
    log('full-matrix DP calls replayed through align_batch_plain on the '
        'card and walk_full_plain: %d/%d give equal PairAlignments (%d '
        'pairs, %.1f s)'
        % (pairs_same, len(pair_calls),
           sum(len(c[0]) for c in pair_calls), pairs_replay_s))
    log('full DP fetched %d bytes to the host (full_dp.fetch_bytes); its '
        'calls made %d bytes of moves (%.2f%%), which stayed on the card'
        % (fetch_bytes, moves_bytes,
           100.0 * fetch_bytes / max(moves_bytes, 1)))
    log('pairs: %d full-matrix DP, %d banded; %d alignments re-tallied, %d '
        'degenerate (empty CIGAR)'
        % (counters.get('dispatch.full_dp_pairs', 0),
           counters.get('dispatch.banded_pairs', 0), len(captured),
           degenerate))
    log_kernel_times(per_kernel, launches)
    log('device busy at most %.1f%% of the bridging wall (kernel time / '
        'wall)' % (100 * busy * 1e-3 / wall))
    log('host spans (s): %s' % json.dumps(
        {k: v['seconds'] for k, v in spans.items()}))
    log('placement: %d/%d planted adjacencies bridged, %d/%d bridges on the '
        'true allele path (%.1f%%); %d CIGAR tally mismatches'
        % (len(found), len(truth), right, len(bridges), 100 * frac,
           tally_bad))
    report['bridging'] = {
        'align_wall_s': align_wall, 'wall_s': wall, 'bridges': len(bridges),
        'planted': len(truth), 'bridged': len(found), 'true_path': right,
        'alignments': len(captured), 'degenerate': degenerate,
        'launches': launches, 'align_launches': align_launches,
        'per_kernel': per_kernel, 'counters': counters, 'spans': spans,
        'row_launches': row_launches, 'row_calls': len(row_calls),
        'row_calls_same_in_jax_layout': replay_same,
        'full_dp_calls': len(pair_calls),
        'full_dp_calls_same_as_plain': pairs_same,
        'full_dp_replay_s': pairs_replay_s,
        'full_dp_fetch_bytes': fetch_bytes,
        'full_dp_moves_bytes': moves_bytes,
        'bridges_sha256': digest}
    if missing:
        raise AssertionError('planted adjacencies without a bridge: %s'
                             % missing)
    if frac < 0.95:
        raise AssertionError('only %.1f%% of bridges take the true path'
                             % (100 * frac))
    if tally_bad:
        raise AssertionError('%d CIGARs do not re-tally to their score'
                             % tally_bad)
    if launches['tape_fwd'] <= 0 or launches['tape_walk'] <= 0:
        raise AssertionError('bridging did not go through the row-tape '
                             'kernels')
    if replay_same != len(row_calls):
        raise AssertionError('%d banded calls differ from the JAX package\'s '
                             'row layout' % (len(row_calls) - replay_same))
    if counters.get('tape.short_launches', 0):
        raise AssertionError('row launches below min(tasks, 132) tracks that '
                             'the moves budget could hold: %s' % ', '.join(
                                 sorted(k for k in counters
                                        if k.startswith('tape.short.'))))
    if counters.get('dispatch.full_dp_pairs', 0) <= 0:
        raise AssertionError('bridging did not run the full-matrix DP')
    if launches['pairwise'] <= 0:
        raise AssertionError('bridging did not launch the full-matrix DP '
                             'kernel')
    if launches['pairwise_walk'] <= 0:
        raise AssertionError('bridging did not walk the full-matrix DP on '
                             'the card')
    if pairs_same != len(pair_calls):
        raise AssertionError('%d full-matrix DP calls differ from their '
                             'plain version' % (len(pair_calls) - pairs_same))
    return launches, per_kernel


def microbench_tasks(n, W, drift, B=8, seed=0):
    """The tasks of scripts/wavefront_microbench.py
    (tools/wavefront_ab.microbench_tasks: B reads of n bases planted at
    90% identity W/2 diagonals into their references, per-row band starts
    c[i] = i + drift * i // 16). Returns (q, r, c_rows, n_acts, m_acts)
    and the same tasks as BandedTasks whose anchors make build_corridor
    give exactly c_rows."""
    import numpy as np
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.tools.wavefront_ab import microbench_tasks as mt
    q, r, c_rows, n_acts, m_acts = mt(n, W, drift, B, seed)
    m = int(m_acts[0])
    rows = np.arange(n + 1, dtype=np.int64)
    tasks = [bo.BandedTask(q[b], r[b], rows.astype(np.int32),
                           (c_rows[b] + W // 2).astype(np.int32))
             for b in range(B)]
    for t, c in zip(tasks, c_rows):
        if not np.array_equal(bo.build_corridor(
                t.corridor_read, t.corridor_ref, n, m, W), c):
            raise AssertionError('corridor anchors do not rebuild c_rows')
    return q, r, c_rows, n_acts, m_acts, tasks


def phase_wavefront(dev, results, report):
    """Kernel 7, the per-task wavefront forward, at the shapes of
    scripts/wavefront_microbench.py, at two wide bands (short tasks) and
    on 160 tasks: against its plain version, and up to W 2048 its
    (score, end_i, end_j) against the wave route (kernels 1-2)."""
    import torch
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import wavefront as wf
    from unicycler_tpu_torch.ops.pairwise import NEG, SEMI_GLOBAL, Scoring

    log('== phase 9: per-task wavefront forward (wavefront_batch_corridor)')
    scoring = Scoring(3, -6, -5, -2)
    launches = 0
    entry_ms = 0.0
    rows = []
    # (W, drift a 16 rows, rows a task, tasks)
    for W, drift, n, B in ((512, 0, 2048, 8), (512, 4, 2048, 8),
                           (1024, 0, 2048, 8), (1024, 4, 2048, 8),
                           (4096, 4, 256, 8), (16384, 4, 256, 8),
                           (1024, 4, 1024, 160)):
        q, r, c_rows, n_acts, m_acts, tasks = microbench_tasks(n, W, drift,
                                                               B)
        par, db, zq, zr, a_lo, n_groups, Wcap, GWp, _ = wf._prepare(
            q, r, c_rows, n_acts, m_acts, W)
        args = [torch.from_numpy(x).to(dev) for x in (par, db, zq, zr)]
        kw = dict(W=W, Wcap=Wcap, a_lo=a_lo, scoring=scoring,
                  config=SEMI_GLOBAL)
        fwd = lambda: wf.wavefront_forward_cuda(*args, **kw)
        fwd()
        ms, out_k = cuda_time(fwd, reps=3)
        plain_ms, out_p = cuda_time(
            lambda: wf.wavefront_forward_plain(*args, **kw))
        err = max(exact('wavefront_fwd ' + nm, a, b) for nm, a, b in
                  zip(('hatn', 'lcv', 'lci'), out_k, out_p))
        # the cells the function needs: W band cells a row. The kernel
        # computes one cell a lane pair and wavefront (the real-parity
        # lanes) over windows 4/3 as wide as the lanes a warp owns.
        cells = int(n_acts.sum(dtype='int64')) * W
        nbytes = sum(x.numel() * x.element_size() for x in args + list(out_k))
        results.append({'name': 'wavefront_fwd', 'W': W, 'bt': B,
                        'drift': drift, 'rows': n, 'groups': n_groups,
                        'plan': list(wf.launch_plan(B, W)), 'ms': ms,
                        'plain_ms': plain_ms,
                        'bound_ms': bound_ms(nbytes,
                                             cells * OPS_PER_CELL_WAVEFRONT),
                        'bytes': nbytes, 'cells': cells,
                        'max_abs_err': err,
                        'summary': (W, drift, B) == (1024, 0, 8)})

        # the entry, counted as this kernel's path, then the wave route
        cuda_lib.reset_launches()
        cuda_lib.TIMINGS = []
        score, ei, ej = wf.wavefront_batch_corridor(
            q, r, c_rows, n_acts, m_acts, scoring, SEMI_GLOBAL, W,
            device=dev)
        launches += cuda_lib.LAUNCHES['wavefront_fwd']
        entry_ms += sum(e0.elapsed_time(e1) for _, e0, e1, _ in
                        cuda_lib.TIMINGS)
        cuda_lib.TIMINGS = None
        row = {'W': W, 'drift': drift, 'tasks': B, 'rows': n,
               'groups': n_groups, 'ms': ms, 'us_per_row': 1e3 * ms / n,
               'us_per_group': 1e3 * ms / n_groups}
        if W > 2048:
            # the wave route takes W <= 2048; wider bands take the row
            # route, whose per-row band differs from the kernel's windows
            rows.append(row)
            log('W=%5d drift %d/16 B=%d n=%d  wavefront %.3f ms = %.3f us a '
                'group of %d (plain %.0f ms)  bit-equal'
                % (W, drift, B, n, ms, 1e3 * ms / n_groups, n_groups,
                   plain_ms))
            continue
        cuda_lib.TIMINGS = []
        route, ctr = retry_counters(lambda: bo.align_banded_tape(
            tasks, scoring, SEMI_GLOBAL, W, True, device=dev))
        torch.cuda.synchronize()
        timings, cuda_lib.TIMINGS = cuda_lib.TIMINGS, None
        wave_ms = sum(e0.elapsed_time(e1) for nm, e0, e1, _ in timings
                      if nm == 'wavetape_fwd')
        if ctr.get('tape.retry', 0):
            raise AssertionError('the wave route retried %d tasks'
                                 % ctr['tape.retry'])
        compared = 0
        for b, pa in enumerate(route):
            if int(score[b]) <= NEG // 2:
                if pa.score != 0 or pa.cigar:
                    raise AssertionError('task %d: NEG in the wavefront, '
                                         'not in the wave route' % b)
                continue
            if (pa.score, pa.s1_end, pa.s2_end) != (int(score[b]),
                                                    int(ei[b]), int(ej[b])):
                raise AssertionError(
                    'task %d: wavefront (%d, %d, %d) != wave route (%d, %d, '
                    '%d)' % (b, score[b], ei[b], ej[b], pa.score, pa.s1_end,
                             pa.s2_end))
            compared += 1
        row.update(wave_fwd_ms=wave_ms, wave_us_per_row=1e3 * wave_ms / n,
                   compared=compared)
        rows.append(row)
        log('W=%5d drift %d/16 B=%d n=%d  wavefront %.3f ms = %.3f us/row '
            '(plain %.0f ms)  bit-equal; wave forward %.3f ms = %.3f us/row; '
            '%d/%d ends equal to the wave route'
            % (W, drift, B, n, ms, 1e3 * ms / n, plain_ms, wave_ms,
               1e3 * wave_ms / n, compared, B))
        if compared < B // 2:
            raise AssertionError('too few tasks compared')
    if launches <= 0:
        raise AssertionError('the entry did not launch the wavefront kernel')
    report['wavefront'] = {'rows': rows, 'launches': launches,
                           'entry_ms': entry_ms}
    return launches, entry_ms


def assembly_workload(seed, genome=5_000_000, plasmid=100_000, depth=20.0):
    """Phase 10's workload: a chromosome and a plasmid (both circular)
    from `seed`, with long reads of the slice's length and error model at
    `depth`-fold coverage (synth.simulate_read_set)."""
    import numpy as np
    from unicycler_tpu_torch import synth
    rng = np.random.default_rng(seed)
    reps = synth.random_replicons(rng, [genome, plasmid])
    return reps, synth.simulate_read_set(rng, reps, depth)


def identity_to_truth(seqs, reps, dev, chunk=10000, placements=None):
    """Cut the assembled sequences ((name, sequence) pairs) into
    `chunk`-bp pieces, align them to the truth replicons (each extended by
    `chunk` bases across its origin) with align_reads_to_refs, and return
    (identity of the pieces' best alignments, weighted by piece length;
    fraction of the genome those alignments cover; the pieces under 99%
    identity, as (piece, identity, replicon, start, end of its alignment
    on the truth); pieces; pieces aligned). Given a list `placements`,
    appends (sequence name, piece offset, replicon, start, end, reverse)
    of each aligned piece's best alignment to it."""
    import numpy as np
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.align.semi_global import align_reads_to_refs
    from unicycler_tpu_torch.io.fastx import Read, Reference
    pieces = []
    for name, seq in sorted(seqs):
        for k in range(0, len(seq), chunk):
            if len(seq) - k >= 1000:
                pieces.append(Read('%s_%d' % (name, k), seq[k:k + chunk],
                                   None))
                pieces[-1].origin = (name, k)
    refs = [Reference(str(i), s + s[:chunk]) for i, s in enumerate(reps)]
    align_reads_to_refs(pieces, refs, AlignmentScoringScheme('3,-6,-5,-2'),
                        low_score_threshold=70.9, device=dev)
    cover = [np.zeros(len(s), bool) for s in reps]
    ident = length = aligned = 0
    low = []
    for piece in pieces:
        if not piece.alignments:
            continue
        a = max(piece.alignments, key=lambda x: x.raw_score)
        aligned += 1
        ident += a.percent_identity * piece.get_length()
        length += piece.get_length()
        ri = int(a.ref.name)
        if a.percent_identity < 99.0:
            low.append((piece.name, a.percent_identity, ri, a.ref_start_pos,
                        a.ref_end_pos))
        cover[ri][np.arange(a.ref_start_pos, a.ref_end_pos)
                  % len(reps[ri])] = True
        if placements is not None:
            placements.append(piece.origin + (ri, a.ref_start_pos,
                                              a.ref_end_pos,
                                              bool(a.rev_comp)))
    return (ident / max(length, 1), sum(int(c.sum()) for c in cover)
            / sum(len(s) for s in reps), low, len(pieces), aligned)


def write_fastq(path, sim, qual=','):
    """The simulated reads as FASTQ, every base at one quality (',' is
    Q11, about the simulator's 8% error)."""
    with open(path, 'w') as f:
        for name, seq, _ in sim:
            f.write('@%s\n%s\n+\n%s\n' % (name, seq, qual * len(seq)))


def expected_rotation(seq, args_ns):
    """The sequence rotate_completed_replicons should make of a circular
    replicon `seq`: at its best start gene (rotation.find_start_gene on
    the bundled genes), else at rotation.canonical_rotation; and which."""
    from unicycler_tpu_torch.graph.string_graph import StringGraphSegment
    from unicycler_tpu_torch.pipeline import rotation
    try:
        hit = rotation.find_start_gene(seq, rotation.BUNDLED_START_GENES,
                                       args_ns.start_gene_id,
                                       args_ns.start_gene_cov)
        start, flip, how = hit.start_pos, hit.flip, hit.qseqid
    except rotation.CannotFindStart:
        start, flip = rotation.canonical_rotation(seq)
        how = 'canonical'
    seg = StringGraphSegment('x', seq)
    seg.rotate_sequence(start, flip)
    return seg.forward_sequence, how


def phase_assembly(args, dev, report, workload=None):
    """The slice: a long-read-only run of the command line
    (pipeline.main.main: make_miniasm_string_graph with no short-read
    graph, rotation, assembly.gfa / assembly.fasta) on the card; checks
    every polish CIGAR, assembly.fasta against the truth, the polish
    quality and each circular replicon's rotation."""
    import torch
    from unicycler_tpu_torch.asm import polish
    from unicycler_tpu_torch.io.fastx import load_fasta
    from unicycler_tpu_torch.ops import banded, cuda_lib
    from unicycler_tpu_torch.pipeline import main as cli
    from unicycler_tpu_torch.utils import trace

    log('== phase 10: long-read-only assembly (python -m unicycler_tpu_torch '
        '-l reads.fastq on %s)' % dev)
    t0 = time.time()
    reps, sim = workload or assembly_workload(
        args.seed + 3, genome=ASSEMBLY_CHROMOSOME, depth=ASSEMBLY_DEPTH)
    out_dir = os.path.join(os.path.dirname(args.out), 'cli')
    os.makedirs(out_dir, exist_ok=True)
    reads_fq = os.path.join(out_dir, 'reads.fastq')
    write_fastq(reads_fq, sim)
    total = sum(len(s) for _, s, _ in sim)
    log('genome %s bp (circular), %d reads, %d bp (%.1fx; set-up %.1f s)'
        % ('+'.join(str(len(s)) for s in reps), len(sim), total,
           total / sum(len(s) for s in reps), time.time() - t0))

    # observe every polish alignment (re-tallied at once, not kept), every
    # round's mapping quality and the replicons before rotation
    tally = {'checked': 0, 'bad': 0}
    qualities = []
    before_rotation = {}
    inner_align, inner_round = banded.align_banded, polish.polish_round
    inner_rotate = cli.rotate_completed_replicons

    def observed_align(tasks, scoring, config=None, band=25,
                       need_cigar=True, device=None):
        out = inner_align(tasks, scoring, config=config, band=band,
                          need_cigar=need_cigar, device=device)
        for t, pa in zip(tasks, out):
            if pa.cigar:
                tally['checked'] += 1
                tally['bad'] += retally(t.q, t.r, pa, scoring) != pa.score
        return out

    def observed_round(*a, **kw):
        out = inner_round(*a, **kw)
        qualities.append(out[1])
        return out

    def observed_rotate(graph, cli_args, counter):
        for name in graph.completed_circular_replicons():
            before_rotation[name] = graph.segments[name].forward_sequence
        report['cli_args'] = {k: v for k, v in vars(cli_args).items()
                              if k.startswith('start_gene')}
        return inner_rotate(graph, cli_args, counter)

    argv = ['-l', reads_fq, '-o', out_dir, '--verbosity', '0']
    trace.reset()
    trace.enable()
    cuda_lib.TIMINGS = []
    banded.align_banded, polish.polish_round = observed_align, observed_round
    cli.rotate_completed_replicons = observed_rotate
    sync(dev)
    cuda_lib.reset_launches()
    t0 = time.time()
    try:
        graph = cli.main(argv, device=dev)
        sync(dev)
    finally:
        banded.align_banded, polish.polish_round = inner_align, inner_round
        cli.rotate_completed_replicons = inner_rotate
        os.remove(reads_fq)
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    timings, cuda_lib.TIMINGS = cuda_lib.TIMINGS, None
    trace.disable()
    counters = trace.as_dict()['counters']
    spans = trace.as_dict()['spans']
    per_kernel = kernel_costs(timings)
    fasta = load_fasta(os.path.join(out_dir, 'assembly.fasta'))
    if not fasta:
        raise AssertionError('the command line wrote no sequence')

    lens = sorted((len(s) for _, s in fasta), reverse=True)
    acc, n50 = 0, 0
    for length in lens:
        acc += length
        if acc >= sum(lens) / 2:
            n50 = length
            break
    circular = sum(graph.segment_is_circular(n) for n in graph.segments)
    t1 = time.time()
    ident, covered, low, n_pieces, n_aligned = identity_to_truth(
        fasta, reps, dev)
    check_s = time.time() - t1
    # each circular replicon as rotation.py says: at its start gene, else
    # at its canonical rotation (the search run again on the sequence the
    # command line had before it rotated)
    t1 = time.time()
    rotations = []
    ns = argparse.Namespace(**report.get('cli_args', {}))
    for name, seq in sorted(before_rotation.items()):
        want, how = expected_rotation(seq, ns)
        got = graph.segments[name].forward_sequence
        rotations.append({'segment': name, 'length': len(seq), 'how': how,
                          'ok': got == want})
    rotation_check_s = time.time() - t1
    best = max(range(len(qualities)), key=lambda k: qualities[k])
    busy = sum(a['ms'] for a in per_kernel.values())
    log('assembly (command line): %.2f s wall; %d sequences (%d circular), '
        '%d bp, N50 %d, longest %s' % (wall, len(lens), circular, sum(lens),
                                       n50, lens[:3]))
    log('spans (s): %s' % json.dumps(
        {k: v['seconds'] for k, v in spans.items()
         if k.count('/') <= 1}))
    log('kernel launches: %s' % json.dumps(launches))
    tracks = wave_launch_shapes(timings, counters)
    log_kernel_times(per_kernel, launches)
    log('device busy at most %.1f%% of the assembly wall (kernel time / '
        'wall)' % (100 * busy * 1e-3 / wall))
    log('counters: %s' % json.dumps(
        {k: v for k, v in sorted(counters.items())
         if k.startswith(('retry.', 'tape.retry', 'wave.', 'tape.fetch'))}))
    log('polish: mapping quality by round %s (best round %d); %d CIGARs '
        're-tallied, %d off their score'
        % (['%.2f' % x for x in qualities], best, tally['checked'],
           tally['bad']))
    log('rotation: %.2f s (span); %s; checked in %.1f s'
        % (spans.get('rotation', {}).get('seconds', float('nan')),
           json.dumps(rotations), rotation_check_s))
    log('truth: %d pieces of 10 kb of assembly.fasta, %d aligned, identity '
        '%.3f%%, covering %.2f%% of the genome (%.1f s); pieces under 99%% '
        '(piece, identity, replicon, start, end): %s; assembly.gfa and '
        'assembly.fasta in %s'
        % (n_pieces, n_aligned, ident, 100 * covered, check_s,
           json.dumps(low), out_dir))
    report['assembly'] = {
        'wall_s': wall, 'reads': len(sim), 'read_bases': total,
        'genome': [len(s) for s in reps], 'unitigs': lens,
        'circular': circular, 'n50': n50, 'qualities': qualities,
        'retallied': tally['checked'], 'tally_bad': tally['bad'],
        'identity': ident, 'low_pieces': low, 'rotations': rotations,
        'covered': covered, 'launches': launches, 'wave_tracks': tracks,
        'per_kernel': per_kernel, 'counters': counters, 'spans': spans}
    if tally['bad']:
        raise AssertionError('%d polish CIGARs do not re-tally'
                             % tally['bad'])
    if not tally['checked']:
        raise AssertionError('polish aligned nothing')
    if ident < 99.0 or covered < 0.9:
        raise AssertionError('unitigs reach %.3f%% identity over %.1f%% of '
                             'the genome (gate: 99%% over 90%%)'
                             % (ident, 100 * covered))
    # A piece that crosses a layout deletion of the OLC (which the JAX
    # package's unpolished unitigs share) reads well under 99%, so the
    # gate is on how many pieces fall short, not on the lowest.
    if n_aligned < n_pieces or len(low) > 0.1 * n_pieces:
        raise AssertionError('%d of %d unitig pieces aligned, %d under 99%% '
                             'identity (gate: all, at most 10%%)'
                             % (n_aligned, n_pieces, len(low)))
    if qualities[best] <= qualities[0]:
        raise AssertionError('polish never raised the mapping quality above '
                             'round 0 (%.2f)' % qualities[0])
    if launches['wavetape_fwd'] <= 0 or launches['wavetape_walk'] <= 0:
        raise AssertionError('polish did not go through the wave kernels')
    if not circular or len(rotations) != circular:
        raise AssertionError('%d circular replicons, %d seen by the rotation'
                             % (circular, len(rotations)))
    if not all(r['ok'] for r in rotations):
        raise AssertionError('replicons not rotated as rotation.py says: %s'
                             % json.dumps(rotations))
    if 'rotation' not in spans:
        raise AssertionError('the rotation left no trace span')
    return launches, per_kernel


def hybrid_workload(seed, genome=HYBRID_CHROMOSOME, depth=HYBRID_DEPTH,
                    plasmid=100_000,
                    families=((5000, 7, 250), (1300, 12, 250))):
    """Phase 11's workload: phase 7's repeat genome (repeat_replicons) cut
    to `genome` bp, its collapsed overlap-0 GFA with copy counts as depths
    as the short-read graph, and long reads of the slice's length and error
    model over both replicons (both circular) at `depth`-fold coverage
    (synth.simulate_read_set). Returns (gfa_text, [chromosome, plasmid],
    copies, reads)."""
    from unicycler_tpu_torch import synth
    rng, chrom, pseq, gfa, copies, _ = repeat_replicons(seed, genome, plasmid,
                                                        families)
    reps = [chrom, pseq]
    return gfa, reps, copies, synth.simulate_read_set(rng, reps, depth)


def copies_resolved(seqs, chrom, copies, flank=200, gap=500, slack=100):
    """Which planted repeat copies an assembly resolves: a copy is resolved
    when one sequence holds the `flank` bases of unique sequence `gap`
    bases before the copy and those `gap` bases after it, on one strand,
    in order, as far apart as on the truth within `slack` bases (an
    allele is 250 bases longer or shorter). Circular sequences are
    searched across their origin. Returns one bool a copy."""
    from unicycler_tpu_torch.misc import reverse_complement
    doubled = [s + s for s in seqs]
    doubled += [reverse_complement(s) for s in doubled]
    out = []
    for cp in copies:
        left = chrom[cp.start - gap - flank:cp.start - gap]
        right = chrom[cp.end + gap:cp.end + gap + flank]
        want = (cp.end + gap) - (cp.start - gap - flank)
        ok = False
        for seq in doubled:
            i = seq.find(left)
            while i >= 0 and not ok:
                j = seq.find(right, i)
                ok = j >= 0 and abs((j - i) - want) <= slack
                i = seq.find(left, i + 1)
            if ok:
                break
        out.append(ok)
    return out


def misjoins(placements, reps, chunk=10000, slack=1000):
    """Consecutive 10 kb pieces of one assembled sequence whose best
    alignments disagree: on another replicon or strand, or not one piece
    apart on the truth (mod the replicon's length, within `slack`).
    placements: (sequence name, piece offset, replicon, start, end,
    reverse) of every aligned piece (identity_to_truth)."""
    by_seq = {}
    for name, k, ri, start, end, rev in placements:
        by_seq.setdefault(name, []).append((k, ri, start, end, rev))
    bad = []
    for name, pieces in sorted(by_seq.items()):
        pieces.sort()
        for a, b in zip(pieces, pieces[1:]):
            if b[0] - a[0] != chunk:
                continue
            length = len(reps[a[1]])
            step = (b[2] - a[2]) if not a[4] else (a[3] - b[3])
            if a[1] != b[1] or a[4] != b[4] or \
                    abs((step % length) - chunk) > slack:
                bad.append((name, a[0], b[0]))
    return bad


class ObservedRun(object):
    """Observers of one command-line run: every alignment re-tallied at
    once (the banded pairs of polish and bridging, the full-matrix pairs
    and the semi-global read alignments of contig placement and long
    reads to the graph; tally['bad'] counts those off their score) and
    the circular replicons before rotation (before_rotation, with the
    start-gene options in report[args_key]). Use as a context manager
    around cli.main."""

    def __init__(self, cli, report, args_key):
        from unicycler_tpu_torch.align import semi_global
        from unicycler_tpu_torch.ops import banded, pairwise
        self.mods = (banded, pairwise, semi_global, cli)
        self.report, self.args_key = report, args_key
        self.tally = {'checked': 0, 'bad': 0}
        self.before_rotation = {}

    def _check(self, q_list, r_list, out, scoring):
        for q, r, pa in zip(q_list, r_list, out):
            if pa is not None and pa.cigar:
                self.tally['checked'] += 1
                self.tally['bad'] += retally(q, r, pa, scoring) != pa.score

    def __enter__(self):
        banded, pairwise, semi_global, cli = self.mods
        self.inner = (banded.align_banded, pairwise.align_pairs,
                      semi_global.align_reads_to_refs,
                      cli.rotate_completed_replicons)
        inner_align, inner_pairs, inner_refs, inner_rotate = self.inner

        def observed_align(tasks, scoring, config=None, band=25,
                           need_cigar=True, device=None):
            out = inner_align(tasks, scoring, config=config, band=band,
                              need_cigar=need_cigar, device=device)
            self._check([t.q for t in tasks], [t.r for t in tasks], out,
                        scoring)
            return out

        def observed_pairs(q_list, r_list, scoring=None, **kw):
            out = inner_pairs(q_list, r_list, scoring=scoring, **kw)
            self._check(q_list, r_list, out, scoring)
            return out

        def observed_refs(reads, references, scoring_scheme, **kw):
            out = inner_refs(reads, references, scoring_scheme, **kw)
            for read in reads:
                for a in read.alignments:
                    self.tally['checked'] += 1
                    self.tally['bad'] += a.raw_score != a._pair.score
            return out

        def observed_rotate(graph, cli_args, counter):
            for num in graph.completed_circular_replicons():
                self.before_rotation[num] = \
                    graph.segments[num].forward_sequence
            self.report[self.args_key] = {
                k: v for k, v in vars(cli_args).items()
                if k.startswith('start_gene')}
            return inner_rotate(graph, cli_args, counter)

        banded.align_banded, pairwise.align_pairs = observed_align, \
            observed_pairs
        semi_global.align_reads_to_refs = observed_refs
        cli.rotate_completed_replicons = observed_rotate
        return self

    def __exit__(self, *exc):
        banded, pairwise, semi_global, cli = self.mods
        (banded.align_banded, pairwise.align_pairs,
         semi_global.align_reads_to_refs,
         cli.rotate_completed_replicons) = self.inner
        return False


def circular_plasmid(graph, plasmid_seq, report, args_key, before_rotation):
    """The circular segments (linked only to themselves) of a final graph,
    the ones among them that are the plasmid (its length, its sequence on
    either strand across its origin), and each such segment's rotation
    re-checked as rotation.py says (the chromosome's start-gene search
    would add ~11 s; phase 10 checks every replicon)."""
    circular = sorted(n for n in graph.segments
                      if graph.forward_links.get(n) == [n])
    doubled = plasmid_seq + plasmid_seq
    plasmid = [n for n in circular
               if graph.segments[n].get_length() == len(plasmid_seq)
               and (graph.segments[n].forward_sequence in doubled
                    or graph.segments[n].reverse_sequence in doubled)]
    ns = argparse.Namespace(**report.get(args_key, {}))
    rotations = []
    for num in plasmid:
        if num not in before_rotation:
            continue
        seq = before_rotation[num]
        want, how = expected_rotation(seq, ns)
        rotations.append({'segment': num, 'length': len(seq), 'how': how,
                          'ok': graph.segments[num].forward_sequence == want})
    ok = len(plasmid) == 1 and rotations and \
        all(r['ok'] for r in rotations) and plasmid[0] in before_rotation
    return circular, plasmid, rotations, bool(ok)


def phase_hybrid(args, dev, report, workload=None):
    """Hybrid assembly on a supplied short-read graph through the command
    line (`python -m unicycler_tpu_torch --short_read_graph G.gfa -l
    reads.fastq`, as pipeline.main.main runs it) on the card; checks every
    CIGAR of the phase, assembly.fasta against the truth, the planted
    repeat copies, the plasmid's circle and rotation and the kernels the
    phase launched."""
    import torch
    from unicycler_tpu_torch.io.fastx import load_fasta
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.pipeline import main as cli
    from unicycler_tpu_torch.utils import trace

    log('== phase 11: hybrid assembly (python -m unicycler_tpu_torch '
        '--short_read_graph G.gfa -l reads.fastq on %s)' % dev)
    t0 = time.time()
    gfa, reps, copies, sim = workload or hybrid_workload(args.seed + 4)
    out_dir = os.path.join(os.path.dirname(args.out), 'hybrid')
    os.makedirs(out_dir, exist_ok=True)
    gfa_file = os.path.join(out_dir, 'short_read_graph.gfa')
    reads_fq = os.path.join(out_dir, 'reads.fastq')
    with open(gfa_file, 'w') as f:
        f.write(gfa)
    write_fastq(reads_fq, sim)
    total = sum(len(s) for _, s, _ in sim)
    log('genome %s bp (circular), %d repeat copies; graph %d segments; %d '
        'reads, %d bp (%.1fx; set-up %.1f s)'
        % ('+'.join(str(len(s)) for s in reps), len(copies),
           gfa.count('S\t'), len(sim), total,
           total / sum(len(s) for s in reps), time.time() - t0))

    argv = ['--short_read_graph', gfa_file, '-l', reads_fq, '-o', out_dir,
            '--verbosity', '0', '--keep', '0']
    trace.reset()
    trace.enable()
    cuda_lib.TIMINGS = []
    sync(dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.time()
    try:
        with ObservedRun(cli, report, 'hybrid_cli_args') as obs:
            graph = cli.main(argv, device=dev)
            sync(dev)
    finally:
        os.remove(reads_fq)
        os.remove(gfa_file)
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    timings, cuda_lib.TIMINGS = cuda_lib.TIMINGS, None
    trace.disable()
    peak = torch.cuda.max_memory_allocated() if dev.type == 'cuda' else 0
    counters = trace.as_dict()['counters']
    spans = trace.as_dict()['spans']
    per_kernel = kernel_costs(timings)
    fasta = load_fasta(os.path.join(out_dir, 'assembly.fasta'))
    if not fasta or not os.path.isfile(os.path.join(out_dir,
                                                    'assembly.gfa')):
        raise AssertionError('the command line did not write both files')

    lens = sorted((len(s) for _, s in fasta), reverse=True)
    tally, before_rotation = obs.tally, obs.before_rotation
    t1 = time.time()
    placements = []
    ident, covered, low, n_pieces, n_aligned = identity_to_truth(
        fasta, reps, dev, placements=placements)
    joins = misjoins(placements, reps)
    resolved = copies_resolved([s for _, s in fasta], reps[0], copies)
    check_s = time.time() - t1
    circular, plasmid, rotations, plasmid_ok = circular_plasmid(
        graph, reps[1], report, 'hybrid_cli_args', before_rotation)
    busy = sum(a['ms'] for a in per_kernel.values())
    kinds = {k[len('bridges.'):]: v for k, v in counters.items()
             if k.startswith('bridges.')}
    log('hybrid assembly (command line): %.2f s wall; %d sequences (%d '
        'circular), %d bp, longest %s; peak device memory %.1f MiB'
        % (wall, len(lens), len(circular), sum(lens), lens[:3],
           peak / 2 ** 20))
    log('spans (s): %s' % json.dumps(
        {k: v['seconds'] for k, v in spans.items() if k.count('/') <= 1}))
    log('bridges by kind (count, s): %s' % json.dumps(
        {k: (v, spans.get(k + '_bridges', {}).get('seconds'))
         for k, v in sorted(kinds.items())}))
    log('kernel launches: %s' % json.dumps(launches))
    tracks = wave_launch_shapes(timings, counters)
    log_kernel_times(per_kernel, launches)
    log('device busy at most %.1f%% of the hybrid wall (kernel time / wall)'
        % (100 * busy * 1e-3 / wall))
    log('alignments: %d CIGARs re-tallied, %d off their score'
        % (tally['checked'], tally['bad']))
    log('repeat copies resolved: %d/%d; resolved (copy, left, right): %s; '
        'unresolved: %s'
        % (sum(resolved), len(copies), json.dumps(
            [(i, cp.left, cp.right) for i, cp in enumerate(copies)
             if resolved[i]]), json.dumps(
            [(i, cp.left, cp.right) for i, cp in enumerate(copies)
             if not resolved[i]])))
    log('plasmid: circular segment(s) %s; rotation %s; circular replicons '
        'rotated %s' % (plasmid, json.dumps(rotations),
                        sorted(before_rotation)))
    log('truth: %d pieces of 10 kb of assembly.fasta, %d aligned, identity '
        '%.3f%%, covering %.2f%% of the genome; misjoins %s; pieces under '
        '99%% %s (%.1f s); assembly.gfa and assembly.fasta in %s'
        % (n_pieces, n_aligned, ident, 100 * covered, json.dumps(joins),
           json.dumps(low), check_s, out_dir))
    report['hybrid'] = {
        'wall_s': wall, 'reads': len(sim), 'read_bases': total,
        'genome': [len(s) for s in reps], 'sequences': lens,
        'circular': circular, 'retallied': tally['checked'],
        'tally_bad': tally['bad'], 'identity': ident, 'covered': covered,
        'low_pieces': low, 'misjoins': joins, 'resolved': resolved,
        'plasmid': plasmid, 'rotations': rotations, 'launches': launches,
        'wave_tracks': tracks, 'per_kernel': per_kernel,
        'counters': counters, 'spans': spans, 'peak_bytes': peak,
        'bridges': kinds}
    if tally['bad']:
        raise AssertionError('%d CIGARs do not re-tally' % tally['bad'])
    if not tally['checked']:
        raise AssertionError('the hybrid run aligned nothing')
    if ident < 99.0 or covered < 0.99 or joins:
        raise AssertionError('assembly reaches %.3f%% identity over %.2f%% '
                             'of the genome with %d misjoins (gate: 99%% '
                             'over 99%%, none)'
                             % (ident, 100 * covered, len(joins)))
    if sum(resolved) < len(copies) - 1:
        raise AssertionError('%d of %d repeat copies resolved (gate: all '
                             'but one)' % (sum(resolved), len(copies)))
    if not plasmid_ok:
        raise AssertionError('the plasmid is not one circular contig '
                             'rotated as rotation.py says')
    for name in ('wavetape_fwd', 'wavetape_walk', 'tape_fwd', 'tape_walk',
                 'pairwise', 'pairwise_walk'):
        if launches[name] <= 0:
            raise AssertionError('the hybrid run did not launch %s' % name)
    return launches, per_kernel


def hybrid_reads_workload(seed, genome=SHORTREAD_CHROMOSOME,
                          plasmid=SHORTREAD_PLASMID, depth=SHORTREAD_DEPTH,
                          long_depth=HYBRID_DEPTH,
                          families=((5000, 2, 250), (1300, 4, 250))):
    """Phase 12's workload: a repeat genome (repeat_replicons: `genome` bp
    chromosome with the families' copies planted, and a `plasmid` bp
    plasmid, both circular), Illumina-style 2 x 150 bp pairs at
    `depth`-fold coverage over both (synth.short_read_pairs: 400 +- 40 bp
    inserts, 0.5% errors) and long reads of the slice's length and error
    model at `long_depth` (synth.simulate_read_set). Returns ([chromosome,
    plasmid], copies, pairs_1, pairs_2, long reads)."""
    from unicycler_tpu_torch import synth
    rng, chrom, pseq, _, copies, _ = repeat_replicons(seed, genome, plasmid,
                                                      families)
    reps = [chrom, pseq]
    pairs_1, pairs_2 = synth.short_read_pairs(rng, reps, depth)
    return reps, copies, pairs_1, pairs_2, synth.simulate_read_set(
        rng, reps, long_depth)


def write_pairs_fastq(path, pairs):
    with open(path, 'w') as f:
        for name, seq, qual in pairs:
            f.write('@%s\n%s\n+\n%s\n' % (name, seq, qual))


class HostMemorySampler(object):
    """Peak resident set of this process while the context is open,
    sampled from /proc/self/statm every `period` seconds by a thread
    (ru_maxrss is the peak since the process started, which an earlier
    phase may hold)."""

    def __init__(self, period=0.05):
        import threading
        self.period, self.peak = period, 0
        self.page = os.sysconf('SC_PAGE_SIZE')
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self):
        with open('/proc/self/statm') as f:
            self.peak = max(self.peak, int(f.read().split()[1]) * self.page)

    def _run(self):
        while not self.stop.wait(self.period):
            self._sample()

    def __enter__(self):
        self._sample()
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self._sample()
        return False


def card_kmer_counts(reads, dev, ks=(21, 31)):
    """kmer_count.count_spectrum on the card against the host np.unique
    (asm/correct.count_spectrum) at each k, array for array; returns
    {k: (k-mers counted, distinct, host s, card s)} and raises on a
    difference."""
    import numpy as np
    from unicycler_tpu_torch.asm import correct
    from unicycler_tpu_torch.ops import kmer_count
    out = {}
    for k in ks:
        t = time.time()
        want_k, want_c = correct.count_spectrum(reads, k)
        host_s = time.time() - t
        sync(dev)
        t = time.time()
        got_k, got_c = kmer_count.count_spectrum(reads, k, device=dev)
        sync(dev)
        card_s = time.time() - t
        if not (np.array_equal(got_k, want_k)
                and np.array_equal(got_c, want_c)):
            raise AssertionError('k = %d: the card k-mer count differs from '
                                 'np.unique' % k)
        out[k] = (int(want_c.sum()), len(want_k), host_s, card_s)
    return out


def phase_shortread(args, dev, report, workload=None):
    """Unicycler's default command line (`python -m unicycler_tpu_torch -1
    R1 -2 R2 -l long.fastq`, as pipeline.main.main runs it) on the card:
    the de Bruijn build from the pairs, then the hybrid pipeline; checks
    every CIGAR of the phase, assembly.fasta against the truth, the planted
    repeat copies, the plasmid's circle and rotation, the de Bruijn spans,
    the wave kernels' launches and the card k-mer count of the corrected
    pairs."""
    import resource
    import shutil
    import torch
    from unicycler_tpu_torch.asm import correct
    from unicycler_tpu_torch.io.fastx import load_fasta
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.pipeline import main as cli
    from unicycler_tpu_torch.utils import trace

    log('== phase 12: the default command line (python -m unicycler_tpu_torch '
        '-1 r1.fastq -2 r2.fastq -l long.fastq on %s)' % dev)
    t0 = time.time()
    reps, copies, pairs_1, pairs_2, sim = workload or hybrid_reads_workload(
        args.seed + 5)
    base = os.path.dirname(args.out)
    reads_dir = os.path.join(base, 'reads12')
    out_dir = os.path.join(base, 'shortread')
    os.makedirs(reads_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    r1, r2 = os.path.join(reads_dir, 'r1.fastq'), os.path.join(reads_dir,
                                                               'r2.fastq')
    rl = os.path.join(reads_dir, 'long.fastq')
    write_pairs_fastq(r1, pairs_1)
    write_pairs_fastq(r2, pairs_2)
    write_fastq(rl, sim)
    genome = sum(len(s) for s in reps)
    short_bases = sum(len(s) for _, s, _ in pairs_1 + pairs_2)
    long_bases = sum(len(s) for _, s, _ in sim)
    log('genome %s bp (circular), %d repeat copies; %d pairs, %d bp (%.1fx); '
        '%d long reads, %d bp (%.1fx); set-up %.1f s'
        % ('+'.join(str(len(s)) for s in reps), len(copies), len(pairs_1),
           short_bases, short_bases / genome, len(sim), long_bases,
           long_bases / genome, time.time() - t0))

    # the corrected reads, kept for the card k-mer count
    corrected = []
    inner_correct = correct.correct_reads

    def observed_correct(read_arrays, *a, **kw):
        out = inner_correct(read_arrays, *a, **kw)
        corrected[:] = out[0]
        return out

    argv = ['-1', r1, '-2', r2, '-l', rl, '-o', out_dir, '--verbosity', '0',
            '--keep', '0']
    trace.reset()
    trace.enable()
    cuda_lib.TIMINGS = []
    sync(dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    correct.correct_reads = observed_correct
    cuda_lib.reset_launches()
    t0 = time.time()
    try:
        with ObservedRun(cli, report, 'shortread_cli_args') as obs, \
                HostMemorySampler() as host_mem:
            graph = cli.main(argv, device=dev)
            sync(dev)
    finally:
        correct.correct_reads = inner_correct
        shutil.rmtree(reads_dir)
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    timings, cuda_lib.TIMINGS = cuda_lib.TIMINGS, None
    trace.disable()
    peak = torch.cuda.max_memory_allocated() if dev.type == 'cuda' else 0
    # ru_maxrss: the process's peak in KiB since it started
    rss_process = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    counters = trace.as_dict()['counters']
    spans = trace.as_dict()['spans']
    per_kernel = kernel_costs(timings)
    fasta = load_fasta(os.path.join(out_dir, 'assembly.fasta'))
    if not fasta or not os.path.isfile(os.path.join(out_dir,
                                                    'assembly.gfa')):
        raise AssertionError('the command line did not write both files')

    lens = sorted((len(s) for _, s in fasta), reverse=True)
    tally, before_rotation = obs.tally, obs.before_rotation
    t1 = time.time()
    placements = []
    ident, covered, low, n_pieces, n_aligned = identity_to_truth(
        fasta, reps, dev, placements=placements)
    joins = misjoins(placements, reps)
    resolved = copies_resolved([s for _, s in fasta], reps[0], copies)
    check_s = time.time() - t1
    circular, plasmid, rotations, plasmid_ok = circular_plasmid(
        graph, reps[1], report, 'shortread_cli_args', before_rotation)
    kcounts = card_kmer_counts(corrected, dev)
    busy = sum(a['ms'] for a in per_kernel.values())
    ladder = {int(k.split('.')[1][1:]): v for k, v in counters.items()
              if k.startswith('debruijn.k') and k.endswith('.score')}
    best_k = int(counters.get('debruijn.best_k', 0))
    kinds = {k[len('bridges.'):]: v for k, v in counters.items()
             if k.startswith('bridges.')}
    log('default command line: %.2f s wall; %d sequences (%d circular), %d '
        'bp, longest %s; peak device memory %.1f MiB; peak host memory '
        'during the run %.1f MiB (the process since it started %.1f MiB)'
        % (wall, len(lens), len(circular), sum(lens), lens[:3],
           peak / 2 ** 20, host_mem.peak / 2 ** 20, rss_process / 1024))
    log('spans (s): %s' % json.dumps(
        {k: v['seconds'] for k, v in spans.items() if k.count('/') == 0}))
    log('de Bruijn spans (s): %s' % json.dumps(
        {k: v['seconds'] for k, v in spans.items()
         if k.startswith('short_read_graph/')}))
    log('k ladder scores %s; best k %d; %d repeats split by read pairs, %d '
        'paired paths; final short-read polish %s'
        % (json.dumps({k: ladder[k] for k in sorted(ladder)}), best_k,
           counters.get('debruijn.pair_splits', 0),
           counters.get('debruijn.paths', 0),
           '%.2f s' % spans['final_polish']['seconds']
           if 'final_polish' in spans else
           'not run (the last bridging round made no bridge)'))
    log('bridges by kind (count, s): %s' % json.dumps(
        {k: (v, spans.get(k + '_bridges', {}).get('seconds'))
         for k, v in sorted(kinds.items())}))
    log('kernel launches: %s' % json.dumps(launches))
    tracks = wave_launch_shapes(timings, counters)
    log_kernel_times(per_kernel, launches)
    log('device busy at most %.1f%% of the wall (kernel time / wall)'
        % (100 * busy * 1e-3 / wall))
    log('card k-mer count of the %d corrected reads, equal to np.unique: %s'
        % (len(corrected), '; '.join(
            'k %d: %d k-mers, %d distinct, host %.3f s, card %.3f s'
            % ((k,) + v) for k, v in sorted(kcounts.items()))))
    log('alignments: %d CIGARs re-tallied, %d off their score'
        % (tally['checked'], tally['bad']))
    log('repeat copies resolved: %d/%d; unresolved (copy, left, right): %s'
        % (sum(resolved), len(copies), json.dumps(
            [(i, cp.left, cp.right) for i, cp in enumerate(copies)
             if not resolved[i]])))
    log('plasmid: circular segment(s) %s; rotation %s'
        % (plasmid, json.dumps(rotations)))
    log('truth: %d pieces of 10 kb of assembly.fasta, %d aligned, identity '
        '%.3f%%, covering %.2f%% of the genome; misjoins %s; pieces under '
        '99%% %s (%.1f s); assembly.gfa and assembly.fasta in %s'
        % (n_pieces, n_aligned, ident, 100 * covered, json.dumps(joins),
           json.dumps(low), check_s, out_dir))
    report['shortread'] = {
        'wall_s': wall, 'pairs': len(pairs_1), 'short_bases': short_bases,
        'long_reads': len(sim), 'long_bases': long_bases,
        'genome': [len(s) for s in reps], 'sequences': lens,
        'circular': circular, 'retallied': tally['checked'],
        'tally_bad': tally['bad'], 'identity': ident, 'covered': covered,
        'low_pieces': low, 'misjoins': joins, 'resolved': resolved,
        'plasmid': plasmid, 'rotations': rotations, 'launches': launches,
        'wave_tracks': tracks, 'per_kernel': per_kernel,
        'counters': counters, 'spans': spans, 'peak_bytes': peak,
        'host_peak_bytes': host_mem.peak, 'process_peak_kib': rss_process,
        'kmer_counts': {str(k): v for k, v in kcounts.items()},
        'ladder': ladder, 'best_k': best_k, 'bridges': kinds}
    if tally['bad']:
        raise AssertionError('%d CIGARs do not re-tally' % tally['bad'])
    if not tally['checked']:
        raise AssertionError('the run aligned nothing')
    if ident < 99.0 or covered < 0.99 or joins:
        raise AssertionError('assembly reaches %.3f%% identity over %.2f%% '
                             'of the genome with %d misjoins (gate: 99%% '
                             'over 99%%, none)'
                             % (ident, 100 * covered, len(joins)))
    if sum(resolved) < len(copies) - 1:
        raise AssertionError('%d of %d repeat copies resolved (gate: all '
                             'but one)' % (sum(resolved), len(copies)))
    if not plasmid_ok:
        raise AssertionError('the plasmid is not one circular contig '
                             'rotated as rotation.py says')
    want = ['short_read_graph/correct_reads',
            'short_read_graph/pair_resolution'] + [
        'short_read_graph/k%d/count_kmers' % k for k in sorted(ladder)]
    missing = [name for name in want if name not in spans]
    if len(ladder) != 8 or missing:
        raise AssertionError('de Bruijn spans: %d k values, missing %s'
                             % (len(ladder), missing))
    for name in ('wavetape_fwd', 'wavetape_walk', 'pairwise',
                 'pairwise_walk'):
        if launches[name] <= 0:
            raise AssertionError('the run did not launch %s' % name)
    return launches, per_kernel


PARALLEL_READS = 400        # phase 13c's reads, sharded over two ranks
PARALLEL_RANKS = 2


def pa_key(pa):
    """Everything a PairAlignment says, with the CIGAR as plain tuples."""
    return (int(pa.score), int(pa.s1_start), int(pa.s1_end),
            int(pa.s2_start), int(pa.s2_end),
            [(int(c), str(op)) for c, op in pa.cigar],
            int(pa.s1_len), int(pa.s2_len))


def alignment_map(reads):
    """read name -> sorted alignment tuples (coordinates, scores, CIGAR)."""
    return {read.name: sorted(
        (a.ref.name, bool(a.rev_comp), int(a.read_start_pos),
         int(a.read_end_pos), int(a.ref_start_pos), int(a.ref_end_pos),
         int(a.raw_score), round(float(a.scaled_score), 6),
         ''.join(a.cigar_parts))
        for a in read.alignments) for read in reads}


def pipeline_genome():
    """tests/test_distributed_pipeline.py's 9.8 kbp genome: two unique
    parts and two copies of a 400 bp repeat."""
    rng = random.Random(4242)
    repeat = ''.join(rng.choice('ACGT') for _ in range(400))
    a = ''.join(rng.choice('ACGT') for _ in range(5000))
    b = ''.join(rng.choice('ACGT') for _ in range(4000))
    return a + repeat + b + repeat


def pipeline_argv(data_dir, out):
    return ['-1', os.path.join(data_dir, 'r1.fastq'),
            '-2', os.path.join(data_dir, 'r2.fastq'),
            '-l', os.path.join(data_dir, 'long.fastq'),
            '-o', out, '--verbosity', '0', '--keep', '0',
            '--min_fasta_length', '100', '--no_rotate']


def _rank_counts(part, t0, dev, launches, trace):
    sync(dev)
    d = trace.as_dict()
    part.update({
        'wall_s': time.time() - t0, 'launches': dict(launches),
        'allgather_bytes': int(d['counters'].get('dist.allgather_bytes', 0)),
        'allgather_s': sum(v['seconds'] for k, v in d['spans'].items()
                           if k.split('/')[-1] == 'allgather')})


def parallel_rank(rank, world, port, seed, device, data_dir, out_dir, q):
    """One rank of phase 13c/13d in a spawned process: join the gloo group
    on localhost, align this rank's shard of phase 4's genome with 400
    reads (distributed_align_long_reads), then run the command line on the
    pipeline genome; put the results on q."""
    try:
        os.environ.update({
            'UNICYCLER_TPU_COORDINATOR': 'localhost:%d' % port,
            'UNICYCLER_TPU_NUM_PROCESSES': str(world),
            'UNICYCLER_TPU_PROCESS_ID': str(rank)})
        os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
        sys.path.insert(0, HERE)
        import torch
        from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
        from unicycler_tpu_torch.ops import cuda_lib
        from unicycler_tpu_torch.parallel import distributed as dist
        from unicycler_tpu_torch.pipeline.main import main as cli
        from unicycler_tpu_torch.utils import trace
        dev = torch.device(device)
        ctx = dist.maybe_initialize()
        refs, sim, Read = _load_genome(seed, PARALLEL_READS)
        reads = [Read(n, s, None) for n, s, _ in sim]
        out = {'index': ctx.index, 'count': ctx.count}
        trace.reset()
        trace.enable()
        cuda_lib.reset_launches()
        t0 = time.time()
        out['local_reads'] = dist.distributed_align_long_reads(
            reads, refs, AlignmentScoringScheme('3,-6,-5,-2'), ctx=ctx,
            device=dev, sensitivity_level=0)
        out['align'] = {}
        _rank_counts(out['align'], t0, dev, cuda_lib.LAUNCHES, trace)
        out['map'] = alignment_map(reads)
        trace.reset()
        cuda_lib.reset_launches()
        t0 = time.time()
        cli(pipeline_argv(data_dir, os.path.join(out_dir, 'p%d' % rank)),
            device=dev)
        out['cli'] = {}
        _rank_counts(out['cli'], t0, dev, cuda_lib.LAUNCHES, trace)
        with open(os.path.join(out_dir, 'p%d' % rank,
                               'assembly.fasta')) as f:
            out['fasta'] = f.read()
        out['jax_imported'] = 'jax' in sys.modules
        torch.distributed.destroy_process_group()
        q.put((rank, out))
    except BaseException as exc:          # surface in the parent
        import traceback
        q.put((rank, 'ERROR %r\n%s' % (exc, traceback.format_exc())))
        raise


def multi_sets(rng, seed):
    """Phase 13a's task sets: (name, tasks, config, W)."""
    import numpy as np
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import pairwise as pw
    grng = np.random.default_rng(seed + 5)     # phase 5's zigzag tasks
    zig = synth.zigzag_tasks(grng, [int(x) for x in
                                    grng.integers(300, 1500, 24)])
    return [('polish W512', [bo.BandedTask(*t) for t in
                             polish_like_tasks(rng, 300)],
             pw.SEMI_GLOBAL, 512),
            ('bridging W4096', [bo.BandedTask(*t) for t in
                                bridging_like_tasks(rng, 84)],
             pw.PATH_CONFIG, 4096),
            ('zigzag W128', [bo.BandedTask(*t) for t in zig],
             pw.FULLY_GLOBAL, 128)]


def compat_calls(seed):
    """Phase 13e's calls: (name, fn(compat, scheme, device)) on seeded
    sequences; the two 5 kbp global pairs take the banded route (the wave
    kernels), the rest the full-matrix DP."""
    rng = random.Random(seed)

    def seq(n):
        return ''.join(rng.choice('ACGT') for _ in range(n))

    def mutate(s, rate=0.05):
        out = []
        for base in s:
            r = rng.random()
            if r < rate / 3:
                continue
            if r < 2 * rate / 3:
                out.append(base + rng.choice('ACGT'))
            elif r < rate:
                out.append(rng.choice([b for b in 'ACGT' if b != base]))
            else:
                out.append(base)
        return ''.join(out)

    calls = []
    for k in range(2):
        s2 = seq(rng.randint(500, 800))
        glob, big = mutate(s2), seq(5000)
        big_q = mutate(big)
        head = mutate(s2[:rng.randint(150, 300)])
        path_q = head + seq(40)
        tail = mutate(s2[-rng.randint(150, 300):])
        inner = mutate(s2[50:300])
        left = seq(300) + s2[:200]
        seqs = [mutate(s2, 0.04) for _ in range(4)]
        calls += [
            ('fully_global %d' % k, lambda c, sc, d, a=glob, b=s2:
             c.fully_global_alignment(a, b, sc, band_size=100, device=d)),
            ('fully_global 5 kbp %d' % k, lambda c, sc, d, a=big_q, b=big:
             c.fully_global_alignment(a, b, sc, device=d)),
            ('path %d' % k, lambda c, sc, d, a=path_q, b=s2:
             c.path_alignment(a, b, sc, band_size=120, device=d)),
            ('semi_global_exhaustive %d' % k, lambda c, sc, d, a=inner, b=s2:
             c.semi_global_alignment_exhaustive(a, b, sc, device=d)),
            ('overlap %d' % k, lambda c, sc, d, a=left, b=s2:
             c.overlap_alignment(a, b, sc, 200, device=d)),
            ('start %d' % k, lambda c, sc, d, a=head, b=s2:
             c.start_alignment(a, b, sc, device=d)),
            ('end %d' % k, lambda c, sc, d, a=tail, b=s2:
             c.end_alignment(a, b, sc, device=d)),
            ('consensus %d' % k, lambda c, sc, d, a=seqs:
             c.consensus_alignment(a, [], sc, bandwidth=200, device=d))]
    calls.append(('random alignment mean', lambda c, sc, d:
                  c.get_random_sequence_alignment_mean_and_std_dev(
                      120, 12, sc, device=d)))
    return calls


def phase_parallel(args, dev, report):
    """Phase 13: the data-parallel and multi-process layer on the card.
    13a align_banded_multi over [cuda:0, cuda:0] (and every card when
    there are several) on three task sets, per task equal to one device's
    align_banded_tape; 13b sharded_banded_align and sharded_align_stats
    on a planted and a random batch, bit-equal to one unsharded launch of
    kernel 3 and to its plain version, the stats equal to numpy; 13c/13d
    two spawned ranks on the one card meeting over gloo on localhost:
    distributed_align_long_reads on phase 4's genome with 400 reads (each
    rank's full map equal to a single-process align_reads_to_refs) and the
    command line on the 9.8 kbp pipeline genome (both assemblies
    byte-equal to a single-process run); 13e each align/compat function
    on the card equal to its CPU route. Runs 13a, 13b and 13e, then the
    ranks, then the single-process references, so no timed run shares
    the card. Returns the launches of the phase's paths (13a-13e,
    comparison runs excluded)."""
    import multiprocessing as mp
    import shutil
    import numpy as np
    import torch
    from unicycler_tpu_torch.align import compat
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.align.semi_global import align_reads_to_refs
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import banded_kernel as bk
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import pairwise as pw
    from unicycler_tpu_torch.ops.encode import R_PAD
    from unicycler_tpu_torch.parallel import mesh as pmesh
    from unicycler_tpu_torch.pipeline.fake_reads import (
        make_fake_long_reads, make_fake_short_reads, write_fastq as wfq)
    from unicycler_tpu_torch.utils import trace

    log('== phase 13: parallel (align_banded_multi, sharded_banded_align, '
        'two gloo ranks on %s)' % dev)
    t_phase = time.time()
    par = {k: 0 for k in cuda_lib.LAUNCHES}
    rep = report.setdefault('parallel', {})

    def count(fn):
        cuda_lib.reset_launches()
        out = fn()
        sync(dev)
        for k, v in cuda_lib.LAUNCHES.items():
            par[k] += v
        return out, dict(cuda_lib.LAUNCHES)

    # 13a: align_banded_multi against one device's tape route
    scoring = pw.Scoring(3, -6, -5, -2)
    meshes = [('cuda:0 x2', pmesh.get_mesh([dev, dev]))]
    if torch.cuda.device_count() > 1:
        meshes.append(('every card', pmesh.get_mesh()))
    rows = []
    for name, tasks, config, W in multi_sets(
            np.random.default_rng(args.seed + 13), args.seed):
        # the reference (which also warms the route up), then the multi
        # route, then the one-device route again for its wall
        want = bo.align_banded_tape(tasks, scoring, config, W, True,
                                    device=dev)
        timed_single = []
        for mname, mesh in meshes:
            trace.reset()
            trace.enable()
            t0 = time.time()
            got, launches = count(lambda: bo.align_banded_multi(
                tasks, scoring, config, W, True, mesh))
            multi_s = time.time() - t0
            counters = trace.as_dict()['counters']
            trace.disable()
            if not timed_single:
                t0 = time.time()
                bo.align_banded_tape(tasks, scoring, config, W, True,
                                     device=dev)
                sync(dev)
                timed_single.append(time.time() - t0)
            single_s = timed_single[0]
            bad = sum(pa_key(g) != pa_key(w) for g, w in zip(got, want))
            parts = [{'tasks': int(counters.get('multi.p%d.tasks' % k,
                                                0)),
                      'rows': int(counters.get('multi.p%d.rows' % k, 0)),
                      'launches': int(counters.get(
                          'multi.p%d.launches' % k, 0))}
                     for k in range(len(mesh))]
            row = {'set': name, 'mesh': mname, 'W': W,
                   'tasks': len(tasks), 'multi_s': multi_s,
                   'single_s': single_s, 'launches': launches,
                   'partitions': parts, 'differ': bad,
                   'retries': int(counters.get('tape.retry', 0))}
            rows.append(row)
            log('13a %s on %s: %d tasks at W %d; partitions %s; '
                'launches %s; %d retries; multi %.3f s, one device '
                '%.3f s; %d tasks differ'
                % (name, mname, len(tasks), W, json.dumps(parts),
                   json.dumps({k: v for k, v in launches.items() if v}),
                   row['retries'], multi_s, single_s, bad))
            if bad:
                raise AssertionError('13a: align_banded_multi differs '
                                     'from align_banded_tape on %d '
                                     'tasks (%s)' % (bad, name))
            if name.startswith('zigzag') and (
                    launches['banded'] <= 0
                    or launches['banded_walk'] <= 0):
                raise AssertionError('13a: the zigzag set did not '
                                     'retry on kernels 3 and 6')
    rep['multi'] = rows

    # 13b: sharded_banded_align and sharded_align_stats
    config = pw.SEMI_GLOBAL
    W, n_pad, m_pad, batch = 128, 512, 1024, 256
    srows = []
    for planted in (True, False):
        brng = np.random.RandomState(args.seed + 13)
        qb = brng.randint(0, 4, (batch, n_pad)).astype(np.int8)
        r_ext = np.full((batch, m_pad + 2 * W), R_PAD, np.int8)
        r_ext[:, W:W + m_pad] = brng.randint(0, 4, (batch, m_pad))
        c = np.tile(np.arange(n_pad + 1, dtype=np.int32) - W // 2,
                    (batch, 1))
        n_acts = np.full(batch, n_pad, np.int32)
        m_acts = np.full(batch, m_pad, np.int32)
        if planted:
            qb[:] = r_ext[:, W:W + n_pad]
        else:
            n_acts[:] = brng.randint(n_pad // 2, n_pad + 1, batch)
            m_acts[:] = brng.randint(m_pad // 2, m_pad + 1, batch)
        host = (qb, r_ext, c, n_acts, m_acts)
        mesh = meshes[0][1]
        t0 = time.time()
        got, _ = count(lambda: pmesh.sharded_banded_align(
            mesh, *host, scoring=scoring, config=config, W=W,
            need_moves=True))
        sharded_s = time.time() - t0
        up = [torch.from_numpy(x).to(dev) for x in host]
        one = bk.banded_batch_cuda(*up, scoring, config, W, True)
        plain = bk.banded_batch_plain(*up, scoring, config, W, True)
        n_t = up[3]
        for label, ref in (('one launch', one), ('plain', plain)):
            for i, what in enumerate(('score', 'end_i', 'end_j')):
                exact('13b %s vs %s' % (what, label), got[i], ref[i])
            exact('13b moves vs %s' % label,
                  bk.moves_rows_real(got[3], n_t),
                  bk.moves_rows_real(ref[3], n_t))
        scores = got[0].cpu().numpy()
        stats = pmesh.sharded_align_stats(mesh, got[0])
        want_stats = {'aligned': int((scores > 0).sum()),
                      'score_sum': int(scores.astype(np.int64).sum()),
                      'score_max': int(scores.max())}
        if stats != want_stats:
            raise AssertionError('13b stats %s != numpy %s'
                                 % (stats, want_stats))
        if planted and not (scores == 3 * n_pad).all():
            raise AssertionError('13b: a planted task did not score '
                                 'match x n')
        srows.append({'planted': planted, 'batch': batch, 'W': W,
                      'stats': stats, 'sharded_s': sharded_s})
        log('13b %s batch of %d (n %d, m %d, W %d) over %d entries: '
            'bit-equal to one launch and to the plain version; stats '
            '%s equal to numpy; %.3f s'
            % ('planted' if planted else 'random', batch, n_pad, m_pad,
               W, len(mesh), json.dumps(stats), sharded_s))
        del up, one, plain, got
    rep['sharded'] = srows

    # 13e: the compat surface on the card against its CPU route
    scheme = AlignmentScoringScheme('3,-6,-5,-2')
    crows = []
    for name, call in compat_calls(args.seed + 13):
        t0 = time.time()
        got, _ = count(lambda: call(compat, scheme, dev))
        card_s = time.time() - t0
        want = call(compat, scheme, 'cpu')
        crows.append({'call': name, 'equal': got == want,
                      'card_s': card_s})
        if got != want:
            raise AssertionError('13e %s: card %r != CPU route %r'
                                 % (name, got, want))
    rep['compat'] = crows
    log('13e compat: %d calls, each equal to its CPU route (%s)'
        % (len(crows), ', '.join('%s %.2f s' % (r['call'], r['card_s'])
                                 for r in crows)))

    # 13c/13d: two ranks on the card; the single-process references run
    # after them, so no wall below shares the card with another run
    base = os.path.dirname(args.out)
    data_dir = os.path.join(base, 'parallel_reads')
    out_dir = os.path.join(base, 'parallel')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    genome = pipeline_genome()
    p1, p2 = make_fake_short_reads(genome)
    wfq(os.path.join(data_dir, 'r1.fastq'), p1)
    wfq(os.path.join(data_dir, 'r2.fastq'), p2)
    wfq(os.path.join(data_dir, 'long.fastq'),
        make_fake_long_reads(genome, read_length=3000, step=500))
    sock = __import__('socket').socket()
    sock.bind(('localhost', 0))
    port = sock.getsockname()[1]
    sock.close()
    ctx = mp.get_context('spawn')
    q = ctx.Queue()
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, PARALLEL_RANKS, port, args.seed,
                               str(dev), data_dir, out_dir, q))
             for r in range(PARALLEL_RANKS)]
    for p in procs:
        p.start()
    try:
        outs = {}
        for _ in procs:
            rank, out = q.get(timeout=600)
            if isinstance(out, str):
                raise AssertionError('rank %d failed: %s' % (rank, out))
            outs[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    refs, sim, Read = _load_genome(args.seed, PARALLEL_READS)
    reads = [Read(n, s, None) for n, s, _ in sim]
    t0 = time.time()
    align_reads_to_refs(reads, refs, AlignmentScoringScheme('3,-6,-5,-2'),
                        sensitivity_level=0, device=dev)
    single_align_s = time.time() - t0
    want_map = alignment_map(reads)
    single_out = os.path.join(out_dir, 'single')
    from unicycler_tpu_torch.pipeline.main import main as cli
    t0 = time.time()
    cli(pipeline_argv(data_dir, single_out), device=dev)
    single_cli_s = time.time() - t0
    shutil.rmtree(data_dir, ignore_errors=True)
    with open(os.path.join(single_out, 'assembly.fasta')) as f:
        want_fasta = f.read()
    ranks = []
    for rank in range(PARALLEL_RANKS):
        out = outs[rank]
        if (out['index'], out['count']) != (rank, PARALLEL_RANKS) \
                or out['jax_imported']:
            raise AssertionError('rank %d: context %s, jax imported %s'
                                 % (rank, (out['index'], out['count']),
                                    out['jax_imported']))
        differ = sorted(n for n in want_map
                        if out['map'].get(n) != want_map[n])
        if differ or set(out['map']) != set(want_map):
            raise AssertionError('13c rank %d: %d reads differ from the '
                                 'single-process map (%s)'
                                 % (rank, len(differ), differ[:5]))
        if out['fasta'] != want_fasta:
            raise AssertionError('13d rank %d: assembly.fasta differs from '
                                 'the single-process run' % rank)
        for part in ('align', 'cli'):
            for k, v in out[part]['launches'].items():
                par[k] += v
        ranks.append({'rank': rank, 'local_reads': out['local_reads'],
                      'align': out['align'], 'cli': out['cli']})
        log('13c rank %d: %d local reads of %d, %.2f s wall, allgather %d '
            'bytes in %.3f s, launches %s; full map equal to the single '
            'process (%.2f s)'
            % (rank, out['local_reads'], len(reads), out['align']['wall_s'],
               out['align']['allgather_bytes'], out['align']['allgather_s'],
               json.dumps({k: v for k, v in out['align']['launches'].items()
                           if v}), single_align_s))
        log('13d rank %d: command line %.2f s wall, allgather %d bytes in '
            '%.3f s, launches %s; assembly.fasta (%d bytes) byte-equal to '
            'the other rank and the single process (%.2f s)'
            % (rank, out['cli']['wall_s'], out['cli']['allgather_bytes'],
               out['cli']['allgather_s'],
               json.dumps({k: v for k, v in out['cli']['launches'].items()
                           if v}), len(out['fasta']), single_cli_s))
    n_aln = sum(len(v) for v in want_map.values())
    if n_aln < len(reads):
        raise AssertionError('13c: only %d alignments for %d reads'
                             % (n_aln, len(reads)))
    rep.update({'ranks': ranks, 'single_align_s': single_align_s,
                'single_cli_s': single_cli_s, 'alignments': n_aln,
                'launches': par, 'seconds': time.time() - t_phase})
    for k, v in par.items():
        if k != 'wavefront_fwd' and v <= 0:
            raise AssertionError('phase 13 did not launch %s' % k)
    log('phase 13 launches (13a-13e, comparison runs excluded): %s; %.1f s'
        % (json.dumps(par), time.time() - t_phase))
    return par


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reads', type=int, default=200)
    ap.add_argument('--out', default=os.path.join(HERE, 'chiprun_out',
                                                  'chip_smoke.json'))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('error: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import unicycler_tpu_torch  # noqa: F401
    except ImportError as exc:
        print('error: unicycler_tpu_torch not found beside chip_smoke.py '
              '(%s)' % exc, file=sys.stderr)
        return 2
    import numpy as np
    assert 'jax' not in sys.modules

    t0 = time.time()
    phase_s = {}

    def timed_phase(label, fn, *a):
        t = time.time()
        out = fn(*a)
        phase_s[label] = round(time.time() - t, 1)
        return out

    name, smi_line = timed_phase('1 device', phase_device)
    dev = torch.device('cuda', 0)
    report = {'device': name, 'nvidia_smi': smi_line, 'phase_s': phase_s}
    report['build_s'], report['occupancy'] = timed_phase('2 build',
                                                         phase_build)
    kres = []
    timed_phase('3 kernels', phase_kernels, np.random.default_rng(args.seed),
                dev, kres, report)
    launches, per_kernel = timed_phase('4 slice', phase_slice, args, dev,
                                       report)
    timed_phase('4b small reference', phase_small_reference, dev)
    retry_launches = timed_phase('5 retry', phase_retry, args, dev, kres,
                                 report)
    timed_phase('6 row kernels', phase_tape_kernels,
                np.random.default_rng(args.seed + 2), dev, kres, report)
    bridge_launches, bridge_kernels = timed_phase(
        '7 bridging', phase_bridging, args, dev, report)
    wavefront_launches, wavefront_ms = timed_phase(
        '9 wavefront', phase_wavefront, dev, kres, report)
    asm_launches, asm_kernels = timed_phase('10 assembly', phase_assembly,
                                            args, dev, report)
    hybrid_launches, hybrid_kernels = timed_phase(
        '11 hybrid', phase_hybrid, args, dev, report)
    short_launches, short_kernels = timed_phase(
        '12 default command line', phase_shortread, args, dev, report)
    parallel_launches = timed_phase('13 parallel', phase_parallel, args,
                                    dev, report)
    assert 'jax' not in sys.modules

    sources = {'wavetape_fwd': ('unicycler_tpu_torch/csrc/wavetape_fwd.cu',
                                'unicycler_tpu/ops/pallas_wavetape.py:430'),
               'wavetape_walk': ('unicycler_tpu_torch/csrc/wavetape_walk.cu',
                                 'unicycler_tpu/ops/pallas_wavetape.py:608'),
               'banded': ('unicycler_tpu_torch/csrc/banded.cu',
                          'unicycler_tpu/ops/pallas_banded.py:333'),
               'tape_fwd': ('unicycler_tpu_torch/csrc/tape_fwd.cu',
                            'unicycler_tpu/ops/pallas_tape.py:583'),
               'tape_walk': ('unicycler_tpu_torch/csrc/tape_walk.cu',
                             'unicycler_tpu/ops/pallas_tape.py:777'),
               'banded_walk': ('unicycler_tpu_torch/csrc/banded_walk.cu',
                               'unicycler_tpu/ops/pallas_traceback.py:150'),
               'wavefront_fwd': ('unicycler_tpu_torch/csrc/wavefront_fwd.cu',
                                 'unicycler_tpu/ops/pallas_wavefront.py:312'),
               # the twin of a lax.scan device program, not of a Pallas
               # kernel: _align_single's row scan
               'pairwise': ('unicycler_tpu_torch/csrc/pairwise.cu',
                            'unicycler_tpu/ops/pairwise.py:167'),
               # the twin of a host function: decode_traceback
               'pairwise_walk': ('unicycler_tpu_torch/csrc/pairwise_walk.cu',
                                 'unicycler_tpu/ops/pairwise.py:287')}
    # the row-tape kernels' summary row is phase 6's card layout at the
    # bridging path's W 4096 (the forward at the launch's own cluster
    # size); the wave kernels' the assembly's (the card's layout at W 512);
    # the retry pair's the flagged shapes (kernel 3: phase 3's W 1024,
    # kernel 6: phase 5's W 2048), the full-matrix DP's phase 6's
    # consensus shape (SEMI_GLOBAL, unbanded, with moves); the others' the
    # widest shape measured
    kernels = []
    for kname, (src, replaces) in sources.items():
        rows = [r for r in kres if r['name'] == kname]
        shaped = [r for r in rows if r.get('layout') == 'card'
                  and r['W'] == 4096 and r.get('own_C', True)]
        wave = [r for r in rows if r.get('layout') == 'task'
                and r['W'] == 512]
        flagged = [r for r in rows if r.get('summary')]
        if kname.startswith('tape_') and shaped:
            row = shaped[0]
        elif flagged:
            row = flagged[0]
        elif wave:
            row = wave[0]
        else:
            row = max(rows, key=lambda r: (r['W'], r['bt']))
        # each kernel's launches on the path that runs it, counted from 0
        # just before that path: retries (phase 5), bridging (phase 7:
        # the row-tape kernels and the full-matrix DP), the wavefront
        # entry (phase 9), the assembly (phase 10)
        on_bridging = kname.startswith(('tape_', 'pairwise'))
        if kname in retry_launches:
            n_launch = retry_launches[kname]
        elif on_bridging:
            n_launch = bridge_launches[kname]
        elif kname == 'wavefront_fwd':
            n_launch = wavefront_launches
        else:
            n_launch = asm_launches[kname]
        entry = {'name': kname, 'route': 'cuda', 'source': src,
                 'replaces': replaces, 'launches': n_launch,
                 'max_abs_err': max(r['max_abs_err'] for r in rows),
                 'ms': row['ms'], 'plain_ms': row['plain_ms'],
                 'bound_ms': row['bound_ms'],
                 'bound_by': 'operations' if row['bound_ms'] * 1e-3
                 > row['bytes'] / PEAK_BYTES_S else 'bytes',
                 'library_ms': None}
        if kname.startswith('pairwise'):
            entry['replaces_kind'] = (
                'lax.scan device program, not Pallas' if kname == 'pairwise'
                else 'host function (decode_traceback), not Pallas')
            entry['shape'] = {k: row[k] for k in ('pairs', 'n_pad', 'm_pad',
                                                  'config', 'band')}
            entry['assembly_launches'] = asm_launches.get(kname, 0)
        else:
            entry['shape'] = {'W': row['W'], 'bt': row['bt']}
        if 'C' in row:
            entry['shape']['C'] = row['C']
        main_kernels = bridge_kernels if on_bridging else asm_kernels
        if kname in main_kernels:
            entry['main_path_ms'] = main_kernels[kname]['ms']
            entry['main_path_bound_ms'] = main_kernels[kname]['bound_ms']
        if kname == 'wavefront_fwd':
            entry['main_path_ms'] = wavefront_ms
        # and on the hybrid path (phase 11), counted from 0 just before it
        entry['hybrid_launches'] = hybrid_launches.get(kname, 0)
        if kname in hybrid_kernels:
            entry['hybrid_ms'] = hybrid_kernels[kname]['ms']
            entry['hybrid_bound_ms'] = hybrid_kernels[kname]['bound_ms']
        # and on the default command line's path (phase 12)
        entry['shortread_launches'] = short_launches.get(kname, 0)
        if kname in short_kernels:
            entry['shortread_ms'] = short_kernels[kname]['ms']
            entry['shortread_bound_ms'] = short_kernels[kname]['bound_ms']
        # and on the parallel paths (phase 13: the parent's mesh routes
        # and compat calls plus both ranks' alignment and command line)
        entry['parallel_launches'] = parallel_launches.get(kname, 0)
        kernels.append(entry)
    report['kernels'] = kernels
    report['kernel_rows'] = kres
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(report, f, indent=1)
    log('== phase 8: summary')
    log('phase seconds: %s; %.0f s in all' % (json.dumps(phase_s),
                                             time.time() - t0))
    log(json.dumps({'kernels': kernels}))
    log(smi_line)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
