"""Semi-global long-read alignment driver (counterpart of
unicycler_tpu/align/semi_global.py).

Capability parity with reference unicycler/unicycler_align.py:88-470 and
the C++ seed-and-extend aligner it drives (src/semi_global_align.cpp:24-347):

  reference pipeline                     this package
  ------------------------------------   ---------------------------------
  minimap seeding (vendored minimap)     minimiser index lookup (ops/minimizer)
  k-mer cloud + nanoflann line tracing   diagonal-binned hit clusters + LIS chain
  SeqAn bandedChainAlignment per range   batched banded corridor DP (ops/banded)
  ThreadPool over reads                  one device launch over all (read,
                                         window) tasks, bucketed by shape

The auto low-score threshold table is reproduced verbatim
(ref unicycler_align.py:473-520). Entry points take `device` (None = CUDA):
on CUDA the device driver of align_jobs runs (tape kernels, host seeding
of later reads overlapping device work); with device='cpu' the JAX
package's host route runs (score pass, winners, traceback pass on the
bucketed row DP).
"""

import contextvars
import os
from typing import List

import numpy as np

from .. import log, settings
from ..device import resolve_device
from ..io.fastx import load_references
from ..misc import float_to_str
from ..ops import banded as banded_ops
from ..ops import minimizer as mz
from ..ops import pairwise as pw
from ..ops.encode import revcomp_codes
from ..utils import trace
from .alignment import Alignment

# Precomputed random-alignment score distributions for known scoring schemes
# (ref unicycler_align.py:480-508).
_RANDOM_SCORE_TABLE = {
    '1,0,0,0': (50.225667, 2.467919),
    '0,-1,-1,-1': (49.024927, 2.724548),
    '1,-1,-1,-1': (51.741783, 2.183467),
    '5,-4,-8,-6': (42.707636, 2.435548),
    '5,-6,-10,0': (58.65047, 0.853201),
    '2,-5,-2,-1': (72.712148, 0.95266),
    '1,-3,-5,-2': (46.257408, 2.162765),
    '5,-11,-2,-4': (73.221967, 1.363692),
    '3,-6,-5,-2': (61.656918, 1.314624),
    '2,-3,-5,-2': (47.453862, 1.985947),
    '1,-2,0,0': (81.720641, 0.77204),
    '0,-6,-5,-3': (62.647055, 1.738603),
    '2,-6,-5,-3': (59.713806, 1.641191),
    '1,-4,-6,-1': (60.328393, 1.176776),
}


def get_auto_score_threshold(scoring_scheme, std_devs_over_mean=
                             settings.AUTO_SCORE_STDEV_ABOVE_RANDOM_ALIGNMENT_MEAN,
                             device=None):
    """Low score threshold from random-alignment statistics
    (ref unicycler_align.py:473-520). Schemes outside the table measure
    the distribution with the full-matrix DP on `device`."""
    key = str(scoring_scheme)
    if key in _RANDOM_SCORE_TABLE:
        mean, std_dev = _RANDOM_SCORE_TABLE[key]
    else:
        mean, std_dev = get_random_sequence_alignment_mean_and_std_dev(
            100, 10000, scoring_scheme, device=device)
    threshold = mean + std_devs_over_mean * std_dev
    threshold = max(50.0, min(95.0, threshold))
    return threshold, mean, std_dev


def get_random_sequence_alignment_mean_and_std_dev(seq_len, count,
                                                   scoring_scheme,
                                                   device=None):
    """Scaled scores of global alignments of random sequence pairs, batched
    on the device (replaces src/random_alignments.cpp:30-52)."""
    rng = np.random.RandomState(0)
    q = [rng.randint(0, 4, seq_len).astype(np.int8) for _ in range(count)]
    r = [rng.randint(0, 4, seq_len).astype(np.int8) for _ in range(count)]
    res = pw.align_pairs(q, r, scoring=scoring_scheme.to_ops(),
                         config=pw.FULLY_GLOBAL, need_cigar=True,
                         device=device)
    scaled = []
    for pa in res:
        align_len = sum(c for c, _ in pa.cigar)
        if align_len == 0:
            continue
        perfect = scoring_scheme.match * align_len
        worst = scoring_scheme.mismatch * align_len
        scaled.append(100.0 * (pa.score - worst) / (perfect - worst))
    return float(np.mean(scaled)), float(np.std(scaled))


def _dump_seed_debug(debug_dir, read, level, clusters):
    """Verbosity-4 seed diagnostics: one TSV per read/level with every
    candidate cluster's span, strand, and chained anchor dots (the role
    of the reference aligner's k-mer cloud / trace dot dumps,
    ref src/semi_global_align.cpp:654-734)."""
    os.makedirs(debug_dir, exist_ok=True)
    safe = ''.join(c if c.isalnum() or c in '._-' else '_'
                   for c in read.name)[:80]
    path = os.path.join(debug_dir, 'seeds_%s_level%d.tsv' % (safe, level))
    with open(path, 'w') as f:
        f.write('cluster\tref_id\tstrand\tread_start\tread_end\t'
                'ref_start\tref_end\tn_hits\n')
        for ci, cl in enumerate(clusters):
            f.write('%d\t%d\t%s\t%d\t%d\t%d\t%d\t%d\n'
                    % (ci, cl.ref_id, '-' if cl.rev_comp else '+',
                       cl.read_start, cl.read_end, cl.ref_start,
                       cl.ref_end, cl.n_hits))
        f.write('# anchor dots (cluster, read_pos, ref_pos)\n')
        for ci, cl in enumerate(clusters):
            for rp, fp in zip(cl.anchors_read, cl.anchors_ref):
                f.write('%d\t%d\t%d\n' % (ci, int(rp), int(fp)))


_SEED_POOL = None


def seed_threads():
    """Worker count of the seeding pool (UNICYCLER_TPU_SEED_THREADS,
    default 3)."""
    return max(1, int(os.environ.get('UNICYCLER_TPU_SEED_THREADS', '3')))


def _seed_pool():
    """Shared seeding executor (created on first use, reused across
    align_jobs calls; seed_threads() workers)."""
    global _SEED_POOL
    if _SEED_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _SEED_POOL = ThreadPoolExecutor(max_workers=seed_threads())
    return _SEED_POOL


# Row thresholds for pipelined chunk dispatch: the i-th dispatched chunk
# (across all jobs) flushes at the i-th entry's DP-row count (last entry
# repeats). A smallish first chunk starts the device promptly while the
# host seeds the remaining reads; later chunks are unbounded.
_CHUNK_THRESHOLDS = (150_000, 10**12)


class _Task(object):
    """One (read, strand, reference window) banded-alignment task."""
    __slots__ = ('read', 'ref', 'rev_comp', 'window_start', 'banded')

    def __init__(self, read, ref, rev_comp, window_start, banded):
        self.read = read
        self.ref = ref
        self.rev_comp = rev_comp
        self.window_start = window_start
        self.banded = banded


def _make_tasks(read, ref_list, clusters, band, fine_k=10) -> List[_Task]:
    """Build one banded task per seed cluster. The reference window is the
    cluster's ref span expanded by read overhang plus half the read length
    (semantics of getRefRange, ref src/semi_global_align.cpp:608-620).
    Near-duplicate clusters (same ref/strand, overlapping diagonals) are
    deduplicated. Each task's corridor is refined with a dense common-kmer
    pass near the coarse minimiser line."""
    read_len = read.get_length()
    pad = read_len // 2
    tasks = []
    rc_codes = None     # revcomp computed at most once per read
    seen = []   # (ref_id, rev, diag_lo, diag_hi, read_lo, read_hi)
    for cl in clusters:
        diag_lo = int(np.min(cl.anchors_ref - cl.anchors_read))
        diag_hi = int(np.max(cl.anchors_ref - cl.anchors_read))
        dup = False
        for (rid, rev, dlo, dhi, rlo, rhi) in seen:
            if (rid == cl.ref_id and rev == cl.rev_comp
                    and diag_lo <= dhi + 2 * band and dlo <= diag_hi + 2 * band
                    and cl.read_start <= rhi and rlo <= cl.read_end):
                dup = True
                break
        if dup:
            continue
        seen.append((cl.ref_id, cl.rev_comp, diag_lo, diag_hi,
                     cl.read_start, cl.read_end))
        ref = ref_list[cl.ref_id]
        ref_len = ref.get_length()
        start = max(0, cl.ref_start - cl.read_start - pad)
        end = min(ref_len, cl.ref_end + (read_len - cl.read_end) + pad)
        if cl.rev_comp:
            if rc_codes is None:
                rc_codes = revcomp_codes(read.codes)
            q = rc_codes
        else:
            q = read.codes
        r_window = ref.codes[start:end]
        coarse_ref = (cl.anchors_ref - start).astype(np.int64)
        with trace.span('fine_anchors'):
            fine_read, fine_ref = mz.collect_common_kmers(
                q, ref.codes, cl.anchors_read.astype(np.int64), coarse_ref,
                k=fine_k, max_dist=settings.FINE_ANCHOR_MAX_DIST,
                max_occ=settings.FINE_ANCHOR_MAX_OCC, window=(start, end))
        if len(fine_read) >= 3:
            a_read, a_ref = fine_read, fine_ref
        else:
            a_read = cl.anchors_read
            a_ref = coarse_ref.astype(np.int32)
        banded = banded_ops.BandedTask(
            q=q, r=r_window, corridor_read=a_read, corridor_ref=a_ref)
        tasks.append(_Task(read, ref, cl.rev_comp, start, banded))
    return tasks


def _select_winner_tasks(tasks, prelim):
    """Indices of tasks worth a traceback pass: per read, tasks whose
    score-only result is within 95% of the best among tasks covering an
    overlapping part of the read (lower-scored overlapping candidates
    would be dropped by remove_conflicting_alignments anyway)."""
    by_read = {}
    for i, (task, pa) in enumerate(zip(tasks, prelim)):
        if pa is None or pa.score <= 0:
            continue
        span = (int(task.banded.corridor_read[0]),
                int(task.banded.corridor_read[-1]))
        if task.rev_comp:
            read_len = len(task.banded.q)
            span = (read_len - span[1], read_len - span[0])
        by_read.setdefault(id(task.read), []).append((i, span, pa.score))
    winners = []
    for entries in by_read.values():
        for i, span, score in entries:
            best_overlapping = max(
                (s for _, other, s in entries
                 if min(span[1], other[1]) > max(span[0], other[0])),
                default=score)
            if score >= 0.95 * best_overlapping:
                winners.append(i)
    return sorted(winners)


class AlignJob(object):
    """One (reads, references) alignment request for align_jobs.

    Carries the request arguments plus the in-flight dispatch state so
    several jobs can share merged device sync points (see align_jobs)."""

    def __init__(self, reads, references, scoring_scheme,
                 sensitivity_level=0, keep_bad=False,
                 low_score_threshold=None,
                 min_align_length=settings.MIN_LONG_READ_ALIGNMENT_LENGTH,
                 allowed_overlap=0, debug_dir=None):
        self.reads = reads
        self.references = references
        self.scoring_scheme = scoring_scheme
        self.scoring = scoring_scheme.to_ops()
        self.sensitivity_level = sensitivity_level
        self.keep_bad = keep_bad
        self.low_score_threshold = low_score_threshold
        self.min_align_length = min_align_length
        self.allowed_overlap = allowed_overlap
        self.debug_dir = debug_dir
        self._levels = []       # [(band, [(chunk_tasks, handle), ...])]
        self._refine = None     # (refine_alignments, handle)


def _dispatch_job_device(job, handles, device):
    """Seed + dispatch every sensitivity level of one job. Kernels queue
    on the device asynchronously; nothing here blocks on device results,
    so calling this for job N+1 overlaps its host seeding with job N's
    device compute. Every dispatched (chunk_tasks, handle) is appended to
    `handles` too, in dispatch order."""
    ref_codes = [r.codes for r in job.references]
    for level in range(0, job.sensitivity_level + 1):
        k = settings.SEED_KMER_SIZES[level]
        band = settings.BAND_SIZES[level]
        with trace.span('seed_index'):
            index = mz.get_cached_index(ref_codes, k, 10)
        max_traces = settings.MAX_LINE_TRACE_COUNTS[level]
        live_reads = [r for r in job.reads
                      if r.get_length() >= job.min_align_length]
        # Pipelined seeding: buffer seeded tasks and dispatch a tape batch
        # as soon as a chunk's worth of DP rows accumulates, so host
        # seeding of later reads hides under device compute of earlier
        # ones. Longest-first seeding groups the big reads into the same
        # tape launches: a launch's serial length is its LONGEST task.
        def chunk_threshold():
            n = len(handles)
            seq = _CHUNK_THRESHOLDS
            return seq[n] if n < len(seq) else seq[-1]
        live_reads.sort(key=lambda r: -r.get_length())
        level_chunks = []
        chunk_tasks: List[_Task] = []
        chunk_rows = 0

        def flush_chunk():
            with trace.span('dispatch'):
                h = banded_ops.align_banded_async(
                    [t.banded for t in chunk_tasks], job.scoring,
                    config=pw.SEMI_GLOBAL, band=band, need_cigar=True,
                    device=device)
                level_chunks.append((chunk_tasks[:], h))
                handles.append((chunk_tasks[:], h))
            del chunk_tasks[:]

        # Threaded seeding (the reference's own ThreadPool shape,
        # ref unicycler_align.py:204): lookup + task building spend most
        # of their time in native seed search and numpy, which release the
        # GIL. Results are consumed IN ORDER so chunk packing and dispatch
        # order stay deterministic.
        def seed_one(read):
            with trace.span('seed_read'):
                with trace.span('seed_lookup'):
                    clusters = index.lookup(read.codes)
                if job.debug_dir is not None:
                    _dump_seed_debug(job.debug_dir, read, level, clusters)
                return _make_tasks(read, job.references,
                                   clusters[:max_traces], band)

        # each read runs in a copy of this thread's context, so that its
        # spans name the span open here as their parent
        pool = _seed_pool()
        futures = [pool.submit(contextvars.copy_context().run, seed_one,
                               read) for read in live_reads]
        for fut in futures:
            with trace.span('seed_and_tasks'):
                new_tasks = fut.result()
            chunk_tasks.extend(new_tasks)
            chunk_rows += sum(len(t.banded.q) for t in new_tasks)
            if chunk_rows >= chunk_threshold():
                flush_chunk()
                chunk_rows = 0
        if chunk_tasks:
            flush_chunk()
        job._levels.append((level, band, level_chunks))


def _decode_job_level(job, band, tasks, results):
    """Winner filtering + Alignment construction for one level's
    collected results (device path: every candidate was walked; the
    losers are dropped here)."""
    if not tasks:
        return
    task_counts = {}
    for t in tasks:
        task_counts[id(t.read)] = task_counts.get(id(t.read), 0) + 1
    # Single full pass: with the on-device traceback, aligning every
    # candidate WITH its CIGAR is cheaper than a score-only prefilter +
    # rerun. Losers are filtered here.
    keep = set(_select_winner_tasks(tasks, results))
    keep |= {i for i, t in enumerate(tasks)
             if task_counts[id(t.read)] == 1}
    for i, (task, pa) in enumerate(zip(tasks, results)):
        if i not in keep or pa.s1_end <= pa.s1_start:
            continue
        alignment = Alignment(read=task.read, ref=task.ref,
                              scoring_scheme=job.scoring_scheme,
                              pair_alignment=pa, rev_comp=task.rev_comp,
                              ref_offset=task.window_start)
        alignment._pair = pa
        alignment._task = task
        task.read.alignments.append(alignment)


def _build_refine(job):
    """Corridor refinement candidates: surviving alignments whose traced
    path came within REFINE_MARGIN lanes of the band edge get the band
    re-centered on the found path and realigned, keeping the better
    result (the analog of the reference's repeated line tracing,
    semi_global_align.cpp:229). Paths well inside the corridor cannot
    improve from re-centering at the same width — the first pass already
    runs at the full refine-grade band — so the refine pass is empty for
    most calls. Returns (refine_alignments, refine_tasks, band)."""
    band = settings.BAND_SIZES[min(job.sensitivity_level,
                                   len(settings.BAND_SIZES) - 1)]
    pass_W = banded_ops.band_width(band)
    refine_alignments = []
    for read in job.reads:
        for alignment in read.alignments:
            pa = getattr(alignment, '_pair', None)
            if pa is None or pa.score <= 0 or not pa.cigar:
                continue
            if len(pa.cigar) == 1 and pa.cigar[0][1] == 'M' and \
                    alignment.mismatch_count == 0:
                continue            # already perfect
            task = alignment._task
            if banded_ops.path_band_margin(pa, task.banded, pass_W) \
                    >= settings.REFINE_MARGIN:
                continue            # path never approached the band edge
            refine_alignments.append(alignment)
    refine_tasks = []
    for alignment in refine_alignments:
        pa = alignment._pair
        task = alignment._task
        a_read, a_ref = banded_ops.alignment_path_anchors(pa)
        refine_tasks.append(banded_ops.BandedTask(
            q=task.banded.q, r=task.banded.r,
            corridor_read=a_read, corridor_ref=a_ref))
    refine_band = max(settings.REFINE_BAND, band)
    return refine_alignments, refine_tasks, refine_band


def _apply_refined(job, refine_alignments, refined):
    for alignment, pa2 in zip(refine_alignments, refined):
        if pa2.score > alignment._pair.score:
            task = alignment._task
            better = Alignment(read=task.read, ref=task.ref,
                               scoring_scheme=job.scoring_scheme,
                               pair_alignment=pa2,
                               rev_comp=task.rev_comp,
                               ref_offset=task.window_start)
            better._pair = pa2
            better._task = task
            read_alignments = task.read.alignments
            read_alignments[read_alignments.index(alignment)] = better


def _final_filters(job):
    for read in job.reads:
        if not job.keep_bad and job.low_score_threshold is not None:
            read.remove_low_score_alignments(job.low_score_threshold)
        read.remove_short_alignments(job.min_align_length)


def align_jobs(jobs, device=None):
    """Run several alignment jobs, filling read.alignments of every read.

    On CUDA (the default) the device driver runs in four phases: (A) every
    job's reads are seeded and their chunks dispatched (job N+1's host
    seeding overlaps job N's device compute); (B) every chunk is
    collected and decoded; (C) per job, winner filtering, the conflict
    filter and the refine dispatch (job N's refine kernels run while job
    N+1 decodes); (D) the refine results are collected and the final
    filters applied. With device='cpu' each job takes the host route."""
    dev = resolve_device(device)
    jobs = [j for j in jobs if j.reads]
    for job in jobs:
        for read in job.reads:
            read.alignments = []
    if not banded_ops.has_device_traceback(dev):
        for job in jobs:
            _align_job_host(job, dev)
        return

    # Phase A: dispatch everything.
    handles = []
    for job in jobs:
        _dispatch_job_device(job, handles, dev)

    # Phase B: collect every job's chunks.
    with trace.span('traceback_pass'):
        flat = [(job, level, chunk_tasks, h)
                for job in jobs
                for level, band, level_chunks in job._levels
                for chunk_tasks, h in level_chunks]
        all_res = banded_ops.collect_many([h for _, _, _, h in flat])

    # Phase C: per-job decode + conflict filter + refine dispatch.
    by_job = {}
    for (job, level, chunk_tasks, _h), res in zip(flat, all_res):
        t_acc, r_acc = by_job.setdefault(id(job), {}).setdefault(
            level, ([], []))
        t_acc.extend(chunk_tasks)
        r_acc.extend(res)
    refine_pend = []
    for job in jobs:
        with trace.span('decode_level'):
            for level, band, level_chunks in job._levels:
                t_acc, r_acc = by_job.get(id(job), {}).get(level, ([], []))
                _decode_job_level(job, band, t_acc, r_acc)
        with trace.span('conflict_filter'):
            for read in job.reads:
                read.remove_conflicting_alignments(job.allowed_overlap)
        with trace.span('build_refine'):
            refine_alignments, refine_tasks, refine_band = \
                _build_refine(job)
        if refine_tasks:
            with trace.span('refine_dispatch'):
                h = banded_ops.align_banded_async(
                    refine_tasks, job.scoring, config=pw.SEMI_GLOBAL,
                    band=refine_band, need_cigar=True, device=dev)
            refine_pend.append((job, refine_alignments, h))

    # Phase D: collect the refine passes, then final filters.
    if refine_pend:
        with trace.span('refine_pass'):
            refined_all = banded_ops.collect_many(
                [h for _, _, h in refine_pend])
        for (job, refine_alignments, _h), refined in zip(refine_pend,
                                                         refined_all):
            _apply_refined(job, refine_alignments, refined)
    for job in jobs:
        _final_filters(job)


def _align_job_host(job, device):
    """CPU route: move matrices are materialised per candidate, so a
    score-only prefilter pass still pays; everything is synchronous."""
    ref_codes = [r.codes for r in job.references]
    for level in range(0, job.sensitivity_level + 1):
        k = settings.SEED_KMER_SIZES[level]
        band = settings.BAND_SIZES[level]
        with trace.span('seed_index'):
            index = mz.get_cached_index(ref_codes, k, 10)
        tasks: List[_Task] = []
        with trace.span('seed_and_tasks'):
            for read in job.reads:
                if read.get_length() < job.min_align_length:
                    continue
                with trace.span('seed_lookup'):
                    clusters = index.lookup(read.codes)
                if job.debug_dir is not None:
                    _dump_seed_debug(job.debug_dir, read, level, clusters)
                max_traces = settings.MAX_LINE_TRACE_COUNTS[level]
                tasks.extend(_make_tasks(read, job.references,
                                         clusters[:max_traces], band))
        if not tasks:
            continue
        task_counts = {}
        for t in tasks:
            task_counts[id(t.read)] = task_counts.get(id(t.read), 0) + 1
        single = [t for t in tasks if task_counts[id(t.read)] == 1]
        multi = [t for t in tasks if task_counts[id(t.read)] > 1]
        if multi:
            with trace.span('score_pass'):
                prelim = banded_ops.align_banded(
                    [t.banded for t in multi], job.scoring,
                    config=pw.SEMI_GLOBAL, band=band,
                    need_cigar=False, device=device)
            winners = _select_winner_tasks(multi, prelim)
            multi = [multi[i] for i in winners]
        tasks = single + multi
        with trace.span('traceback_pass'):
            results = banded_ops.align_banded(
                [t.banded for t in tasks], job.scoring,
                config=pw.SEMI_GLOBAL, band=band, need_cigar=True,
                device=device)
        for task, pa in zip(tasks, results):
            if pa.s1_end <= pa.s1_start:
                continue
            alignment = Alignment(read=task.read, ref=task.ref,
                                  scoring_scheme=job.scoring_scheme,
                                  pair_alignment=pa, rev_comp=task.rev_comp,
                                  ref_offset=task.window_start)
            alignment._pair = pa
            alignment._task = task
            task.read.alignments.append(alignment)

    for read in job.reads:
        read.remove_conflicting_alignments(job.allowed_overlap)
    refine_alignments, refine_tasks, refine_band = _build_refine(job)
    if refine_tasks:
        with trace.span('refine_pass'):
            refined = banded_ops.align_banded(
                refine_tasks, job.scoring, config=pw.SEMI_GLOBAL,
                band=refine_band, need_cigar=True, device=device)
        _apply_refined(job, refine_alignments, refined)
    _final_filters(job)


def align_reads_to_refs(reads, references, scoring_scheme,
                        sensitivity_level=0, keep_bad=False,
                        low_score_threshold=None,
                        min_align_length=settings.MIN_LONG_READ_ALIGNMENT_LENGTH,
                        allowed_overlap=0, debug_dir=None, device=None):
    """Core batched aligner: fills read.alignments for every read.

    Tries every sensitivity level 0..sensitivity_level, accumulating
    redundant alignments and filtering afterwards, exactly like the
    reference's escalation loop (ref unicycler_align.py:390-403).
    One-job wrapper over align_jobs."""
    align_jobs([AlignJob(reads, references, scoring_scheme,
                         sensitivity_level=sensitivity_level,
                         keep_bad=keep_bad,
                         low_score_threshold=low_score_threshold,
                         min_align_length=min_align_length,
                         allowed_overlap=allowed_overlap,
                         debug_dir=debug_dir)], device=device)


def semi_global_align_long_reads(references, ref_fasta, read_dict, read_names,
                                 reads_fastq, threads, scoring_scheme,
                                 low_score_threshold_list, keep_bad,
                                 min_align_length, sam_filename, full_command,
                                 allowed_overlap, sensitivity_level,
                                 contamination_fasta, verbosity=None,
                                 stdout_header='Aligning reads',
                                 display_low_score=True,
                                 single_copy_segment_names=None,
                                 device=None):
    """Reference-compatible driver entry point
    (signature parity with ref unicycler_align.py:88)."""
    dev = resolve_device(device)
    if sensitivity_level is None:
        sensitivity_level = 0
    if verbosity is None:
        verbosity = 0

    low_score_threshold = low_score_threshold_list[0]
    if low_score_threshold is None:
        low_score_threshold, rand_mean, rand_std = get_auto_score_threshold(
            scoring_scheme, device=dev)
        low_score_threshold_list[0] = low_score_threshold
        if display_low_score and verbosity > 0:
            log.log('Random alignment mean score: '
                    + float_to_str(rand_mean, 2))
            log.log('        Low score threshold: '
                    + float_to_str(low_score_threshold, 2))

    if contamination_fasta is not None:
        references = references + load_references(contamination_fasta,
                                                  contamination=True,
                                                  section_header=None,
                                                  show_progress=False)

    debug_dir = None
    if verbosity >= 4 and sam_filename:
        debug_dir = os.path.join(os.path.dirname(sam_filename),
                                 'seed_debug')

    reads_to_align = [read_dict[x] for x in read_names]
    from ..parallel import distributed as dist
    ctx = dist.get_context()
    if ctx.active:
        # several processes: each aligns its read shard on its own card
        # and the results allgather, so every process holds the full map
        # (the replicated graph stages need it; parallel/distributed.py)
        dist.distributed_align_long_reads(
            reads_to_align, references, scoring_scheme, ctx=ctx,
            device=dev, sensitivity_level=sensitivity_level,
            keep_bad=keep_bad, low_score_threshold=low_score_threshold,
            min_align_length=min_align_length,
            allowed_overlap=allowed_overlap, debug_dir=debug_dir)
    else:
        align_reads_to_refs(reads_to_align, references, scoring_scheme,
                            sensitivity_level=sensitivity_level,
                            keep_bad=keep_bad,
                            low_score_threshold=low_score_threshold,
                            min_align_length=min_align_length,
                            allowed_overlap=allowed_overlap,
                            debug_dir=debug_dir, device=dev)

    if verbosity > 0:
        print_alignment_summary_table(read_dict, verbosity)

    if sam_filename:
        with open(sam_filename, 'w') as sam_file:
            sam_file.write('@HD\tVN:1.5\tSO:unknown\n')
            for ref in references:
                sam_file.write('@SQ\tSN:' + ref.name + '\tLN:'
                               + str(ref.get_length()) + '\n')
            sam_file.write('@PG\tID:unicycler_tpu_align')
            if full_command:
                sam_file.write('\tCL:' + full_command + '\t')
            sam_file.write('SC:' + str(scoring_scheme) + '\n')
            for name in read_names:
                for alignment in read_dict[name].alignments:
                    if not alignment.ref.name.startswith('CONTAMINATION_'):
                        sam_file.write(alignment.get_sam_line())

    return read_dict


def print_alignment_summary_table(read_dict, verbosity,
                                  using_contamination=False):
    """Fully/partially/unaligned read summary
    (role of ref unicycler_align.py:266-310)."""
    from ..misc import print_table
    fully, partially, unaligned = 0, 0, 0
    for read in read_dict.values():
        fraction = read.get_fraction_aligned()
        if fraction >= 1.0:
            fully += 1
        elif fraction > 0.0:
            partially += 1
        else:
            unaligned += 1
    table = [['Reads', 'Count'],
             ['Fully aligned', str(fully)],
             ['Partially aligned', str(partially)],
             ['Unaligned', str(unaligned)],
             ['Total', str(len(read_dict))]]
    print_table(table, alignments='LR',
                out=lambda s: log.log(s, verbosity))


def load_sam_alignments(sam_filename, read_dict, reference_dict,
                        scoring_scheme):
    """Rebuild Alignment objects from a SAM file
    (parity with ref unicycler_align.py:313-340)."""
    alignments = []
    with open(sam_filename, 'rt') as sam:
        for line in sam:
            line = line.strip()
            if not line or line.startswith('@'):
                continue
            if line.split('\t', 3)[2] == '*':
                continue
            alignments.append(Alignment(sam_line=line, read_dict=read_dict,
                                        reference_dict=reference_dict,
                                        scoring_scheme=scoring_scheme))
    return alignments
