"""Assembly polishing by batched read-to-assembly consensus voting (a copy
of unicycler_tpu/asm/polish.py; the alignments run on `device`, None =
CUDA, and each stage of a round is a trace span).

Replaces the reference's Racon subprocess loop (ref miniasm_assembly.py:
288-419, where Racon is a black box — SURVEY.md §7.8 notes only end-to-end
quality matters, not Racon parity). Each polish round:

  1. map every read to the unitigs (minimiser mapper, 'find contigs' role)
  2. banded-align each mapped read span to its unitig window — ONE batched
     device launch for all (read, unitig) pairs
  3. walk the CIGARs accumulating per-position votes along each unitig
     (base counts + summed quality, deletion votes, majority insertions)
  4. call the consensus per unitig

The mapping-quality metric (sum of matching/num bases) drives the same
early-stopping loop as the reference (:349-360), and circular unitigs are
rotated between rounds so their ends get polished too.
"""

from collections import Counter, defaultdict

import numpy as np

from .. import log, settings
from ..align.minimap_like import map_reads
from ..device import resolve_device
from ..utils import trace
from ..io.fastx import Reference, encode_sequence
from ..ops import banded as banded_ops
from ..ops import pairwise as pw
from ..ops.encode import revcomp_codes


def polish_round(unitig_graph, reads, scoring, multi_place=False,
                 min_agreement=0.0, max_placements=4,
                 collect_votes=False, device=None):
    """One polishing round. reads: list of Read objects. Returns
    (polished_seqs dict, mapping_quality, unitig_depths); with
    collect_votes=True, a 4th element (the per-segment ColumnVotes) for
    diagnostics (scripts/polish_debug.py).

    multi_place + min_agreement exist for polishing graphs that contain
    NEAR-DUPLICATE sequence (a final assembly whose bridge consensus
    regions repeat elsewhere as leftover segments): best-placement
    mapping sends every read to the error-FREE copy, so errors starve of
    corrective votes (measured: 0/98 segments changed with 59 real
    mismatches present). With multi_place, a read votes at every
    placement within the minimiser ratio of its best (capped), and
    min_agreement accepts a correction only when the votes are
    near-unanimous — a random consensus error is outvoted unanimously
    (all copies share the true base), while genuinely diverged repeat
    sites show mixed votes and stay untouched (the plasmid-E
    bubble-popping lesson: never homogenise variants)."""
    device = resolve_device(device)
    refs = [Reference(name, seg.forward_sequence)
            for name, seg in sorted(unitig_graph.segments.items())]
    if not refs:
        return {}, 0.0, {}
    ref_by_name = {r.name: r for r in refs}
    k = settings.SEED_KMER_SIZES[3]
    with trace.span('map_reads'):
        mapped = map_reads(refs, reads, k=k, w=10,
                           filter_overlaps=not multi_place,
                           allowed_overlap=10, filter_by_minimisers=True)
    if multi_place:
        for name in mapped:
            mapped[name] = mapped[name][:max_placements]

    mapping_quality = 0.0
    unitig_depths = defaultdict(float)
    tasks = []
    task_meta = []   # (unitig_name, window_start, read, rev)
    read_by_name = {r.name: r for r in reads}
    for read_name in sorted(mapped.keys()):
        read = read_by_name[read_name]
        for a in mapped[read_name]:
            mapping_quality += a.matching_bases / max(1, a.num_bases)
            unitig_depths[a.ref_name] += a.fraction_ref_aligned()
            ref = ref_by_name[a.ref_name]
            pad = 200
            win_start = max(0, a.ref_start - pad)
            win_end = min(ref.get_length(), a.ref_end + pad)
            read_codes = read.codes[a.read_start:a.read_end]
            if a.read_strand == '-':
                read_codes = revcomp_codes(read_codes)
            anchors_read = np.array([0, a.read_end - a.read_start],
                                    np.int32)
            anchors_ref = np.array([a.ref_start - win_start,
                                    a.ref_end - win_start], np.int32)
            tasks.append(banded_ops.BandedTask(
                q=read_codes, r=ref.codes[win_start:win_end],
                corridor_read=anchors_read, corridor_ref=anchors_ref))
            task_meta.append((a.ref_name, win_start, read, a))

    with trace.span('align_banded'):
        results = banded_ops.align_banded(tasks, scoring,
                                          config=pw.SEMI_GLOBAL, band=200,
                                          need_cigar=True, device=device)
    with trace.span('votes'):
        return _vote(unitig_graph, task_meta, results, ref_by_name,
                     min_agreement, collect_votes, mapping_quality,
                     unitig_depths)


def _vote(unitig_graph, task_meta, results, ref_by_name, min_agreement,
          collect_votes, mapping_quality, unitig_depths):
    """Votes and consensus call of a polish round (polish_round's tail).
    Every alignment is voted in one batch (ops/votes.add_batch, native);
    without the native library, one alignment at a time in numpy."""
    from ..ops.votes import ColumnVotes, add_batch, left_align_indels
    votes = {name: ColumnVotes(seg.get_length())
             for name, seg in unitig_graph.segments.items()}

    alignments = []
    for (ref_name, win_start, read, a), pa in zip(task_meta, results):
        if pa is None or pa.score <= 0 or not pa.cigar:
            continue
        codes = read.codes[a.read_start:a.read_end]
        qual = (read.qualities or '')[a.read_start:a.read_end]
        if a.read_strand == '-':
            codes = revcomp_codes(codes)
            qual = qual[::-1]
        qv = np.frombuffer(qual.encode()[:len(codes)].ljust(
            len(codes), b'\x00'), np.uint8)
        alignments.append((ref_name, pa.cigar, pa.s1_start,
                           win_start + pa.s2_start, codes, qv))

    # Normalise indel placement before voting: equivalent alignments
    # otherwise split gap votes across columns inside duplications /
    # homopolymers and assembly insertions survive every round
    # (ops/votes.left_align_indels docstring has the measurement).
    refs = {name: ref_by_name[name].codes for name in votes}
    if add_batch(votes, alignments, refs):
        trace.add('votes.native_alignments', len(alignments))
    else:
        for ref_name, cigar, i0, j0, codes, qv in alignments:
            with trace.span('left_align'):
                runs = left_align_indels(cigar, codes, refs[ref_name],
                                         i0, j0)
            with trace.span('vote_add'):
                votes[ref_name].add_alignment(runs, i0, j0, codes,
                                              qv.astype(np.int64))
        trace.add('votes.python_alignments', len(alignments))

    with trace.span('consensus_call'):
        polished = _consensus(unitig_graph, votes, min_agreement)
    if collect_votes:
        return polished, mapping_quality, dict(unitig_depths), votes
    return polished, mapping_quality, dict(unitig_depths)


def _consensus(unitig_graph, votes, min_agreement):
    """Consensus call per unitig from the round's column votes: unitig
    name -> polished sequence."""
    from ..io.fastx import decode_sequence
    polished = {}
    for name, seg in unitig_graph.segments.items():
        v = votes[name]
        original = seg.forward_sequence
        n = len(original)
        best_code, best_count, _ = v.best_bases()
        cover = v.cover
        gap = v.gap
        # covered = any read SPANS the column, including pure-deletion
        # coverage: a spurious assembly insertion gets ONLY gap votes
        # (every read aligns around it, none through it), and counting
        # just base votes marked it "uncovered" and kept it verbatim —
        # the 27-bp-surviving-polish bug on perfect-read OLC assemblies.
        covered = (v.base.sum(axis=1) > 0) | (gap > 0)
        orig_arr = np.frombuffer(original.encode(), dtype='S1')
        best_arr = np.frombuffer(decode_sequence(best_code).encode(),
                                 dtype='S1')
        if min_agreement > 0.0:
            span = np.maximum(1, cover + gap)
            change_ok = best_count >= min_agreement * span
            chars = np.where(covered & change_ok, best_arr, orig_arr)
            keep = ~covered | (gap <= best_count) \
                | (gap < min_agreement * span)
        else:
            chars = np.where(covered, best_arr, orig_arr)
            keep = ~covered | (gap <= best_count)
        # an insertion before column b + 1 is a candidate only where more
        # than half of the reads covering b vote for one (and, with
        # min_agreement, at least that share of them)
        n_ins = v.ins_counts()[1:]
        cov_b = np.maximum(1, cover)
        take = 2 * n_ins > cov_b
        if min_agreement != 0.0:
            take &= n_ins >= min_agreement * cov_b
        cols = np.nonzero(take)[0] + 1
        accepted = []
        for p, texts in zip(cols.tolist(), v.ins_texts(cols)):
            counts = Counter(texts)
            best_ins, cnt = counts.most_common(1)[0]
            if 2 * cnt > len(texts) or len(counts) == 1:
                accepted.append((p, best_ins))
        if not accepted:
            polished[name] = chars[keep].tobytes().decode()
        else:
            accepted.sort()
            out, prev = [], 0
            for p, text in accepted:
                span = slice(prev, p)
                out.append(chars[span][keep[span]].tobytes().decode())
                out.append(text)
                prev = p
            out.append(chars[prev:][keep[prev:]].tobytes().decode())
            polished[name] = ''.join(out)
    return polished


def polish_unitigs(unitig_graph, reads, scoring_scheme, hybrid,
                   device=None):
    """The full polish loop with early stopping and inter-round rotation
    (semantics of ref polish_unitigs_with_racon :288-419)."""
    device = resolve_device(device)
    log.log_section_header('Polishing miniasm assembly')
    scoring = scoring_scheme.to_ops()
    loop_count = (settings.RACON_POLISH_LOOP_COUNT_HYBRID if hybrid
                  else settings.RACON_POLISH_LOOP_COUNT_LONG_ONLY)
    best_quality = 0.0
    best_sequences = {}
    best_depths = {}
    fails = 0
    for round_num in range(loop_count + 3):
        with trace.span('polish_round_%d' % round_num):
            polished, quality, depths = polish_round(unitig_graph, reads,
                                                     scoring, device=device)
        log.log('  polish round %d: quality %.2f' % (round_num, quality), 2)
        if quality > best_quality:
            best_quality = quality
            best_sequences = {name: seg.forward_sequence for name, seg
                              in unitig_graph.segments.items()}
            best_depths = depths
            fails = 0
        else:
            fails += 1
        if fails > 2 or round_num >= loop_count:
            break
        with trace.span('polish_round_%d' % round_num), \
                trace.span('replace_with_polished_sequences'):
            unitig_graph.replace_with_polished_sequences(
                polished, scoring_scheme, device=device)
        unitig_graph.rotate_circular_sequences()

    if best_sequences:
        from ..misc import reverse_complement
        for name, seq in best_sequences.items():
            segment = unitig_graph.segments[name]
            segment.forward_sequence = seq
            segment.reverse_sequence = reverse_complement(seq)
            if name in best_depths:
                segment.depth = best_depths[name]
        unitig_graph.normalise_read_depths()
    return unitig_graph


def final_short_read_polish(graph, short_read_files, scoring_scheme,
                            rounds=2, device=None):
    """Short-read polish of the FINAL assembly graph (the Pilon role in
    older Unicycler releases): bridge sequences built from long-read
    consensus carry ~0.5-2% error patches, and one round of short-read
    column voting removes them. Runs after bridging/merging, before
    rotation. Mutates segment sequences in place; returns the number of
    changed segments."""
    from ..io.fastx import load_long_reads
    from ..misc import reverse_complement

    reads = []
    for path in short_read_files:
        if not path:
            continue
        d, names, _ = load_long_reads(path, silent=True)
        reads.extend(d[n] for n in names)
    if not reads or not graph.segments:
        return 0

    log.log_section_header('Polishing assembly with short reads')
    scoring = scoring_scheme.to_ops()
    total_changed = 0
    for round_num in range(1, rounds + 1):
        # multi-placement + near-unanimity: see polish_round docstring —
        # the final graph holds near-duplicate copies of bridge-consensus
        # sequence, and best-placement voting starves the erroneous copy
        polished, quality, _ = polish_round(graph, reads, scoring,
                                            multi_place=True,
                                            min_agreement=0.9, device=device)
        changed = 0
        for name, seq in polished.items():
            segment = graph.segments[name]
            if seq and seq != segment.forward_sequence:
                segment.forward_sequence = seq
                segment.reverse_sequence = reverse_complement(seq)
                if hasattr(segment, '_codes'):
                    segment._codes = None
                changed += 1
        log.log('round %d: %d/%d segments changed (mapping quality '
                '%.1f)' % (round_num, changed, len(graph.segments),
                           quality))
        total_changed += changed
        if changed == 0:
            break
    return total_changed
