"""Reference-compatible wrapper surface for the device aligners
(counterpart of unicycler_tpu/align/compat.py).

The reference exposes its C++ aligners through ctypes
(ref unicycler/cpp_wrappers.py); this module gives the same Python call
surface backed by the port's kernels, so reference-style callers work
unchanged. No pipeline stage calls it. Result strings follow
ScoredAlignment.getFullString (ref src/scoredalignment.cpp:139-156):
    refName,strand,readStart,readEnd,refStart,refEnd,raw,scaled,ms,CIGAR

Every function takes `device` (None = CUDA) and passes it down.
"""

import numpy as np

from ..io.fastx import encode_sequence
from ..ops import dispatch
from ..ops import pairwise as pw
from ..ops.msa import consensus_align


def _result_string(pa, scoring, ref_name='s2', rev_comp=False,
                   ref_offset=0, include_clips=False):
    scaled = dispatch.scaled_score(pa, scoring)
    if include_clips:
        cigar = pa.cigar_str_with_clips()
    else:
        cigar = ''.join(str(c) + op for c, op in pa.cigar)
    return ','.join([
        ref_name, '-' if rev_comp else '+', str(pa.s1_start),
        str(pa.s1_end), str(pa.s2_start + ref_offset),
        str(pa.s2_end + ref_offset), str(pa.score), '%.6f' % scaled,
        '0', cigar])


def fully_global_alignment(sequence_1, sequence_2, scoring_scheme,
                           use_banding=True, band_size=1000, device=None):
    """(role of ref global_align.cpp fullyGlobalAlignment)"""
    scoring = scoring_scheme.to_ops()
    pa = dispatch.align_pair(encode_sequence(sequence_1),
                             encode_sequence(sequence_2), scoring,
                             pw.FULLY_GLOBAL,
                             band=band_size if use_banding else None,
                             device=device)
    if pa is None:
        return ''
    return _result_string(pa, scoring)


def path_alignment(path_sequence, consensus_sequence, scoring_scheme,
                   use_banding=True, band_size=1000, device=None):
    """(role of ref path_align.cpp pathAlignment)"""
    scoring = scoring_scheme.to_ops()
    pa = dispatch.align_pair(encode_sequence(path_sequence),
                             encode_sequence(consensus_sequence), scoring,
                             pw.PATH_CONFIG,
                             band=band_size if use_banding else None,
                             device=device)
    if pa is None or pa.score < -1000000:
        return ''
    return _result_string(pa, scoring)


def semi_global_alignment_exhaustive(sequence_1, sequence_2,
                                     scoring_scheme, device=None):
    """(role of ref semi_global_align_exhaustive.cpp)"""
    scoring = scoring_scheme.to_ops()
    pa = dispatch.align_pair(encode_sequence(sequence_1),
                             encode_sequence(sequence_2), scoring,
                             pw.SEMI_GLOBAL, band=None, device=device)
    if pa is None:
        return ''
    return _result_string(pa, scoring, include_clips=True)


def overlap_alignment(sequence_1, sequence_2, scoring_scheme,
                      guess_overlap, device=None):
    """Overlap sizes between s1's end and s2's start: returns
    'overlap1,overlap2' (role of ref overlap_align.cpp:17-81)."""
    trim_size = int((guess_overlap + 100) * 1.5)
    s1 = sequence_1[-trim_size:] if trim_size < len(sequence_1) \
        else sequence_1
    s2 = sequence_2[:trim_size] if trim_size < len(sequence_2) \
        else sequence_2
    scoring = scoring_scheme.to_ops()
    pa = dispatch.align_pair(encode_sequence(s1), encode_sequence(s2),
                             scoring, pw.OVERLAP_CONFIG, band=None,
                             device=device)
    if pa is None:
        return '-1,-1'
    overlap_1 = len(s1) - pa.s1_start
    overlap_2 = pa.s2_end
    return '%d,%d' % (overlap_1, overlap_2)


def start_alignment(sequence_1, sequence_2, scoring_scheme, device=None):
    """s2 coordinate of s1's end when s1 sits at s2's start
    (ref start_end_align.cpp:19-21)."""
    from ..asm.hybrid import start_seq_alignment
    return start_seq_alignment(sequence_1, sequence_2, scoring_scheme,
                               device=device)


def end_alignment(sequence_1, sequence_2, scoring_scheme, device=None):
    """s2 coordinate of s1's start when s1 sits at s2's end
    (ref start_end_align.cpp:25-27)."""
    from ..asm.hybrid import end_seq_alignment
    return end_seq_alignment(sequence_1, sequence_2, scoring_scheme,
                             device=device)


def consensus_alignment(sequences, qualities, scoring_scheme,
                        bandwidth=1000, device=None):
    """Consensus + per-sequence identities
    (role of ref consensus_align.cpp multipleSequenceAlignment via
    cpp_wrappers.py:226-250)."""
    if not sequences:
        return '', []
    qualities = list(qualities) + [''] * (len(sequences) - len(qualities))
    qualities = [q if q else 'I' * len(s)
                 for s, q in zip(sequences, qualities)]
    if len(sequences) == 1:
        return sequences[0], [1.0]
    scoring = scoring_scheme.to_ops()
    consensus = consensus_align(list(sequences), qualities, scoring,
                                device=device)
    # per-sequence identity vs the consensus (ref consensus_align.cpp:
    # 139-147)
    cons_codes = encode_sequence(consensus)
    seq_codes = [encode_sequence(s) for s in sequences]
    alignments = dispatch.batch_align(seq_codes,
                                      [cons_codes] * len(sequences),
                                      scoring, pw.FULLY_GLOBAL,
                                      band=bandwidth, need_cigar=True,
                                      device=device)
    scores = []
    for s, pa in zip(sequences, alignments):
        if pa is None or not pa.cigar:
            scores.append(0.0)
            continue
        matches = 0
        align_len = 0
        i = pa.s1_start
        j = pa.s2_start
        for count, op in pa.cigar:
            align_len += count
            if op == 'M':
                for k in range(count):
                    if i + k < len(s) and j + k < len(consensus) and \
                            s[i + k] == consensus[j + k]:
                        matches += 1
                i += count
                j += count
            elif op == 'I':
                i += count
            else:
                j += count
        scores.append(matches / align_len if align_len else 0.0)
    return consensus, scores


def get_random_sequence_alignment_mean_and_std_dev(seq_length, count,
                                                   scoring_scheme,
                                                   device=None):
    """(role of ref random_alignments.cpp:30-52)"""
    from .semi_global import \
        get_random_sequence_alignment_mean_and_std_dev as impl
    return impl(seq_length, count, scoring_scheme, device=device)


def simulate_depths(read_lengths, ref_length, iterations, threads=1):
    """Min/max depth distributions from random read placement on a
    circular reference (role of ref random_alignments.cpp:204-319,
    exposed but unused by the reference pipeline). Host numpy."""
    rng = np.random.RandomState(0)
    read_lengths = np.asarray(read_lengths)
    min_depths = np.zeros(iterations, np.int64)
    max_depths = np.zeros(iterations, np.int64)
    for it in range(iterations):
        depth = np.zeros(ref_length, np.int32)
        starts = rng.randint(0, ref_length, len(read_lengths))
        for start, length in zip(starts, read_lengths):
            end = start + length
            if end <= ref_length:
                depth[start:end] += 1
            else:
                depth[start:] += 1
                depth[:end - ref_length] += 1
        min_depths[it] = depth.min()
        max_depths[it] = depth.max()
    return min_depths, max_depths
