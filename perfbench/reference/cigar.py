"""A reported alignment checked against the bases it claims to align.

The alignment is given as its CIGAR (SAM parts: S clips, M, I, D), the
read's codes in the aligned orientation, the reference's codes and the
reported span. It is walked from its start: M columns score match or
mismatch, a gap run of length L scores open + (L - 1) * extend.
"""

import re

import numpy as np

_PART = re.compile(r'(\d+)([MIDS])')


def parse(parts):
    """SAM CIGAR parts ('12S', '100M', ...) as (counts, ops) arrays."""
    text = ''.join(parts)
    found = _PART.findall(text)
    if ''.join(c + o for c, o in found) != text:
        raise ValueError('not a CIGAR of S, M, I and D: %r' % text[:80])
    counts = np.array([int(c) for c, _ in found], np.int64)
    ops = np.array([o for _, o in found], 'U1')
    return counts, ops


def walk(read, ref, read_start, ref_start, counts, ops, scoring):
    """Walk a CIGAR without clips from (read_start, ref_start). Returns
    (score, read_end, ref_end), or None where it leaves either
    sequence."""
    match, mismatch, gap_open, gap_ext = scoring
    m, ins, dele = ops == 'M', ops == 'I', ops == 'D'
    if not (m | ins | dele).all():
        return None
    adv_read = np.where(dele, 0, counts)
    adv_ref = np.where(ins, 0, counts)
    read_end = read_start + int(adv_read.sum())
    ref_end = ref_start + int(adv_ref.sum())
    if read_start < 0 or ref_start < 0 or read_end > len(read) \
            or ref_end > len(ref):
        return None
    r0 = read_start + np.cumsum(adv_read) - adv_read
    f0 = ref_start + np.cumsum(adv_ref) - adv_ref
    rm, fm, cm = r0[m], f0[m], counts[m]
    total = int(cm.sum())
    if total:
        rows = np.repeat(rm - np.cumsum(cm) + cm, cm) + np.arange(total)
        cols = np.repeat(fm - np.cumsum(cm) + cm, cm) + np.arange(total)
        a, b = read[rows], ref[cols]
        same = int(np.count_nonzero((a == b) & (a < 4)))
    else:
        same = 0
    gaps = ins | dele
    n_runs = int(gaps.sum())
    gap_len = int(counts[gaps].sum())
    score = same * match + (total - same) * mismatch \
        + n_runs * gap_open + (gap_len - n_runs) * gap_ext
    return score, read_end, ref_end


def check(read, ref, span, parts, scores, scoring):
    """Faults of one reported alignment: its CIGAR's clips against the
    read span, the walk's end against the reported ends, and the walked
    score against each reported score (the alignment's and its DP's).
    span: (read_start, read_end, ref_start, ref_end), the read in the
    aligned orientation. Returns a list of fault names (empty: sound)."""
    read_start, read_end, ref_start, ref_end = span
    try:
        counts, ops = parse(parts)
    except ValueError:
        return ['unparsed']
    faults = []
    lead = int(counts[0]) if len(ops) and ops[0] == 'S' else 0
    trail = int(counts[-1]) if len(ops) > 1 and ops[-1] == 'S' else 0
    body = slice(1 if lead else 0, len(ops) - 1 if trail else len(ops))
    if lead != read_start or trail != len(read) - read_end:
        faults.append('clips')
    got = walk(read, ref, read_start, ref_start, counts[body], ops[body],
               scoring)
    if got is None:
        return faults + ['walk']
    score, r_end, f_end = got
    if (r_end, f_end) != (read_end, ref_end):
        faults.append('ends')
    if any(s is not None and int(s) != score for s in scores):
        faults.append('score')
    return faults


def check_pair(q, r, s1_start, s1_end, s2_start, s2_end, score, cigar,
               scoring):
    """Faults of one DP result over the task it was given (q, r: the
    task's query and reference window codes): its CIGAR, a list of
    (count, op) with op in M, I, D, walked from (s1_start, s2_start),
    must end at (s1_end, s2_end) and give `score`."""
    counts = np.array([int(c) for c, _ in cigar], np.int64)
    ops = np.array([o for _, o in cigar], 'U1')
    got = walk(q, r, s1_start, s2_start, counts, ops, scoring)
    if got is None:
        return ['walk']
    faults = []
    if (got[1], got[2]) != (s1_end, s2_end):
        faults.append('ends')
    if got[0] != score:
        faults.append('score')
    return faults
