"""Multiple sequence consensus via star alignment.

Replaces the reference's SeqAn banded globalMsaAlignment + quality-aware
column voting (ref src/consensus_align.cpp:26-236, driven by
bridge_long_read.get_consensus_sequence :630). SeqAn's progressive MSA is
irregular and graph-shaped; the batched substitute is a star alignment:
every read batch-aligns to the best read (the backbone) in ONE device
launch, and columns are called by majority vote with summed base
qualities breaking ties — preserving the reference's most-common-base /
quality-tie-break semantics (consensus_align.cpp:159-236). Counterpart of
unicycler_tpu/ops/msa.py; the alignments run on `device` (None = CUDA).
"""

from collections import Counter

import numpy as np

from ..io.fastx import decode_sequence, encode_sequence
from . import dispatch
from . import pairwise as pw


def consensus_align(seqs, quals, scoring, device=None):
    """Consensus of the given sequences (first = best = backbone).

    seqs: list of str. quals: list of Phred+33 strings (same lengths).
    Returns the consensus string.
    """
    if not seqs:
        return ''
    if len(seqs) == 1:
        return seqs[0]
    backbone = seqs[0]
    backbone_qual = quals[0]
    n = len(backbone)

    backbone_codes = encode_sequence(backbone)
    others = [encode_sequence(s) for s in seqs[1:]]
    alignments = dispatch.batch_align(others,
                                      [backbone_codes] * len(others),
                                      scoring, pw.FULLY_GLOBAL, band=1000,
                                      need_cigar=True, device=device)

    # Vectorised vote accumulation (ops/votes.py): the backbone votes
    # once per column, each aligned read's runs expand to flat
    # scatter-adds — no per-base Python work.
    from .votes import ColumnVotes
    votes = ColumnVotes(n)
    bq = np.frombuffer(backbone_qual.encode()[:n].ljust(n, b'\x00'),
                       np.uint8).astype(np.int64)
    cols = np.arange(n)
    ok = (backbone_codes >= 0) & (backbone_codes <= 3)
    np.add.at(votes.base, (cols[ok], backbone_codes[ok].astype(np.int64)),
              1)
    np.add.at(votes.qual, (cols[ok], backbone_codes[ok].astype(np.int64)),
              bq[ok])
    for read_idx, pa in enumerate(alignments):
        if pa is None:
            continue
        qual = quals[read_idx + 1]
        codes = others[read_idx]
        qv = np.frombuffer(qual.encode()[:len(codes)].ljust(
            len(codes), b'\x00'), np.uint8).astype(np.int64)
        votes.add_alignment(pa.cigar, pa.s1_start, pa.s2_start,
                            codes, qv, seq=seqs[read_idx + 1])

    total_reads = 1 + sum(1 for a in alignments if a is not None)
    best_code, best_count, _ = votes.best_bases(
        prefer_codes=backbone_codes[:n])
    gap_votes = votes.gap
    keep = gap_votes <= best_count           # gap wins only strictly
    best_chars = decode_sequence(best_code)
    chars_arr = np.frombuffer(best_chars.encode(), dtype='S1')
    accepted = []                            # (position, insertion text)
    for p, ins in votes.ins.items():
        if len(ins) * 2 > total_reads and 1 <= p <= n:
            counts = Counter(s for s, _ in ins)
            best_ins, _ = max(counts.items(),
                              key=lambda kv: (kv[1],
                                              sum(q for s, q in ins
                                                  if s == kv[0])))
            accepted.append((p, best_ins))
    if not accepted:
        return chars_arr[keep].tobytes().decode()
    accepted.sort()
    out, prev = [], 0
    for p, text in accepted:
        span = slice(prev, p)
        out.append(chars_arr[span][keep[span]].tobytes().decode())
        out.append(text)
        prev = p
    out.append(chars_arr[prev:][keep[prev:]].tobytes().decode())
    return ''.join(out)
