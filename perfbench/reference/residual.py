"""Differences of a sequence from the truth it should equal, counted in
pieces: the truth is cut into pieces, and each piece is aligned whole,
at unit cost (a mismatch, an inserted and a deleted base each cost 1),
against the part of the sequence where it should lie (its position
scaled by the two lengths, with a margin on each side, whose ends are
free). The pieces run as one batch of reference/dp.py."""

from . import dp

UNIT = (0, -1, -1, -1)


def differences(truths, seqs, piece, margin, device):
    """Summed differences of each seqs[k] (codes) from truths[k] (codes);
    a sequence that is missing (None) differs in every base."""
    qs, rs = [], []
    for truth, seq in zip(truths, seqs):
        L = len(truth)
        Ls = 0 if seq is None else len(seq)
        for a in range(0, L, piece):
            b = min(L, a + piece)
            lo = max(0, a * Ls // L - margin)
            hi = min(Ls, b * Ls // L + margin)
            qs.append(truth[a:b])
            rs.append(seq[lo:hi] if seq is not None and hi > lo
                      else truth[:0])
    best = dp.semiglobal_best(qs, rs, UNIT, device, free_query_ends=False)
    return -sum(best)
