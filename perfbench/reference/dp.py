"""Best scores of semi-global Gotoh alignments, in plain PyTorch.

Scoring: a match adds `match`, a mismatch `mismatch`, and a gap of
length L adds open + (L - 1) * extend. All four ends are free: the path
may start anywhere in the first row or column and end anywhere in the
last row or column, so a clipped end of either sequence costs nothing.
A code of 4 (N) matches nothing.

The matrix is filled a row at a time, every column and every pair of
the batch at once. The horizontal gap of a row is a prefix maximum:
E[j] = open + (j - 1) * extend + max_{k < j} (H'[k] - k * extend),
where H' is the cell's best without a horizontal gap (a gap run starts
from a cell that does not itself end one, since open < extend). Columns
past a pair's own end never feed a column inside it, so pairs of
different lengths share one padded batch.

`dtype` is the precision of every score: int32 for the reference; a
narrower type wraps as the hardware does, which is what the control
(control.py) computes.
"""

import numpy as np
import torch


def semiglobal_best(qs, rs, scoring, device, dtype=torch.int32,
                    free_query_ends=True):
    """The best score of each pair (qs[b] against rs[b], int8 code
    arrays) as a list of ints. With free_query_ends=False every base of
    the query is aligned (the path runs from the first row to the last)
    and only the reference's ends are free."""
    match, mismatch, gap_open, gap_ext = scoring
    B = len(qs)
    if B == 0:
        return []
    n_max = max(len(q) for q in qs)
    m_max = max(len(r) for r in rs)
    q = torch.full((B, n_max), 5, dtype=torch.int8)
    r = torch.full((B, m_max), 6, dtype=torch.int8)
    for b in range(B):
        q[b, :len(qs[b])] = torch.from_numpy(np.asarray(qs[b], np.int8))
        r[b, :len(rs[b])] = torch.from_numpy(np.asarray(rs[b], np.int8))
    q, r = q.to(device), r.to(device)
    n = torch.tensor([len(x) for x in qs], device=device)
    m = torch.tensor([len(x) for x in rs], device=device)
    r_ok = r < 4

    def const(v):
        return torch.tensor(v, dtype=dtype, device=device)

    neg = const(np.iinfo(np.dtype(str(dtype).split('.')[-1])).min // 2)
    s_open, s_ext = const(gap_open), const(gap_ext)
    # the substitution score of each query code (0-3 bases, 4 N, 5 the
    # padding past a query's end) against every column: (B * 6, m) rows,
    # row b * 6 + c for pair b and code c; a query row picks its B rows
    codes = torch.arange(6, device=device).view(1, 6, 1)
    tab = torch.where((r.view(B, 1, m_max).long() == codes)
                      & r_ok.view(B, 1, m_max),
                      const(match), const(mismatch)).view(B * 6, m_max)
    pick = (torch.arange(B, device=device).view(1, B) * 6
            + q.t().long())                       # (n_max, B)
    # E's column terms k * extend and open + (j - 1) * extend, in dtype
    idx = torch.arange(m_max + 1, device=device)
    ramp = (idx * gap_ext).to(dtype)
    e_base = (s_open - s_ext) + ramp[1:]
    in_row = idx.view(1, -1) <= m.view(B, 1)
    col_m = m.view(B, 1)
    # column 0: nothing of the reference yet; free, or a gap in the query
    rows = torch.arange(n_max + 1, device=device)
    edges = torch.zeros((n_max + 1,), dtype=dtype, device=device) \
        if free_query_ends else \
        torch.where(rows > 0, (gap_open - gap_ext + rows * gap_ext).to(dtype),
                    torch.zeros((), dtype=dtype, device=device))
    H = torch.zeros((B, m_max + 1), dtype=dtype, device=device)  # row 0
    F = torch.full((B, m_max), int(neg), dtype=dtype, device=device)
    # buffers, written in place a row at a time
    sub = torch.empty((B, m_max), dtype=dtype, device=device)
    Hp = torch.empty_like(sub)
    tmp = torch.empty_like(sub)
    X = torch.zeros((B, m_max), dtype=dtype, device=device)
    run = torch.empty_like(sub)
    arg = torch.empty((B, m_max), dtype=torch.long, device=device)
    last = torch.empty((n_max + 1, B), dtype=dtype, device=device)
    last[0] = 0
    best = torch.zeros((B,), dtype=dtype, device=device)
    ends = {}
    for b, x in enumerate(qs):
        ends.setdefault(len(x), []).append(b)
    for i in range(1, n_max + 1):
        if not free_query_ends:
            X[:, 0] = edges[i]
        torch.index_select(tab, 0, pick[i - 1], out=sub)
        torch.add(H[:, 1:], s_open, out=tmp)
        torch.add(F, s_ext, out=F)
        torch.maximum(tmp, F, out=F)
        torch.add(H[:, :-1], sub, out=Hp)
        torch.maximum(Hp, F, out=Hp)
        # run[j] = max over k <= j of (H' at column k, edge at 0) - k * ext
        torch.sub(Hp[:, :-1], ramp[1:m_max], out=X[:, 1:])
        torch.cummax(X, dim=1, out=(run, arg))
        torch.add(run, e_base, out=tmp)
        torch.maximum(Hp, tmp, out=H[:, 1:])
        if not free_query_ends:
            H[:, 0] = edges[i]
        # the last column of every pair (a pair's own rows are kept below)
        torch.gather(H, 1, col_m, out=last[i].view(B, 1))
        if i in ends:
            # the last row of the pairs that end here
            row_best = torch.where(in_row, H, neg).max(dim=1).values
            hit = torch.zeros((B,), dtype=torch.bool, device=device)
            hit[ends[i]] = True
            best = torch.where(hit, torch.maximum(best, row_best)
                               if free_query_ends else row_best, best)
    if free_query_ends:
        own = rows.view(-1, 1) <= n.view(1, B)
        best = torch.maximum(best, torch.where(own, last, neg).max(dim=0)
                             .values)
    return [int(x) for x in best.cpu()]
