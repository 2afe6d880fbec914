"""Deterministic synthetic long-read workloads, made with numpy from a seed.

A bacterial-style genome (random replicons) and long reads sampled from
random positions and strands with log-normal lengths and substitution /
insertion / deletion errors. Returns plain strings, so the same workload
can be loaded into this package's Reference/Read objects or any other
package's.
"""

from typing import List, NamedTuple

import numpy as np

_BASES = np.frombuffer(b'ACGT', np.uint8)
_COMP = np.array([3, 2, 1, 0], np.int8)


class ReadTruth(NamedTuple):
    replicon: int      # index into the replicon list
    rev_comp: bool     # read comes from the reverse strand
    start: int         # reference span [start, end) on the forward strand
    end: int


def _to_str(codes):
    return _BASES[codes].tobytes().decode()


def random_replicons(rng, lengths) -> List[str]:
    return [_to_str(rng.integers(0, 4, n)) for n in lengths]


def _mutate(rng, codes, sub, ins, dele):
    """Apply per-base substitution, deletion and insertion (a random base
    after the base) errors, vectorised."""
    n = len(codes)
    u = rng.random(n)
    out = codes.copy()
    is_sub = u < sub
    out[is_sub] = (out[is_sub] + rng.integers(1, 4, int(is_sub.sum()))) % 4
    is_del = (u >= sub) & (u < sub + dele)
    is_ins = (u >= sub + dele) & (u < sub + dele + ins)
    counts = (~is_del).astype(np.int64) + is_ins
    idx = np.repeat(np.arange(n), counts)
    res = out[idx]
    # the second copy of an inserting base becomes a random base
    second = np.zeros(len(idx), bool)
    second[1:] = idx[1:] == idx[:-1]
    res[second] = rng.integers(0, 4, int(second.sum()))
    return res


def simulate_reads(rng, replicons, n_reads, n50=15000, min_len=1000,
                   max_len=60000, sub=0.04, ins=0.02, dele=0.02,
                   sigma=0.6):
    """Long reads from random positions and strands. Lengths are
    log-normal with N50 ~ n50 (for a log-normal, N50 = exp(mu + sigma^2)),
    clipped to [min_len, max_len] and to the replicon. Returns
    [(name, sequence, ReadTruth)]."""
    lens = np.array([len(r) for r in replicons], np.float64)
    codes = [np.frombuffer(r.encode(), np.uint8) for r in replicons]
    lut = np.zeros(256, np.int8)
    lut[_BASES] = np.arange(4)
    codes = [lut[c] for c in codes]
    mu = np.log(n50) - sigma ** 2
    reads = []
    for k in range(n_reads):
        rep = int(rng.choice(len(replicons), p=lens / lens.sum()))
        length = int(np.clip(rng.lognormal(mu, sigma), min_len,
                             min(max_len, len(replicons[rep]))))
        start = int(rng.integers(0, len(replicons[rep]) - length + 1))
        piece = codes[rep][start:start + length]
        rev = bool(rng.integers(0, 2))
        if rev:
            piece = _COMP[piece[::-1]]
        seq = _to_str(_mutate(rng, piece, sub, ins, dele))
        reads.append(('read_%d' % k, seq,
                      ReadTruth(rep, rev, start, start + length)))
    return reads


def banded_tasks(rng, sizes, drift=False, sub=0.06, ins=0.02, dele=0.02):
    """Standalone banded-DP tasks: per size n, a random reference window of
    n + 120 bases and a mutated copy of n of its bases as the query, with a
    straight corridor or (drift=True) one bent at the query's midpoint.
    Returns [(q, r, corridor_read, corridor_ref)] of int8 / int32 arrays."""
    out = []
    for n in sizes:
        ref = rng.integers(0, 4, n + 120).astype(np.int8)
        off = int(rng.integers(0, 80))
        q = _mutate(rng, ref[off:off + n], sub, ins, dele).astype(np.int8)
        if drift:
            mid = len(q) // 2
            cr = [0, mid, len(q)]
            cf = [off, off + mid + int(rng.integers(-20, 20)), off + n]
        else:
            cr = [0, len(q)]
            cf = [off, off + n]
        out.append((q, ref, np.array(cr, np.int32), np.array(cf, np.int32)))
    return out
