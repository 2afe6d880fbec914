"""Deterministic synthetic long-read workloads, made with numpy from a seed.

A bacterial-style genome (random replicons) and long reads sampled from
random positions and strands with log-normal lengths and substitution /
insertion / deletion errors. Returns plain strings, so the same workload
can be loaded into this package's Reference/Read objects or any other
package's.
"""

import random
from typing import List, NamedTuple

import numpy as np

from .misc import reverse_complement
from .pipeline.fake_reads import _mutate_read

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


def simulate_read_set(rng, replicons, depth, n50=15000, min_len=1000,
                      max_len=60000, sub=0.04, ins=0.02, dele=0.02,
                      sigma=0.6):
    """Long reads of circular replicons at `depth`-fold coverage: reads of
    the simulate_reads length and error model are drawn until their true
    spans total depth x the genome's length. A read may run past its
    replicon's end and wrap to its start (truth.end may exceed the
    replicon's length). Returns [(name, sequence, ReadTruth)]."""
    lens = np.array([len(r) for r in replicons], np.float64)
    lut = np.zeros(256, np.int8)
    lut[_BASES] = np.arange(4)
    codes = [lut[np.frombuffer(r.encode(), np.uint8)] for r in replicons]
    mu = np.log(n50) - sigma ** 2
    target, total, reads = depth * lens.sum(), 0, []
    while total < target:
        rep = int(rng.choice(len(replicons), p=lens / lens.sum()))
        length = int(np.clip(rng.lognormal(mu, sigma), min_len,
                             min(max_len, len(replicons[rep]))))
        start = int(rng.integers(0, len(replicons[rep])))
        piece = np.take(codes[rep], np.arange(start, start + length),
                        mode='wrap')
        rev = bool(rng.integers(0, 2))
        if rev:
            piece = _COMP[piece[::-1]]
        seq = _to_str(_mutate(rng, piece, sub, ins, dele))
        reads.append(('read_%d' % len(reads), seq,
                      ReadTruth(rep, rev, start, start + length)))
        total += length
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


def zigzag_tasks(rng, sizes, amp=44, step=24, sub=0.03, ins=0.01,
                 dele=0.01):
    """Global banded-DP tasks whose corridors zigzag: per size n, a random
    reference of n bases and a mutated copy of it as the query, with
    corridor anchors every `step` rows alternately `amp` diagonals above
    and below the straight line from (0, 0) to the end. A group-quantized
    wavefront window lags such a corridor where a per-row band follows it,
    so a no-free-end alignment can find no path in the first and a real
    one in the second. Returns [(q, r, corridor_read, corridor_ref)]."""
    out = []
    for n in sizes:
        ref = rng.integers(0, 4, n).astype(np.int8)
        q = _mutate(rng, ref, sub, ins, dele).astype(np.int8)
        rows = np.arange(0, len(q) + step, step)
        rows[-1] = len(q)
        cf = np.round(rows * (n / len(q))).astype(np.int64)
        cf[1:-1] += amp * (np.arange(1, len(rows) - 1) % 2 * 2 - 1)
        out.append((q, ref, rows.astype(np.int32), cf.astype(np.int32)))
    return out


class RepeatCopy(NamedTuple):
    family: int        # index into the family list
    long_allele: bool  # the copy carries the family's indel insert
    left: int          # number of the unique segment before the copy
    right: int         # number of the unique segment after it
    start: int         # the copy's span [start, end) in the chromosome
    end: int
    path: tuple        # the copy's true graph path, left to right


def repeat_genome(rng, unique_lens, families):
    """A chromosome of unique stretches with repeat copies planted between
    them, and its collapsed overlap-0 assembly graph.

    families: [(repeat length, number of copies, indel)]. With indel > 0
    the repeat is A + X + B with X an `indel`-bp insert that about half of
    the family's copies carry (a length-variant bubble in the graph: links
    A -> X -> B and A -> B); with indel 0 it is one segment R. The copies
    go, in a shuffled order, between consecutive unique stretches, so
    len(unique_lens) must be one more than the number of copies. Unique
    stretch i is segment i + 1 (depth 1); repeat segments follow, with the
    copy counts as depths. Returns (chromosome, gfa_text, copies)."""
    n_copies = sum(f[1] for f in families)
    assert len(unique_lens) == n_copies + 1
    uniques = random_replicons(rng, unique_lens)
    seqs = {n + 1: u for n, u in enumerate(uniques)}
    depths = {n: 1.0 for n in seqs}
    links = set()
    order = []
    for fi, (length, copies, indel) in enumerate(families):
        seq = random_replicons(rng, [length])[0]
        num = len(seqs) + 1
        if indel:
            a_len = (length - indel) // 2
            parts = (seq[:a_len], seq[a_len:a_len + indel],
                     seq[a_len + indel:])
            a, x, b = num, num + 1, num + 2
            links.update([(a, x), (x, b), (a, b)])
            n_long = copies // 2 + (copies % 2) * int(rng.integers(0, 2))
            alleles = [True] * n_long + [False] * (copies - n_long)
            rng.shuffle(alleles)
            order += [(fi, (a, x, b) if long_ else (a, b))
                      for long_ in alleles]
            depths.update({a: float(copies), x: float(n_long),
                           b: float(copies)})
        else:
            parts = (seq,)
            order += [(fi, (num,))] * copies
            depths[num] = float(copies)
        for k, part in enumerate(parts):
            seqs[num + k] = part
    order = [order[k] for k in rng.permutation(len(order))]

    chrom, copies_out = [uniques[0]], []
    pos = len(uniques[0])
    for i, (fi, path) in enumerate(order):
        copy = ''.join(seqs[n] for n in path)
        copies_out.append(RepeatCopy(fi, len(path) == 3, i + 1, i + 2, pos,
                                     pos + len(copy), path))
        chrom += [copy, uniques[i + 1]]
        pos += len(copy) + len(uniques[i + 1])
        links.update([(i + 1, path[0]), (path[-1], i + 2)])
    lines = ['S\t%d\t%s\tDP:f:%.1f\n' % (n, seqs[n], depths[n])
             for n in sorted(seqs)]
    lines += ['L\t%d\t+\t%d\t+\t0M\n' % (s, e) for s, e in sorted(links)]
    return ''.join(chrom), ''.join(lines), copies_out


def reads_around(rng, chrom, copies, per_copy, n50=15000, min_flank=600,
                 max_len=60000, sub=0.04, ins=0.02, dele=0.02, sigma=0.6):
    """`per_copy` long reads spanning each repeat copy, with at least
    `min_flank` bases of unique sequence on both sides, random strands,
    log-normal lengths of N50 ~ n50 (the simulate_reads model, clipped to
    [span + 2 * min_flank, max_len] and to the chromosome) and the same
    error model. Returns
    [(name, sequence, copy index)]."""
    lut = np.zeros(256, np.int8)
    lut[_BASES] = np.arange(4)
    codes = lut[np.frombuffer(chrom.encode(), np.uint8)]
    mu = np.log(n50) - sigma ** 2
    reads = []
    for ci, cp in enumerate(copies):
        for k in range(per_copy):
            need = cp.end - cp.start + 2 * min_flank
            length = int(np.clip(rng.lognormal(mu, sigma), need,
                                 max(need, min(max_len, len(chrom)))))
            lo = max(0, cp.end + min_flank - length)
            hi = min(cp.start - min_flank, len(chrom) - length)
            start = int(rng.integers(lo, hi + 1))
            piece = codes[start:start + length]
            if rng.integers(0, 2):
                piece = _COMP[piece[::-1]]
            reads.append(('copy%d_read%d' % (ci, k),
                          _to_str(_mutate(rng, piece, sub, ins, dele)), ci))
    return reads


def short_read_pairs(rng, replicons, depth, read_length=150,
                     insert_mean=400.0, insert_sd=40.0, error_rate=0.005,
                     indel_frac=0.1):
    """Illumina-style read pairs of circular replicons at `depth`-fold
    coverage (2 x read_length bases a pair). Fragments start uniformly on
    each circle (pairs per replicon in proportion to its length), their
    lengths are normal (insert_mean +- insert_sd, at least read_length),
    each comes from a random strand, mate 1 reads the fragment's start and
    mate 2 its end reverse-complemented, and both take
    fake_reads._mutate_read's error model (substitutions and rare 1 bp
    indels at error_rate, the read length kept). Unlike
    fake_reads.make_fake_short_reads, which tiles a 100 bp pair at every
    position, the pairs are drawn at random up to the depth. Returns
    (pairs_1, pairs_2) of (name, sequence, quality)."""
    lens = np.array([len(r) for r in replicons], np.int64)
    n_pairs = int(round(depth * lens.sum() / (2 * read_length)))
    per_rep = np.floor(n_pairs * lens / lens.sum()).astype(np.int64)
    per_rep[0] += n_pairs - per_rep.sum()
    py_rng = random.Random(int(rng.integers(0, 2 ** 31)))
    qual = 'I' * read_length
    pairs_1, pairs_2 = [], []
    for rep, (seq, n) in enumerate(zip(replicons, per_rep)):
        starts = rng.integers(0, len(seq), n)
        sizes = np.maximum(read_length, np.rint(
            rng.normal(insert_mean, insert_sd, n)).astype(np.int64))
        flips = rng.integers(0, 2, n).astype(bool)
        doubled = seq + seq[:int(sizes.max()) if n else 0]
        for start, size, flip in zip(starts.tolist(), sizes.tolist(),
                                     flips.tolist()):
            fragment = doubled[start:start + size]
            if flip:
                fragment = reverse_complement(fragment)
            num = len(pairs_1) + 1
            pairs_1.append(('pair_%d/1' % num, _mutate_read(
                fragment[:read_length], error_rate, py_rng, indel_frac),
                qual))
            pairs_2.append(('pair_%d/2' % num, _mutate_read(
                reverse_complement(fragment[-read_length:]), error_rate,
                py_rng, indel_frac), qual))
    return pairs_1, pairs_2
