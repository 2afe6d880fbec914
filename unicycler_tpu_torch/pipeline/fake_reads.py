"""Deterministic synthetic read generation for end-to-end testing (a copy
of unicycler_tpu/pipeline/fake_reads.py).

The role of reference test/fake_reads.py:26-90: a 'perfect fake
sequencer' producing 100 bp reads at 300 bp inserts, tiled at every
position on both strands of a (circular) genome — the substrate for the
random-sequence assembly property test. Unlike the reference's, this
sequencer can also inject a realistic Illumina-style error model
(substitutions plus rare short indels) so the error-correction and
graph-cleaning stages get exercised end to end.
"""

import random

from ..misc import reverse_complement

_BASES = 'ACGT'


def _mutate_read(seq, error_rate, rng, indel_frac=0.1):
    """Apply per-base errors: (1-indel_frac) substitutions, the rest
    single-base insertions/deletions, keeping the read length fixed by
    trimming/padding at the 3' end like a real sequencer's fixed cycle
    count."""
    out = []
    target = len(seq)
    for ch in seq:
        r = rng.random()
        if r >= error_rate:
            out.append(ch)
        elif r < error_rate * (1 - indel_frac):
            out.append(rng.choice([b for b in _BASES if b != ch]))
        elif r < error_rate * (1 - indel_frac / 2):
            out.append(rng.choice(_BASES))     # insertion before the base
            out.append(ch)
        # else: deletion (skip the base)
    s = ''.join(out)
    if len(s) < target:
        s += ''.join(rng.choice(_BASES) for _ in range(target - len(s)))
    return s[:target]


def make_fake_short_reads(genome, read_length=100, insert_size=300,
                          circular=True, error_rate=0.0, seed=0,
                          indel_frac=0.1):
    """Returns (pairs_1, pairs_2): lists of (name, seq, qual) tuples with
    every genome position covered on both strands. error_rate > 0 applies
    the Illumina-style error model per read."""
    pairs_1, pairs_2 = [], []
    qual = 'I' * read_length
    rng = random.Random(seed)
    extended = genome + genome[:insert_size] if circular else genome
    limit = len(genome) if circular else len(genome) - insert_size + 1
    read_num = 0
    for i in range(limit):
        fragment = extended[i:i + insert_size]
        if len(fragment) < insert_size:
            continue
        read_1 = fragment[:read_length]
        read_2 = reverse_complement(fragment[-read_length:])
        if error_rate > 0:
            read_1 = _mutate_read(read_1, error_rate, rng, indel_frac)
            read_2 = _mutate_read(read_2, error_rate, rng, indel_frac)
        read_num += 1
        pairs_1.append(('fake_%d/1' % read_num, read_1, qual))
        pairs_2.append(('fake_%d/2' % read_num, read_2, qual))
    return pairs_1, pairs_2


def _mutate_long(seq, error_rate, rng, indel_frac=0.5):
    """Long-read error model: half substitutions, half 1-2 bp indels
    (no length restoration — long-read lengths vary anyway)."""
    out = []
    for ch in seq:
        r = rng.random()
        if r >= error_rate:
            out.append(ch)
        elif r < error_rate * (1 - indel_frac):
            out.append(rng.choice([b for b in _BASES if b != ch]))
        elif r < error_rate * (1 - indel_frac / 2):
            out.append(rng.choice(_BASES))
            out.append(ch)
        # else deletion
    return ''.join(out)


def make_fake_long_reads(genome, read_length=10000, step=500,
                         circular=True, error_rate=0.0, seed=0):
    """Long reads tiled across the genome on both strands; error_rate > 0
    applies a nanopore-style substitution+indel model."""
    reads = []
    rng = random.Random(seed)
    extended = genome + genome[:read_length] if circular else genome
    limit = len(genome) if circular else max(1, len(genome) - read_length)
    read_num = 0
    for i in range(0, limit, step):
        seq = extended[i:i + read_length]
        if len(seq) < min(read_length, len(genome)):
            continue
        read_num += 1
        if read_num % 2 == 0:
            seq = reverse_complement(seq)
        if error_rate > 0:
            seq = _mutate_long(seq, error_rate, rng)
        reads.append(('fake_long_%d' % read_num, seq))
    return reads


def write_fastq(filename, reads):
    with open(filename, 'w') as f:
        for item in reads:
            if len(item) == 3:
                name, seq, qual = item
            else:
                name, seq = item
                qual = 'I' * len(seq)
            f.write('@%s\n%s\n+\n%s\n' % (name, seq, qual))
