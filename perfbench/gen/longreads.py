"""The general generator of long-read alignment traffic.

A traffic file (traffic/<name>.json) gives the read model and the job
shape; a configuration file gives the genome. Every seed gets the same
job: the same multiset of read lengths, drawn once from the traffic's
`length_seed`, in an order, at positions, on strands and with errors
drawn from the run's seed. So runs on different seeds do the same
amount of work, and a seed changes only which bases are aligned.
"""

import numpy as np

from . import synth


def seed_rng(seed, salt=0):
    """A numpy generator from any whole number (seeds may exceed
    32 bits) and a salt that keeps the streams of one run apart."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), int(salt)])


def genome(config, seed):
    """The configuration's replicons as strings, from `seed`."""
    return synth.random_replicons(seed_rng(seed, 1), config['replicons'])


def job_lengths(traffic):
    """The read lengths of one job: log-normal with N50 ~ n50, clipped to
    [min_len, max_len], from the traffic's fixed length_seed."""
    m = traffic['reads']
    rng = np.random.default_rng(int(traffic['length_seed']))
    mu = np.log(m['n50']) - m['sigma'] ** 2
    lens = rng.lognormal(mu, m['sigma'], traffic['reads_per_job'])
    return np.clip(lens, m['min_len'], m['max_len']).astype(np.int64)


def depth_lengths(traffic, total):
    """Read lengths drawn from the traffic's fixed length_seed (the
    model of job_lengths) until they sum to depth x total bases."""
    m = traffic['reads']
    rng = np.random.default_rng(int(traffic['length_seed']))
    mu = np.log(m['n50']) - m['sigma'] ** 2
    out, acc = [], 0
    while acc < traffic['depth'] * total:
        length = int(np.clip(rng.lognormal(mu, m['sigma']), m['min_len'],
                             m['max_len']))
        out.append(length)
        acc += length
    return np.array(out, np.int64)


def cover_reads(rng, replicons, circular, lengths, model):
    """Reads of each of the given lengths, in a shuffled order, with the
    model's substitution / insertion / deletion rates (the error model of
    synth.simulate_reads): each on a replicon chosen by length, at a
    uniform start and strand; a read on a circular replicon may wrap past
    its end, one on a linear replicon lies inside it. Returns
    [(sequence, ReadTruth)]."""
    lens = np.array([len(r) for r in replicons], np.float64)
    codes = [_codes(r) for r in replicons]
    out = []
    for length in rng.permutation(lengths):
        rep = int(rng.choice(len(replicons), p=lens / lens.sum()))
        length = int(min(length, len(replicons[rep])))
        if circular[rep]:
            start = int(rng.integers(0, len(replicons[rep])))
            piece = np.take(codes[rep], np.arange(start, start + length),
                            mode='wrap')
        else:
            start = int(rng.integers(0, len(replicons[rep]) - length + 1))
            piece = codes[rep][start:start + length]
        rev = bool(rng.integers(0, 2))
        if rev:
            piece = synth._COMP[piece[::-1]]
        seq = synth._to_str(synth._mutate(rng, piece, model['sub'],
                                          model['ins'], model['del']))
        out.append((seq, synth.ReadTruth(rep, rev, start, start + length)))
    return out


def mutated(rng, seq, model):
    """seq (a string) with the model's substitution, insertion and
    deletion errors."""
    return synth._to_str(synth._mutate(rng, _codes(seq), model['sub'],
                                       model['ins'], model['del']))


def _codes(seq):
    lut = np.zeros(256, np.int8)
    lut[np.frombuffer(b'ACGT', np.uint8)] = np.arange(4)
    return lut[np.frombuffer(seq.encode(), np.uint8)]
