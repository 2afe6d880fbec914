"""The port's external-SPAdes helpers (unicycler_tpu_torch.asm.spades_compat)
against the JAX package's: the FASTQ counters on plain and gzipped files
and a malformed one, and build_spades_command over the cases its
contract names (first and later k, paired and unpaired reads, --careful
and --isolate, SPAdes 3.x and 4.x, a user memory cap).
"""

import gzip
import itertools

import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)

from unicycler_tpu.asm import spades_compat as js

from unicycler_tpu_torch.asm import spades_compat as ts

_FASTQ = ''.join('@r%d\n%s\n+\n%s\n' % (i, 'ACGT' * (i + 1), 'I' * 4 * (i + 1))
                 for i in range(7))


@pytest.mark.parametrize('gz', [False, True], ids=['plain', 'gzip'])
def test_fastq_counters_match_jax(tmp_path, gz):
    path = tmp_path / ('reads.fastq' + ('.gz' if gz else ''))
    if gz:
        with gzip.open(path, 'wt') as f:
            f.write(_FASTQ)
    else:
        path.write_text(_FASTQ)
    assert ts.get_read_lengths(str(path)) == js.get_read_lengths(str(path)) \
        == [4 * (i + 1) for i in range(7)]
    assert ts.get_read_count(str(path)) == js.get_read_count(str(path)) == 7
    assert ts.get_read_lengths(None) == [] and ts.get_read_count(None) == 0


def test_malformed_fastq_raises_bad_fastq(tmp_path):
    path = tmp_path / 'bad.fastq'
    path.write_text(_FASTQ + 'ACGT\n')        # framing slips at record 8
    path2 = tmp_path / 'bad2.fastq'
    path2.write_text('>fasta\nACGT\n')
    for p in (path, path2):
        with pytest.raises(js.BadFastq):
            js.get_read_count(str(p))
        with pytest.raises(ts.BadFastq):
            ts.get_read_count(str(p))


_KMERS = [21, 33, 55, 77]


@pytest.mark.parametrize('i,version,options,paired,unpaired', [
    (i, v, o, p, u) for i, v, o, (p, u) in itertools.product(
        [0, 2], ['3.15.5', '4.0.0'],
        [None, '--careful', '--isolate', '--careful -m 4000',
         '--cov-cutoff auto', '-m 500 --isolate'],
        [(True, False), (False, True), (True, True)])])
def test_build_spades_command_matches_jax(i, version, options, paired,
                                          unpaired):
    args = ('spades.py', 'out/spades', 4, _KMERS, i, 'r1.fq', 'r2.fq',
            'u.fq', paired, unpaired, options, version)
    got = ts.build_spades_command(*args)
    assert got == js.build_spades_command(*args)
    extra = options.split() if options else []
    assert got[:7] == ['spades.py', '-o', 'out/spades', '-k',
                       ','.join(str(k) for k in _KMERS[:i + 1]),
                       '--threads', '4']
    assert ('--gfa11' in got) == version.startswith('4.')
    assert got.count('-m') == 1
    assert ('1024' in got) == ('-m' not in extra)
    if i == 0:
        assert ('--careful' in got) != ('--isolate' in got)
        assert ('-1' in got) == paired and ('-s' in got) == unpaired
    else:
        assert got[got.index('--restart-from') + 1] == 'k%d' % _KMERS[i - 1]
        assert '--careful' not in got and '--isolate' not in got
        assert '-1' not in got and '-s' not in got


def test_careful_with_isolate_raises():
    for mod in (js, ts):
        with pytest.raises(ValueError, match='not compatible'):
            mod.build_spades_command('spades.py', 'o', 1, _KMERS, 0, 'a',
                                     'b', None, True, False,
                                     '--careful --isolate', '3.15.5')
    # at a later k the pair is dropped, not refused
    assert ts.build_spades_command(
        'spades.py', 'o', 1, _KMERS, 1, 'a', 'b', None, True, False,
        '--careful --isolate', '3.15.5') == js.build_spades_command(
        'spades.py', 'o', 1, _KMERS, 1, 'a', 'b', None, True, False,
        '--careful --isolate', '3.15.5')
