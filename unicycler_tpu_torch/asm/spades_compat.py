"""External-SPAdes interop helpers (a copy of
unicycler_tpu/asm/spades_compat.py).

The framework's own de Bruijn assembler (asm/debruijn.py) replaces the
SPAdes subprocess, but users coming from the reference may still want to
drive an external SPAdes and feed its GFA in via --short_read_graph.
This module provides the same helper surface the reference exposes in
unicycler/spades_func.py (FASTQ sanity counters and the function that
builds the SPAdes command, ref spades_func.py:220-252, 409-446) so
existing workflows and the reference's own test_spades_func.py keep
working.
"""

import gzip

from ..misc import get_compression_type


class BadFastq(Exception):
    pass


def _open_maybe_gz(filename):
    if get_compression_type(filename) == 'gz':
        return gzip.open(filename, 'rb')
    return open(filename, 'rb')


def get_read_lengths(reads_filename):
    """Lengths of every read in a (possibly gzipped) FASTQ."""
    if reads_filename is None:
        return []
    lengths = []
    with _open_maybe_gz(reads_filename) as reads:
        for i, line in enumerate(reads):
            if i % 4 == 1:
                lengths.append(len(line.strip()))
    return lengths


def get_read_count(reads_filename):
    """Number of reads in a (possibly gzipped) FASTQ; raises BadFastq on
    records whose header line does not start with '@' (which also
    catches files whose 4-line framing has slipped)."""
    if reads_filename is None:
        return 0
    count = 0
    with _open_maybe_gz(reads_filename) as reads:
        for i, line in enumerate(reads):
            if i % 4 == 0:
                if not line.startswith(b'@'):
                    raise BadFastq
                count += 1
    return count


def build_spades_command(spades_path, spades_dir, threads, kmers, i,
                         short1, short2, unpaired, using_paired_reads,
                         using_unpaired_reads, spades_options,
                         spades_version):
    """Command line for one k of an external SPAdes run (incremental
    --restart-from scheme). Mirrors the contract the reference's SPAdes
    code and tests pin down: first k passes the reads and --careful/--isolate;
    later ks restart from the previous k's work dir; SPAdes 4.x needs
    --gfa11 for a GFA the graph loader can parse; -m 1024 is appended
    unless the user's options already set a memory cap."""
    kmer_string = ','.join(str(x) for x in kmers[:i + 1])
    command = [spades_path, '-o', spades_dir, '-k', kmer_string,
               '--threads', str(threads)]
    extra = spades_options.split() if spades_options else []
    if spades_version.startswith('4.'):
        command.append('--gfa11')
    if i == 0:
        if '--careful' in extra:
            if '--isolate' in extra:
                raise ValueError(
                    "SPAdes options '--careful' and '--isolate' are not "
                    'compatible; please choose one or the other')
            command.append('--careful')
            extra.remove('--careful')
        else:
            command.append('--isolate')
            if '--isolate' in extra:
                extra.remove('--isolate')
        if using_paired_reads:
            command += ['-1', short1, '-2', short2]
        if using_unpaired_reads:
            command += ['-s', unpaired]
    else:
        command += ['--restart-from', 'k%d' % kmers[i - 1]]
        for opt in ('--careful', '--isolate'):
            if opt in extra:
                extra.remove(opt)
    command += extra
    if '-m' not in extra:
        command += ['-m', '1024']
    return command
