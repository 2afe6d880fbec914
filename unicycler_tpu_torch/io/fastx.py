"""FASTA/FASTQ(.gz) IO and the Read / Reference data model.

Capability parity with reference unicycler/read_ref.py (load_references :27,
load_long_reads :93, Reference :241, Read :266) and misc.py fasta loaders
(:320-368). Differences by design:
  * Sequences are additionally cached as int8 base-code numpy arrays
    (A=0 C=1 G=2 T=3 other=4) so device batches can be built without
    re-encoding strings.
  * Duplicate-name handling, conflict filtering, and fraction-aligned
    semantics match the reference exactly (tie-break via random.random(),
    ref read_ref.py:299).
"""

import gzip
import os
import random

import numpy as np

from .. import log, settings
from ..misc import (add_line_breaks_to_sequence, get_compression_type,
                    get_nice_header, get_open_function, get_sequence_file_type,
                    quit_with_error, range_is_contained, range_overlap_size,
                    simplify_ranges, strip_read_extensions)

# Base-code lookup table: ASCII -> code. A/a=0, C/c=1, G/g=2, T/t=3, rest 4.
_ENCODE_LUT = np.full(256, 4, dtype=np.int8)
for i, b in enumerate('ACGT'):
    _ENCODE_LUT[ord(b)] = i
    _ENCODE_LUT[ord(b.lower())] = i
_DECODE_LUT = np.frombuffer(b'ACGTN', dtype=np.uint8)


def encode_sequence(seq: str) -> np.ndarray:
    """String -> int8 base-code array."""
    raw = np.frombuffer(seq.encode('ascii'), dtype=np.uint8)
    return _ENCODE_LUT[raw]


def decode_sequence(codes: np.ndarray) -> str:
    return _DECODE_LUT[np.asarray(codes, dtype=np.int64)].tobytes().decode('ascii')


class Reference(object):
    """A reference sequence: name + uppercase sequence (ref read_ref.py:241)."""

    def __init__(self, name, sequence):
        self.name = name
        self.sequence = sequence.upper()
        try:
            self.number = int(name)
        except ValueError:
            self.number = 0
        self._codes = None

    def __repr__(self):
        return self.name + ' (' + str(len(self.sequence)) + ' bp)'

    def get_length(self):
        return len(self.sequence)

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = encode_sequence(self.sequence)
        return self._codes


class Read(object):
    """A long read with its alignments (ref read_ref.py:266)."""

    def __init__(self, name, sequence, qualities):
        self.name = name
        self.sequence = sequence.upper()
        # Missing qualities become '+' (Phred+33 for 10% error, ref :278-280).
        self.qualities = qualities if qualities else '+' * len(self.sequence)
        self.alignments = []
        self._codes = None

    def __repr__(self):
        return self.name + ' (' + str(len(self.sequence)) + ' bp)'

    def get_length(self):
        return len(self.sequence)

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = encode_sequence(self.sequence)
        return self._codes

    def remove_conflicting_alignments(self, allowed_overlap):
        """Greedy keep-best filter over the read's alignments
        (semantics of ref read_ref.py:293-326)."""
        self.alignments = sorted(self.alignments, reverse=True,
                                 key=lambda x: (x.raw_score, random.random()))
        kept = []
        kept_ranges = []
        for alignment in self.alignments:
            this_range = alignment.read_start_end_positive_strand()
            if range_is_contained(this_range, kept_ranges):
                continue
            if range_overlap_size(this_range, kept_ranges) > allowed_overlap:
                continue
            if any(k.is_very_similar(alignment) for k in kept):
                continue
            kept.append(alignment)
            kept_ranges = simplify_ranges(kept_ranges + [this_range])
        self.alignments = sorted(
            kept, key=lambda x: x.read_start_end_positive_strand()[0])

    def remove_low_score_alignments(self, low_score_threshold):
        self.alignments = [a for a in self.alignments
                           if a.scaled_score is not None
                           and a.scaled_score >= low_score_threshold]

    def remove_short_alignments(self, min_align_length):
        self.alignments = [a for a in self.alignments
                           if a.get_aligned_ref_length() >= min_align_length]

    def get_fastq(self):
        return ('@' + self.name + '\n' + self.sequence + '\n+\n'
                + self.qualities + '\n')

    def get_fasta(self):
        return '>' + self.name + '\n' + add_line_breaks_to_sequence(self.sequence, 70)

    def get_fraction_aligned(self):
        if len(self.sequence) == 0:
            return 0.0
        ranges = simplify_ranges(
            [a.read_start_end_positive_strand() for a in self.alignments])
        return sum(b - a for a, b in ranges) / len(self.sequence)

    def get_reference_bases_aligned(self):
        return sum(a.get_aligned_ref_length() for a in self.alignments)

    def has_one_contained_alignment(self):
        return (len(self.alignments) == 1
                and self.alignments[0].read_start_pos == 0
                and self.alignments[0].read_end_gap == 0)

    def mostly_aligns_to_contamination(self):
        if len(self.sequence) == 0 or not self.alignments:
            return False
        contam = sum(a.get_aligned_read_length() for a in self.alignments
                     if a.ref.name.startswith('CONTAMINATION_'))
        good = sum(a.get_aligned_read_length() for a in self.alignments
                   if not a.ref.name.startswith('CONTAMINATION_'))
        return contam >= good

    def aligns_to_multiple_single_copy_segments(self, single_copy_segment_names):
        return sum(a.ref.name in single_copy_segment_names
                   for a in self.alignments) > 1


def load_fasta(filename):
    """[(name, seq)] for each record (semantics of ref misc.py:320-342)."""
    return [(name, seq) for name, _, seq in load_fasta_with_full_header(filename)]


def load_fasta_with_full_header(filename):
    """[(name, full_header, seq)] for each record (ref misc.py:345-368)."""
    records = []
    open_func = get_open_function(filename)
    with open_func(filename, 'rt') as f:
        name, header, chunks = '', '', []
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith('>'):
                if name:
                    records.append((name, header, ''.join(chunks)))
                    chunks = []
                header = line[1:]
                name = header.split()[0]
            else:
                chunks.append(line)
        if name:
            records.append((name, header, ''.join(chunks)))
    return records


def load_references(fasta_filename, contamination=False,
                    section_header='Loading references', show_progress=True):
    """Load a FASTA into Reference objects (ref read_ref.py:27-90)."""
    if section_header:
        log.log_section_header(section_header)
    try:
        if get_sequence_file_type(fasta_filename) != 'FASTA':
            quit_with_error(fasta_filename + ' is not in FASTA format')
    except ValueError:
        quit_with_error(fasta_filename + ' is not in FASTA format')

    references = []
    for name, header, seq in load_fasta_with_full_header(fasta_filename):
        nice = get_nice_header(header)
        if contamination:
            nice = 'CONTAMINATION_' + nice
        references.append(Reference(nice, seq))
    if not references:
        quit_with_error('There are no references sequences in ' + fasta_filename)
    if show_progress:
        total = sum(r.get_length() for r in references)
        log.log('  loaded %d references (%d bp)' % (len(references), total), 2)
    return references


def load_long_reads(filename, silent=False, section_header='Loading reads',
                    output_dir=None):
    """Load FASTA/FASTQ(.gz) reads; returns (read_dict, read_names, filename).

    Duplicate read names get a trailing _N and a duplicate-free file is
    written, matching ref read_ref.py:93-238.
    """
    try:
        file_type = get_sequence_file_type(filename)
    except ValueError:
        file_type = ''
        quit_with_error(filename + ' is not in either FASTA or FASTQ format')
    open_func = get_open_function(filename)
    if not silent:
        log.log_section_header(section_header)

    read_dict, read_names = {}, []
    duplicates_found = False

    def add_read(original_name, sequence, qualities):
        nonlocal duplicates_found
        name, n = original_name, 1
        while name in read_dict:
            duplicates_found = True
            n += 1
            name = original_name + '_' + str(n)
        read_dict[name] = Read(name, sequence, qualities)
        read_names.append(name)

    if file_type == 'FASTQ':
        with open_func(filename, 'rt') as fastq:
            for line in fastq:
                stripped = line.strip()
                if not stripped or not stripped.startswith('@'):
                    continue
                name = stripped[1:].split()[0]
                sequence = next(fastq).strip()
                next(fastq)
                qualities = next(fastq).strip()
                add_read(name, sequence, qualities)
    else:
        for name, header, seq in load_fasta_with_full_header(filename):
            add_read(get_nice_header(header), seq, None)

    if not read_dict:
        quit_with_error('There are no read sequences in ' + filename)
    if not silent:
        total = sum(r.get_length() for r in read_dict.values())
        log.log('  loaded %d reads (%d bp)' % (len(read_dict), total), 2)

    if duplicates_found:
        no_dup = strip_read_extensions(filename) + '_no_duplicates'
        no_dup += '.fastq.gz' if file_type == 'FASTQ' else '.fasta.gz'
        base_dir = (output_dir if output_dir is not None
                    else os.path.dirname(os.path.abspath(filename)))
        no_dup_filename = os.path.join(base_dir, no_dup)
        if not silent:
            log.log('\nDuplicate read names found. Saving duplicate-free file:')
            log.log(no_dup_filename)
        with gzip.open(no_dup_filename, 'wb') as f:
            for read_name in read_names:
                read = read_dict[read_name]
                out = read.get_fastq() if file_type == 'FASTQ' else read.get_fasta()
                f.write(out.encode())
    else:
        no_dup_filename = filename

    return read_dict, read_names, no_dup_filename


def get_read_nickname_dict(read_names):
    """Shortest unambiguous prefixes as nicknames (ref read_ref.py:426-444)."""
    max_len = max(len(name) for name in read_names)
    for length in range(1, max_len):
        nicknames = set()
        for name in read_names:
            nick = name[:length]
            if nick in nicknames:
                break
            nicknames.add(nick)
        else:
            return {name: name[:length] for name in read_names}
    return {name: name for name in read_names}
