"""The Alignment model: a long read aligned to one reference.

Capability parity with reference unicycler/alignment.py:45-368. An
Alignment can be built three ways:
  * from a device PairAlignment (replaces the C++ seqan output string path,
    ref alignment.py:97-116)
  * from a SAM line (ref alignment.py:118-140)
  * directly from fields (internal)
The CIGAR tally (score/identity/error counts, ref alignment.py:142-216) is
vectorised with numpy over the encoded sequences instead of a char loop.
"""

import re

import numpy as np

from ..misc import float_to_str, reverse_complement

_OP_CHARS = np.array(['M', 'I', 'D'])


class Alignment(object):

    def __init__(self, read=None, ref=None, scoring_scheme=None,
                 pair_alignment=None, rev_comp=None, ref_offset=0,
                 sam_line=None, read_dict=None, reference_dict=None):
        assert scoring_scheme is not None
        self.read = read
        self.ref = ref
        self.read_start_pos = None
        self.read_end_pos = None
        self.read_end_gap = None
        self.ref_start_pos = None
        self.ref_end_pos = None
        self.rev_comp = rev_comp
        self._runs = None
        self.cigar_parts = None
        self.match_count = 0
        self.mismatch_count = 0
        self.insertion_count = 0
        self.deletion_count = 0
        self.alignment_length = None
        self.edit_distance = None
        self.percent_identity = None
        self.raw_score = None
        self.scaled_score = None
        self.milliseconds = 0

        if sam_line is not None:
            self._setup_from_sam(sam_line, read_dict, reference_dict)
        elif pair_alignment is not None:
            self._setup_from_pair(pair_alignment, ref_offset)
        self._tally_up(scoring_scheme)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_runs(cls, read, ref, scoring_scheme, rev_comp,
                  read_start, read_end, ref_start, ref_end,
                  counts, op_codes):
        """Rebuild an Alignment from its serialised coordinate + CIGAR-run
        form (the multi-host allgather wire format,
        parallel/distributed.py). Scores re-tally deterministically from
        the sequences, so reconstructed objects equal the originals."""
        from ..ops.pairwise import PairAlignment

        class _Runs(object):
            def __init__(self, c, o):
                self.counts = np.asarray(c, np.int64)
                self.op_codes = np.asarray(o, np.int8)

        pa = PairAlignment(score=0, s1_start=read_start, s1_end=read_end,
                           s2_start=ref_start, s2_end=ref_end,
                           cigar=_Runs(counts, op_codes),
                           s1_len=read.get_length(),
                           s2_len=ref.get_length())
        return cls(read=read, ref=ref, scoring_scheme=scoring_scheme,
                   pair_alignment=pa, rev_comp=rev_comp)

    def _setup_from_pair(self, pa, ref_offset):
        """From a device PairAlignment (s1 = read in aligned orientation,
        s2 = trimmed ref window starting at ref_offset). The CIGAR is kept
        as numpy run arrays; the string parts list materialises lazily
        (only alignments that reach the SAM writer need it)."""
        self.read_start_pos = pa.s1_start
        self.read_end_pos = pa.s1_end
        self.read_end_gap = self.read.get_length() - self.read_end_pos
        self.ref_start_pos = pa.s2_start + ref_offset
        self.ref_end_pos = pa.s2_end + ref_offset
        cigar = pa.cigar
        if hasattr(cigar, 'op_codes'):
            self._runs = (cigar.counts, cigar.op_codes)
        else:
            counts = np.array([c for c, _ in cigar], np.int64)
            codes = np.array([{'M': 0, 'I': 1, 'D': 2}[op]
                              for _, op in cigar], np.int8)
            self._runs = (counts, codes)

    @property
    def cigar_parts(self):
        if self._cigar_parts is None and self._runs is not None:
            counts, op_codes = self._runs
            parts = []
            if self.read_start_pos:
                parts.append(str(self.read_start_pos) + 'S')
            parts.extend(np.char.add(counts.astype('U'),
                                     _OP_CHARS[op_codes]).tolist())
            if self.read_end_gap:
                parts.append(str(self.read_end_gap) + 'S')
            self._cigar_parts = parts
        return self._cigar_parts

    @cigar_parts.setter
    def cigar_parts(self, value):
        self._cigar_parts = value

    def _setup_from_sam(self, sam_line, read_dict, reference_dict):
        from ..misc import get_nice_header
        parts = sam_line.split('\t', 6)
        self.rev_comp = bool(int(parts[1]) & 0x10)
        self.cigar_parts = re.findall(r'\d+\w', parts[5])
        self.read = read_dict[parts[0]]
        self.read_start_pos = self.get_start_soft_clips()
        self.read_end_pos = self.read.get_length() - self.get_end_soft_clips()
        self.read_end_gap = self.get_end_soft_clips()
        self.ref = reference_dict[get_nice_header(parts[2])]
        self.ref_start_pos = int(parts[3]) - 1
        self.ref_end_pos = self.ref_start_pos
        for cigar_part in self.cigar_parts:
            op = cigar_part[-1]
            if op in 'MD':
                self.ref_end_pos += int(cigar_part[:-1])
        self.ref_end_pos = min(self.ref_end_pos, len(self.ref.sequence))

    # -- scoring -----------------------------------------------------------

    def _tally_up(self, scoring_scheme):
        """Walk the CIGAR computing counts, raw and scaled scores
        (semantics of ref alignment.py:142-216, numpy-vectorised)."""
        self.match_count = 0
        self.mismatch_count = 0
        self.insertion_count = 0
        self.deletion_count = 0
        self.percent_identity = 0.0
        self.raw_score = 0

        if self._runs is not None:
            self._tally_up_runs(scoring_scheme)
            return

        cigar_parts = list(self.cigar_parts)
        if cigar_parts and cigar_parts[0][-1] == 'S':
            cigar_parts.pop(0)
        if cigar_parts and cigar_parts[-1][-1] == 'S':
            cigar_parts.pop()
        if not cigar_parts:
            return

        read_codes = self.read.codes
        if self.rev_comp:
            from ..ops.encode import revcomp_codes
            read_codes = revcomp_codes(read_codes)
        ref_codes = self.ref.codes
        read_i = self.read_start_pos
        ref_i = self.ref_start_pos
        align_i = 0
        for cigar_part in cigar_parts:
            count = int(cigar_part[:-1])
            op = cigar_part[-1]
            if op == 'I':
                self.raw_score += (scoring_scheme.gap_open
                                   + (count - 1) * scoring_scheme.gap_extend)
                self.insertion_count += count
                read_i += count
            elif op == 'D':
                self.raw_score += (scoring_scheme.gap_open
                                   + (count - 1) * scoring_scheme.gap_extend)
                self.deletion_count += count
                ref_i += count
            else:  # M
                n = min(count, len(read_codes) - read_i,
                        len(ref_codes) - ref_i)
                if n > 0:
                    eq = int(np.count_nonzero(
                        read_codes[read_i:read_i + n]
                        == ref_codes[ref_i:ref_i + n]))
                    self.match_count += eq
                    self.mismatch_count += n - eq
                    self.raw_score += (eq * scoring_scheme.match
                                       + (n - eq) * scoring_scheme.mismatch)
                read_i += count
                ref_i += count
            align_i += count

        self.percent_identity = 100.0 * self.match_count / align_i
        self.edit_distance = (self.mismatch_count + self.insertion_count
                              + self.deletion_count)
        self.alignment_length = align_i
        perfect = scoring_scheme.match * align_i
        worst = scoring_scheme.mismatch * align_i
        self.scaled_score = 100.0 * (self.raw_score - worst) / (perfect - worst)

    def _tally_up_runs(self, scoring_scheme):
        """Fully-vectorised tally over numpy CIGAR run arrays (the hot
        path: alignments decoded from device records)."""
        counts, op_codes = self._runs
        if len(counts) == 0:
            return
        read_codes = self.read.codes
        if self.rev_comp:
            from ..ops.encode import revcomp_codes
            read_codes = revcomp_codes(read_codes)
        ref_codes = self.ref.codes
        ins = op_codes == 1
        dele = op_codes == 2
        m = op_codes == 0
        self.insertion_count = int(counts[ins].sum())
        self.deletion_count = int(counts[dele].sum())
        n_gap_runs = int(np.count_nonzero(ins) + np.count_nonzero(dele))
        gap_total = self.insertion_count + self.deletion_count
        raw = (n_gap_runs * scoring_scheme.gap_open
               + (gap_total - n_gap_runs) * scoring_scheme.gap_extend)
        adv_read = np.where(dele, 0, counts)
        adv_ref = np.where(ins, 0, counts)
        r0 = self.read_start_pos + np.cumsum(adv_read) - adv_read
        f0 = self.ref_start_pos + np.cumsum(adv_ref) - adv_ref
        rm, fm, cm = r0[m], f0[m], counts[m]
        n_eff = np.minimum(cm, np.minimum(len(read_codes) - rm,
                                          len(ref_codes) - fm))
        n_eff = np.maximum(n_eff, 0)
        from ..ops.minimizer import _expand_ranges
        idx = _expand_ranges(rm, n_eff)
        jdx = _expand_ranges(fm, n_eff)
        eq = int(np.count_nonzero(read_codes[idx] == ref_codes[jdx]))
        tot = int(n_eff.sum())
        self.match_count = eq
        self.mismatch_count = tot - eq
        raw += (eq * scoring_scheme.match
                + (tot - eq) * scoring_scheme.mismatch)
        self.raw_score = int(raw)
        align_i = int(counts.sum())
        self.percent_identity = 100.0 * self.match_count / align_i
        self.edit_distance = (self.mismatch_count + self.insertion_count
                              + self.deletion_count)
        self.alignment_length = align_i
        perfect = scoring_scheme.match * align_i
        worst = scoring_scheme.mismatch * align_i
        self.scaled_score = 100.0 * (self.raw_score - worst) / (perfect - worst)

    # -- accessors (parity with ref alignment.py:218-368) ------------------

    def __repr__(self):
        read_start, read_end = self.read_start_end_positive_strand()
        s = self.read.name + ' (' + str(read_start) + '-' + str(read_end) + ', '
        s += 'strand: -), ' if self.rev_comp else 'strand: +), '
        s += (self.ref.name + ' (' + str(self.ref_start_pos) + '-'
              + str(self.ref_end_pos) + ')')
        if self.scaled_score is not None:
            s += ', raw score = ' + str(self.raw_score)
            s += ', scaled score = ' + float_to_str(self.scaled_score, 2)
        if self.percent_identity is not None:
            s += ', ' + float_to_str(self.percent_identity, 2) + '% ID'
        return s

    def get_aligned_ref_length(self):
        return self.ref_end_pos - self.ref_start_pos

    def get_aligned_read_length(self):
        return self.read_end_pos - self.read_start_pos

    def get_ref_to_read_ratio(self):
        return self.get_aligned_ref_length() / self.get_aligned_read_length()

    def get_read_to_ref_ratio(self):
        return 1.0 / self.get_ref_to_read_ratio()

    def read_start_end_positive_strand(self):
        return (self.read_start_positive_strand(),
                self.read_end_positive_strand())

    def read_start_positive_strand(self):
        if self.rev_comp:
            return self.read.get_length() - self.read_end_pos
        return self.read_start_pos

    def read_end_positive_strand(self):
        if self.rev_comp:
            return self.read.get_length() - self.read_start_pos
        return self.read_end_pos

    def get_start_soft_clips(self):
        if self._runs is not None:
            return self.read_start_pos or 0
        if self.cigar_parts and self.cigar_parts[0][-1] == 'S':
            return int(self.cigar_parts[0][:-1])
        return 0

    def get_end_soft_clips(self):
        if self._runs is not None:
            return self.read_end_gap or 0
        if self.cigar_parts and self.cigar_parts[-1][-1] == 'S':
            return int(self.cigar_parts[-1][:-1])
        return 0

    def get_sam_line(self):
        """SAM emission (parity with ref alignment.py:304-333)."""
        parts = [self.read.name, '16' if self.rev_comp else '0',
                 self.ref.name, str(self.ref_start_pos + 1), '255',
                 ''.join(self.cigar_parts), '*', '0', '0']
        if self.rev_comp:
            parts.append(reverse_complement(self.read.sequence))
            parts.append(self.read.qualities[::-1])
        else:
            parts.append(self.read.sequence)
            parts.append(self.read.qualities)
        parts.append('AS:i:' + str(self.raw_score))
        parts.append('NM:i:' + str(self.mismatch_count + self.insertion_count
                                   + self.deletion_count))
        return '\t'.join(parts) + '\n'

    def is_very_similar(self, other):
        """Redundancy test: same read/ref/strand, >=90% overlap
        (ref alignment.py:335-358)."""
        if self.read.name != other.read.name:
            return False
        if self.ref.name != other.ref.name:
            return False
        if self.rev_comp != other.rev_comp:
            return False
        this_start, this_end = self.read_start_end_positive_strand()
        other_start, other_end = other.read_start_end_positive_strand()
        if other_start > this_end or this_start > other_end:
            return False
        overlap = min(this_end, other_end) - max(this_start, other_start)
        smaller = min(this_end - this_start, other_end - other_start)
        if smaller == 0:
            return False
        return overlap / smaller >= 0.9

    def get_signed_ref_num(self):
        return -self.ref.number if self.rev_comp else self.ref.number
