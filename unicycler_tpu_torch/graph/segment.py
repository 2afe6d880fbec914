"""Assembly-graph segment: one node holding a double-stranded sequence.

Behavioral parity with reference unicycler/assembly_graph_segment.py:27-211
(a copy of unicycler_tpu/graph/segment.py).
Sequences are strings (graph topology work is host-side); device code pulls
int8 code arrays on demand via the codes() helper.
"""

from ..misc import add_line_breaks_to_sequence, reverse_complement


class Segment(object):

    def __init__(self, number, depth, sequence, positive, bridge=None,
                 graph_path=None, original_depth=True):
        self.number = number
        self.depth = depth
        self.original_depth = original_depth
        self.bridge = bridge
        self.graph_path = graph_path
        self.forward_sequence = sequence if positive else ''
        self.reverse_sequence = '' if positive else sequence
        self.used_in_bridges = []
        self._codes = None

    def __repr__(self):
        seq = self.forward_sequence
        shown = seq if len(seq) <= 6 else seq[:3] + '...' + seq[-3:]
        return str(self.number) + ' (' + shown + ')'

    def add_sequence(self, sequence, positive):
        if positive:
            self.forward_sequence = sequence
        else:
            self.reverse_sequence = sequence
        self._codes = None

    def build_other_sequence_if_necessary(self):
        if not self.forward_sequence:
            self.forward_sequence = reverse_complement(self.reverse_sequence)
        if not self.reverse_sequence:
            self.reverse_sequence = reverse_complement(self.forward_sequence)

    def codes(self):
        """int8 base codes of the forward sequence (cached)."""
        if self._codes is None or len(self._codes) != len(self.forward_sequence):
            from ..io.fastx import encode_sequence
            self._codes = encode_sequence(self.forward_sequence)
        return self._codes

    def get_length(self):
        return len(self.forward_sequence)

    def get_length_no_overlap(self, overlap):
        return len(self.forward_sequence) - overlap

    def is_homopolymer(self):
        seq = self.forward_sequence.lower()
        return len(seq) > 0 and seq.count(seq[0]) == len(seq)

    def gfa_segment_line(self):
        return ('S\t' + str(self.number) + '\t' + self.forward_sequence
                + '\tLN:i:' + str(self.get_length())
                + '\tdp:f:' + str(self.depth) + '\n')

    def get_fasta_name_and_description_line(self, circular_seg_nums=None):
        line = ('>' + str(self.number) + ' length=' + str(self.get_length())
                + ' depth=' + ('%.2f' % self.depth) + 'x')
        if circular_seg_nums and self.number in circular_seg_nums:
            line += ' circular=true'
        return line + '\n'

    def save_to_fasta(self, fasta_filename):
        with open(fasta_filename, 'w') as fasta:
            fasta.write(self.get_fasta_name_and_description_line())
            fasta.write(add_line_breaks_to_sequence(self.forward_sequence))

    def get_seg_type_label(self):
        """Bridge-type label for GFA display (ref segment.py:113-135)."""
        if self.bridge is None:
            return ''
        label = self.bridge.get_type_name() + ' bridge'
        if self.graph_path:
            import textwrap
            path_str = ', '.join(str(x) for x in self.graph_path)
            label += ':\\n' + '\\n'.join(textwrap.wrap(path_str, 40))
        return label

    def trim_from_end(self, amount):
        assert self.get_length() >= amount
        if amount == 0:
            return
        self.forward_sequence = self.forward_sequence[:-amount]
        self.reverse_sequence = self.reverse_sequence[amount:]
        self._codes = None

    def trim_from_start(self, amount):
        assert self.get_length() >= amount
        if amount == 0:
            return
        self.forward_sequence = self.forward_sequence[amount:]
        self.reverse_sequence = self.reverse_sequence[:-amount]
        self._codes = None

    def append_to_forward_sequence(self, additional_seq):
        self.forward_sequence = self.forward_sequence + additional_seq
        self.reverse_sequence = reverse_complement(self.forward_sequence)
        self._codes = None

    def append_to_reverse_sequence(self, additional_seq):
        self.reverse_sequence = self.reverse_sequence + additional_seq
        self.forward_sequence = reverse_complement(self.reverse_sequence)
        self._codes = None

    def prepend_to_forward_sequence(self, additional_seq):
        self.forward_sequence = additional_seq + self.forward_sequence
        self.reverse_sequence = reverse_complement(self.forward_sequence)
        self._codes = None

    def prepend_to_reverse_sequence(self, additional_seq):
        self.reverse_sequence = additional_seq + self.reverse_sequence
        self.forward_sequence = reverse_complement(self.reverse_sequence)
        self._codes = None

    def remove_sequence(self):
        self.forward_sequence = ''
        self.reverse_sequence = ''
        self._codes = None

    def rotate_sequence(self, start_pos, flip):
        """Rotate a circular segment to start at start_pos; optionally flip
        strands (ref segment.py:196-211)."""
        rotated = self.forward_sequence[start_pos:] + \
            self.forward_sequence[:start_pos]
        rc_rotated = reverse_complement(rotated)
        if flip:
            self.forward_sequence, self.reverse_sequence = rc_rotated, rotated
        else:
            self.forward_sequence, self.reverse_sequence = rotated, rc_rotated
        self._codes = None
