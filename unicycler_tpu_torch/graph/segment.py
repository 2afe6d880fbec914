"""Assembly-graph segment: one node holding a double-stranded sequence.

Behavioral parity with reference unicycler/assembly_graph_segment.py:27-211
(a copy of unicycler_tpu/graph/segment.py).
Sequences are strings (graph topology work is host-side); device code pulls
int8 code arrays on demand via the codes() helper.
"""

from ..misc import reverse_complement


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

    def gfa_segment_line(self):
        return ('S\t' + str(self.number) + '\t' + self.forward_sequence
                + '\tLN:i:' + str(self.get_length())
                + '\tdp:f:' + str(self.depth) + '\n')

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

