"""Alignment scoring scheme (parity with ref unicycler/alignment.py:20-42)."""

from ..ops.pairwise import Scoring


class AlignmentScoringScheme(object):
    """Parses a "match,mismatch,gap_open,gap_extend" string. Default 3,-6,-5,-2."""

    def __init__(self, scheme_string='3,-6,-5,-2'):
        parts = scheme_string.split(',')
        self.match, self.mismatch, self.gap_open, self.gap_extend = 3, -6, -5, -2
        if len(parts) == 4:
            self.match = int(parts[0])
            self.mismatch = int(parts[1])
            self.gap_open = int(parts[2])
            self.gap_extend = int(parts[3])

    def __repr__(self):
        return ','.join(str(x) for x in (self.match, self.mismatch,
                                         self.gap_open, self.gap_extend))

    def get_full_string(self):
        return repr(self)

    def to_ops(self) -> Scoring:
        """Device-kernel scoring tuple."""
        return Scoring(self.match, self.mismatch, self.gap_open,
                       self.gap_extend)
