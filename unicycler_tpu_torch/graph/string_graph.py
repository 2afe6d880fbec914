"""String graph: miniasm-style graph with per-link overlaps (a copy of
unicycler_tpu/graph/string_graph.py; the end-repair alignment takes a
`device`, None = CUDA).

Capability parity with reference unicycler/string_graph.py:33-611:
string-named segments signed with '+'/'-' suffixes, per-link overlap
sizes, branching-link removal, circularity tests, polished-sequence
end-repair, rotation, and unitig merging. The Racon end-repair alignment
(ref :301-355) runs through the device aligner instead of the C++
exhaustive semi-global call.
"""

from collections import defaultdict, deque

from .. import log, settings
from ..io.fastx import encode_sequence, load_fasta_with_full_header
from ..misc import add_line_breaks_to_sequence, reverse_complement
from .gfa import build_reverse_links


class StringGraph(object):

    def __init__(self, filename):
        self.segments = {}                      # unsigned name -> segment
        self.forward_links = defaultdict(list)  # signed name -> [signed]
        self.reverse_links = defaultdict(list)
        self.links = {}                         # (start, end) -> link
        if not filename:
            return
        with open(filename, 'rt') as f:
            first = f.read(1)
        if first == '>':
            self.load_from_fasta(filename)
        else:
            self.load_from_gfa(filename)

    def load_from_gfa(self, filename):
        with open(filename, 'rt') as gfa_file:
            for line in gfa_file:
                if line.startswith('S'):
                    parts = line.strip().split('\t')
                    self.segments[parts[1]] = StringGraphSegment(parts[1],
                                                                 parts[2])
        with open(filename, 'rt') as gfa_file:
            for line in gfa_file:
                if line.startswith('L'):
                    parts = line.strip().split('\t')
                    name_1 = parts[1] + parts[2]
                    name_2 = parts[3] + parts[4]
                    self.forward_links[name_1].append(name_2)
                    link_tuple = (name_1, name_2)
                    if link_tuple not in self.links:
                        self.links[link_tuple] = StringGraphLink(name_1,
                                                                 name_2)
                    overlap = int(parts[5][:-1])
                    self.links[link_tuple].seg_1_overlap = overlap
                    rev_tuple = (flip_segment_name(name_2),
                                 flip_segment_name(name_1))
                    if rev_tuple not in self.links:
                        self.links[rev_tuple] = StringGraphLink(*rev_tuple)
                    self.links[rev_tuple].seg_2_overlap = overlap
        self.reverse_links = build_reverse_links(self.forward_links)

    def load_from_fasta(self, filename):
        for name, header, sequence in load_fasta_with_full_header(filename):
            self.segments[name] = StringGraphSegment(name, sequence)
            if 'circular=true' in header.lower():
                self.forward_links[name + '+'].append(name + '+')
        self.reverse_links = build_reverse_links(self.forward_links)

    def save_to_gfa(self, filename, verbosity=1, newline=False,
                    include_depth=True):
        log.log(('\n' if newline else '') + 'Saving ' + filename, verbosity)
        with open(filename, 'w') as gfa:
            for segment in sorted(self.segments.values(),
                                  key=lambda x: x.full_name):
                gfa.write(segment.gfa_segment_line(include_depth))
            for link in sorted(self.links.keys()):
                gfa.write(self.links[link].gfa_link_line())

    def save_to_fasta(self, filename, min_length=1):
        with open(filename, 'w') as fasta:
            for segment in sorted(self.segments.values(), reverse=True,
                                  key=lambda x: x.get_length()):
                if segment.get_length() >= min_length:
                    fasta.write(segment.fasta_record())

    def get_preceding_segments(self, seg_name):
        return self.reverse_links.get(seg_name, [])

    def get_following_segments(self, seg_name):
        return self.forward_links.get(seg_name, [])

    def add_link(self, start, end, overlap_1, overlap_2):
        rev_start = flip_segment_name(start)
        rev_end = flip_segment_name(end)
        for d, a, b in ((self.forward_links, start, end),
                        (self.forward_links, rev_end, rev_start)):
            d.setdefault(a, [])
            if b not in d[a]:
                d[a].append(b)
        for d, a, b in ((self.reverse_links, end, start),
                        (self.reverse_links, rev_start, rev_end)):
            d.setdefault(a, [])
            if b not in d[a]:
                d[a].append(b)
        self.links[(start, end)] = StringGraphLink(start, end)
        self.links[(start, end)].seg_1_overlap = overlap_1
        self.links[(start, end)].seg_2_overlap = overlap_2
        self.links[(rev_end, rev_start)] = StringGraphLink(rev_end, rev_start)
        self.links[(rev_end, rev_start)].seg_1_overlap = overlap_2
        self.links[(rev_end, rev_start)].seg_2_overlap = overlap_1

    def remove_segment(self, seg_name_to_remove):
        def remove_signed(seg_name):
            for preceding in list(self.get_preceding_segments(seg_name)):
                self.links.pop((preceding, seg_name), None)
                self.forward_links[preceding].remove(seg_name)
            for following in list(self.get_following_segments(seg_name)):
                self.links.pop((seg_name, following), None)
                self.reverse_links[following].remove(seg_name)
            self.forward_links.pop(seg_name, None)
            self.reverse_links.pop(seg_name, None)
        remove_signed(seg_name_to_remove + '+')
        remove_signed(seg_name_to_remove + '-')
        self.segments.pop(seg_name_to_remove, None)

    def remove_branching_paths(self):
        """Delete every link at a >1-link segment end (ref :180-223)."""
        links_to_delete = set()
        for seg_name in self.segments:
            pos = seg_name + '+'
            neg = seg_name + '-'
            following = self.get_following_segments(pos)
            preceding = self.get_preceding_segments(pos)
            if len(following) > 1:
                for f in following:
                    links_to_delete.add((pos, f))
                    links_to_delete.add((flip_segment_name(f), neg))
            if len(preceding) > 1:
                for p in preceding:
                    links_to_delete.add((p, pos))
                    links_to_delete.add((neg, flip_segment_name(p)))
        for link in sorted(links_to_delete):
            if link in self.links:
                seg_1, seg_2 = link
                rev_1 = flip_segment_name(seg_1)
                rev_2 = flip_segment_name(seg_2)
                del self.links[(seg_1, seg_2)]
                self.forward_links[seg_1].remove(seg_2)
                self.reverse_links[seg_2].remove(seg_1)
                del self.links[(rev_2, rev_1)]
                self.forward_links[rev_2].remove(rev_1)
                self.reverse_links[rev_1].remove(rev_2)

    def seq_from_signed_seg_name(self, signed_name):
        unsigned = get_unsigned_seg_name(signed_name)
        if signed_name.endswith('+'):
            return self.segments[unsigned].forward_sequence
        return self.segments[unsigned].reverse_sequence

    def segment_is_circular(self, seg_name):
        pos = seg_name + '+'
        preceding = self.get_preceding_segments(pos)
        following = self.get_following_segments(pos)
        return (len(preceding) == 1 and len(following) == 1
                and preceding[0] == pos and following[0] == pos)

    def completed_circular_replicons(self):
        return [comp[0] for comp in self.get_connected_components()
                if len(comp) == 1 and self.segment_is_circular(comp[0])]

    def get_connected_components(self):
        visited = set()
        components = []
        for v in self.segments:
            if v in visited:
                continue
            component = []
            q = deque([v])
            visited.add(v)
            while q:
                w = q.popleft()
                component.append(w)
                for k in self.get_connected_segments(w):
                    if k not in visited:
                        visited.add(k)
                        q.append(k)
            components.append(sorted(component))
        return sorted(components)

    def get_connected_segments(self, seg_name):
        connected = set()
        pos = seg_name + '+'
        for segment in self.forward_links.get(pos, []):
            connected.add(get_unsigned_seg_name(segment))
        for segment in self.reverse_links.get(pos, []):
            connected.add(get_unsigned_seg_name(segment))
        return list(connected)

    def replace_with_polished_sequences(self, polished_seqs, scoring_scheme,
                                        device=None):
        """Swap in polished sequences, repairing ends that the polisher
        dropped (semantics of ref string_graph.py:301-355; alignment runs
        on `device`). polished_seqs is {name: sequence}."""
        from ..ops import dispatch
        from ..ops import pairwise as pw
        scoring = scoring_scheme.to_ops()
        gap = 500
        for seg_name, segment in self.segments.items():
            if seg_name not in polished_seqs:
                continue
            polished_seq = polished_seqs[seg_name]
            if not polished_seq:
                continue
            unpolished_start = segment.forward_sequence[:gap]
            unpolished_end = segment.forward_sequence[-gap:]
            start_pa = dispatch.align_pair(
                encode_sequence(unpolished_start),
                encode_sequence(polished_seq[:gap]), scoring,
                pw.SEMI_GLOBAL, device=device)
            end_pa = dispatch.align_pair(
                encode_sequence(unpolished_end),
                encode_sequence(polished_seq[-gap:]), scoring,
                pw.SEMI_GLOBAL, device=device)
            missing_start_seq = ''
            if start_pa.s2_start == 0 and start_pa.s1_start > 0:
                missing_start_seq = unpolished_start[:start_pa.s1_start]
            missing_end_seq = ''
            end_window_len = min(gap, len(polished_seq))
            if end_pa.s2_end == end_window_len and \
                    end_pa.s1_end < len(unpolished_end):
                missing_end_seq = unpolished_end[end_pa.s1_end:]
            if missing_start_seq or missing_end_seq:
                polished_seq = missing_start_seq + polished_seq \
                    + missing_end_seq
            segment.forward_sequence = polished_seq
            segment.reverse_sequence = reverse_complement(polished_seq)

    def rotate_circular_sequences(self, shift_fraction=0.70710678118655):
        for seg_name, segment in self.segments.items():
            if self.segment_is_circular(seg_name):
                seq = segment.forward_sequence
                shift = int(len(seq) * shift_fraction)
                seq = seq[shift:] + seq[:shift]
                segment.forward_sequence = seq
                segment.reverse_sequence = reverse_complement(seq)

    def get_total_segment_length(self):
        return sum(s.get_length() for s in self.segments.values())

    def get_median_read_depth(self):
        by_depth = sorted(self.segments.values(), key=lambda x: x.depth)
        halfway = sum(s.get_length() for s in by_depth) // 2
        so_far = 0
        for segment in by_depth:
            so_far += segment.get_length()
            if so_far >= halfway:
                return segment.depth
        return 0.0

    def normalise_read_depths(self):
        median_depth = self.get_median_read_depth()
        if median_depth == 0.0:
            return
        for segment in self.segments.values():
            segment.depth /= median_depth

    def get_circular_segment_count(self):
        return sum(1 for name in self.segments
                   if self.segment_is_circular(name))

    def get_linear_segment_count(self):
        return sum(1 for name in self.segments
                   if not self.segment_is_circular(name))


class StringGraphSegment(object):

    def __init__(self, full_name, sequence, qual=None):
        self.full_name = full_name
        self.forward_sequence = sequence
        self.reverse_sequence = reverse_complement(sequence)
        self.depth = 1.0
        # miniasm-style names carry trim ranges: name:start-end (ref :418-427)
        try:
            name_parts = full_name.rsplit(':', 1)
            self.short_name = name_parts[0]
            self.start_pos, self.end_pos = (int(x) for x in
                                            name_parts[1].split('-'))
        except (IndexError, ValueError):
            self.short_name = self.full_name
            self.start_pos, self.end_pos = 1, len(self.forward_sequence)
        if self.short_name.startswith('CONTIG_'):
            self.contig = True
            self.qual = settings.CONTIG_READ_QSCORE
        else:
            self.contig = False
            self.qual = None
        if qual is not None:
            self.qual = qual

    def __repr__(self):
        seq = self.forward_sequence
        shown = (seq[:3] + '...' + seq[-3:] + ', ' + str(len(seq)) + ' bp') \
            if len(seq) > 6 else seq
        return (self.full_name + ' (' + shown + '), mean score = '
                + str(self.qual))

    def get_length(self):
        return len(self.forward_sequence)

    def gfa_segment_line(self, include_depth=True):
        parts = ['S', self.full_name, self.forward_sequence,
                 'LN:i:' + str(self.get_length())]
        if include_depth:
            parts.append('dp:f:' + str(self.depth))
        return '\t'.join(parts) + '\n'

    def fasta_record(self):
        return ('>' + self.full_name + '\n'
                + add_line_breaks_to_sequence(self.forward_sequence, 70))

    def rotate_sequence(self, start_pos, flip):
        rotated = self.forward_sequence[start_pos:] + \
            self.forward_sequence[:start_pos]
        rc = reverse_complement(rotated)
        if flip:
            self.forward_sequence, self.reverse_sequence = rc, rotated
        else:
            self.forward_sequence, self.reverse_sequence = rotated, rc


class StringGraphLink(object):

    def __init__(self, seg_1_signed_name, seg_2_signed_name):
        self.seg_1_signed_name = seg_1_signed_name
        self.seg_2_signed_name = seg_2_signed_name
        self.seg_1_overlap = None
        self.seg_2_overlap = None

    def __repr__(self):
        return (self.seg_1_signed_name + ' -> ' + self.seg_2_signed_name
                + ' (' + str(self.seg_1_overlap) + ', '
                + str(self.seg_2_overlap) + ')')

    def gfa_link_line(self):
        return '\t'.join([
            'L', get_unsigned_seg_name(self.seg_1_signed_name),
            self.seg_1_signed_name[-1],
            get_unsigned_seg_name(self.seg_2_signed_name),
            self.seg_2_signed_name[-1],
            str(self.seg_1_overlap) + 'M']) + '\n'


def flip_segment_name(seg_name):
    if seg_name.endswith('+'):
        return seg_name[:-1] + '-'
    return seg_name[:-1] + '+'


def get_unsigned_seg_name(seg_name):
    return seg_name[:-1]


def merge_string_graph_segments_into_unitig_graph(string_graph,
                                                  read_nicknames):
    """Build a unitig graph from a branchless string graph (reimplements
    miniasm's make_unitig_graph the way ref string_graph.py:514-596 does)."""
    unitig_sequences = []
    for component in string_graph.get_connected_components():
        dead_ends = []
        for seg_name in component:
            pos = seg_name + '+'
            neg = seg_name + '-'
            if not string_graph.get_preceding_segments(pos):
                dead_ends.append(pos)
            if not string_graph.get_following_segments(pos):
                dead_ends.append(neg)
        assert len(dead_ends) in (0, 2)
        circular = len(dead_ends) == 0
        if circular:
            start_seg = sorted(component,
                               key=lambda x:
                               string_graph.segments[x].get_length())[0] + '+'
        else:
            option_1 = string_graph.segments[
                get_unsigned_seg_name(dead_ends[0])]
            option_2 = string_graph.segments[
                get_unsigned_seg_name(dead_ends[1])]
            start_seg = dead_ends[0] if option_1.get_length() >= \
                option_2.get_length() else dead_ends[1]

        unitig_seq = ''
        current = start_seg
        while True:
            current_seq = string_graph.seq_from_signed_seg_name(current)
            next_segs = string_graph.get_following_segments(current)
            if len(next_segs) == 0:
                unitig_seq += current_seq
                break
            assert len(next_segs) == 1
            overlap = string_graph.links[(current, next_segs[0])].seg_1_overlap
            unitig_seq += current_seq if overlap == 0 else \
                current_seq[:-overlap]
            if circular and next_segs[0] == start_seg:
                break
            current = next_segs[0]
        unitig_sequences.append((unitig_seq,
                                 'circular' if circular else 'linear'))

    unitig_sequences.sort(key=lambda x: len(x[0]), reverse=True)
    unitig_graph = StringGraph(None)
    for i, (unitig_seq, kind) in enumerate(unitig_sequences):
        name = str(i + 1)
        unitig_graph.segments[name] = StringGraphSegment(name, unitig_seq)
        if kind == 'circular':
            unitig_graph.add_link(name + '+', name + '+', 0, 0)
    return unitig_graph
