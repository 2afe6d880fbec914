"""The assembly graph: segments keyed by signed integers and the GFA
round-trip, with the queries long-read bridging makes of it.

Counterpart of unicycler_tpu/graph/assembly_graph.py (capability parity
with reference unicycler/assembly_graph.py:43-2371). This copy keeps the
JAX package's method names and bodies for what the bridging slice calls:
GFA load and save, depth statistics, dead ends, link queries and path
sequences, lengths and availability. The graph-editing operations
(cleaning, merging, bridge application, overlap removal) and FASTG input
come with the pipeline slice. Graph work is host-side by design: graphs
are thousands of nodes and the algorithms are sequential with
order-dependent output.
"""

from .. import log
from ..misc import float_to_str
from .gfa import (build_rc_links_if_necessary, build_reverse_links,
                  get_overlap_from_gfa_link, get_sign_string,
                  int_to_signed_string, is_link_positive,
                  signed_string_to_int)
from .segment import Segment


class CannotTrimOverlaps(Exception):
    pass


class BadPath(Exception):
    pass


class BadOverlaps(Exception):
    pass


class AssemblyGraph(object):
    """An assembly graph loaded from GFA: segments (unsigned int keys),
    signed-int link dicts, SPAdes paths, copy depths and overlap size."""

    def __init__(self, filename, overlap, insert_size_mean=250,
                 insert_size_deviation=50):
        self.segments = {}          # unsigned num -> Segment
        self.forward_links = {}     # signed num -> [signed num]
        self.reverse_links = {}     # signed num <- [signed num]
        self.copy_depths = {}       # unsigned num -> [copy depths]
        self.manual_multiplicity = {}   # unsigned num -> int (ML tags)
        self.paths = {}             # path name -> [signed nums]
        self.overlap = overlap
        self.insert_size_mean = insert_size_mean
        self.insert_size_deviation = insert_size_deviation
        self.load_from_gfa(filename)
        if not overlap:
            self.overlap = get_overlap_from_gfa_link(filename)

    def load_from_gfa(self, filename):
        with open(filename, 'rt') as gfa_file:
            for line in gfa_file:
                if line.startswith('S'):
                    parts = line.strip().split('\t')
                    num = int(parts[1])
                    depth = 1.0
                    for part in parts:
                        if part.lower().startswith('dp:'):
                            depth = float(part[5:])
                        if part.lower().startswith('ml:'):
                            self.manual_multiplicity[num] = int(part[5:])
                    self.segments[num] = Segment(num, depth, parts[2], True)
                    self.segments[num].build_other_sequence_if_necessary()
                elif line.startswith('i'):
                    parts = line.strip().split('\t')
                    try:
                        self.insert_size_mean = float(parts[1])
                        self.insert_size_deviation = float(parts[2])
                    except (ValueError, IndexError):
                        pass
        with open(filename, 'rt') as gfa_file:
            for line in gfa_file:
                if line.startswith('L'):
                    parts = line.strip().split('\t')
                    start = signed_string_to_int(parts[1] + parts[2])
                    end = signed_string_to_int(parts[3] + parts[4])
                    self.forward_links.setdefault(start, []).append(end)
        self.forward_links = build_rc_links_if_necessary(self.forward_links)
        self.reverse_links = build_reverse_links(self.forward_links)
        self.sort_link_order()
        with open(filename, 'rt') as gfa_file:
            for line in gfa_file:
                if line.startswith('P'):
                    parts = line.strip().split('\t')
                    segs = [signed_string_to_int(x)
                            for x in parts[2].split(',')]
                    if len(segs) > 1:
                        self.paths[parts[1]] = segs

    def save_to_gfa(self, filename, verbosity=1, save_copy_depth_info=False,
                    save_seg_type_info=False, newline=False,
                    include_insert_size=False):
        log.log(('\n' if newline else '') + 'Saving ' + filename, verbosity)
        with open(filename, 'w') as gfa:
            for segment in sorted(self.segments.values(),
                                  key=lambda x: x.number):
                seg_line = segment.gfa_segment_line()
                colour, label = '', ''
                if save_copy_depth_info and segment.number in self.copy_depths:
                    colour = self.get_copy_number_colour(segment)
                    label = self.get_depth_string(segment)
                if save_seg_type_info and segment.bridge is not None:
                    colour = 'pink'
                    label = segment.get_seg_type_label()
                if colour or label:
                    seg_line = (seg_line[:-1] + '\tLB:z:'
                                + label.replace('\n', '\\n')
                                + '\tCL:z:' + colour + '\n')
                gfa.write(seg_line)
            gfa.write(self.get_all_gfa_link_lines())
            overlap_cigar = str(self.overlap) + 'M'
            for path_name, seg_list in sorted(self.paths.items()):
                gfa.write('P\t' + path_name + '\t'
                          + ','.join(int_to_signed_string(x)
                                     for x in seg_list)
                          + '\t' + ','.join([overlap_cigar]
                                            * (len(seg_list) - 1)) + '\n')
            if include_insert_size and self.insert_size_mean is not None \
                    and self.insert_size_deviation is not None:
                gfa.write('i\t' + str(self.insert_size_mean) + '\t'
                          + str(self.insert_size_deviation) + '\n')

    def get_all_gfa_link_lines(self):
        lines = []
        for start, ends in self.forward_links.items():
            for end in ends:
                if is_link_positive(start, end):
                    lines.append(self.gfa_link_line(start, end))
        return ''.join(lines)

    def gfa_link_line(self, start, end):
        return ('L\t' + str(abs(start)) + '\t' + get_sign_string(start)
                + '\t' + str(abs(end)) + '\t' + get_sign_string(end)
                + '\t' + str(self.overlap) + 'M\n')

    def get_median_read_depth(self, segment_list=None):
        """Median depth by base (ref :119-136)."""
        if not segment_list:
            segment_list = self.segments.values()
        by_depth = sorted(segment_list, key=lambda x: x.depth)
        total_length = sum(s.get_length_no_overlap(self.overlap)
                           for s in by_depth)
        halfway = total_length // 2
        so_far = 0
        for segment in by_depth:
            so_far += segment.get_length_no_overlap(self.overlap)
            if so_far >= halfway:
                return segment.depth
        return 0.0

    def _ten_longest(self):
        return sorted(self.segments.values(), reverse=True,
                      key=lambda x: x.get_length())[:10]

    def get_single_copy_depth(self):
        median_depth = self.get_median_read_depth(self._ten_longest())
        log.log('Median depth of 10 longest contigs: '
                + float_to_str(median_depth, 2), 2)
        log.log('', 2)
        return median_depth

    def starts_with_dead_end(self, signed_seg_num):
        return not self.reverse_links.get(signed_seg_num)

    def ends_with_dead_end(self, signed_seg_num):
        return not self.forward_links.get(signed_seg_num)

    def seq_from_signed_seg_num(self, signed_num):
        if signed_num > 0:
            return self.segments[signed_num].forward_sequence
        return self.segments[-signed_num].reverse_sequence

    def get_downstream_seg_nums(self, seg_num):
        return self.forward_links.get(seg_num, [])

    def get_upstream_seg_nums(self, seg_num):
        return self.reverse_links.get(seg_num, [])

    def sort_link_order(self):
        for seg_num in self.forward_links:
            self.forward_links[seg_num].sort()
        for seg_num in self.reverse_links:
            self.reverse_links[seg_num].sort()

    def get_depth_string(self, segment):
        if segment.number not in self.copy_depths:
            return ''
        return '\n'.join('%.3f' % x
                         for x in self.copy_depths[segment.number])

    def get_copy_number(self, segment):
        if segment.number not in self.copy_depths:
            return 0
        return len(self.copy_depths[segment.number])

    def get_copy_number_colour(self, segment):
        return {0: 'grey', 1: 'forestgreen', 2: 'gold',
                3: 'darkorange'}.get(self.get_copy_number(segment), 'red')

    def get_path_sequence(self, path_segments):
        path_sequence = ''
        prev = None
        for i, seg_num in enumerate(path_segments):
            seq = self.seq_from_signed_seg_num(seg_num)
            if i == 0:
                path_sequence = seq
            else:
                if seg_num not in self.forward_links[prev]:
                    raise BadPath(str(path_segments) + ' is not a valid path')
                if self.overlap > 0 and \
                        path_sequence[-self.overlap:] != seq[:self.overlap]:
                    raise BadOverlaps(
                        'overlaps do not match when merging ' + str(prev)
                        + ' and ' + str(seg_num) + ' in path '
                        + str(path_segments))
                path_sequence += seq[self.overlap:]
            prev = seg_num
        return path_sequence

    def max_path_segment_count(self, seg_num, start_end_depth):
        if abs(seg_num) in self.copy_depths:
            count_by_copies = len(self.copy_depths[abs(seg_num)])
        else:
            count_by_copies = 1
        depth = self.segments[abs(seg_num)].depth
        count_by_depth = max(1, int(round(depth / start_end_depth)))
        return 2 * max(count_by_copies, count_by_depth)

    def get_path_length(self, path):
        if not path:
            return 0
        try:
            total = sum(self.segments[abs(s)].get_length() for s in path)
            return total - (len(path) - 1) * self.overlap
        except KeyError:
            return 0

    def get_bridge_path_length(self, path):
        return self.overlap if not path else self.get_path_length(path)

    def get_path_availability(self, path):
        """Fraction of a path's bases still depth-available (ref :1885-1906)."""
        total_bases = 0
        available_bases = 0.0
        for seg_num in path:
            seg = self.segments[abs(seg_num)]
            availability = 1.0 if seg.depth >= 0.5 else 2 * seg.depth
            seg_len = seg.get_length() - self.overlap
            total_bases += seg_len
            available_bases += seg_len * availability
        if total_bases == 0:
            return 1.0
        return max(0.0, available_bases / total_bases)

    def get_estimated_sequence_len(self):
        single_copy_depth = self.get_single_copy_depth()
        total = 0.0
        for seg_num, seg in self.segments.items():
            seg_len = seg.get_length()
            if seg_num in self.forward_links:
                seg_len -= self.overlap / 2
            if seg_num in self.reverse_links:
                seg_len -= self.overlap / 2
            total += seg_len * (seg.depth / single_copy_depth)
        return total
