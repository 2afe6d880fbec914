"""Bridges built from SPAdes contig paths (P-lines of the loaded GFA).

Capability parity with reference unicycler/bridge_spades_contig.py:22-240:
sub-paths between anchor segments become bridges; quality = 0.4 x
depth-agreement x path-depth-consistency (when self-contained) x
insert-size length factor, finalised as 100 * sqrt(q); type score 1.
A copy of unicycler_tpu/bridges/spades_contig.py.
"""

import math

from .. import log
from ..misc import float_to_str, get_num_agreement
from .common import get_bridge_str, get_depth_agreement_factor, get_mean_depth


class SpadesContigBridge(object):

    def __init__(self, graph, spades_contig_path, length_penalty=True):
        self.graph_path = list(spades_contig_path)
        self.start_segment = self.graph_path.pop(0)
        self.end_segment = self.graph_path.pop()
        self.bridge_sequence = graph.get_path_sequence(self.graph_path)
        self.segments_reduced_depth = []
        self.quality = 0.4

        start_seg = graph.segments[abs(self.start_segment)]
        end_seg = graph.segments[abs(self.end_segment)]
        self.quality *= get_depth_agreement_factor(start_seg.depth,
                                                   end_seg.depth)
        self.depth = get_mean_depth(start_seg, end_seg, graph)

        # Path-depth consistency only counts for self-contained paths
        # (ref bridge_spades_contig.py:77-83).
        if path_is_self_contained(self.graph_path, self.start_segment,
                                  self.end_segment, graph):
            pos_nums = list(set(abs(x) for x in self.graph_path))
            for seg_num in pos_nums:
                actual = graph.segments[seg_num].depth
                expected = ([abs(x) for x in self.graph_path].count(seg_num)
                            * self.depth)
                self.quality *= get_num_agreement(actual, expected)

        # Long bridges relative to the insert size are implausible
        # (ref :85-96) — for PAIRED-END-derived paths. Higher-k
        # continuity paths (HKPATH records, asm/debruijn.py
        # resolve_paths_with_higher_k) are exempt: their evidence is a
        # chain of k'-mer junction windows along one assembled unitig,
        # which does not decay with bridge length.
        if self.graph_path and length_penalty:
            bridge_length = len(self.bridge_sequence)
            if bridge_length > graph.insert_size_mean:
                self.quality *= (graph.insert_size_deviation
                                 / (bridge_length - graph.insert_size_mean
                                    + graph.insert_size_deviation))
        self.quality = 100.0 * math.sqrt(self.quality)

    def __repr__(self):
        return ('SPAdes bridge: ' + get_bridge_str(self) + ' (quality = '
                + float_to_str(self.quality, 2) + ')')

    @staticmethod
    def get_type_score():
        return 1

    @staticmethod
    def get_type_name():
        return 'SPAdes'


def create_spades_contig_bridges(graph, anchor_segments):
    """Bridges from SPAdes path records (ref bridge_spades_contig.py:
    122-202), with conflict removal when multiple paths share an end."""
    log.log_section_header('Creating SPAdes contig bridges')
    bridge_path_set = set()
    no_penalty = set()          # bridge paths from HKPATH records
    single_copy_numbers = [x.number for x in anchor_segments]
    for segment in anchor_segments:
        for path_name, path in graph.paths.items():
            is_hk = path_name.startswith('HKPATH')
            flipped_path = [-x for x in reversed(path)]
            contig_bridges = find_contig_bridges(segment.number, path,
                                                 single_copy_numbers)
            contig_bridges += find_contig_bridges(segment.number,
                                                  flipped_path,
                                                  single_copy_numbers)
            for contig_bridge in contig_bridges:
                flipped = [-x for x in reversed(contig_bridge)]
                s = ','.join(str(x) for x in contig_bridge)
                fs = ','.join(str(x) for x in flipped)
                if s not in bridge_path_set and fs not in bridge_path_set:
                    if contig_bridge[0] < 0 and contig_bridge[-1] < 0:
                        bridge_path_set.add(fs)
                    else:
                        bridge_path_set.add(s)
                if is_hk:
                    no_penalty.add(s)
                    no_penalty.add(fs)

    bridge_path_list = sorted([[int(y) for y in x.split(',')]
                               for x in bridge_path_set])

    # Paths sharing a start or end conflict with single-copy determination
    # and are thrown out (ref :153-184).
    by_start, by_end = {}, {}
    for path in bridge_path_list:
        start, end = path[0], path[-1]
        for key, d in ((start, by_start), (end, by_end),
                       (-end, by_start), (-start, by_end)):
            d.setdefault(key, [])
        by_start[start].append(path)
        by_end[end].append(path)
        by_start[-end].append(path)
        by_end[-start].append(path)
    conflicting = []
    for grouped in list(by_start.values()) + list(by_end.values()):
        if len(grouped) > 1:
            conflicting += grouped
    no_dupes = []
    for path in conflicting:
        if path not in no_dupes:
            no_dupes.append(path)
    final_paths = [x for x in bridge_path_list if x not in no_dupes]

    bridges = [SpadesContigBridge(
                   spades_contig_path=x, graph=graph,
                   length_penalty=','.join(str(y) for y in x)
                   not in no_penalty)
               for x in final_paths]
    if not bridges:
        log.log('No SPAdes contig bridges')
    return bridges


def find_contig_bridges(segment_num, path, single_copy_numbers):
    """Every sub-path starting at segment_num and ending at any single-copy
    segment (ref bridge_spades_contig.py:205-222)."""
    bridge_paths = []
    indices = [i for i, x in enumerate(path) if abs(x) == segment_num]
    for index in indices:
        bridge_path = [path[index]]
        for i in range(index + 1, len(path)):
            bridge_path.append(path[i])
            if path[i] in single_copy_numbers or \
                    -path[i] in single_copy_numbers:
                break
        else:
            bridge_path = []
        if bridge_path:
            bridge_paths.append(bridge_path)
    return bridge_paths


def path_is_self_contained(path, start, end, graph):
    """True if path segments connect only to each other and start/end
    (ref bridge_spades_contig.py:225-240)."""
    in_path = {abs(start), abs(end)}
    in_path.update(abs(x) for x in path)
    for segment in path:
        for connected in graph.get_connected_segments(segment):
            if connected not in in_path:
                return False
    return True
