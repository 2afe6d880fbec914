"""Miniasm bridges: BRIDGE_ segments between CONTIG_s become graph bridges.

Capability parity with reference unicycler/bridge_miniasm.py:27-247:
path search against the bridge sequence (graph path adopted when scaled
score > 95), contig-trim overlaps carried as start/end_overlap, and the
anchor-interior splitting pass. The reference returns the UNSPLIT bridge
list (bridge_miniasm.py:247 returns `bridges` even though it just built
`split_bridges`) — reproduced for behavioural parity. A copy of
unicycler_tpu/bridges/miniasm.py; the path search's alignments run on
`device` (None = CUDA), which create_miniasm_bridges takes and passes down.
"""

import math

from .. import log, settings
from ..device import resolve_device
from ..misc import float_to_str
from .common import get_bridge_str, get_depth_agreement_factor, get_mean_depth
from .path_finding import get_best_paths_for_seq


class MiniasmBridge(object):

    def __init__(self, graph, start, end, bridge_sequence, start_overlap,
                 end_overlap, scoring_scheme, do_path_search=True,
                 device=None):
        self.start_segment = start
        self.end_segment = end
        self.start_overlap = start_overlap
        self.end_overlap = end_overlap
        self.depth = get_mean_depth(graph.segments[abs(start)],
                                    graph.segments[abs(end)], graph)
        self.segments_reduced_depth = []

        if not do_path_search:
            self.bridge_sequence = bridge_sequence
            self.all_paths = []
            self.graph_path = []
            self.quality = 1.0
            return

        target_path_length = len(bridge_sequence)
        self.all_paths, _ = get_best_paths_for_seq(
            graph, start, end, target_path_length, bridge_sequence,
            scoring_scheme, 90.0, device=device)
        if self.all_paths:
            self.graph_path = self.all_paths[0][0]
            scaled_score = self.all_paths[0][3]
        else:
            self.graph_path = []
            scaled_score = 0.0

        if scaled_score > settings.MINIASM_BRIDGE_SCALED_SCORE_TO_USE_GRAPH_PATH:
            self.bridge_sequence = graph.get_path_sequence(self.graph_path)
            self.quality = settings.MINIASM_BRIDGE_QUAL_WITH_GRAPH_PATH
        else:
            self.bridge_sequence = bridge_sequence
            if graph.ends_with_dead_end(start) or \
                    graph.starts_with_dead_end(end):
                self.quality = settings.MINIASM_BRIDGE_QUAL_WITH_DEAD_END
            else:
                self.quality = \
                    settings.MINIASM_BRIDGE_QUAL_WITHOUT_PATH_OR_DEAD_END

        start_seg = graph.segments[abs(start)]
        end_seg = graph.segments[abs(end)]
        self.quality *= get_depth_agreement_factor(start_seg.depth,
                                                   end_seg.depth)
        bridge_len = max(0, len(self.bridge_sequence))
        half_qual = settings.MINIASM_BRIDGE_HALF_QUAL_LENGTH
        self.quality *= half_qual / (bridge_len + half_qual)
        self.quality = 100.0 * math.sqrt(self.quality)

    def __repr__(self):
        return ('miniasm bridge: ' + get_bridge_str(self) + ' (quality = '
                + float_to_str(self.quality, 2) + ')')

    @staticmethod
    def get_type_score():
        return 2

    @staticmethod
    def get_type_name():
        return 'miniasm'


def create_miniasm_bridges(graph, string_graph, anchor_segments,
                           scoring_scheme, verbosity, min_bridge_qual,
                           device=None):
    """(ref bridge_miniasm.py:141-247) The path searches align on `device`
    (None = CUDA; 'cpu' for the CPU route)."""
    device = resolve_device(device)
    log.log_section_header('Creating miniasm/Racon bridges')
    bridges = []
    anchor_seg_nums = set(x.number for x in anchor_segments)

    bridge_seg_names = sorted(x for x in string_graph.segments
                              if x.startswith('BRIDGE_')
                              or x.startswith('OVERLAPPING_BRIDGE_'))
    filtered = []
    for name in bridge_seg_names:
        pos = name + '+'
        preceding = string_graph.get_preceding_segments(pos)
        following = string_graph.get_following_segments(pos)
        if len(preceding) != 1 or len(following) != 1:
            continue
        if not preceding[0].startswith('CONTIG_') or \
                not following[0].startswith('CONTIG_'):
            continue
        filtered.append(name)

    for name in filtered:
        bridge_seg = string_graph.segments[name]
        pos = name + '+'
        preceding = string_graph.get_preceding_segments(pos)[0]
        following = string_graph.get_following_segments(pos)[0]
        first_link = string_graph.links[(preceding, pos)]
        second_link = string_graph.links[(pos, following)]
        preceding = preceding[7:]    # strip 'CONTIG_'
        following = following[7:]
        preceding_num = int(preceding[:-1]) * \
            (1 if preceding[-1] == '+' else -1)
        following_num = int(following[:-1]) * \
            (1 if following[-1] == '+' else -1)
        bridges.append(MiniasmBridge(
            graph, preceding_num, following_num,
            bridge_seg.forward_sequence, first_link.seg_1_overlap,
            second_link.seg_2_overlap, scoring_scheme, device=device))

    # Splitting pass — note the reference discards its result (returns the
    # unsplit list); kept identical.
    split_bridges = []
    for bridge in bridges:
        if not bridge.graph_path or \
                not any(abs(x) in anchor_seg_nums
                        for x in bridge.graph_path):
            split_bridges.append(bridge)
        else:
            full_path = [bridge.start_segment] + bridge.graph_path + \
                [bridge.end_segment]
            anchor_indices = sorted(i for i, seg in enumerate(full_path)
                                    if abs(seg) in anchor_seg_nums)
            for i in range(len(anchor_indices) - 1):
                start_i, end_i = anchor_indices[i], anchor_indices[i + 1]
                new_path = full_path[start_i + 1:end_i]
                split_bridge = MiniasmBridge(
                    graph, full_path[start_i], full_path[end_i],
                    graph.get_path_sequence(new_path), 0, 0, scoring_scheme,
                    do_path_search=False)
                split_bridge.graph_path = new_path
                split_bridge.all_paths = [new_path]
                split_bridge.quality = bridge.quality
                split_bridges.append(split_bridge)
    return bridges
