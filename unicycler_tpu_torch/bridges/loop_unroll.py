"""Loop-unrolling bridges: resolve simple loops with depth-derived counts.

Capability parity with reference unicycler/bridge_loop_unroll.py:25-190:
for A->B->C->B->D loops joined to a SPAdes path, the loop count comes from
middle/repeat depths weighted by length; quality = 0.2 x depth-agreement x
closeness-to-whole-count x 2^-(count-1), finalised 100*sqrt(q); type 0.
A copy of unicycler_tpu/bridges/loop_unroll.py.
"""

import math

from .. import log
from ..misc import float_to_str, weighted_average
from .common import get_bridge_str, get_depth_agreement_factor, get_mean_depth


class LoopUnrollingBridge(object):

    def __init__(self, graph, start, end, middle, repeat):
        self.start_segment = start
        self.end_segment = end
        self.middle_segment = middle
        self.repeat_segment = repeat
        self.segments_reduced_depth = []
        self.quality = 0.2

        start_seg = graph.segments[abs(start)]
        end_seg = graph.segments[abs(end)]
        middle_seg = graph.segments[abs(middle)]
        repeat_seg = graph.segments[abs(repeat)]

        self.quality *= get_depth_agreement_factor(start_seg.depth,
                                                   end_seg.depth)
        self.depth = get_mean_depth(start_seg, end_seg, graph)
        self.loop_count_by_middle = middle_seg.depth / self.depth
        self.loop_count_by_repeat = max(
            (repeat_seg.depth - self.depth) / self.depth, 0.0)
        mean_loop_count = weighted_average(
            self.loop_count_by_middle, self.loop_count_by_repeat,
            middle_seg.get_length_no_overlap(graph.overlap),
            repeat_seg.get_length_no_overlap(graph.overlap))

        if mean_loop_count < 1.0:
            self.loop_count = 1
            closeness_to_whole = mean_loop_count
        else:
            self.loop_count = int(round(mean_loop_count))
            fractional = mean_loop_count % 1
            closeness_to_whole = 1.0 - 2.0 * min(fractional, 1.0 - fractional)
        self.quality *= closeness_to_whole
        self.quality *= 1 / (2 ** (self.loop_count - 1))

        self.graph_path = [repeat]
        for _ in range(self.loop_count):
            self.graph_path += [middle, repeat]
        self.bridge_sequence = graph.get_path_sequence(self.graph_path)
        self.quality = 100.0 * math.sqrt(self.quality)

    def __repr__(self):
        return ('loop bridge: ' + get_bridge_str(self) + ' (quality = '
                + float_to_str(self.quality, 2) + ')')

    @staticmethod
    def get_type_score():
        return 0

    @staticmethod
    def get_type_name():
        return 'loop'


def create_loop_unrolling_bridges(graph, anchor_segments):
    """Bridges for simple loops whose middle is joined to an anchor by a
    SPAdes path (ref bridge_loop_unroll.py:130-190)."""
    log.log_section_header('Creating loop unrolling bridges')
    bridges = []
    simple_loops = [x for x in graph.find_all_simple_loops()
                    if x[2] is not None]
    seg_nums_to_bridge = set(x.number for x in anchor_segments)
    for start, end, middle, repeat in simple_loops:
        if abs(start) not in seg_nums_to_bridge:
            continue
        if abs(end) not in seg_nums_to_bridge:
            continue
        if abs(repeat) in seg_nums_to_bridge:
            continue
        joined = False
        for path in graph.paths.values():
            flipped = [-x for x in reversed(path)]
            if (start in path and middle in path) or \
                    (end in path and middle in path) or \
                    (start in flipped and middle in flipped) or \
                    (end in flipped and middle in flipped):
                joined = True
                break
        if joined:
            bridges.append(LoopUnrollingBridge(graph, start, end, middle,
                                               repeat))
    if not bridges:
        log.log('No loop unrolling bridges made')
    return bridges
