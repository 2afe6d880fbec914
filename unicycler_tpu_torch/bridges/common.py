"""Shared bridge helpers (parity with ref unicycler/bridge_common.py; a
copy of unicycler_tpu/bridges/common.py)."""

import math

from ..misc import weighted_average


def get_mean_depth(seg_1, seg_2, graph):
    """Length-weighted mean depth of two segments (ref bridge_common.py:22)."""
    return weighted_average(seg_1.depth, seg_2.depth,
                            seg_1.get_length_no_overlap(graph.overlap),
                            seg_2.get_length_no_overlap(graph.overlap))


def get_bridge_str(bridge):
    s = str(bridge.start_segment) + ' -> '
    if bridge.graph_path:
        s += ', '.join(str(x) for x in bridge.graph_path) + ' -> '
    return s + str(bridge.end_segment)


def get_depth_agreement_factor(start_seg_depth, end_seg_depth):
    """Logistic agreement curve: equal depths -> 1.0, ratio 1.35 -> ~0.5,
    ratio 2.06 -> ~0.1 (ref bridge_common.py:42-63)."""
    larger = max(start_seg_depth, end_seg_depth)
    smaller = min(start_seg_depth, end_seg_depth)
    if larger == 0.0 or smaller == 0.0:
        return 0.0
    if larger == smaller:
        return 1.0
    ratio = larger / smaller
    return 1.0 / (1.0 + 10.0 ** (2 * (math.log10(ratio - 1.0) + 0.45)))
