"""Copy-depth (multiplicity) assignment by greedy propagation.

Behavioral parity with reference unicycler/assembly_graph_copy_depth.py:
21-469. The algorithm is deliberately sequential and greedy — order affects
output, so it stays host-side and exact: initial single-copy
seeding, then alternating merge (sum of exclusive inputs/outputs, lowest
relative error first) and redistribute (copy depths shuffled into exclusive
neighbours over all bin arrangements), with new single-copy seeds between
rounds and a final tolerance-1.0 pass. Honours manual ML multiplicity tags.
A copy of unicycler_tpu/graph/copy_depth.py.
"""

from .. import log, settings


def determine_copy_depth(graph):
    """Assign copy depths to every segment (ref copy_depth.py:21-90)."""
    graph.copy_depths = {}
    log.log_section_header('Determining graph multiplicity')

    single_copy_depth = graph.get_single_copy_depth()
    max_depth = single_copy_depth + settings.INITIAL_SINGLE_COPY_TOLERANCE
    initial = []
    for segment in sorted(graph.segments.values(),
                          key=lambda x: x.get_length(), reverse=True):
        num = segment.number
        manual_single = (num in graph.manual_multiplicity
                         and graph.manual_multiplicity[num] == 1)
        if (segment.depth <= max_depth
                and okay_for_initial_single_copy(graph, segment)) \
                or manual_single:
            graph.copy_depths[num] = [segment.depth]
            initial.append(num)
    if initial:
        log.log('\nInitial single copy segments:', 2)
        log.log_number_list(initial, 2)

    _propagate(graph, settings.COPY_PROPAGATION_TOLERANCE)
    while True:
        assignments = assign_single_copy_depth(
            graph, settings.MIN_SINGLE_COPY_LENGTH)
        _propagate(graph, settings.COPY_PROPAGATION_TOLERANCE)
        if not assignments:
            break
    _propagate(graph, 1.0)


def _propagate(graph, tolerance):
    """Merge until exhausted, then redistribute and recurse
    (ref copy_depth.py:93-107)."""
    while merge_copy_depths(graph, tolerance):
        pass
    if redistribute_copy_depths(graph, tolerance):
        try:
            _propagate(graph, tolerance)
        except RecursionError:
            pass


def assign_single_copy_depth(graph, min_single_copy_length):
    """Single-copy seed the longest eligible segment (ref :110-130)."""
    for segment in sorted(get_segments_without_copies(graph),
                          key=lambda x: x.get_length(), reverse=True):
        if segment.get_length() < min_single_copy_length:
            continue
        num = segment.number
        if num in graph.manual_multiplicity and \
                graph.manual_multiplicity[num] != 1:
            continue
        if exactly_one_link_per_end(graph, segment):
            graph.copy_depths[num] = [segment.depth]
            return 1
    return 0


def merge_copy_depths(graph, error_margin):
    """Assign the lowest-error merge of exclusive-neighbour copy depths
    (ref :133-182)."""
    segments = get_segments_without_copies(graph)
    if not segments:
        return 0
    best_num = None
    best_depths = []
    lowest_error = float('inf')
    for segment in segments:
        num = segment.number
        for sources in (graph.get_exclusive_inputs(num),
                        graph.get_exclusive_outputs(num)):
            if not sources or not all_have_copy_depths(graph, sources):
                continue
            depths, error = scale_copy_depths_from_source_segments(
                graph, num, sources)
            conflict = (num in graph.manual_multiplicity
                        and graph.manual_multiplicity[num] != len(depths))
            if error < lowest_error and not conflict:
                lowest_error = error
                best_num = num
                best_depths = depths
    if best_num and lowest_error < error_margin:
        graph.copy_depths[best_num] = best_depths
        return 1
    return 0


def redistribute_copy_depths(graph, error_margin):
    """Split a multi-copy segment's depths into its exclusive neighbours
    (ref :211-271)."""
    for segment in get_segments_with_two_or_more_copies(graph):
        num = segment.number
        connections = graph.get_exclusive_inputs(num)
        if not connections or all_have_copy_depths(graph, connections):
            connections = graph.get_exclusive_outputs(num)
        if not connections or all_have_copy_depths(graph, connections):
            continue
        copy_depths = graph.copy_depths[num]
        bins = [[]] * len(connections)
        targets = [len(graph.copy_depths[x]) if x in graph.copy_depths
                   else None for x in connections]
        if len(bins) ** len(copy_depths) > \
                settings.MAX_COPY_DEPTH_DISTRIBUTION_ARRANGEMENTS:
            continue
        arrangements = shuffle_into_bins(copy_depths, bins, targets)
        if not arrangements:
            continue
        lowest_error = float('inf')
        best_arrangement = None
        for i, arrangement in enumerate(arrangements):
            error = get_error_for_multiple_segments_and_depths(
                graph, connections, arrangement)
            if i == 0 or error < lowest_error:
                lowest_error = error
                best_arrangement = arrangement
        conflict = False
        if best_arrangement is not None:
            for conn_num, conn_depths in zip(connections, best_arrangement):
                if (conn_num in graph.manual_multiplicity and
                        graph.manual_multiplicity[conn_num]
                        != len(conn_depths)):
                    conflict = True
        if lowest_error < error_margin and not conflict:
            if assign_copy_depths_where_needed(graph, connections,
                                               best_arrangement,
                                               error_margin):
                return 1
    return 0


def okay_for_initial_single_copy(graph, segment):
    """Link-based eligibility for the initial single-copy pass
    (ref :274-326)."""
    num = segment.number
    forward_count = len(graph.forward_links.get(num, []))
    reverse_count = len(graph.reverse_links.get(num, []))

    if segment.get_length() < settings.MIN_SINGLE_COPY_LENGTH:
        # Short segments: strict — exactly one link per side and neither
        # neighbour already single-copy.
        if forward_count != 1 or reverse_count != 1:
            return False
        downstream = abs(graph.forward_links[num][0])
        if len(graph.copy_depths.get(downstream, [])) == 1:
            return False
        upstream = abs(graph.reverse_links[num][0])
        if len(graph.copy_depths.get(upstream, [])) == 1:
            return False
        return True

    forward_okay = forward_count <= 1
    reverse_okay = reverse_count <= 1
    # Too many links is excused when neighbour depths are wildly
    # inconsistent (bogus connections).
    if not forward_okay:
        exclusive_outputs = graph.get_exclusive_outputs(num)
        if exclusive_outputs:
            depth_sum = sum(graph.segments[x].depth
                            for x in exclusive_outputs)
            if get_error(depth_sum, segment.depth) > \
                    settings.COPY_PROPAGATION_TOLERANCE:
                forward_okay = True
    if not reverse_okay:
        exclusive_inputs = graph.get_exclusive_inputs(num)
        if exclusive_inputs:
            depth_sum = sum(graph.segments[x].depth
                            for x in exclusive_inputs)
            if get_error(depth_sum, segment.depth) > \
                    settings.COPY_PROPAGATION_TOLERANCE:
                reverse_okay = True
    return forward_okay and reverse_okay


def exactly_one_link_per_end(graph, segment):
    num = segment.number
    if num in graph.forward_links and len(graph.forward_links[num]) != 1:
        return False
    if num in graph.reverse_links and len(graph.reverse_links[num]) != 1:
        return False
    return True


def all_have_copy_depths(graph, segment_numbers):
    return all(num in graph.copy_depths for num in segment_numbers)


def scale_copy_depths_from_source_segments(graph, segment_number,
                                           source_segment_numbers):
    source_depths = []
    for num in source_segment_numbers:
        source_depths += graph.copy_depths[num]
    return scale_copy_depths(graph.segments[segment_number].depth,
                             source_depths)


def scale_copy_depths(target_depth, source_depths):
    source_sum = sum(source_depths)
    scaling = target_depth / source_sum
    scaled = sorted((scaling * x for x in source_depths), reverse=True)
    return scaled, get_error(source_sum, target_depth)


def get_segments_without_copies(graph):
    return [x for x in graph.segments.values()
            if x.number not in graph.copy_depths]


def get_segments_with_two_or_more_copies(graph):
    return [x for x in graph.segments.values()
            if len(graph.copy_depths.get(x.number, [])) > 1]


def get_error_for_multiple_segments_and_depths(graph, segment_numbers,
                                               copy_depths):
    max_error = 0.0
    for i, num in enumerate(segment_numbers):
        max_error = max(max_error,
                        get_error(sum(copy_depths[i]),
                                  graph.segments[num].depth))
    return max_error


def assign_copy_depths_where_needed(graph, segment_numbers, new_depths,
                                    error_margin):
    success = False
    for i, num in enumerate(segment_numbers):
        if num not in graph.copy_depths:
            scaled, error = scale_copy_depths(graph.segments[num].depth,
                                              new_depths[i])
            if error <= error_margin:
                graph.copy_depths[num] = scaled
                success = True
    return success


def get_error(source, target):
    if target > 0.0:
        return abs(source - target) / target
    return float('inf')


def shuffle_into_bins(items, bins, targets):
    """All arrangements of items into bins with every bin non-empty and
    target-sized bins exact (ref :433-469)."""
    arrangements = []
    if items:
        empty_bins = sum(1 for x in bins if not x)
        only_empty = len(items) <= empty_bins
        for i in range(len(bins)):
            if targets[i] and len(bins[i]) >= targets[i]:
                continue
            if only_empty and bins[i]:
                continue
            bins_copy = [list(x) for x in bins]
            bins_copy[i].append(items[0])
            arrangements += shuffle_into_bins(items[1:], bins_copy, targets)
    elif all(bins) and all(not target or target == len(bins[i])
                           for i, target in enumerate(targets)):
        arrangements.append(bins)
    return arrangements
