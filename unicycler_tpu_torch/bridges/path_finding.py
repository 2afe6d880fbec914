"""Find graph paths matching a consensus sequence between two segments.

Capability parity with reference unicycler/path_finding.py:33-378:
exhaustive BFS with per-segment count caps, falling back to bidirectional
progressive search with alignment-based culling. All candidate-path
scoring is batched into single device launches (ref scores serially at
path_finding.py:64-86; culling at :328-338). Counterpart of
unicycler_tpu/bridges/path_finding.py; the alignments run on `device`
(None = CUDA), which every function that aligns takes and passes down.
"""

from collections import defaultdict

from .. import settings
from ..io.fastx import encode_sequence
from ..misc import get_num_agreement, reverse_complement, weighted_average
from ..ops import dispatch
from ..ops import pairwise as pw


class TooManyPaths(Exception):
    pass


def get_best_paths_for_seq(graph, start_seg, end_seg, target_length,
                           sequence, scoring_scheme, expected_scaled_score,
                           device=None):
    """Best graph paths from start to end matching the consensus
    (ref path_finding.py:33-97). Returns (paths_and_scores, progressive)."""
    assert graph.overlap == 0

    min_length = min(int(round(target_length
                               * settings.MIN_RELATIVE_PATH_LENGTH)),
                     target_length
                     - settings.RELATIVE_PATH_LENGTH_BUFFER_SIZE)
    max_length = max(int(round(target_length
                               * settings.MAX_RELATIVE_PATH_LENGTH)),
                     target_length
                     + settings.RELATIVE_PATH_LENGTH_BUFFER_SIZE)

    from ..utils import trace
    try:
        with trace.span('path_bfs'):
            paths = all_paths(graph, start_seg, end_seg, min_length,
                              max_length)
        progressive_path_search = False
    except TooManyPaths:
        progressive_path_search = True
        with trace.span('path_progressive'):
            paths = progressive_path_find(graph, start_seg, end_seg,
                                          min_length, max_length, sequence,
                                          scoring_scheme,
                                          expected_scaled_score,
                                          device=device)

    paths = sorted(paths, key=lambda x: abs(target_length
                                            - graph.get_bridge_path_length(x)))

    scoring = scoring_scheme.to_ops()
    paths_and_scores = []
    if sequence:
        seq_codes = encode_sequence(sequence)
        with trace.span('path_seq_build'):
            path_seqs = [encode_sequence(graph.get_path_sequence(p))
                         for p in paths]
        # One batched launch scores every candidate path.
        alignments = dispatch.batch_align(
            [seq_codes] * len(paths), path_seqs, scoring, pw.FULLY_GLOBAL,
            band=1000, need_cigar=True, device=device)
        for path, pa in zip(paths, alignments):
            if pa is None or (pa.score == 0 and not pa.cigar):
                continue
            raw_score = pa.score
            scaled = dispatch.scaled_score(pa, scoring)
            length_discrepancy = abs(graph.get_bridge_path_length(path)
                                     - target_length)
            paths_and_scores.append((path, raw_score, length_discrepancy,
                                     scaled))
    else:
        for path in paths:
            path_len = graph.get_bridge_path_length(path)
            raw_score = get_num_agreement(path_len, target_length) * 100.0
            paths_and_scores.append((path, raw_score,
                                     abs(path_len - target_length), 100.0))

    paths_and_scores = sorted(paths_and_scores,
                              key=lambda x: (-x[1], x[2], -x[3]))
    if paths_and_scores:
        min_scaled = paths_and_scores[0][3] * 0.95
        paths_and_scores = [x for x in paths_and_scores if x[3] >= min_scaled]
    return paths_and_scores, progressive_path_search


def all_paths(graph, start, end, min_length, max_length):
    """Exhaustive BFS of connecting paths within length bounds
    (ref path_finding.py:100-142)."""
    if start not in graph.forward_links:
        return []
    start_seg = graph.segments[abs(start)]
    end_seg = graph.segments[abs(end)]
    start_end_depth = weighted_average(start_seg.depth, end_seg.depth,
                                       start_seg.get_length(),
                                       end_seg.get_length())

    # Path lengths are tracked incrementally: recomputing
    # get_path_length per candidate per BFS level made the search
    # O(paths x length^2) and dominated bridge finalisation.
    def seg_len(s):
        return graph.segments[abs(s)].get_length()

    end_len = seg_len(end) if abs(end) in graph.segments else 0
    working_paths = [([x], seg_len(x)) for x in graph.forward_links[start]]
    final_paths = []
    while working_paths:
        new_working_paths = []
        for working_path, wlen in working_paths:
            last_seg = working_path[-1]
            if last_seg == end:
                if wlen - end_len >= min_length:
                    final_paths.append(working_path[:-1])
                    if len(final_paths) > \
                            settings.ALL_PATH_SEARCH_MAX_FINAL_PATHS:
                        raise TooManyPaths
            elif wlen <= max_length and last_seg in graph.forward_links:
                for next_seg in graph.forward_links[last_seg]:
                    max_count = graph.max_path_segment_count(next_seg,
                                                             start_end_depth)
                    count = (working_path.count(next_seg)
                             + working_path.count(-next_seg))
                    if count < max_count:
                        new_working_paths.append(
                            (working_path + [next_seg],
                             wlen + seg_len(next_seg)))
        if len(working_paths) > settings.ALL_PATH_SEARCH_MAX_WORKING_PATHS:
            raise TooManyPaths
        working_paths = new_working_paths
    return final_paths


def progressive_path_find(graph, start, end, min_length, max_length,
                          sequence, scoring_scheme, expected_scaled_score,
                          device=None):
    """Bidirectional progressive search with alignment culling
    (ref path_finding.py:145-212)."""
    reverse_sequence = reverse_complement(sequence)
    final_paths = set()

    def seg_len(s):
        return graph.segments[abs(s)].get_length()

    # working paths carry their total length (incl. the seed segment);
    # lengths excluding the seed subtract its constant size
    forward_working_paths = [([start], seg_len(start))]
    reverse_working_paths = [([-end], seg_len(end))]
    fwd_seed_len = seg_len(start)
    rev_seed_len = seg_len(end)

    start_seg = graph.segments[abs(start)]
    end_seg = graph.segments[abs(end)]
    start_end_depth = weighted_average(start_seg.depth, end_seg.depth,
                                       start_seg.get_length(),
                                       end_seg.get_length())
    forward_clogged = False
    reverse_clogged = False

    while True:
        if not forward_clogged:
            shortest_reverse = min(l for _, l in reverse_working_paths) \
                - rev_seed_len
            reverse_dict = build_path_dictionary(
                [p for p, _ in reverse_working_paths])
            forward_working_paths = advance_paths(
                forward_working_paths, reverse_dict, shortest_reverse,
                final_paths, False, sequence, scoring_scheme,
                expected_scaled_score, graph, start_end_depth, max_length,
                settings.PROGRESSIVE_PATH_SEARCH_SCORE_FRACTION,
                fwd_seed_len, device=device)
            if not forward_working_paths:
                break
            elif len(forward_working_paths) > \
                    settings.PROGRESSIVE_PATH_SEARCH_MAX_WORKING_PATHS:
                forward_clogged = True
        if not reverse_clogged:
            shortest_forward = min(l for _, l in forward_working_paths) \
                - fwd_seed_len
            forward_dict = build_path_dictionary(
                [p for p, _ in forward_working_paths])
            reverse_working_paths = advance_paths(
                reverse_working_paths, forward_dict, shortest_forward,
                final_paths, True, reverse_sequence, scoring_scheme,
                expected_scaled_score, graph, start_end_depth, max_length,
                settings.PROGRESSIVE_PATH_SEARCH_SCORE_FRACTION,
                rev_seed_len, device=device)
            if not reverse_working_paths:
                break
            elif len(reverse_working_paths) > \
                    settings.PROGRESSIVE_PATH_SEARCH_MAX_WORKING_PATHS:
                reverse_clogged = True
        if forward_clogged and reverse_clogged:
            return []

    final_paths = [list(x)[1:-1] for x in final_paths]
    return [x for x in final_paths
            if min_length <= graph.get_path_length(x) <= max_length]


def build_path_dictionary(path_list):
    path_dict = defaultdict(list)
    for path in path_list:
        r_path = reverse_path(path)
        path_dict[r_path[0]].append(r_path)
    return path_dict


def reverse_path(path):
    return [-x for x in path[::-1]]


def advance_paths(working_paths, opposite_paths_dict, shortest_opposite_path,
                  final_paths, flip_new_final_paths, sequence, scoring_scheme,
                  expected_scaled_score, graph, start_end_depth,
                  total_max_length, cull_score_fraction, seed_len,
                  device=None):
    """Extend one direction's working paths (ref path_finding.py:235-294).
    working_paths entries are (path, total_length) pairs."""
    max_length = total_max_length - shortest_opposite_path

    def seg_len(s):
        return graph.segments[abs(s)].get_length()

    while True:
        if not 0 < len(working_paths) <= \
                settings.PROGRESSIVE_PATH_SEARCH_MAX_WORKING_PATHS:
            break
        shortest_path_len = min(l for _, l in working_paths)
        new_working_paths = []
        for path, plen in working_paths:
            if plen > shortest_path_len:
                new_working_paths.append((path, plen))
            elif path[-1] in graph.forward_links:
                for next_seg in graph.forward_links[path[-1]]:
                    max_count = graph.max_path_segment_count(next_seg,
                                                             start_end_depth)
                    count = path.count(next_seg) + path.count(-next_seg)
                    if count < max_count:
                        if next_seg in opposite_paths_dict:
                            for final_part in opposite_paths_dict[next_seg]:
                                final_path = path + final_part
                                if flip_new_final_paths:
                                    final_path = reverse_path(final_path)
                                final_paths.add(tuple(final_path))
                        nlen = plen + seg_len(next_seg)
                        if nlen - seed_len <= max_length:
                            new_working_paths.append(
                                (path + [next_seg], nlen))
        working_paths = new_working_paths

    if len(working_paths) > settings.PROGRESSIVE_PATH_SEARCH_MAX_WORKING_PATHS:
        culled = cull_paths(graph, [p for p, _ in working_paths], sequence,
                            scoring_scheme, expected_scaled_score,
                            cull_score_fraction, device=device)
        working_paths = [(p, seed_len + graph.get_path_length(p[1:]))
                         for p in culled]
    return working_paths


def cull_paths(graph, paths, sequence, scoring_scheme, expected_scaled_score,
               cull_score_fraction, device=None):
    """Keep the best-aligning working paths (ref path_finding.py:297-378).
    The per-path tail alignments run as one batched device launch."""
    scoring = scoring_scheme.to_ops()

    # Common path prefix alignment is reused across all candidates.
    common_start = []
    smallest = min(len(x) for x in paths)
    for i in range(smallest):
        seg = paths[0][i]
        if all(path[i] == seg for path in paths):
            common_start.append(seg)
        else:
            break

    common_path_seq = graph.get_path_sequence(common_start[1:])[:-100]
    path_align_start = len(common_path_seq)
    if common_path_seq:
        pa = dispatch.align_pair(encode_sequence(common_path_seq),
                                 encode_sequence(sequence), scoring,
                                 pw.PATH_CONFIG, band=1000, device=device)
        seq_align_start = pa.s2_end
    else:
        seq_align_start = 0

    shortest_len = min(graph.get_path_length(x[1:]) for x in paths)
    seq_after = encode_sequence(sequence[seq_align_start:])
    tails = []
    from ..utils import trace
    with trace.span('cull_tail_build'):
        for path in paths:
            tail = graph.get_path_sequence(
                path[1:])[path_align_start:shortest_len]
            tails.append(encode_sequence(tail))
    alignments = dispatch.batch_align(tails, [seq_after] * len(paths),
                                      scoring, pw.PATH_CONFIG, band=500,
                                      device=device)
    scored_paths = []
    for path, pa in zip(paths, alignments):
        if pa is not None:
            scored_paths.append((path, dispatch.scaled_score(pa, scoring)))
    scored_paths.sort(key=lambda x: x[1], reverse=True)
    if not scored_paths:
        return []

    best_score = scored_paths[0][1]
    worst_score = scored_paths[-1][1]
    if best_score < 0.9 * expected_scaled_score and \
            best_score * 0.95 < worst_score:
        return []

    surviving = [x for x in scored_paths
                 if x[1] >= best_score * cull_score_fraction]

    # Per-terminal-segment dedup: lower-scored paths ending in the same
    # segment can never overtake (ref path_finding.py:356-376).
    by_terminal = {}
    for path in surviving:
        terminal = path[0][-1]
        score = path[1]
        if terminal not in by_terminal:
            by_terminal[terminal] = [path]
        else:
            current_best = by_terminal[terminal][0][1]
            if score > current_best:
                by_terminal[terminal] = [path]
            elif score == current_best:
                by_terminal[terminal].append(path)
    result = []
    for group in by_terminal.values():
        result += [x[0] for x in group]
    return result
