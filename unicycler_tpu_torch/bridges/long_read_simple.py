"""Simple long-read bridges: two-way junction votes and loop-count votes.

Capability parity with reference unicycler/bridge_long_read_simple.py:
42-521. TPU-first difference: the per-read loop-count votes — the
reference runs one banded fully-global alignment per (read, count) in a
ThreadPool (:336-351) with per-read early stopping — are batched here:
all (read, candidate-count) pairs go through one device launch per round.
A copy of unicycler_tpu/bridges/long_read_simple.py; the loop-count
alignments run on `device` (None = CUDA), which
create_simple_long_read_bridges takes and passes down.
"""

import itertools
import math
from collections import defaultdict

from .. import log, settings
from ..device import resolve_device
from ..io.fastx import encode_sequence
from ..misc import float_to_str
from ..ops import dispatch
from ..ops import pairwise as pw
from ..align.minimap_like import (align_long_reads_to_assembly_graph,
                                  build_start_end_overlap_sets)
from .common import get_bridge_str, get_depth_agreement_factor, get_mean_depth


class SimpleLongReadBridge(object):

    def __init__(self, graph, start, end, path, votes_for, votes_against):
        self.start_segment = start
        self.end_segment = end
        self.graph_path = path
        self.depth = get_mean_depth(graph.segments[abs(start)],
                                    graph.segments[abs(end)], graph)
        self.quality = 1.0
        self.segments_reduced_depth = []
        self.bridge_sequence = graph.get_path_sequence(self.graph_path)

        start_seg = graph.segments[abs(start)]
        end_seg = graph.segments[abs(end)]
        self.quality *= get_depth_agreement_factor(start_seg.depth,
                                                   end_seg.depth)
        try:
            vote_proportion = votes_for / (votes_for + votes_against)
        except ZeroDivisionError:
            vote_proportion = 0.0
        self.quality *= max(0.0, 2.0 * (vote_proportion - 0.5))
        if votes_for == 1:
            self.quality *= 0.5
        elif votes_for == 2:
            self.quality *= 0.75
        self.quality = 100.0 * math.sqrt(self.quality)

    def __repr__(self):
        return ('Simple long read bridge: ' + get_bridge_str(self)
                + ' (quality = ' + float_to_str(self.quality, 2) + ')')

    @staticmethod
    def get_type_score():
        return 2

    @staticmethod
    def get_type_name():
        return 'simple long read'


def create_simple_long_read_bridges(graph, out_dir, keep, threads, read_dict,
                                    long_read_filename, scoring_scheme,
                                    anchor_segments, device=None):
    """(ref bridge_long_read_simple.py:113-136) The loop votes align on
    `device` (None = CUDA; 'cpu' for the CPU route)."""
    device = resolve_device(device)
    log.log_section_header('Creating simple long read bridges')
    minimap_alignments = align_long_reads_to_assembly_graph(
        graph, long_read_filename, out_dir, threads)
    start_overlap_reads, end_overlap_reads = \
        build_start_end_overlap_sets(minimap_alignments)
    bridges = simple_bridge_two_way_junctions(
        graph, start_overlap_reads, end_overlap_reads, minimap_alignments,
        anchor_segments)
    bridges += simple_bridge_loops(
        graph, start_overlap_reads, end_overlap_reads, minimap_alignments,
        read_dict, scoring_scheme, threads, anchor_segments, device=device)
    return bridges


def simple_bridge_two_way_junctions(graph, start_overlap_reads,
                                    end_overlap_reads, minimap_alignments,
                                    segments_to_bridge):
    """Reads vote between the two resolutions of each 2-in 2-out junction
    (ref bridge_long_read_simple.py:139-268)."""
    bridges = []
    junctions = graph.find_simple_two_way_junctions(segments_to_bridge)
    if not junctions:
        log.log('No suitable two-way junctions present')
        return []
    for junction in junctions:
        inputs = graph.reverse_links[junction]
        outputs = graph.forward_links[junction]
        relevant_reads = list(
            end_overlap_reads[inputs[0]] | end_overlap_reads[inputs[1]]
            | end_overlap_reads[-outputs[0]] | end_overlap_reads[-outputs[1]]
            | start_overlap_reads[outputs[0]]
            | start_overlap_reads[outputs[1]]
            | start_overlap_reads[-inputs[0]]
            | start_overlap_reads[-inputs[1]])

        option_1_votes = 0
        option_2_votes = 0
        neither_votes = 0
        expected_next_seg = [[inputs[0], outputs[0], outputs[1]],
                             [inputs[1], outputs[1], outputs[0]],
                             [-outputs[0], -inputs[0], -inputs[1]],
                             [-outputs[1], -inputs[1], -inputs[0]]]
        for r in relevant_reads:
            alignments = [int(x.ref_name) * (-1 if x.read_strand == '-'
                                             else 1)
                          for x in minimap_alignments[r]
                          if x.ref_name != str(junction)]
            alignments = [k for k, _ in itertools.groupby(alignments)]
            for start, option_1_end, option_2_end in expected_next_seg:
                try:
                    after = alignments[alignments.index(start) + 1]
                    if after == option_1_end:
                        option_1_votes += 1
                    elif after == option_2_end:
                        option_2_votes += 1
                    else:
                        neither_votes += 1
                except (ValueError, IndexError):
                    pass

        if option_1_votes == 0 and option_2_votes == 0:
            continue
        if option_1_votes == option_2_votes:
            continue
        start_1, start_2 = inputs[0], inputs[1]
        if option_1_votes > option_2_votes:
            end_1, end_2 = outputs[0], outputs[1]
            votes_for = option_1_votes
            votes_against = option_2_votes + neither_votes
        else:
            end_1, end_2 = outputs[1], outputs[0]
            votes_for = option_2_votes
            votes_against = option_1_votes + neither_votes
        bridges.append(SimpleLongReadBridge(graph, start_1, end_1,
                                            [junction], votes_for,
                                            votes_against))
        bridges.append(SimpleLongReadBridge(graph, start_2, end_2,
                                            [junction], votes_for,
                                            votes_against))
    return bridges


def simple_bridge_loops(graph, start_overlap_reads, end_overlap_reads,
                        minimap_alignments, read_dict, scoring_scheme,
                        threads, segments_to_bridge, device=None):
    """Reads vote for the loop traversal count by aligning their spans
    against candidate loop sequences (ref :271-400), batched on device."""
    bridges = []
    seg_nums_to_bridge = set(x.number for x in segments_to_bridge)
    loops = [x for x in sorted(graph.find_all_simple_loops())
             if abs(x[0]) in seg_nums_to_bridge
             and abs(x[1]) in seg_nums_to_bridge
             and abs(x[3]) not in seg_nums_to_bridge
             and abs(x[0]) != abs(x[1])]
    if not loops:
        log.log('No suitable simple loops present')
        return []

    for start, end, middle, repeat in loops:
        forward_reads = end_overlap_reads[start] & start_overlap_reads[end]
        reverse_reads = end_overlap_reads[-end] & start_overlap_reads[-start]
        all_reads = list(forward_reads) + list(reverse_reads)
        strands = ['F'] * len(forward_reads) + ['R'] * len(reverse_reads)

        mean_depth = (graph.segments[abs(start)].depth
                      + graph.segments[abs(end)].depth) / 2
        if middle is None:
            best_guess = int(round(graph.segments[abs(repeat)].depth
                                   / mean_depth)) - 1
        else:
            best_guess = int(round(graph.segments[abs(middle)].depth
                                   / mean_depth))
        best_guess = max(1, best_guess)
        max_tested = (best_guess + 1) * 2

        votes = defaultdict(int)
        for read, strand in zip(all_reads, strands):
            vote = get_read_loop_vote(start, end, middle, repeat, strand,
                                      minimap_alignments, read, read_dict,
                                      graph, max_tested, scoring_scheme,
                                      device=device)
            votes[vote] += 1

        results = sorted(votes.items(), key=lambda x: x[1], reverse=True)
        if not results:
            continue
        winning_count, winning_votes = results[0]
        second_best = results[1][1] if len(results) > 1 else 0
        votes_against = sum(v for _, v in results) - winning_votes
        if winning_count == -1 or winning_votes == second_best:
            continue
        bridge_path = [repeat]
        for _ in range(winning_count):
            if middle is not None:
                bridge_path.append(middle)
            bridge_path.append(repeat)
        bridges.append(SimpleLongReadBridge(graph, start, end, bridge_path,
                                            winning_votes, votes_against))
    return bridges


def get_read_loop_vote(start, end, middle, repeat, strand,
                       minimap_alignments, read, read_dict, graph,
                       max_tested_loop_count, scoring_scheme, device=None):
    """One read's loop-count vote (ref :410-521). All candidate counts
    align in one batched launch; the argmax with strictly-greater updates
    reproduces the reference's lowest-winning-count tie behaviour."""
    if strand == 'F':
        s, e, m, r = start, end, middle, repeat
    else:
        if middle is None:
            s, e, m, r = -end, -start, None, -repeat
        else:
            s, e, m, r = -end, -start, -middle, -repeat
    alignments = minimap_alignments[read]

    last_index_of_start = -1
    for i, a in enumerate(alignments):
        if a.get_signed_ref_name() == str(s):
            last_index_of_start = i
    first_index_of_end = -1
    for i in range(last_index_of_start + 1, len(alignments)):
        if alignments[i].get_signed_ref_name() == str(e):
            first_index_of_end = i
            break
    if last_index_of_start == -1 or first_index_of_end == -1:
        return -1
    for i in range(last_index_of_start + 1, first_index_of_end):
        ref_name = alignments[i].get_signed_ref_name()
        if m is None:
            if ref_name != str(r):
                return -1
        elif ref_name != str(m) and ref_name != str(r):
            return -1

    start_alignment = alignments[last_index_of_start]
    end_alignment = alignments[first_index_of_end]
    read_seq = read_dict[read].sequence[start_alignment.read_start:
                                        end_alignment.read_end]
    if start_alignment.read_strand == '+':
        start_seg_start = start_alignment.ref_start
    else:
        start_seg_start = (start_alignment.ref_length
                           - start_alignment.ref_end)
    if end_alignment.read_strand == '+':
        end_seg_end = end_alignment.ref_end
    else:
        end_seg_end = end_alignment.ref_length - end_alignment.ref_start
    start_seg_seq = graph.seq_from_signed_seg_num(s)[start_seg_start:]
    end_seg_seq = graph.seq_from_signed_seg_num(e)[:end_seg_end]
    middle_seq = '' if m is None else graph.seq_from_signed_seg_num(m)
    repeat_seq = graph.seq_from_signed_seg_num(r)

    read_codes = encode_sequence(read_seq)
    scoring = scoring_scheme.to_ops()
    best_score, best_count = None, None
    base_count = 0
    while True:
        counts = list(range(base_count, max_tested_loop_count + 1))
        test_seqs = []
        for count in counts:
            seq = start_seg_seq + repeat_seq
            seq += (middle_seq + repeat_seq) * count
            seq += end_seg_seq
            test_seqs.append(encode_sequence(seq))
        results = dispatch.batch_align(
            [read_codes] * len(counts), test_seqs, scoring, pw.FULLY_GLOBAL,
            band=settings.SIMPLE_REPEAT_BRIDGING_BAND_SIZE,
            need_cigar=False, device=device)
        for count, pa in zip(counts, results):
            if pa is None:
                continue
            if best_score is None or pa.score > best_score:
                best_score = pa.score
                best_count = count
        # If the best is at the ceiling, extend upward (ref :496-499).
        if best_count is not None and \
                best_count == max_tested_loop_count and \
                max_tested_loop_count < len(read_seq):
            base_count = max_tested_loop_count + 1
            max_tested_loop_count *= 2
            continue
        break
    return best_count if best_count is not None else -1
