"""Long-read bridges: the flagship bridging mechanism.

Capability parity with reference unicycler/bridge_long_read.py:37-670:
spanning read segments between pairs of anchor alignments (including the
same-segment circularisation special case) are collected per segment pair,
a consensus is built (capped at 25 reads), a graph path is searched, and a
multi-factor quality model scores the bridge. Counterpart of
unicycler_tpu/bridges/long_read.py; the consensus and path alignments run
on `device` (None = CUDA), which create_long_read_bridges takes and passes
down.
"""

import math
import statistics
from collections import defaultdict

from .. import log, settings
from ..misc import (flip_number_order, float_to_str, reverse_complement,
                    score_function)
from ..ops.msa import consensus_align
from .common import get_bridge_str, get_depth_agreement_factor, get_mean_depth
from .path_finding import get_best_paths_for_seq


class LongReadBridge(object):

    def __init__(self, graph, start, end):
        self.start_segment = start
        self.end_segment = end
        # (seq_or_overlap_int, qual, start_alignment, end_alignment) tuples
        self.reads = []
        self.consensus_sequence = ''
        self.graph_path = []
        self.all_paths = []
        self.bridge_sequence = ''
        self.depth = get_mean_depth(graph.segments[abs(start)],
                                    graph.segments[abs(end)], graph)
        self.quality = 1.0
        self.segments_reduced_depth = []
        self.graph = graph

    def __repr__(self):
        return ('long read bridge: ' + get_bridge_str(self) + ' (quality = '
                + float_to_str(self.quality, 2) + ')')

    def finalise(self, scoring_scheme, min_alignment_length, read_lengths,
                 estimated_genome_size, expected_linear_seqs, device=None):
        """Consensus + path search + quality model
        (ref bridge_long_read.py:112-343)."""
        start_seg = self.graph.segments[abs(self.start_segment)]
        end_seg = self.graph.segments[abs(self.end_segment)]

        start_scores = [x[2].scaled_score for x in self.reads]
        end_scores = [x[3].scaled_score for x in self.reads]
        best_overall_scaled_score = min(max(start_scores), max(end_scores))
        mean_alignment_scaled_score = statistics.mean(start_scores
                                                      + end_scores)
        read_to_ref_ratios = ([x[2].get_read_to_ref_ratio()
                               for x in self.reads]
                              + [x[3].get_read_to_ref_ratio()
                                 for x in self.reads])
        mean_read_to_ref_ratio = statistics.mean(read_to_ref_ratios)

        reads_without_seq = [r for r in self.reads if isinstance(r[0], int)]
        reads_with_seq = [r for r in self.reads
                          if not isinstance(r[0], int)]
        # Mixed case: keep the majority group (ref :144-150).
        if reads_with_seq and reads_without_seq:
            if len(reads_without_seq) > len(reads_with_seq):
                reads_with_seq = []
            else:
                reads_without_seq = []

        if reads_with_seq:
            from ..utils import trace
            with trace.span('bridge_consensus'):
                self.consensus_sequence = get_consensus_sequence(
                    reads_with_seq, scoring_scheme, device=device)
            num_span_reads = len(self.reads)
            expected_scaled_score = 100.0 * (
                (1.0 - mean_alignment_scaled_score / 100.0)
                * (1.0 - (3.0 / (2.0 + num_span_reads)))
                + mean_alignment_scaled_score / 100.0)
            expected_scaled_score = max(expected_scaled_score,
                                        best_overall_scaled_score)
            expected_consensus_to_ref_ratio = 1.0 + \
                (mean_read_to_ref_ratio - 1.0) * (4 / (4 + num_span_reads - 1))
            target_path_length = int(round(len(self.consensus_sequence)
                                           / expected_consensus_to_ref_ratio))
        else:
            self.consensus_sequence = ''
            target_path_length = 0
            expected_scaled_score = 100.0

        from ..utils import trace
        with trace.span('bridge_path_search'):
            self.all_paths, _ = get_best_paths_for_seq(
                self.graph, self.start_segment, self.end_segment,
                target_path_length, self.consensus_sequence, scoring_scheme,
                expected_scaled_score, device=device)

        if self.all_paths:
            self.graph_path = self.all_paths[0][0]
            self.bridge_sequence = self.graph.get_path_sequence(
                self.graph_path)
            actual_scaled_score = self.all_paths[0][3]
            self.quality = math.sqrt(
                1.0 / (1.0 + 2.0 ** (expected_scaled_score
                                     - actual_scaled_score)))
        else:
            self.graph_path = []
            self.bridge_sequence = self.consensus_sequence or ''
            dead_end_count = 0
            if self.graph.ends_with_dead_end(self.start_segment):
                dead_end_count += 1
            if self.graph.starts_with_dead_end(self.end_segment):
                dead_end_count += 1
            if expected_linear_seqs:
                self.quality = {
                    2: settings.PATHLESS_BRIDGE_QUAL_TWO_DEAD_ENDS_WITH_LINEAR_SEQS,
                    1: settings.PATHLESS_BRIDGE_QUAL_ONE_DEAD_END_WITH_LINEAR_SEQS,
                    0: settings.PATHLESS_BRIDGE_QUAL_NO_DEAD_ENDS_WITH_LINEAR_SEQS,
                }[dead_end_count]
            else:
                self.quality = {
                    2: settings.PATHLESS_BRIDGE_QUAL_TWO_DEAD_ENDS,
                    1: settings.PATHLESS_BRIDGE_QUAL_ONE_DEAD_END,
                    0: settings.PATHLESS_BRIDGE_QUAL_NO_DEAD_ENDS,
                }[dead_end_count]
            bridge_len = max(0, len(self.bridge_sequence))
            half_qual = settings.LONG_READ_BRIDGE_HALF_QUAL_LENGTH
            self.quality *= half_qual / (bridge_len + half_qual)

        # Expected-read-count model (Lander-Waterman-ish, ref :271-303).
        min_read_len = 2 * min_alignment_length + len(self.bridge_sequence)
        total_possible_placements = 0
        for read_len, count in read_lengths.items():
            if read_len < min_read_len:
                continue
            placements = (read_len - min_read_len + 1) * count
            placements *= max(self.depth, 1)
            total_possible_placements += placements
        expected_read_count = total_possible_placements / \
            estimated_genome_size
        expected_read_count = reduce_expected_count(expected_read_count,
                                                    30, 0.5)
        actual_read_count = len(self.reads)

        self.quality *= get_depth_agreement_factor(start_seg.depth,
                                                   end_seg.depth)
        try:
            self.quality *= min(1.0, actual_read_count / expected_read_count)
        except ZeroDivisionError:
            pass

        longest_start = max(x[2].get_aligned_ref_length()
                            for x in self.reads)
        longest_end = max(x[3].get_aligned_ref_length() for x in self.reads)
        self.quality *= score_function(min(longest_start, longest_end),
                                       min_alignment_length * 4)
        best_start = max(x[2].scaled_score for x in self.reads)
        best_end = max(x[3].scaled_score for x in self.reads)
        self.quality *= min(best_start, best_end) / 100.0

        start_length_factor = score_function(start_seg.get_length(),
                                             min_alignment_length * 4)
        end_length_factor = score_function(end_seg.get_length(),
                                           min_alignment_length * 4)
        self.quality *= start_length_factor
        self.quality *= end_length_factor
        self.quality *= min(start_length_factor, end_length_factor)

        self.quality = 100.0 * math.sqrt(self.quality)

    def set_path_based_on_availability(self, graph, unbridged_graph):
        """Re-choose among equal paths by availability
        (ref bridge_long_read.py:345-385)."""
        best_path = self.all_paths[0][0]
        best_sequence = unbridged_graph.get_path_sequence(best_path)
        best_scaled_score = self.all_paths[0][3]
        best_availability = graph.get_path_availability(best_path)
        for i in range(1, len(self.all_paths)):
            potential_path = self.all_paths[i][0]
            potential_scaled_score = self.all_paths[i][3]
            potential_availability = graph.get_path_availability(
                potential_path)
            if potential_scaled_score == 100.0:
                relative_score = 1.0
            else:
                relative_score = min(1.0, (100.0 - best_scaled_score)
                                     / (100.0 - potential_scaled_score))
            relative_availability = min(2.0, (1.1 - best_availability)
                                        / (1.1 - potential_availability))
            if relative_score * relative_availability > 1.0:
                best_path = potential_path
                best_sequence = unbridged_graph.get_path_sequence(
                    potential_path)
                best_scaled_score = potential_scaled_score
                best_availability = potential_availability
        self.graph_path = best_path
        self.bridge_sequence = best_sequence

    @staticmethod
    def get_type_score():
        return 2

    @staticmethod
    def get_type_name():
        return 'long read'


def create_long_read_bridges(graph, read_dict, read_names, anchor_segments,
                             verbosity, min_scaled_score, threads,
                             scoring_scheme, min_alignment_length,
                             expected_linear_seqs, min_bridge_qual,
                             device=None):
    """Bridges from spanning read alignments
    (ref bridge_long_read.py:403-593). The alignments of consensus and
    path scoring run on `device` (None = CUDA; 'cpu' for the CPU route)."""
    from ..device import resolve_device
    device = resolve_device(device)
    log.log_section_header('Building long read bridges')
    anchor_seg_nums = set(x.number for x in anchor_segments)
    spanning_read_seqs = defaultdict(list)

    for read_name in read_names:
        read = read_dict[read_name]
        alignments = get_single_copy_alignments(read, anchor_seg_nums,
                                                min_scaled_score)
        if len(alignments) < 2:
            continue
        already_added = set()
        sorted_alignments = sorted(alignments, key=lambda x: x.raw_score,
                                   reverse=True)
        available = []
        for alignment in sorted_alignments:
            # A segment can't legitimately appear in both orientations in
            # one read (ref :438-446).
            opposite = -alignment.get_signed_ref_num()
            if opposite in set(x.get_signed_ref_num() for x in available):
                continue
            available.append(alignment)
            available.sort(key=lambda x: x.read_start_positive_strand())
            if len(available) < 2:
                continue
            for i in range(len(available)):
                if i < len(available) - 1:
                    alignment_1 = available[i]
                    alignment_2 = available[i + 1]
                elif available[0].ref.name == available[-1].ref.name:
                    # same-segment circularisation special case (ref :459)
                    alignment_1 = available[0]
                    alignment_2 = available[-1]
                else:
                    continue
                seg_nums, flipped = flip_number_order(
                    alignment_1.get_signed_ref_num(),
                    alignment_2.get_signed_ref_num())
                if seg_nums in already_added:
                    continue
                bridge_start = alignment_1.read_end_positive_strand()
                bridge_end = alignment_2.read_start_positive_strand()
                if bridge_end > bridge_start:
                    bridge_seq = read.sequence[bridge_start:bridge_end]
                    bridge_qual = read.qualities[bridge_start:bridge_end]
                    if flipped:
                        bridge_seq = reverse_complement(bridge_seq)
                        bridge_qual = bridge_qual[::-1]
                else:
                    bridge_seq = bridge_end - bridge_start
                    bridge_qual = ''
                spanning_read_seqs[seg_nums].append(
                    (bridge_seq, bridge_qual, alignment_1, alignment_2))
                already_added.add(seg_nums)

    new_bridges = []
    for seg_nums, span in spanning_read_seqs.items():
        start, end = seg_nums
        # Already-circular segments need no bridge (ref :497-501).
        if start == end and \
                graph.get_downstream_seg_nums(start) == [start] and \
                graph.get_upstream_seg_nums(start) == [start]:
            continue
        new_bridge = LongReadBridge(graph, start, end)
        new_bridge.reads += span
        new_bridges.append(new_bridge)
    new_bridges.sort(key=lambda x: (x.start_segment, x.end_segment))

    read_lengths = defaultdict(int)
    for read_name in read_names:
        read = read_dict[read_name]
        if read.alignments:
            read_lengths[read.get_length()] += 1
    estimated_genome_size = graph.get_estimated_sequence_len()

    # Finalise on a thread pool, biggest jobs first (the reference's own
    # structure, ref bridge_long_read.py:543-559). Each finalisation is
    # a chain of device align calls whose dispatch/fetch round trips
    # dominate on a remote device; the blocking fetches release the GIL,
    # so concurrent finalisations overlap their round trips while the
    # device serialises the (small) kernel work. Results are
    # bridge-local, so thread scheduling cannot affect outputs.
    order = sorted(range(len(new_bridges)),
                   key=lambda i: -sum(
                       len(x[0]) for x in new_bridges[i].reads
                       if not isinstance(x[0], int)))

    def _finalise(i):
        new_bridges[i].finalise(scoring_scheme, min_alignment_length,
                                read_lengths, estimated_genome_size,
                                expected_linear_seqs, device=device)

    if len(new_bridges) > 1 and threads > 1:
        from multiprocessing.dummy import Pool as ThreadPool
        with ThreadPool(min(threads, 8)) as pool:
            list(pool.imap_unordered(_finalise, order))
    else:
        for i in order:
            _finalise(i)

    # Split bridges whose path passes through anchor segments (ref :561-591)
    split_bridges = []
    for bridge in new_bridges:
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
                split_bridge = LongReadBridge(graph, full_path[start_i],
                                              full_path[end_i])
                split_bridge.graph_path = new_path
                split_bridge.all_paths = [new_path]
                split_bridge.bridge_sequence = \
                    graph.get_path_sequence(new_path)
                split_bridge.quality = bridge.quality
                split_bridges.append(split_bridge)
    return split_bridges


def get_single_copy_alignments(read, single_copy_num_set, min_scaled_score):
    return [a for a in read.alignments
            if a.ref.number in single_copy_num_set
            and a.scaled_score >= min_scaled_score]


def reduce_expected_count(expected_count, a, b):
    """Dampen high expected counts (ref bridge_long_read.py:618-627)."""
    return expected_count * ((a / (a + expected_count)) * (1.0 - b) + b)


def get_consensus_sequence(reads, scoring_scheme, device=None):
    """Best-first read selection + star-MSA consensus
    (ref bridge_long_read.py:630-670)."""
    reads = sorted(reads, reverse=True,
                   key=lambda x: min(x[2].scaled_score, x[3].scaled_score))
    best = min(reads[0][2].scaled_score, reads[0][3].scaled_score)
    reads = [x for x in reads
             if min(x[2].scaled_score, x[3].scaled_score) >= best - 10.0]
    if len(reads) == 2:
        diff = (min(reads[0][2].scaled_score, reads[0][3].scaled_score)
                - min(reads[1][2].scaled_score, reads[1][3].scaled_score))
        if diff > 2.0:
            reads = reads[0:1]
    if len(reads) > settings.MAX_READS_FOR_CONSENSUS:
        reads = reads[:settings.MAX_READS_FOR_CONSENSUS]
    if len(reads) == 1:
        return reads[0][0]
    return consensus_align([x[0] for x in reads], [x[1] for x in reads],
                           scoring_scheme.to_ops(), device=device)
