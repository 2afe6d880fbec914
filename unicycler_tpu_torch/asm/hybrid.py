"""Long-read (+contig) string-graph assembly orchestration.

Capability parity with reference unicycler/miniasm_assembly.py:50-785:
choose reads overlapping contig ends, assemble contigs-as-reads + long
reads with the OLC assembler, clean to unitigs, polish, trim short-read
dead ends from the assembler's clip info, and place contigs back into
unitigs to define bridge sequences. No subprocesses and no intermediate
files — reads and overlaps stay in memory, device kernels do the
alignment work (counterpart of unicycler_tpu/asm/hybrid.py). Every call
that aligns runs on `device` (None = CUDA): contig placement, the
polish rounds and their end repair.
"""

import itertools

from .. import log, settings
from ..device import resolve_device
from ..align.minimap_like import align_long_reads_to_assembly_graph
from ..align.semi_global import semi_global_align_long_reads
from ..graph.string_graph import (StringGraph, StringGraphSegment,
                                  merge_string_graph_segments_into_unitig_graph)
from ..io.fastx import Read, Reference, encode_sequence
from ..misc import range_overlap_size
from ..ops import dispatch
from ..ops import pairwise as pw
from ..utils import trace
from .olc import OLCAssembler, ava_overlaps
from .polish import polish_unitigs


class MiniasmFailure(Exception):
    pass


def make_miniasm_string_graph(graph, read_dict, long_read_filename,
                              scoring_scheme, read_nicknames, counter, args,
                              anchor_segments,
                              existing_long_read_assembly=None, device=None):
    """(ref miniasm_assembly.py:50-214) The polished unitig graph (graph =
    None: a long-read-only run) or, given the short-read graph, the
    CONTIG_/BRIDGE_ string graph of the contigs placed in it; None when
    the assembler leaves no segment or, in a hybrid run, too little
    sequence to bridge with."""
    device = resolve_device(device)
    log.log_section_header('Assembling contigs and long reads')
    short_reads_available = graph is not None
    seg_nums_to_bridge = set(x.number for x in anchor_segments)

    assembly_read_names = get_miniasm_assembly_reads(
        graph, read_dict, long_read_filename,
        getattr(args, 'threads', 1))
    read_seqs, trim_qual = build_assembly_read_set(
        assembly_read_names, read_dict, graph, seg_nums_to_bridge)

    log.log('Finding all-vs-all overlaps...')
    with trace.span('ava_overlaps'):
        hits = ava_overlaps(read_seqs)
    log.log('  %d overlaps' % len(hits))
    if not hits:
        raise MiniasmFailure('no overlaps found for assembly')

    log.log('Assembling reads...')
    with trace.span('olc_assemble'):
        assembler = OLCAssembler(read_seqs, min_dp=3)
        string_graph, trim_ranges = assembler.assemble(hits)
    if len(string_graph.segments) == 0:
        log.log('  empty result')
        return None
    log.log('  %d segments, %d links' % (len(string_graph.segments),
                                         len(string_graph.links) // 2))

    string_graph.remove_branching_paths()
    unitig_graph = merge_string_graph_segments_into_unitig_graph(
        string_graph, read_nicknames)
    unitig_graph_size = unitig_graph.get_total_segment_length()
    log.log('  %d circular, %d linear unitigs, total %d bp'
            % (unitig_graph.get_circular_segment_count(),
               unitig_graph.get_linear_segment_count(), unitig_graph_size))

    # Too-small assemblies are not useful for bridging (ref :173-182).
    if short_reads_available:
        estimated_genome_size = graph.get_estimated_sequence_len()
        if unitig_graph_size < estimated_genome_size * \
                settings.REQUIRED_MINIASM_ASSEMBLY_SIZE_FOR_BRIDGING:
            log.log('miniasm assembly too small for bridging')
            unitig_graph = None

    if unitig_graph is not None:
        if existing_long_read_assembly:
            log.log('Using provided long read assembly: '
                    + existing_long_read_assembly)
            unitig_graph = StringGraph(existing_long_read_assembly)
        else:
            polish_reads = [read_dict[n] for n in sorted(read_dict.keys())]
            if graph is not None:
                polish_reads = contig_reads(graph, seg_nums_to_bridge) \
                    + polish_reads
            unitig_graph = polish_unitigs(unitig_graph, polish_reads,
                                          scoring_scheme,
                                          hybrid=short_reads_available,
                                          device=device)

    if unitig_graph is not None and short_reads_available:
        trim_dead_ends_based_on_miniasm_trimming(graph, trim_ranges)
        with trace.span('place_contigs'):
            unitig_graph = place_contigs(graph, unitig_graph, scoring_scheme,
                                         seg_nums_to_bridge, device=device)
    return unitig_graph


def get_miniasm_assembly_reads(graph, read_dict, long_read_filename,
                               threads):
    """Reads overlapping contig ends (hybrid) or all reads (long-only)
    (ref miniasm_assembly.py:217-227)."""
    if graph is not None:
        minimap_alignments = align_long_reads_to_assembly_graph(
            graph, long_read_filename, None, threads)
        return sorted(read_name
                      for read_name, alignments in minimap_alignments.items()
                      if any(a.overlaps_reference() for a in alignments))
    return sorted(read_dict.keys())


def contig_reads(graph, seg_nums_to_bridge):
    """Anchor contigs packaged as high-quality 'reads'
    (ref save_assembly_reads_to_file :230-274)."""
    qual = chr(settings.CONTIG_READ_QSCORE + 33)
    out = []
    for seg in sorted(graph.segments.values(), key=lambda x: x.number):
        if segment_suitable_for_miniasm_assembly(graph, seg,
                                                 seg_nums_to_bridge):
            out.append(Read('CONTIG_' + str(seg.number),
                            seg.forward_sequence,
                            qual * seg.get_length()))
    return out


def build_assembly_read_set(read_names, read_dict, graph,
                            seg_nums_to_bridge):
    """Assembly input: contigs as reads + selected long reads
    (ref :230-274). Returns ({name: seq}, {name: qual})."""
    read_seqs = {}
    read_quals = {}
    if graph is not None:
        for read in contig_reads(graph, seg_nums_to_bridge):
            read_seqs[read.name] = read.sequence
            read_quals[read.name] = read.qualities
    for read_name in read_names:
        read = read_dict[read_name]
        if read.get_length() < 100:
            continue
        read_seqs[read_name] = read.sequence
        read_quals[read_name] = read.qualities
    return read_seqs, read_quals


def segment_suitable_for_miniasm_assembly(graph, segment,
                                          seg_nums_to_bridge):
    if segment.number not in seg_nums_to_bridge:
        return False
    return not graph.is_component_complete([segment.number])


def trim_dead_ends_based_on_miniasm_trimming(assembly_graph, trim_ranges):
    """Trim dead-end contigs to the ranges the assembler kept
    (ref miniasm_assembly.py:733-785). trim_ranges maps read names to
    1-based (start, end)."""
    for name, (start_1based, end) in sorted(trim_ranges.items()):
        if not name.startswith('CONTIG_'):
            continue
        contig_number = int(name.split('CONTIG_')[1].split(':')[0])
        if contig_number not in assembly_graph.segments:
            continue
        start_dead_end = assembly_graph.starts_with_dead_end(contig_number)
        end_dead_end = assembly_graph.ends_with_dead_end(contig_number)
        if not (start_dead_end or end_dead_end):
            continue
        contig = assembly_graph.segments[contig_number]
        start_trim = start_1based - 1
        end_trim = contig.get_length() - end
        if not start_dead_end:
            start_trim = 0
        if not end_dead_end:
            end_trim = 0
        if start_trim > settings.MAX_MINIASM_DEAD_END_TRIM_SIZE:
            start_trim = 0
        if end_trim > settings.MAX_MINIASM_DEAD_END_TRIM_SIZE:
            end_trim = 0
        if start_trim and start_dead_end:
            contig.trim_from_start(start_trim)
        if end_trim and end_dead_end:
            contig.trim_from_end(end_trim)


def place_contigs(assembly_graph, unitig_graph, scoring_scheme,
                  seg_nums_to_bridge, device=None):
    """Place anchor contigs back into unitigs, producing a CONTIG_/BRIDGE_
    string graph (ref miniasm_assembly.py:422-560). The contig ends are
    found and the overlapping bridges trimmed by alignments on `device`
    (None = CUDA)."""
    device = resolve_device(device)
    contig_numbers = [seg.number for seg in
                      sorted(assembly_graph.segments.values(),
                             key=lambda x: x.number)
                      if segment_suitable_for_miniasm_assembly(
                          assembly_graph, seg, seg_nums_to_bridge)]
    contig_positions = []
    for contig_search_end_size in settings.CONTIG_SEARCH_END_SIZES:
        position_results, not_found = find_contig_starts_and_ends(
            assembly_graph, unitig_graph, scoring_scheme,
            contig_search_end_size, contig_numbers, device=device)
        contig_positions += position_results
        if not_found:
            contig_numbers = not_found
        else:
            break

    new_graph = StringGraph(None)
    bridge_num = itertools.count(start=1)
    for seg in sorted(unitig_graph.segments.values(),
                      key=lambda x: x.get_length(), reverse=True):
        unitig_name = seg.full_name
        unitig_seq = seg.forward_sequence
        extended_unitig_seq = unitig_seq + unitig_seq
        unitig_length = len(unitig_seq)
        circular_unitig = unitig_graph.segment_is_circular(unitig_name)

        # Contigs that overlap each other a lot are thrown out (ref :466-474)
        good_positions = []
        unitig_positions = [x for x in contig_positions
                            if x[3] == unitig_name]
        for i, pos in enumerate(unitig_positions):
            others = unitig_positions[:i] + unitig_positions[i + 1:]
            if range_overlap_size(pos[:2], [x[:2] for x in others]) <= \
                    settings.FOUND_CONTIG_MAX_OVERLAP_SIZE:
                good_positions.append(pos)
        unitig_positions = sorted(good_positions)

        segment_names = []
        if not unitig_positions:
            seg_name = 'BRIDGE_' + str(next(bridge_num))
            new_graph.segments[seg_name] = StringGraphSegment(seg_name,
                                                              unitig_seq)
            segment_names.append(seg_name + '+')

        for i, (start_pos, end_pos, rev_strand, _, contig_number) in \
                enumerate(unitig_positions):
            if i == 0 and not circular_unitig:
                bridge_seq = unitig_seq[:start_pos]
                if bridge_seq:
                    seg_name = 'BRIDGE_' + str(next(bridge_num))
                    new_graph.segments[seg_name] = \
                        StringGraphSegment(seg_name, bridge_seq)
                    segment_names.append(seg_name + '+')
            seg_name = 'CONTIG_' + str(contig_number)
            contig_seq = \
                assembly_graph.segments[contig_number].forward_sequence
            new_graph.segments[seg_name] = StringGraphSegment(seg_name,
                                                              contig_seq)
            segment_names.append(seg_name + ('-' if rev_strand else '+'))

            not_last = i < len(unitig_positions) - 1
            last_and_circular = (i == len(unitig_positions) - 1
                                 and circular_unitig)
            if not_last or last_and_circular:
                bridge_start = end_pos
                if not_last:
                    bridge_end = unitig_positions[i + 1][0]
                else:
                    bridge_end = unitig_positions[0][0] + unitig_length
                if bridge_end >= bridge_start:
                    bridge_seq = extended_unitig_seq[bridge_start:bridge_end]
                    seg_name = 'BRIDGE_' + str(next(bridge_num))
                else:
                    bridge_seq = extended_unitig_seq[bridge_end:bridge_start]
                    seg_name = 'OVERLAPPING_BRIDGE_' + str(next(bridge_num))
                new_graph.segments[seg_name] = StringGraphSegment(seg_name,
                                                                  bridge_seq)
                segment_names.append(seg_name + '+')
            if i == len(unitig_positions) - 1 and not circular_unitig:
                bridge_seq = unitig_seq[end_pos:unitig_length]
                if bridge_seq:
                    seg_name = 'BRIDGE_' + str(next(bridge_num))
                    new_graph.segments[seg_name] = \
                        StringGraphSegment(seg_name, bridge_seq)
                    segment_names.append(seg_name + '+')

        if circular_unitig and segment_names:
            segment_names.append(segment_names[0])
        for i in range(1, len(segment_names)):
            seg_1, seg_2 = segment_names[i - 1], segment_names[i]
            ob_1 = seg_1.startswith('OVERLAPPING_BRIDGE')
            ob_2 = seg_2.startswith('OVERLAPPING_BRIDGE')
            seg_1_seq = new_graph.seq_from_signed_seg_name(seg_1)
            seg_2_seq = new_graph.seq_from_signed_seg_name(seg_2)
            if ob_1:
                overlap_1 = len(seg_1_seq)
                overlap_2 = start_seq_alignment(seg_1_seq, seg_2_seq,
                                                scoring_scheme, device=device)
                new_graph.add_link(seg_1, seg_2, overlap_1, overlap_2)
            elif ob_2:
                overlap_1 = len(seg_1_seq) - end_seq_alignment(
                    seg_2_seq, seg_1_seq, scoring_scheme, device=device)
                overlap_2 = len(seg_2_seq)
                new_graph.add_link(seg_1, seg_2, overlap_1, overlap_2)
            else:
                new_graph.add_link(seg_1, seg_2, 0, 0)
    return new_graph


def start_seq_alignment(s1, s2, scoring_scheme, device=None):
    """Where s1 ends within the start of s2 (role of ref
    src/start_end_align.cpp startAlignment; trims s2 like :36-43)."""
    trim = int(len(s1) * 1.5)
    s2_trim = s2[:trim] if len(s2) > trim else s2
    pa = dispatch.align_pair(encode_sequence(s1), encode_sequence(s2_trim),
                             scoring_scheme.to_ops(), pw.START_CONFIG,
                             device=device)
    return pa.s2_end


def end_seq_alignment(s1, s2, scoring_scheme, device=None):
    """Where s1 starts within the end of s2 (role of endAlignment)."""
    trim = int(len(s1) * 1.5)
    offset = max(0, len(s2) - trim)
    s2_trim = s2[offset:]
    pa = dispatch.align_pair(encode_sequence(s1), encode_sequence(s2_trim),
                             scoring_scheme.to_ops(), pw.END_CONFIG,
                             device=device)
    return pa.s2_start + offset


def find_contig_starts_and_ends(assembly_graph, unitig_graph, scoring_scheme,
                                contig_search_end_size, contig_numbers,
                                device=None):
    """Locate contig start/end positions in the unitigs via semi-global
    alignment of contig ends (ref miniasm_assembly.py:563-710)."""
    if not contig_numbers:
        return [], []

    search_reads = {}
    smallest_contig_len = float('inf')
    longest_contig_len = 0
    for contig_number in contig_numbers:
        seg = assembly_graph.segments[contig_number]
        seq = seg.forward_sequence
        longest_contig_len = max(longest_contig_len, len(seq))
        smallest_contig_len = min(smallest_contig_len, len(seq))
        contig_name = 'CONTIG_' + str(seg.number)
        if len(seq) >= contig_search_end_size * 2:
            search_reads[contig_name + '_START'] = \
                seq[:contig_search_end_size]
            search_reads[contig_name + '_END'] = \
                seq[-contig_search_end_size:]
        else:
            search_reads[contig_name + '_WHOLE'] = seq

    references = []
    for seg in sorted(unitig_graph.segments.values(),
                      key=lambda x: x.get_length(), reverse=True):
        seg_seq = seg.forward_sequence
        if unitig_graph.segment_is_circular(seg.full_name):
            if len(seg_seq) <= longest_contig_len:
                seg_seq += seg_seq
            else:
                seg_seq += seg_seq[:longest_contig_len]
        references.append(Reference(seg.full_name, seg_seq))

    read_dict = {name: Read(name, seq, None)
                 for name, seq in search_reads.items()}
    read_names = sorted(read_dict.keys())
    min_alignment_len = min(contig_search_end_size * 0.9,
                            smallest_contig_len * 0.9)
    semi_global_align_long_reads(references, None, read_dict, read_names,
                                 None, 1, scoring_scheme, [None], False,
                                 min_alignment_len, None, None, 10, 0, None,
                                 verbosity=0, device=device)

    start_positions = {}
    end_positions = {}
    for contig_name in read_names:
        contig_number = int(contig_name.split('_')[1])
        contig = read_dict[contig_name]
        if not contig.alignments:
            continue
        a = sorted(contig.alignments, key=lambda x: x.scaled_score)[-1]
        if a.percent_identity < settings.CONTIG_SEARCH_MIN_IDENTITY:
            continue
        unitig_name = a.ref.name
        if contig_name.endswith('_START') or contig_name.endswith('_WHOLE'):
            pos = a.ref_end_pos if a.rev_comp else a.ref_start_pos
            start_positions[contig_number] = (unitig_name, pos, a.rev_comp)
        if contig_name.endswith('_END') or contig_name.endswith('_WHOLE'):
            pos = a.ref_start_pos if a.rev_comp else a.ref_end_pos
            end_positions[contig_number] = (unitig_name, pos, a.rev_comp)

    contig_positions = []
    for contig_number in contig_numbers:
        if contig_number not in start_positions or \
                contig_number not in end_positions:
            continue
        start_unitig, start_pos, start_rev = start_positions[contig_number]
        end_unitig, end_pos, end_rev = end_positions[contig_number]
        if start_unitig != end_unitig or start_rev != end_rev:
            continue
        unitig_name = start_unitig
        unitig_length = unitig_graph.segments[unitig_name].get_length()
        circular_unitig = unitig_graph.segment_is_circular(unitig_name)
        rev_comp = start_rev
        if start_pos >= unitig_length:
            start_pos -= unitig_length
        if end_pos >= unitig_length:
            end_pos -= unitig_length
        if start_pos > end_pos and not rev_comp and circular_unitig:
            start_pos -= unitig_length
        if end_pos > start_pos and rev_comp and circular_unitig:
            end_pos -= unitig_length
        if rev_comp:
            start_pos, end_pos = end_pos, start_pos
        contig = assembly_graph.segments[contig_number]
        length_ratio = (end_pos - start_pos) / contig.get_length()
        if length_ratio < settings.FOUND_CONTIG_MIN_RATIO or \
                length_ratio > settings.FOUND_CONTIG_MAX_RATIO:
            continue
        contig_positions.append((start_pos, end_pos, rev_comp, unitig_name,
                                 contig_number))

    not_found = [n for n in contig_numbers
                 if not any(x[4] == n for x in contig_positions)]
    return contig_positions, not_found
