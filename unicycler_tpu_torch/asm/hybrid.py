"""Long-read string-graph assembly, the long-read-only part (counterpart of
unicycler_tpu/asm/hybrid.py).

Capability parity with reference unicycler/miniasm_assembly.py:50-214 for
a run without short reads: every long read goes into an all-vs-all
overlap search, the OLC assembler builds the string graph, branching
links are cut, the graph merges into unitigs, and the unitigs are
polished by read voting, whose alignments run on `device` (None = CUDA).
No subprocesses and no intermediate files.

The hybrid branches of the JAX package (contig reads, dead-end trimming,
contig placement) need the short-read AssemblyGraph, which comes with the
pipeline slice of the port; given a graph, they raise NotImplementedError
instead of running anything else.
"""

from .. import log
from ..device import resolve_device
from ..graph.string_graph import (StringGraph,
                                  merge_string_graph_segments_into_unitig_graph)
from ..utils import trace
from .olc import OLCAssembler, ava_overlaps
from .polish import polish_unitigs


class MiniasmFailure(Exception):
    pass


def _hybrid_only(what):
    return NotImplementedError(
        '%s needs the short-read assembly graph, whose port comes with the '
        'pipeline slice; only the long-read-only assembly (graph=None) is '
        'ported' % what)


def make_miniasm_string_graph(graph, read_dict, long_read_filename,
                              scoring_scheme, read_nicknames, counter, args,
                              anchor_segments,
                              existing_long_read_assembly=None, device=None):
    """(ref miniasm_assembly.py:50-214) The unitig graph of the long reads
    (graph=None: a long-read-only run), polished; None when the assembler
    leaves no segment."""
    device = resolve_device(device)
    if graph is not None:
        raise _hybrid_only('hybrid assembly (make_miniasm_string_graph with '
                           'a graph)')
    log.log_section_header('Assembling contigs and long reads')
    seg_nums_to_bridge = set(x.number for x in anchor_segments)

    assembly_read_names = get_miniasm_assembly_reads(
        graph, read_dict, long_read_filename, getattr(args, 'threads', 1))
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
    log.log('  %d circular, %d linear unitigs, total %d bp'
            % (unitig_graph.get_circular_segment_count(),
               unitig_graph.get_linear_segment_count(),
               unitig_graph.get_total_segment_length()))

    if existing_long_read_assembly:
        log.log('Using provided long read assembly: '
                + existing_long_read_assembly)
        return StringGraph(existing_long_read_assembly)
    polish_reads = [read_dict[n] for n in sorted(read_dict.keys())]
    return polish_unitigs(unitig_graph, polish_reads, scoring_scheme,
                          hybrid=False, device=device)


def get_miniasm_assembly_reads(graph, read_dict, long_read_filename,
                               threads):
    """All reads of a long-read-only run (ref miniasm_assembly.py:217-227;
    a hybrid run picks the reads overlapping contig ends)."""
    if graph is not None:
        raise _hybrid_only('choosing reads that overlap contig ends')
    return sorted(read_dict.keys())


def contig_reads(graph, seg_nums_to_bridge):
    """Anchor contigs packaged as high-quality reads (ref
    save_assembly_reads_to_file :230-274): hybrid runs only."""
    raise _hybrid_only('contig reads')


def build_assembly_read_set(read_names, read_dict, graph,
                            seg_nums_to_bridge):
    """Assembly input: contigs as reads (hybrid runs) + the long reads of
    at least 100 bp (ref :230-274). Returns ({name: seq}, {name: qual})."""
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
    if not hasattr(graph, 'is_component_complete'):
        raise _hybrid_only('choosing contigs for assembly')
    return not graph.is_component_complete([segment.number])
