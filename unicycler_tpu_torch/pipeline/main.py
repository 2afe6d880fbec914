"""The assembly pipeline's command line (counterpart of
unicycler_tpu/pipeline/main.py).

get_arguments is the JAX package's whole option surface, with the same
names and defaults, so the same argv gives the same Namespace. main runs
every input mode:

  * short reads (`-1 R1 -2 R2 [-s U] [-l reads.fq] -o out`, Unicycler's
    default command line): the built-in de Bruijn assembler
    (asm/debruijn.build_best_short_read_graph: read correction, the k
    ladder, pair resolution), or the resume of a run whose
    out/002_depth_filter.gfa exists;
  * a supplied short-read graph (`--short_read_graph G.gfa|G.fastg
    [-l reads.fq] -o out`);
  * then, with a short-read graph: copy depth, overlap removal and
    cleaning, anchors, SPAdes-contig and loop-unrolling bridges, the
    miniasm string graph with the contigs placed in it, simple long-read
    bridges, long-read alignment to the graph and long-read bridges,
    bridge application, clean-up and merging over the bridging rounds,
    final_clean, the final short-read polish of a -1/-2 run whose last
    bridging round made bridges, rotation and the output files;
  * a long-read-only run (`-l reads.fq -o out`): the polished unitigs of
    the long reads, rotated.

Every call that aligns runs on `device`.

Several processes (one a card) can share a run: main joins the process
group that UNICYCLER_TPU_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID name
(parallel/distributed.maybe_initialize; without them it is one process).
Long-read alignment then shards its reads over the processes inside
semi_global_align_long_reads and allgathers the results; the graph
stages run replicated (they are deterministic), so every process writes
the same outputs, and only the main process logs.

    python -m unicycler_tpu_torch -1 R1.fq -2 R2.fq -l reads.fq -o out

main(arg_list=None, device=None) runs on CUDA unless the caller passes
device='cpu' (a Python keyword, not an option).
"""

import argparse
import itertools
import os
import random
import shutil
import sys

from .. import log, settings
from ..align.scoring import AlignmentScoringScheme
from ..align.semi_global import (load_sam_alignments,
                                 semi_global_align_long_reads)
from ..asm.debruijn import build_best_short_read_graph
from ..asm.hybrid import MiniasmFailure, make_miniasm_string_graph
from ..asm.polish import final_short_read_polish
from ..bridges.long_read import create_long_read_bridges
from ..bridges.long_read_simple import create_simple_long_read_bridges
from ..bridges.loop_unroll import create_loop_unrolling_bridges
from ..bridges.miniasm import create_miniasm_bridges
from ..bridges.spades_contig import create_spades_contig_bridges
from ..device import resolve_device
from ..graph.assembly_graph import AssemblyGraph
from ..graph.copy_depth import determine_copy_depth
from ..io.fastx import Reference, get_read_nickname_dict, load_long_reads
from ..misc import get_percentile, gfa_path, int_to_str, quit_with_error
from ..utils import trace
from ..version import __version__
from .rotation import rotate_completed_replicons


def get_arguments(args=None):
    """CLI argument surface (parity with ref unicycler.py:192-469):
    the same two-tier help (--help basic / --help_all everything), the
    same option names and defaults, and absolutised input paths. The
    external-tool path options (--spades_path etc.) are accepted for
    drop-in compatibility; the in-framework assembler/polisher/rotation
    replace those subprocesses, so they are only recorded."""
    argv = sys.argv[1:] if args is None else args
    show_all = '--help_all' in argv

    def ext(text):
        return text if show_all else argparse.SUPPRESS

    parser = argparse.ArgumentParser(
        description='Unicycler: an assembly pipeline for bacterial '
                    'genomes (PyTorch/CUDA implementation)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    basic = parser.add_argument_group('Help')
    basic.add_argument('-h', '--help', action='help',
                       help='Show this help message and exit')
    basic.add_argument('--help_all', action='help',
                       help='Show a help message with all program options')
    basic.add_argument('--version', action='version',
                       version='Unicycler (PyTorch/CUDA) v' + __version__,
                       help='Show the program version and exit')

    inp = parser.add_argument_group('Input')
    inp.add_argument('-1', '--short1',
                     help='FASTQ file of first short reads in each pair')
    inp.add_argument('-2', '--short2',
                     help='FASTQ file of second short reads in each pair')
    inp.add_argument('-s', '--unpaired',
                     help='FASTQ file of unpaired short reads')
    inp.add_argument('-l', '--long',
                     help='FASTQ or FASTA file of long reads')

    out = parser.add_argument_group('Output')
    out.add_argument('-o', '--out', required=('--help' not in argv
                                              and '-h' not in argv
                                              and not show_all),
                     help='Output directory')
    out.add_argument('--verbosity', type=int, default=1,
                     help='Level of stdout and log file information')
    out.add_argument('--min_fasta_length', type=int, default=100,
                     help='Exclude contigs from the FASTA file which are '
                          'shorter than this length')
    out.add_argument('--keep', type=int, default=1,
                     help='Level of file retention')

    other = parser.add_argument_group('Other')
    other.add_argument('-t', '--threads', type=int,
                       default=min(os.cpu_count() or 1, 8),
                       help='Number of threads used')
    other.add_argument('--mode', default='normal',
                       choices=['conservative', 'normal', 'bold'],
                       help='Bridging mode')
    other.add_argument('--min_bridge_qual', type=float, default=None,
                       help=ext('Do not apply bridges with a quality below '
                                'this value (default: set by --mode)'))
    other.add_argument('--linear_seqs', type=int, default=0,
                       help='The expected number of linear (i.e. '
                            'non-circular) sequences in the underlying '
                            'sequence')
    other.add_argument('--min_anchor_seg_len', type=int, default=None,
                       help=ext('Minimum length for anchor segments'))
    other.add_argument('--bridge_rounds', type=int, default=3,
                       help=ext('Long-read bridging rounds: later rounds '
                                're-anchor on the merged graph so the '
                                'same reads can span junctions the first '
                                'round\'s short anchors could not reach '
                                '(1 = reference-equivalent single round)'))
    other.add_argument('--reference_defaults', action='store_true',
                       help=ext('Run with reference-equivalent defaults: '
                                'overrides every default that diverges '
                                'from the reference pipeline (currently '
                                '--bridge_rounds 1; see README '
                                '"Defaults that differ from the '
                                'reference")'))

    spades = parser.add_argument_group('SPAdes-compatible assembly options')
    spades.add_argument('--spades_path', default='spades.py',
                        help=ext('Path to the SPAdes executable (accepted '
                                 'for compatibility; the built-in de '
                                 'Bruijn assembler is used)'))
    spades.add_argument('--spades_options', default=None,
                        help=ext('Additional SPAdes options (compatibility)'))
    spades.add_argument('--no_correct', action='store_true',
                        help=ext('Skip read error correction'))
    spades.add_argument('--min_kmer_frac', type=float, default=0.2,
                        help=ext('Lowest k-mer size for assembly, '
                                 'expressed as a fraction of the read '
                                 'length'))
    spades.add_argument('--max_kmer_frac', type=float, default=0.95,
                        help=ext('Highest k-mer size for assembly, '
                                 'expressed as a fraction of the read '
                                 'length'))
    spades.add_argument('--kmers', default=None,
                        help=ext('Exact k-mers to use for assembly, '
                                 'comma-separated'))
    spades.add_argument('--kmer_count', type=int, default=8,
                        help=ext('Number of k-mer steps to use in assembly'))
    spades.add_argument('--depth_filter', type=float, default=0.25,
                        help=ext('Filter out contigs lower than this '
                                 'fraction of the chromosomal depth'))
    spades.add_argument('--largest_component', action='store_true',
                        help=ext('Only keep the largest connected '
                                 'component of the assembly graph'))
    spades.add_argument('--aggressive_resolution', action='store_true',
                        help=ext('Enable the aggressive repeat-resolution '
                                 'bundle (higher-k thread ladder, '
                                 'interleaved splitting, conflicted-mate '
                                 'rescue). More contiguous but can weld '
                                 'diverged repeat homologs; the default '
                                 'conservative path preserves per-copy '
                                 'variants'))
    spades.add_argument('--short_read_graph', default=None,
                        help=ext('Existing short-read assembly graph '
                                 '(GFA, or SPAdes FASTG with a sibling '
                                 '.paths file) to use instead of the '
                                 'built-in assembler'))

    miniasm = parser.add_argument_group('miniasm+Racon assembly options')
    miniasm.add_argument('--no_miniasm', action='store_true',
                         help=ext('Skip miniasm+Racon bridging'))
    miniasm.add_argument('--racon_path', default='racon',
                         help=ext('Path to the Racon executable (accepted '
                                  'for compatibility; the built-in '
                                  'polisher is used)'))
    miniasm.add_argument('--existing_long_read_assembly', default=None,
                         help=ext('A pre-prepared long-read assembly '
                                  '(GFA) to use for bridging'))

    rotation = parser.add_argument_group('Assembly rotation')
    rotation.add_argument('--no_rotate', action='store_true',
                          help=ext('Do not rotate completed replicons to '
                                   'start at a standard gene'))
    rotation.add_argument('--start_genes', default=None,
                          help=ext('FASTA file of genes for start point '
                                   'of rotated replicons'))
    rotation.add_argument('--start_gene_id', type=float, default=90.0,
                          help=ext('The minimum required BLAST percent '
                                   'identity for a start gene search'))
    rotation.add_argument('--start_gene_cov', type=float, default=95.0,
                          help=ext('The minimum required BLAST percent '
                                   'coverage for a start gene search'))
    rotation.add_argument('--makeblastdb_path', default='makeblastdb',
                          help=ext('Path to the makeblastdb executable '
                                   '(accepted for compatibility; the '
                                   'built-in translated search is used)'))
    rotation.add_argument('--tblastn_path', default='tblastn',
                          help=ext('Path to the tblastn executable '
                                   '(accepted for compatibility; the '
                                   'built-in translated search is used)'))

    graph = parser.add_argument_group('Graph cleaning')
    graph.add_argument('--min_component_size', type=int, default=1000,
                       help=ext('Graph components smaller than this size '
                                'will be removed from the final graph'))
    graph.add_argument('--min_dead_end_size', type=int, default=1000,
                       help=ext('Graph dead ends smaller than this size '
                                'will be removed from the final graph'))

    align = parser.add_argument_group('Long read alignment')
    align.add_argument('--contamination', default=None,
                       help=ext('FASTA file of known contamination in the '
                                'long reads'))
    align.add_argument('--scores', default='3,-6,-5,-2',
                       help=ext('Comma-delimited string of alignment '
                                'scores: match, mismatch, gap open, gap '
                                'extend'))
    align.add_argument('--low_score', type=float, default=None,
                       help=ext('Score threshold - alignments below this '
                                'are considered poor (default: set '
                                'automatically)'))
    align.add_argument('--no_simple_bridges', action='store_true',
                       help=ext('Skip simple long-read bridging'))
    align.add_argument('--no_long_read_alignment', action='store_true',
                       help=ext('Skip the full long-read alignment '
                                'bridging step'))

    parsed = parser.parse_args(args)
    # 'lambda' keyword -> bundled lambda-phage screen, like the
    # reference's shortcut (ref unicycler_align.py:69-86)
    if getattr(parsed, 'contamination', None) == 'lambda':
        lam = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'gene_data', 'lambda_phage.fasta')
        if not os.path.exists(lam):
            quit_with_error(
                'the bundled lambda-phage genome is missing at ' + lam
                + ' (reinstall, or pass a FASTA path directly; '
                'see gene_data/README.md)')
        parsed.contamination = lam
    for attr in ('short1', 'short2', 'unpaired', 'long', 'out',
                 'contamination', 'start_genes', 'short_read_graph',
                 'existing_long_read_assembly'):
        val = getattr(parsed, attr, None)
        if val is not None:
            setattr(parsed, attr, os.path.abspath(val))
    if parsed.reference_defaults:
        # one switch restores the reference's behaviour wherever this
        # build's defaults intentionally diverge (ref unicycler.py
        # bridges exactly once)
        parsed.bridge_rounds = 1
    parsed.mode = {'conservative': 0, 'normal': 1, 'bold': 2}[parsed.mode]
    if parsed.min_bridge_qual is None:
        parsed.min_bridge_qual = [settings.CONSERVATIVE_MIN_BRIDGE_QUAL,
                                  settings.NORMAL_MIN_BRIDGE_QUAL,
                                  settings.BOLD_MIN_BRIDGE_QUAL][parsed.mode]
    return parsed


def main(arg_list=None, device=None):
    """A short-read, hybrid or long-read-only run (ref
    unicycler.py:48-189); returns the final graph. Its alignments run on
    `device` (None = CUDA)."""
    random.seed(0)   # run-to-run determinism (ref unicycler.py:52)
    args = get_arguments(arg_list)
    device = resolve_device(device)
    # several processes: join the group the environment names (a no-op in
    # one process); non-main processes run silent and write no log
    from ..parallel.distributed import maybe_initialize
    dist_ctx = maybe_initialize()
    os.makedirs(args.out, exist_ok=True)
    if dist_ctx.active and not dist_ctx.is_main:
        args.verbosity = 0
    log.logger = log.Log(os.path.join(args.out, 'unicycler_tpu_torch.log')
                         if (not dist_ctx.active or dist_ctx.is_main)
                         else None,
                         stdout_verbosity_level=args.verbosity)

    short_reads_available = bool(args.short1) or bool(args.unpaired)
    long_reads_available = bool(args.long)
    if not short_reads_available and not long_reads_available \
            and not args.short_read_graph:
        quit_with_error('no input reads provided')

    counter = itertools.count(start=1)
    bridges = []

    if short_reads_available or args.short_read_graph:
        with trace.span('short_read_graph'):
            graph = obtain_short_read_graph(args, counter)
        with trace.span('copy_depth'):
            determine_copy_depth(graph)
        if args.keep > 0:
            graph.save_to_gfa(gfa_path(args.out, next(counter),
                                       'depth_filter'),
                              save_copy_depth_info=True, newline=True,
                              include_insert_size=True)
        with trace.span('clean'):
            clean_up_spades_graph(graph)
        if args.keep > 0:
            graph.save_to_gfa(gfa_path(args.out, next(counter),
                                       'overlaps_removed'),
                              save_copy_depth_info=True, newline=True,
                              include_insert_size=True)
        anchor_segments = get_anchor_segments(graph, args.min_anchor_seg_len)
        if args.mode != 0:
            bridges += _bridges('spades_contig', create_spades_contig_bridges,
                                graph, anchor_segments)
            bridges += _bridges('loop_unrolling',
                                create_loop_unrolling_bridges, graph,
                                anchor_segments)
        graph.paths = {}
    else:
        graph = None
        anchor_segments = []

    scoring_scheme = AlignmentScoringScheme(args.scores)

    if long_reads_available:
        read_dict, read_names, long_read_filename = \
            load_long_reads(args.long, output_dir=args.out)
        read_nicknames = get_read_nickname_dict(read_names)
    else:
        read_dict, read_names, long_read_filename, read_nicknames = \
            {}, [], '', {}

    string_graph = None
    if long_reads_available and not args.no_miniasm:
        try:
            with trace.span('long_read_assembly'):
                string_graph = make_miniasm_string_graph(
                    graph, read_dict, long_read_filename, scoring_scheme,
                    read_nicknames, counter, args, anchor_segments,
                    args.existing_long_read_assembly, device=device)
        except MiniasmFailure as e:
            log.log('long-read assembly failed: %s' % e)
            string_graph = None

    if graph is None and string_graph is None:
        quit_with_error('assembly failed: no graph produced')

    rounds = max(1, args.bridge_rounds) if graph is not None else 0
    for bridge_round in range(rounds):
        if bridge_round > 0:
            # Later rounds re-anchor on the MERGED graph: junctions the
            # first round's short anchors could not reach are now
            # flanked by long merged anchors, so the same reads yield
            # new spanning pairs (--bridge_rounds 1 restores the
            # reference's single round).
            if not long_reads_available or args.no_long_read_alignment:
                break
            with trace.span('copy_depth'):
                determine_copy_depth(graph)
            anchor_segments = get_anchor_segments(graph,
                                                  args.min_anchor_seg_len)
            bridges = []
            for read_name in read_names:   # round-1 alignments are stale
                read_dict[read_name].alignments = []
        if long_reads_available:
            if bridge_round == 0 and string_graph is not None \
                    and not args.no_miniasm:
                bridges += _bridges(
                    'miniasm', create_miniasm_bridges, graph, string_graph,
                    anchor_segments, scoring_scheme, args.verbosity,
                    args.min_bridge_qual, device=device)
            if not args.no_simple_bridges:
                # Rounds >= 2 re-run the simple bridges too: the merged
                # graph's remaining junctions are mostly 2-in/2-out
                # choices between long merged flanks.
                bridges += _bridges(
                    'simple_long_read', create_simple_long_read_bridges,
                    graph, args.out, args.keep, args.threads, read_dict,
                    long_read_filename, scoring_scheme, anchor_segments,
                    device=device)
            if not args.no_long_read_alignment:
                with trace.span('long_read_alignment'):
                    read_names, min_scaled_score, min_alignment_length = \
                        align_long_reads_to_assembly_graph(
                            graph, anchor_segments, args, read_dict,
                            read_names, long_read_filename, device=device)
                expected_linear_seqs = args.linear_seqs > 0
                bridges += _bridges(
                    'long_read', create_long_read_bridges, graph, read_dict,
                    read_names, anchor_segments, args.verbosity,
                    min_scaled_score, args.threads, scoring_scheme,
                    min_alignment_length, expected_linear_seqs,
                    args.min_bridge_qual, device=device)
        if bridge_round > 0 and not bridges:
            break
        with trace.span('apply_bridges'):
            seg_nums_used_in_bridges = graph.apply_bridges(
                bridges, args.verbosity, args.min_bridge_qual)
        if args.keep > 0:
            graph.save_to_gfa(gfa_path(args.out, next(counter),
                                       'bridges_applied'),
                              save_seg_type_info=True,
                              save_copy_depth_info=True, newline=True)
        with trace.span('merge'):
            graph.clean_up_after_bridging_1(anchor_segments,
                                            seg_nums_used_in_bridges)
            graph.clean_up_after_bridging_2(
                seg_nums_used_in_bridges, args.min_component_size,
                args.min_dead_end_size, graph, anchor_segments)
            graph.merge_all_possible(anchor_segments, args.mode)
        if bridge_round > 0 and not seg_nums_used_in_bridges:
            break

    if graph is not None:
        with trace.span('final_clean'):
            graph.final_clean()
        if args.keep > 0:
            graph.save_to_gfa(gfa_path(args.out, next(counter),
                                       'final_clean'))
        log.log('')
        graph.print_component_table()
        # Bridge sequences built from long-read consensus carry error
        # patches; a short-read polish pass removes them (the Pilon
        # role of older reference releases).
        if bridges and (args.short1 or args.short2):
            with trace.span('final_polish'):
                final_short_read_polish(
                    graph, [args.short1, args.short2], scoring_scheme,
                    device=device)
    else:
        graph = string_graph

    if not args.no_rotate:
        with trace.span('rotation'):
            rotate_completed_replicons(graph, args, counter)

    log.log_section_header('Assembly complete')
    final_fasta = os.path.join(args.out, 'assembly.fasta')
    final_gfa = os.path.join(args.out, 'assembly.gfa')
    graph.save_to_gfa(final_gfa)
    graph.save_to_fasta(final_fasta, min_length=args.min_fasta_length)
    return graph


def _bridges(kind, create, *args, **kwargs):
    """One kind of bridge, made under its trace span and counted."""
    with trace.span(kind + '_bridges'):
        out = create(*args, **kwargs)
    trace.add('bridges.' + kind, len(out))
    return out


def obtain_short_read_graph(args, counter):
    """Short-read assembly graph: user-supplied GFA or FASTG, a previous
    run's checkpoint (the reference's resume point, unicycler.py:71-74),
    or the built-in de Bruijn assembler."""
    # Counter slot 001 is the raw assembler graph (written by
    # build_best_short_read_graph); consuming it here keeps the
    # depth_filter checkpoint at 002 on EVERY path, so the resume file
    # a previous run wrote is the file this run looks for (the round-3
    # fix: main numbered depth_filter 001 while resume looked for 002,
    # so the documented resume never fired).
    next(counter)
    if args.short_read_graph:
        log.log('Using provided short-read graph: ' + args.short_read_graph)
        return AssemblyGraph(args.short_read_graph, None)
    resume_gfa = gfa_path(args.out, 2, 'depth_filter')
    if os.path.isfile(resume_gfa):
        log.log('Resuming from existing graph: ' + resume_gfa)
        return AssemblyGraph(resume_gfa, None)
    return build_best_short_read_graph(args)


def clean_up_spades_graph(graph):
    """Overlap removal + junction/zero-length/segment cleanup
    (ref unicycler.py:883-900)."""
    log.log_section_header('Cleaning graph')
    graph.remove_all_overlaps()
    while True:
        graph.repair_multi_way_junctions()
        graph.remove_unnecessary_links()
        graph.expand_repeats()
        if not graph.remove_zero_length_segs():
            break
    while True:
        if not graph.merge_small_segments(5):
            break
    graph.normalise_read_depths()
    graph.renumber_segments()
    graph.sort_link_order()


def get_anchor_segments(graph, min_anchor_seg_len):
    """Anchor-contig selection (ref unicycler.py:495-570)."""
    graph_n50 = graph.get_n_segment_length(50.0)
    graph_n80 = graph.get_n_segment_length(80.0)
    graph_n99 = graph.get_n_segment_length(99.0)

    anchor_seg_nums = set(
        x.number for x in graph.get_single_copy_segments()
        if x.get_length() >= graph_n99
        and x.get_length() >= settings.MIN_SINGLE_COPY_LENGTH)
    for component in graph.get_connected_components():
        if graph.is_component_complete(component):
            anchor_seg_nums.add(component[0])
    anchor_seg_nums |= set(x.number
                           for x in graph.get_no_copy_depth_segments()
                           if x.get_length() >= graph_n80)
    anchor_seg_nums |= set(
        x.number for x in graph.segments.values()
        if x.get_length() >= min(graph_n50, settings.ANCHOR_N50_CAP))

    # Rescue dead-end-free components with no anchors (ref :529-553).
    for component in graph.get_connected_components():
        dead_ends = sum(graph.dead_end_count(seg) for seg in component)
        anchors = sum(1 for seg in component if seg in anchor_seg_nums)
        if dead_ends > 0 or anchors > 0:
            continue
        new_anchor_segs = [seg for seg in component
                           if graph.is_seg_num_single_copy(seg)]
        if not new_anchor_segs:
            for seg in sorted(component,
                              key=lambda x: graph.segments[x].get_length(),
                              reverse=True):
                if len(graph.forward_links.get(seg, [])) == 1 or \
                        len(graph.reverse_links.get(seg, [])) == 1:
                    new_anchor_segs = [seg]
                    break
        anchor_seg_nums |= set(new_anchor_segs)

    if min_anchor_seg_len is None:
        min_anchor_seg_len = 0
    anchor_segments = sorted(
        [graph.segments[x] for x in anchor_seg_nums
         if graph.segments[x].get_length() >= min_anchor_seg_len],
        reverse=True, key=lambda x: x.get_length())
    log.log(int_to_str(len(anchor_segments)) + ' anchor segments out of '
            + int_to_str(len(graph.segments)) + ' total segments')
    return anchor_segments


def sam_references_match(sam_filename, assembly_graph):
    """(ref unicycler.py:573-597)"""
    ref_numbers = set()
    with open(sam_filename, 'rt') as sam_file:
        for line in sam_file:
            if not line.startswith('@'):
                break
            if not line.startswith('@SQ'):
                continue
            parts = line.strip().split()
            if len(parts) < 2:
                continue
            name_parts = parts[1].split(':')
            if len(name_parts) < 2:
                continue
            try:
                ref_numbers.add(int(name_parts[1]))
            except ValueError:
                pass
    # EXACT match, like the reference (unicycler.py:573-597): a subset
    # test accepted a stale SAM aligned against a DIFFERENT (merged)
    # graph whose numbers happened to be a subset of this one's.
    return ref_numbers == set(assembly_graph.segments.keys())


def align_long_reads_to_assembly_graph(graph, anchor_segments, args,
                                       read_dict, read_names,
                                       long_read_filename, device=None):
    """Semi-global alignment stage with SAM reuse + min-score percentile
    (ref unicycler.py:808-881), aligning on `device` (None = CUDA)."""
    device = resolve_device(device)
    alignment_dir = os.path.join(args.out, 'read_alignment')
    os.makedirs(alignment_dir, exist_ok=True)
    alignments_sam = os.path.join(alignment_dir, 'long_read_alignments.sam')
    scoring_scheme = AlignmentScoringScheme(args.scores)
    min_alignment_length = settings.MIN_LONG_READ_ALIGNMENT_LENGTH
    anchor_segment_names = set(str(x.number) for x in anchor_segments)

    references = [Reference(str(num), seg.forward_sequence)
                  for num, seg in sorted(graph.segments.items())]
    reference_dict = {x.name: x for x in references}

    if os.path.isfile(alignments_sam) and \
            sam_references_match(alignments_sam, graph):
        log.log('\nSAM file already exists; reusing alignments: '
                + alignments_sam)
        alignments = load_sam_alignments(alignments_sam, read_dict,
                                         reference_dict, scoring_scheme)
        for alignment in alignments:
            read_dict[alignment.read.name].alignments.append(alignment)
    else:
        allowed_overlap = int(round(graph.overlap
                                    * settings.ALLOWED_ALIGNMENT_OVERLAP))
        semi_global_align_long_reads(
            references, None, read_dict, read_names, long_read_filename,
            args.threads, scoring_scheme, [args.low_score], False,
            min_alignment_length, alignments_sam, None, allowed_overlap,
            0, args.contamination, args.verbosity,
            single_copy_segment_names=anchor_segment_names, device=device)
        if args.keep < 2:
            shutil.rmtree(alignment_dir, ignore_errors=True)

    if args.contamination:
        filtered_names, filtered_dict = [], {}
        for read_name in read_names:
            if not read_dict[read_name].mostly_aligns_to_contamination():
                filtered_names.append(read_name)
                filtered_dict[read_name] = read_dict[read_name]
        read_names = filtered_names
        read_dict.clear()
        read_dict.update(filtered_dict)

    contained = [x for x in read_dict.values()
                 if x.has_one_contained_alignment()]
    contained_scores = []
    for read in contained:
        contained_scores += [x.scaled_score for x in read.alignments]
    min_scaled_score = get_percentile(contained_scores,
                                      settings.MIN_SCALED_SCORE_PERCENTILE)
    return read_names, min_scaled_score, min_alignment_length
