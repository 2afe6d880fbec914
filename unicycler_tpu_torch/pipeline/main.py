"""The assembly pipeline's command line, long-read-only slice (counterpart
of unicycler_tpu/pipeline/main.py).

get_arguments is the JAX package's whole option surface, with the same
names and defaults, so the same argv gives the same Namespace. main runs
what the port has: a long-read-only run (`-l reads.fq -o out`) loads the
reads, assembles and polishes them (asm/hybrid.make_miniasm_string_graph
with no short-read graph, its alignments on `device`), rotates the
completed circular replicons to a start gene (pipeline/rotation, on the
host) and writes assembly.gfa and assembly.fasta. Short-read input,
--short_read_graph and bridging on a graph need the short-read slice of
the port and raise NotImplementedError.

The port runs in one process: the JAX package's multi-host join
(parallel/distributed.maybe_initialize) comes with the port's parallel
slice and is not called here.

    python -m unicycler_tpu_torch -l reads.fq -o out

main(arg_list=None, device=None) runs on CUDA unless the caller passes
device='cpu' (a Python keyword, not an option).
"""

import argparse
import itertools
import os
import random
import sys

from .. import log, settings
from ..align.scoring import AlignmentScoringScheme
from ..asm.hybrid import MiniasmFailure, make_miniasm_string_graph
from ..device import resolve_device
from ..io.fastx import get_read_nickname_dict, load_long_reads
from ..misc import quit_with_error
from ..utils import trace
from ..version import __version__
from .rotation import rotate_completed_replicons


def _short_read_slice(what):
    return NotImplementedError(
        '%s needs the short-read assembly graph, whose port comes with the '
        'short-read slice; only long-read-only runs (-l without -1/-2/-s) '
        'are ported' % what)


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
    """A long-read-only run (ref unicycler.py:48-189); returns the final
    graph. Its alignments run on `device` (None = CUDA)."""
    random.seed(0)   # run-to-run determinism (ref unicycler.py:52)
    args = get_arguments(arg_list)
    device = resolve_device(device)
    if args.short1 or args.short2 or args.unpaired:
        raise _short_read_slice('short-read input (-1/-2/-s)')
    if args.short_read_graph:
        raise _short_read_slice('--short_read_graph')
    os.makedirs(args.out, exist_ok=True)
    log.logger = log.Log(os.path.join(args.out, 'unicycler_tpu_torch.log'),
                         stdout_verbosity_level=args.verbosity)
    if not args.long:
        quit_with_error('no input reads provided')

    counter = itertools.count(start=1)
    scoring_scheme = AlignmentScoringScheme(args.scores)
    read_dict, read_names, long_read_filename = \
        load_long_reads(args.long, output_dir=args.out)
    read_nicknames = get_read_nickname_dict(read_names)

    graph = None
    if not args.no_miniasm:
        try:
            with trace.span('long_read_assembly'):
                graph = make_miniasm_string_graph(
                    None, read_dict, long_read_filename, scoring_scheme,
                    read_nicknames, counter, args, [],
                    args.existing_long_read_assembly, device=device)
        except MiniasmFailure as e:
            log.log('long-read assembly failed: %s' % e)
    if graph is None:
        quit_with_error('assembly failed: no graph produced')

    if not args.no_rotate:
        with trace.span('rotation'):
            rotate_completed_replicons(graph, args, counter)

    log.log_section_header('Assembly complete')
    final_fasta = os.path.join(args.out, 'assembly.fasta')
    final_gfa = os.path.join(args.out, 'assembly.gfa')
    graph.save_to_gfa(final_gfa)
    graph.save_to_fasta(final_fasta, min_length=args.min_fasta_length)
    return graph
