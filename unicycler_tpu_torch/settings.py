"""Tuning constants of the alignment and bridging paths (copied from
unicycler_tpu/settings.py; the port keeps only the constants its modules
read, numerically identical, since they shape the pipeline's decisions).
"""

# Alignment driver (ref settings.py:18-67, unicycler_align.py)
ALLOWED_MINIMAP_OVERLAP = 5
ALLOWED_ALIGNMENT_OVERLAP = 1.1
MIN_SCALED_SCORE_PERCENTILE = 5.0
MAX_TO_MIN_MINIMISER_RATIO = 10
MIN_LONG_READ_ALIGNMENT_LENGTH = 50
AUTO_SCORE_STDEV_ABOVE_RANDOM_ALIGNMENT_MEAN = 7

# Sensitivity-level tables (shaped after ref include/settings.h:12-42).
SEED_KMER_SIZES = (15, 14, 13, 12)        # minimiser k per sensitivity level
# Banded-DP half-band per level. The reference uses 25/50/75/100
# (settings.h:22-25); the band rounds up to 128-lane multiples
# (ops/banded.band_width) anyway, so wider bands are nearly free and buy
# alignment quality. The first pass runs at the full (refine-grade) width
# directly: measured on the tough fixture, the old narrow-pass +
# refine-everything flow gained its score almost entirely from the refine
# pass's wider band, so one wide pass + margin-triggered refinement gives
# the same scores with one fewer dispatch/fetch round trip per call.
BAND_SIZES = (200, 250, 300, 350)
# Band for the corridor-refinement pass (re-center on the found path).
# Refinement now only runs for alignments whose traced path came within
# REFINE_MARGIN lanes of the band edge — paths well inside the corridor
# cannot improve from re-centering at the same width. (A narrower
# refine band was tried on the TPU — radius 100, W=256 — and lost:
# re-centered corridors at 100 lanes trigger band-escape retries on the
# long high-error reads, costing more than the narrower DP saves.)
REFINE_BAND = 200
REFINE_MARGIN = 64
FINE_ANCHOR_MAX_DIST = 300                # corridor collection distance
FINE_ANCHOR_MAX_OCC = 256                 # per-kmer occurrence cap
MAX_LINE_TRACE_COUNTS = (4, 8, 12, 16)    # candidate corridor cap

BASES_PER_FASTA_LINE = 70

# Full-matrix DP is used below this cell count; banded DP above it
# (ops/dispatch.batch_align).
MAX_FULL_DP_CELLS = 1 << 24

# Path finding (ref settings.py:74-90)
MIN_RELATIVE_PATH_LENGTH = 0.9
MAX_RELATIVE_PATH_LENGTH = 1.1
RELATIVE_PATH_LENGTH_BUFFER_SIZE = 100
ALL_PATH_SEARCH_MAX_WORKING_PATHS = 10000
ALL_PATH_SEARCH_MAX_FINAL_PATHS = 500
PROGRESSIVE_PATH_SEARCH_MAX_WORKING_PATHS = 100
PROGRESSIVE_PATH_SEARCH_SCORE_FRACTION = 0.995

# Copy depth (ref settings.py:103-107)
INITIAL_SINGLE_COPY_TOLERANCE = 0.1
COPY_PROPAGATION_TOLERANCE = 0.5
MIN_SINGLE_COPY_LENGTH = 1000

# Anchor selection: "every segment >= graph N50" (ref unicycler.py:517)
# self-limits on MERGED graphs — after a bridging round the N50 jumps, so
# the rule that admitted mid-size contigs in round 1 admits almost nothing
# in round 2+ and re-anchored bridging starves. Cap the N50-based length
# threshold at an absolute value: identical behaviour on typical
# fragmented graphs (N50 below the cap), more anchors on merged ones.
ANCHOR_N50_CAP = 10000
MAX_COPY_DEPTH_DISTRIBUTION_ARRANGEMENTS = 10000
COPY_DEPTH_PROPAGATION_TABLE_ROW_WIDTH = 35

# Long-read bridging (ref settings.py:113-176)
CLEANING_USEDUPNESS_THRESHOLD = 0.5
MAX_READS_FOR_CONSENSUS = 25
PATHLESS_BRIDGE_QUAL_TWO_DEAD_ENDS = 1.0
PATHLESS_BRIDGE_QUAL_ONE_DEAD_END = 0.7
PATHLESS_BRIDGE_QUAL_NO_DEAD_ENDS = 0.2
PATHLESS_BRIDGE_QUAL_TWO_DEAD_ENDS_WITH_LINEAR_SEQS = 0.6
PATHLESS_BRIDGE_QUAL_ONE_DEAD_END_WITH_LINEAR_SEQS = 0.4
PATHLESS_BRIDGE_QUAL_NO_DEAD_ENDS_WITH_LINEAR_SEQS = 0.2
SIMPLE_REPEAT_BRIDGING_BAND_SIZE = 50
MAX_SIMPLE_LOOP_SIZE = 10000
LONG_READ_BRIDGE_HALF_QUAL_LENGTH = 2000
MINIASM_BRIDGE_QUAL_WITH_GRAPH_PATH = 1.0
MINIASM_BRIDGE_QUAL_WITH_DEAD_END = 1.0
MINIASM_BRIDGE_QUAL_WITHOUT_PATH_OR_DEAD_END = 0.7
MINIASM_BRIDGE_SCALED_SCORE_TO_USE_GRAPH_PATH = 95.0
MINIASM_BRIDGE_HALF_QUAL_LENGTH = 5000

# Bridge quality floors by --mode (ref settings.py:113-176), read by the
# command line (pipeline/main.get_arguments)
CONSERVATIVE_MIN_BRIDGE_QUAL = 25.0
NORMAL_MIN_BRIDGE_QUAL = 10.0
BOLD_MIN_BRIDGE_QUAL = 1.0

# String-graph assembly + polish (ref settings.py:30-45, 169-174)
CONTIG_READ_QSCORE = 40
RACON_POLISH_LOOP_COUNT_HYBRID = 2
RACON_POLISH_LOOP_COUNT_LONG_ONLY = 4
CONTIG_SEARCH_END_SIZES = [5000, 2500, 1000, 500]
CONTIG_SEARCH_MIN_IDENTITY = 95.0
FOUND_CONTIG_MIN_RATIO = 0.9
FOUND_CONTIG_MAX_RATIO = 1.11111
FOUND_CONTIG_MAX_OVERLAP_SIZE = 250
REQUIRED_MINIASM_ASSEMBLY_SIZE_FOR_BRIDGING = 0.5
MAX_MINIASM_DEAD_END_TRIM_SIZE = 100
