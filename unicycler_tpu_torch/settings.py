"""Tuning constants of the alignment and bridging paths (copied from
unicycler_tpu/settings.py; the port keeps only the constants its modules
read, numerically identical, since they shape the pipeline's decisions).
"""

# Alignment driver (ref settings.py:18-67, unicycler_align.py)
ALLOWED_MINIMAP_OVERLAP = 5
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

# Long-read bridging (ref settings.py:113-176)
MAX_READS_FOR_CONSENSUS = 25
PATHLESS_BRIDGE_QUAL_TWO_DEAD_ENDS = 1.0
PATHLESS_BRIDGE_QUAL_ONE_DEAD_END = 0.7
PATHLESS_BRIDGE_QUAL_NO_DEAD_ENDS = 0.2
PATHLESS_BRIDGE_QUAL_TWO_DEAD_ENDS_WITH_LINEAR_SEQS = 0.6
PATHLESS_BRIDGE_QUAL_ONE_DEAD_END_WITH_LINEAR_SEQS = 0.4
PATHLESS_BRIDGE_QUAL_NO_DEAD_ENDS_WITH_LINEAR_SEQS = 0.2
LONG_READ_BRIDGE_HALF_QUAL_LENGTH = 2000

# Bridge quality floors by --mode (ref settings.py:113-176), read by the
# command line (pipeline/main.get_arguments)
CONSERVATIVE_MIN_BRIDGE_QUAL = 25.0
NORMAL_MIN_BRIDGE_QUAL = 10.0
BOLD_MIN_BRIDGE_QUAL = 1.0

# String-graph assembly + polish (ref settings.py:30-45, 169-174)
CONTIG_READ_QSCORE = 40
RACON_POLISH_LOOP_COUNT_HYBRID = 2
RACON_POLISH_LOOP_COUNT_LONG_ONLY = 4
