"""General helpers: sequences, numbers, ranges, files, ANSI formatting,
tables (counterpart of unicycler_tpu/misc.py, with the same behaviour)."""


import gzip
import math
import os
import random
import re
import textwrap

import numpy as np

from . import settings
from .log import BOLD, DIM, END_FORMATTING, GREEN, RED, UNDERLINE, YELLOW


_COMP_TABLE = bytes.maketrans(
    b'ACGTacgtRYSWKMryswkmBVDHbvdhNn.-?',
    b'TGCAtgcaYRSWMKyrswmkVBHDvbhdNn.-?')


def reverse_complement(seq: str) -> str:
    """IUPAC-aware reverse complement (semantics of ref misc.py:151-166)."""
    return seq.translate(_COMP_TABLE)[::-1]


def complement_base(base: str) -> str:
    return base.translate(_COMP_TABLE)


def get_random_base() -> str:
    return 'ACGT'[random.randint(0, 3)]


def get_random_sequence(length: int) -> str:
    return ''.join(get_random_base() for _ in range(length))


def np_revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement an int8 base-code array (A0 C1 G2 T3 N4)."""
    comp = np.array([3, 2, 1, 0, 4], dtype=codes.dtype)
    return comp[codes[::-1]]


def add_line_breaks_to_sequence(sequence: str, line_length: int = 0) -> str:
    """Wrap a sequence for FASTA output; always ends with a newline."""
    if not sequence:
        return '\n'
    if line_length <= 0:
        line_length = settings.BASES_PER_FASTA_LINE
    return '\n'.join(sequence[i:i + line_length]
                     for i in range(0, len(sequence), line_length)) + '\n'


def is_header_spades_format(contig_name: str) -> bool:
    """True for SPAdes/Velvet-style headers like NODE_5_length_150905_cov_4.42."""
    p = contig_name.split('_')
    return (len(p) > 5 and p[0] in ('NODE', 'EDGE')
            and p[2] == 'length' and p[4] == 'cov')


def get_nice_header(header: str) -> str:
    """Shorten a SPAdes-style header to NODE_<num>, else the first
    whitespace token (ref misc.py get_nice_header)."""
    if is_header_spades_format(header):
        return '_'.join(header.split('_')[:2])
    return header.split()[0]


def get_percentile(values, percentile: float):
    """Nearest-rank percentile (ref misc.py:182-201)."""
    return get_percentile_sorted(sorted(values), percentile)


def get_percentile_sorted(sorted_values, percentile: float):
    if not sorted_values:
        return 0.0
    rank = int(math.ceil((percentile / 100.0) * len(sorted_values)))
    if rank == 0:
        return sorted_values[0]
    return sorted_values[rank - 1]


def weighted_average(a, b, weight_a, weight_b):
    total = weight_a + weight_b
    if total == 0:
        return (a + b) / 2.0
    return a * (weight_a / total) + b * (weight_b / total)


def weighted_average_list(values, weights):
    total = sum(weights)
    if total == 0.0:
        weights = [1.0] * len(values)
        total = float(len(values))
    return sum(v * (w / total) for v, w in zip(values, weights))


def score_function(val: float, half_score_val: float) -> float:
    """0 → 0.0, half_score_val → 0.5, ∞ → 1.0 (ref misc.py:370-377)."""
    return 1.0 - (half_score_val / (half_score_val + val))


def get_num_agreement(num_1, num_2) -> float:
    """How well two numbers agree: 1.0 perfect, 0.0 worst (ref misc.py:284)."""
    if num_1 == 0.0 and num_2 == 0.0:
        return 1.0
    if num_1 < 0.0 and num_2 < 0.0:
        num_1, num_2 = -num_1, -num_2
    if num_1 * num_2 < 0.0:
        return 0.0
    return min(num_1, num_2) / max(num_1, num_2)


def round_to_nearest_odd(num: float) -> int:
    return 2 * round((num - 1) / 2) + 1


def float_to_str(num, decimals, max_num=0):
    """Format a float with thousands separators (ref misc.py float_to_str)."""
    if num is None:
        num_str = 'n/a'
    else:
        num_str = '%.' + str(decimals) + 'f'
        num_str = num_str % num
        parts = num_str.split('.')
        num_str = int_to_str(int(parts[0]))
        if len(parts) > 1:
            num_str += '.' + parts[1]
    if max_num > 0:
        max_str = float_to_str(max_num, decimals)
        num_str = num_str.rjust(len(max_str))
    return num_str


def int_to_str(num, max_num=0):
    num_str = 'n/a' if num is None else '{:,}'.format(num)
    max_str = '{:,}'.format(int(max_num))
    return num_str.rjust(len(max_str))


def flip_number_order(num_1: int, num_2: int):
    """Possibly flip a signed segment pair into canonical orientation.

    The rule is arbitrary but must be consistent so bridging sequences are
    always collected in the same direction (ref misc.py:299-317).
    """
    if num_1 > 0 and num_2 > 0:
        flip = False
    elif num_1 < 0 and num_2 < 0:
        flip = True
    elif num_1 < 0:
        flip = abs(num_1) > abs(num_2)
    else:
        flip = abs(num_2) > abs(num_1)
    if flip:
        return (-num_2, -num_1), True
    return (num_1, num_2), False


def simplify_ranges(ranges):
    """Merge overlapping/adjacent ranges into a minimal sorted set."""
    fixed = [(min(a, b), max(a, b)) for a, b in ranges]
    fixed.sort()
    merged = []
    for a, b in fixed:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def range_is_contained(test_range, other_ranges):
    """True if test_range is entirely covered by one of other_ranges."""
    start, end = test_range
    for a, b in other_ranges:
        if a <= start and end <= b:
            return True
    return False


def range_overlap(range_1, range_2):
    """Size of the overlap between two ranges (can be negative for a gap)."""
    return min(range_1[1], range_2[1]) - max(range_1[0], range_2[0])


def range_overlap_size(test_range, other_ranges):
    """Total bases of test_range covered by the (disjoint) other_ranges."""
    return sum(max(0, range_overlap(test_range, other))
               for other in simplify_ranges(other_ranges))


def ranges_overlap(ranges_1, ranges_2):
    return any(range_overlap(r1, r2) > 0 for r1 in ranges_1 for r2 in ranges_2)


def total_range_length(ranges):
    return sum(b - a for a, b in simplify_ranges(ranges))


def get_compression_type(filename):
    magic = {'gz': b'\x1f\x8b', 'bz2': b'\x42\x5a\x68', 'zip': b'\x50\x4b\x03\x04'}
    with open(filename, 'rb') as f:
        start = f.read(4)
    for ftype, sig in magic.items():
        if start.startswith(sig):
            if ftype != 'gz':
                raise ValueError('cannot use ' + ftype + ' compression: ' + filename)
            return ftype
    return 'plain'


def get_open_function(filename):
    return gzip.open if get_compression_type(filename) == 'gz' else open


def get_sequence_file_type(filename):
    """'FASTA' or 'FASTQ' by first character."""
    with get_open_function(filename)(filename, 'rt') as f:
        first = f.read(1)
    if first == '>':
        return 'FASTA'
    if first == '@':
        return 'FASTQ'
    raise ValueError('could not determine file type of ' + filename)


def strip_read_extensions(read_file_name):
    base = os.path.basename(read_file_name)
    parts = base.split('.')
    endings = {'gz', 'fasta', 'fna', 'fa', 'fas', 'fsa', 'fastq', 'fq'}
    while parts and parts[-1].lower() in endings:
        parts = parts[:-1]
    return '.'.join(parts)


def gfa_path(out_dir, file_num, name):
    """Numbered checkpoint GFA path (ref misc.py:986)."""
    return os.path.join(out_dir, str(file_num).zfill(3) + '_' + name + '.gfa')


def quit_with_error(message):
    """Fatal-error exit path (ref misc.py:106)."""
    raise SystemExit('Error: ' + message)


# ---------------------------------------------------------------------------
# ANSI formatting (parity with ref misc.py:650-738)
# ---------------------------------------------------------------------------

MAGENTA = '\033[35m'


def colour(text, text_colour):
    bold_text = 'bold' in text_colour
    text_colour = text_colour.replace('bold', '')
    underline_text = 'underline' in text_colour
    text_colour = text_colour.replace('underline', '')
    text_colour = text_colour.replace('_', '').replace(' ', '').lower()
    if 'red' in text_colour:
        out = RED
    elif 'green' in text_colour:
        out = GREEN
    elif 'yellow' in text_colour:
        out = YELLOW
    elif 'dim' in text_colour:
        out = DIM
    else:
        out = ''
    if bold_text:
        out += BOLD
    if underline_text:
        out += UNDERLINE
    if not out:
        return text
    return out + text + END_FORMATTING


def green(text):
    return GREEN + text + END_FORMATTING


def bold_green(text):
    return GREEN + BOLD + text + END_FORMATTING


def red(text):
    return RED + text + END_FORMATTING


def magenta(text):
    return MAGENTA + text + END_FORMATTING


def bold_red(text):
    return RED + BOLD + text + END_FORMATTING


def bold(text):
    return BOLD + text + END_FORMATTING


def bold_underline(text):
    return BOLD + UNDERLINE + text + END_FORMATTING


def underline(text):
    return UNDERLINE + text + END_FORMATTING


def dim(text):
    return DIM + text + END_FORMATTING


def dim_underline(text):
    return DIM + UNDERLINE + text + END_FORMATTING


def bold_yellow(text):
    return YELLOW + BOLD + text + END_FORMATTING


def bold_yellow_underline(text):
    return YELLOW + BOLD + UNDERLINE + text + END_FORMATTING


def bold_red_underline(text):
    return RED + BOLD + UNDERLINE + text + END_FORMATTING


def remove_formatting(text):
    return re.sub('\033.*?m', '', text)


def len_without_format(text):
    try:
        return len(remove_formatting(text))
    except TypeError:
        return len(str(text))


# SPAdes interop parsers (semantics of ref misc.py:824-855).

def spades_version_from_spades_output(spades_output):
    for pattern in (r'v(\d+\.\d+\.\d+)', r'v\.(\d+\.\d+\.\d+)'):
        m = re.search(pattern, spades_output)
        if m:
            return m.group(1)
    m = re.search(r'\d+\.\d+\.\d+', spades_output)
    return m.group() if m else ''


def spades_status_from_version(version):
    major_version = int(version.split('.')[0])
    if major_version < 3:
        return 'too old'
    if major_version >= 5:
        return 'too new'
    if major_version == 3 and int(version.split('.')[1]) < 14:
        return 'too old'
    return 'good'


def print_table(table, alignments='', max_col_width=30, col_separation=2,
                indent=2, header=True, out=print, wrap_cells=False):
    """Fixed-width text table. `alignments` is a string of L/R per column.
    Over-width cells are shortened with '...' by default; with
    wrap_cells=True they wrap onto continuation lines instead (the
    reference's table behavior, ref misc.py:551-648 — the bridge
    application table relies on it so full graph paths stay
    reconstructable from logs)."""
    if not table:
        return
    num_cols = max(len(row) for row in table)
    col_widths = [0] * num_cols
    for row in table:
        for i, cell in enumerate(row):
            col_widths[i] = min(max_col_width, max(col_widths[i], len(str(cell))))
    aligns = (alignments + 'L' * num_cols)[:num_cols]
    lines = []
    for r, row in enumerate(table):
        cell_lines = []
        for i in range(num_cols):
            cell = str(row[i]) if i < len(row) else ''
            if len(cell) > max_col_width:
                if wrap_cells:
                    cell_lines.append(textwrap.wrap(cell, max_col_width)
                                      or [''])
                else:
                    cell_lines.append([textwrap.shorten(
                        cell, width=max_col_width, placeholder='...')])
            else:
                cell_lines.append([cell])
        for sub in range(max(len(c) for c in cell_lines)):
            cells = []
            for i in range(num_cols):
                cell = cell_lines[i][sub] if sub < len(cell_lines[i]) else ''
                cells.append(cell.rjust(col_widths[i]) if aligns[i] == 'R'
                             else cell.ljust(col_widths[i]))
            lines.append(' ' * indent
                         + (' ' * col_separation).join(cells).rstrip())
        if r == 0 and header:
            lines.append(' ' * indent + '-' * (sum(col_widths)
                                               + col_separation * (num_cols - 1)))
    for line in lines:
        out(line)
