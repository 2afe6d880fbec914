"""GFA/FASTG parsing helpers and signed-number / path list utilities.

Behavioral parity with the module-level helpers of reference
unicycler/assembly_graph.py:2374-2688 (a copy of unicycler_tpu/graph/gfa.py).
"""


def signed_string_to_int(signed_str):
    """'5+' -> 5, '6-' -> -6."""
    num = int(signed_str[:-1])
    return num if signed_str[-1] == '+' else -num


def int_to_signed_string(num):
    """5 -> '5+', -6 -> '6-'."""
    return str(abs(num)) + get_sign_string(num)


def get_sign_string(num):
    return '+' if num >= 0 else '-'


def is_link_positive(start, end):
    """Arbitrary-but-consistent choice of one link per RC pair
    (ref assembly_graph.py:2515-2530)."""
    if start > 0 and end > 0:
        return True
    if start < 0 and end < 0:
        return False
    if start == -end:
        return True
    return abs(start) > abs(end)


def build_rc_links_if_necessary(links):
    """Ensure every link has its reverse complement
    (ref assembly_graph.py:2466-2480)."""
    new_links = {k: list(v) for k, v in links.items()}
    for start, ends in links.items():
        for end in ends:
            new_links.setdefault(-end, [])
            if -start not in new_links[-end]:
                new_links[-end].append(-start)
    return new_links


def build_reverse_links(links):
    """end -> [starts] from a start -> [ends] dict
    (ref assembly_graph.py:2483-2494)."""
    reverse_links = {}
    for start, ends in links.items():
        for end in ends:
            reverse_links.setdefault(end, []).append(start)
    return reverse_links


def get_overlap_from_gfa_link(filename):
    """Overlap size from the first L line's CIGAR
    (ref assembly_graph.py:2676-2688)."""
    with open(filename, 'rt') as gfa_file:
        for line in gfa_file:
            if line.startswith('L'):
                parts = line.strip().split('\t')
                if len(parts) > 5:
                    return int(parts[5][:-1])
    return 0


# --- FASTG header helpers (ref assembly_graph.py:2403-2463) ---------------

def get_unsigned_number_from_header(header):
    return int(header.split('_')[1])


def is_header_positive(header):
    if header.endswith(';'):
        header = header[:-1]
    return not header.split(':')[0].endswith("'")


def get_signed_number_from_header(header):
    number = get_unsigned_number_from_header(header)
    return number if is_header_positive(header) else -number


def get_depth_from_header(header):
    head = header.split(':')[0]
    if head.endswith("'"):
        head = head[:-1]
    depth_str = head.split('_')[5]
    for suffix in (';', "'"):
        if depth_str.endswith(suffix):
            depth_str = depth_str[:-1]
    return float(depth_str)


def get_links_from_header(header):
    if header.endswith(';'):
        header = header[:-1]
    start = get_signed_number_from_header(header)
    pieces = header.split(':')
    ends = []
    if len(pieces) > 1:
        ends = [get_signed_number_from_header(e) for e in pieces[1].split(',')]
    return start, ends


# --- path list utilities (ref assembly_graph.py:2565-2658) ----------------

def insert_num_in_list(lst, val_1, val_2, insert_val):
    """Insert insert_val between each adjacent (val_1, val_2) pair."""
    if len(lst) < 2:
        return lst
    out = []
    for i, val in enumerate(lst[:-1]):
        out.append(val)
        if val == val_1 and lst[i + 1] == val_2:
            out.append(insert_val)
    out.append(lst[-1])
    return out


def find_replace_in_list(lst, pattern, replacement):
    """Replace every occurrence of the sub-list pattern."""
    changed = True
    while changed:
        changed = False
        for i in range(len(lst)):
            if lst[i] == pattern[0] and lst[i:i + len(pattern)] == pattern:
                lst = lst[:i] + replacement + lst[i + len(pattern):]
                changed = True
                break
    return lst


def find_replace_one_val_in_list(lst, val, replacement):
    if val not in lst:
        return lst
    return [replacement if x == val else x for x in lst]


def split_path(path, seg):
    """Split the path at every occurrence of seg (excluded); pieces of
    length < 2 are dropped."""
    pieces = []
    while seg in path:
        i = path.index(seg)
        pieces.append(path[:i])
        path = path[i + 1:]
    pieces.append(path)
    return [p for p in pieces if len(p) > 1]


def split_path_multiple(path, segs):
    parts = [path]
    for seg in segs:
        parts = [piece for part in parts for piece in split_path(part, seg)]
    return parts


def value_from_fractional_index(lst, index):
    """Linear interpolation into a list at a fractional index."""
    if not lst:
        return 0
    if len(lst) == 1:
        return lst[0]
    whole = int(index)
    if whole < 0:
        return lst[0]
    if whole >= len(lst) - 1:
        return lst[-1]
    frac = index - float(whole)
    return lst[whole] * (1.0 - frac) + lst[whole + 1] * frac


def all_segments_are_one_base(segments):
    """True if every non-empty segment is the same single-base homopolymer."""
    non_empty = [s for s in segments if s.get_length() > 0]
    if not non_empty:
        return False
    base = non_empty[0].forward_sequence[0].lower()
    for seg in non_empty:
        if not seg.is_homopolymer():
            return False
        if (seg.forward_sequence[0].lower() != base
                and seg.reverse_sequence[0].lower() != base):
            return False
    return True


def add_to_bridged_sets(start, end, right_bridged, left_bridged):
    """Track which segment sides have been bridged
    (ref assembly_graph.py:2661-2673)."""
    if start > 0:
        right_bridged.add(start)
    else:
        left_bridged.add(-start)
    if end > 0:
        left_bridged.add(end)
    else:
        right_bridged.add(-end)


def remove_dupes_preserve_order(lst):
    seen = set()
    out = []
    for x in lst:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out
