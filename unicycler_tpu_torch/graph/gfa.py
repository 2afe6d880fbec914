"""GFA parsing helpers and signed-number utilities.

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

