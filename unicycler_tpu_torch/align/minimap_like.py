"""PAF-level read-vs-graph mapping from the minimiser index (a copy of
unicycler_tpu/align/minimap_like.py; host numpy, no device work).

Replaces the reference's vendored in-process minimap plus its PAF parsing
layer (ref unicycler/minimap_alignment.py:32-212, src/minimap_align.cpp).
The MMAlignment attribute surface matches MinimapAlignment so downstream
consumers (simple bridges, miniasm-style assembly, polishing) are drop-in.
Coordinates follow PAF conventions: read and ref coordinates are always on
the forward strands; strand '-' marks a reverse-orientation hit.
"""

from collections import defaultdict

from .. import log, settings
from ..io.fastx import load_long_reads
from ..misc import (range_is_contained, range_overlap, range_overlap_size,
                    simplify_ranges)
from ..ops import minimizer as mz


class MMAlignment(object):
    """One mapping hit (attribute parity with ref minimap_alignment.py:32)."""

    def __init__(self, read_name='', read_length=0, read_start=0, read_end=0,
                 read_strand='+', ref_name='', ref_length=0, ref_start=0,
                 ref_end=0, matching_bases=0, num_bases=0, minimiser_count=0):
        self.read_name = read_name
        self.read_length = read_length
        self.read_start = read_start
        self.read_end = read_end
        self.read_strand = read_strand
        self.ref_name = ref_name
        self.ref_length = ref_length
        self.ref_start = ref_start
        self.ref_end = ref_end
        self.matching_bases = matching_bases
        self.num_bases = num_bases
        self.minimiser_count = minimiser_count
        self.read_end_gap = read_length - read_end

    def get_concise_string(self):
        return ','.join(str(x) for x in
                        [self.read_start, self.read_end, self.read_strand,
                         self.ref_name, self.ref_start, self.ref_end])

    def __repr__(self):
        return (str(self.read_start) + '-' + str(self.read_end) + '('
                + self.read_strand + '):' + self.ref_name + ':'
                + str(self.ref_start) + '-' + str(self.ref_end) + '('
                + str(self.matching_bases) + '/' + str(self.num_bases) + ','
                + str(self.minimiser_count) + ')')

    def get_signed_ref_name(self):
        return ('-' if self.read_strand == '-' else '') + self.ref_name

    def overlaps_reference(self):
        adjusted_start = self.ref_start - self.read_start
        adjusted_end = self.ref_end + self.read_end_gap
        return adjusted_start < 0 or adjusted_end >= self.ref_length

    def fraction_ref_aligned(self):
        try:
            return (self.ref_end - self.ref_start) / self.ref_length
        except ZeroDivisionError:
            return 0.0


def map_read(index, read, ref_names, ref_lengths, k, clusters=None):
    """Map one read against the index, PAF-style hits. `clusters` skips
    the per-read lookup when the caller batched it (lookup_many)."""
    hits = []
    if clusters is None:
        clusters = index.lookup(read.codes)
    for cl in clusters:
        read_len = read.get_length()
        if cl.rev_comp:
            # cluster coords are on the revcomp read; flip to forward
            read_start = read_len - cl.read_end
            read_end = read_len - cl.read_start
            strand = '-'
        else:
            read_start, read_end = cl.read_start, cl.read_end
            strand = '+'
        span = max(read_end - read_start, cl.ref_end - cl.ref_start)
        hits.append(MMAlignment(
            read_name=read.name, read_length=read_len,
            read_start=read_start, read_end=read_end, read_strand=strand,
            ref_name=ref_names[cl.ref_id],
            ref_length=ref_lengths[cl.ref_id],
            ref_start=cl.ref_start, ref_end=cl.ref_end,
            matching_bases=cl.n_hits * k, num_bases=span,
            minimiser_count=cl.n_hits))
    return hits


def map_reads(references, reads, k=15, w=10, filter_by_minimisers=False,
              minimiser_ratio=settings.MAX_TO_MIN_MINIMISER_RATIO,
              filter_overlaps=False, allowed_overlap=0):
    """Map reads to references; returns {read_name: [MMAlignment]} sorted
    by read_start (semantics of ref load_minimap_alignments :104-133)."""
    ref_names = [r.name for r in references]
    ref_lengths = [r.get_length() for r in references]
    index = mz.MinimizerIndex([r.codes for r in references], k=k, w=w)
    alignments = defaultdict(list)
    # one lookup of the whole read set (a native pass, identical output
    # to per-read lookup)
    all_clusters = index.lookup_many([r.codes for r in reads])
    for read, clusters in zip(reads, all_clusters):
        hits = map_read(index, read, ref_names, ref_lengths, k,
                        clusters=clusters)
        if not hits:
            continue
        hits.sort(key=lambda x: x.minimiser_count, reverse=True)
        if filter_by_minimisers:
            min_count = hits[0].minimiser_count / minimiser_ratio
            hits = [x for x in hits if x.minimiser_count >= min_count]
        if filter_overlaps:
            kept = []
            for a in hits:
                if not _alignments_overlap(a, kept, allowed_overlap):
                    kept.append(a)
            hits = kept
        alignments[read.name] = sorted(hits, key=lambda x: x.read_start)
    return alignments


def _alignments_overlap(a, others, allowed_overlap):
    adjusted_start = a.read_start + allowed_overlap
    return any(range_overlap((adjusted_start, a.read_end),
                             (x.read_start, x.read_end)) > 0 for x in others)


def align_long_reads_to_assembly_graph(graph, long_read_filename,
                                       working_dir, threads):
    """All long reads vs all graph segments, filtered (parity with
    ref minimap_alignment.py:141-158; sensitivity-3 k per settings)."""
    log.log('Aligning long reads to graph', 1)
    read_dict, read_names, _ = load_long_reads(long_read_filename,
                                               silent=True)
    reads = [read_dict[n] for n in read_names]
    refs = _graph_as_references(graph)
    k = settings.SEED_KMER_SIZES[3]
    return map_reads(refs, reads, k=k, w=10, filter_overlaps=True,
                     allowed_overlap=settings.ALLOWED_MINIMAP_OVERLAP,
                     filter_by_minimisers=True)


def _graph_as_references(graph):
    from ..io.fastx import Reference
    return [Reference(str(num), seg.forward_sequence)
            for num, seg in sorted(graph.segments.items())]


def build_start_end_overlap_sets(minimap_alignments):
    """Signed segment -> set of read names overlapping that end
    (ref minimap_alignment.py:161-186)."""
    start_overlap_reads = defaultdict(set)
    end_overlap_reads = defaultdict(set)
    min_overlap_amount = 100
    for read_name, alignments in minimap_alignments.items():
        for a in alignments:
            seg_num = int(a.ref_name)
            if a.read_strand == '+':
                seg_start, seg_end = a.ref_start, a.ref_end
            else:
                seg_num *= -1
                seg_start = a.ref_length - a.ref_end
                seg_end = a.ref_length - a.ref_start
            adjusted_start = seg_start - a.read_start
            adjusted_end = seg_end + a.read_end_gap
            if adjusted_start < -min_overlap_amount:
                start_overlap_reads[seg_num].add(read_name)
            if adjusted_end > a.ref_length + min_overlap_amount:
                end_overlap_reads[seg_num].add(read_name)
    return start_overlap_reads, end_overlap_reads


def remove_conflicting_alignments(alignments, allowed_overlap):
    """Greedy per-read conflict filter (ref minimap_alignment.py:189-212)."""
    alignments = sorted(alignments, reverse=True,
                        key=lambda x: (x.matching_bases, x.minimiser_count,
                                       x.ref_name))
    kept = []
    kept_ranges = []
    for a in alignments:
        this_range = (a.read_start, a.read_end)
        if range_is_contained(this_range, kept_ranges):
            continue
        if range_overlap_size(this_range, kept_ranges) > allowed_overlap:
            continue
        kept.append(a)
        kept_ranges = simplify_ranges(kept_ranges + [this_range])
    return sorted(kept, key=lambda x: x.read_start)
