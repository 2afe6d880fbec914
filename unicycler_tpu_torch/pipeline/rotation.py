"""Start-gene search and replicon rotation (a copy of
unicycler_tpu/pipeline/rotation.py, on the host).

Replaces the reference's makeblastdb/tblastn subprocesses
(ref unicycler/blast_func.py:27-134 and the rotation driver
unicycler.py:753-806) with an in-framework translated search: the
replicon is translated in all six frames and the protein start-gene
queries (dnaA/repA) are found with a seeded BLOSUM62 glocal aligner
(pipeline/protein_search.py) — tblastn's scoring model, no external
binaries at all (SURVEY.md §7.9).

Rotation is ON by default like the reference: the full 2,631-sequence
dnaA+repA start-gene database ships in gene_data/ (see
gene_data/README.md for provenance), and replicons
with no gene hit are rotated to a deterministic canonical position
(lexicographically minimal rotation over both strands) so default runs
produce stable, comparable output.
"""

import os
from typing import NamedTuple

import numpy as np

from .. import log
from ..io.fastx import load_fasta
from ..misc import reverse_complement

BUNDLED_START_GENES = os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))),
    'gene_data', 'start_genes.fasta')


class CannotFindStart(Exception):
    pass


class BlastHit(NamedTuple):
    """Hit-surface parity with ref blast_func.py:101-134."""
    qseqid: str
    start_pos: int
    flip: bool
    pident: float
    query_cov: float


_CODON_TABLE = {}
_BASES = 'TCAG'
_AMINO = ('FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRR'
          'VVVVAAAADDEEGGGG')
for _i, _b1 in enumerate(_BASES):
    for _j, _b2 in enumerate(_BASES):
        for _k, _b3 in enumerate(_BASES):
            _CODON_TABLE[_b1 + _b2 + _b3] = _AMINO[16 * _i + 4 * _j + _k]

# Protein letters get codes offset by 10 so the kernels' padding codes
# (5, 6) can never match a residue.
_AA_CODE = {aa: 10 + i for i, aa in enumerate('ACDEFGHIKLMNPQRSTVWY*X')}


def translate(seq: str) -> str:
    """DNA -> protein, frame 0, unknown codons as X."""
    out = []
    for i in range(0, len(seq) - 2, 3):
        out.append(_CODON_TABLE.get(seq[i:i + 3], 'X'))
    return ''.join(out)


def encode_protein(seq: str) -> np.ndarray:
    return np.array([_AA_CODE.get(c, _AA_CODE['X']) for c in seq],
                    dtype=np.int8)


# encoded start-gene database cache: path -> (mtime, names, code arrays)
_GENE_DB_CACHE = {}


def _load_gene_db(start_genes_fasta):
    from .protein_search import encode_aa
    key = os.path.abspath(start_genes_fasta)
    mtime = os.path.getmtime(key)
    cached = _GENE_DB_CACHE.get(key)
    if cached is not None and cached[0] == mtime:
        return cached[1], cached[2]
    genes = load_fasta(start_genes_fasta)
    names = [n for n, s in genes]
    codes = [encode_aa(s) for _, s in genes]
    _GENE_DB_CACHE.clear()
    _GENE_DB_CACHE[key] = (mtime, names, codes)
    return names, codes


def find_start_gene(sequence, start_genes_fasta, identity_threshold,
                    coverage_threshold, blast_dir=None, makeblastdb_path=None,
                    tblastn_path=None):
    """Find the best start-gene hit in a circular sequence
    (semantics of ref blast_func.py:27-98: the sequence start is
    duplicated to handle genes spanning the origin, and the replicon is
    rotated to the position where the gene's first residue aligns).
    Scoring is a real BLOSUM62 translated search, batched over the
    whole database in one indexed pass (protein_search.py
    search_gene_database — the tblastn-call shape)."""
    from .protein_search import encode_aa, search_gene_database
    seq_len = len(sequence)
    dup_length = min(seq_len, 10000)
    queryable = sequence + sequence[:dup_length]

    gene_names, gene_codes = _load_gene_db(start_genes_fasta)
    if not gene_names:
        raise CannotFindStart

    frames = []   # (frame_offset, is_reverse, protein string)
    rc = reverse_complement(queryable)
    for offset in range(3):
        frames.append((offset, False, translate(queryable[offset:])))
        frames.append((offset, True, translate(rc[offset:])))
    frame_codes = [encode_aa(p) for _, _, p in frames]

    best = search_gene_database(
        gene_codes, frame_codes,
        identity_threshold=identity_threshold,
        coverage_threshold=coverage_threshold)
    if best is None:
        raise CannotFindStart

    hit, g_idx, f_idx = best
    gene_name = gene_names[g_idx]
    frame_offset, is_reverse, _ = frames[f_idx]
    nuc_pos = frame_offset + 3 * hit.window_start  # in queryable/rc coords
    if not is_reverse:
        start_pos = nuc_pos % seq_len
        flip = False
    else:
        forward_pos = len(queryable) - nuc_pos
        start_pos = forward_pos % seq_len
        flip = True
    return BlastHit(qseqid=gene_name, start_pos=start_pos, flip=flip,
                    pident=hit.identity, query_cov=hit.coverage)


def canonical_rotation(sequence):
    """(start_pos, flip) of the lexicographically minimal rotation over
    both strands — a deterministic start for replicons with no gene hit
    (Booth's algorithm on the doubled string)."""
    def least_rotation(s):
        s2 = s + s
        f = [-1] * len(s2)
        k = 0
        for j in range(1, len(s2)):
            sj = s2[j]
            i = f[j - k - 1]
            while i != -1 and sj != s2[k + i + 1]:
                if sj < s2[k + i + 1]:
                    k = j - i - 1
                i = f[i]
            if sj != s2[k + i + 1]:
                if sj < s2[k]:
                    k = j
                f[j - k] = -1
            else:
                f[j - k] = i + 1
        return k
    fwd = least_rotation(sequence)
    rc = reverse_complement(sequence)
    rev = least_rotation(rc)
    fwd_rot = sequence[fwd:] + sequence[:fwd]
    rev_rot = rc[rev:] + rc[:rev]
    if fwd_rot <= rev_rot:
        return fwd, False
    # start_pos is given on the forward strand; segment.rotate_sequence
    # flips after rotating, so convert the reverse-strand offset
    return (len(sequence) - rev) % len(sequence), True


def rotate_completed_replicons(graph, args, counter):
    """Rotate circular replicons to start at a start gene
    (ref unicycler.py:753-806)."""
    completed_replicons = graph.completed_circular_replicons()
    if not completed_replicons:
        return
    log.log_section_header('Rotating completed replicons')
    start_genes = args.start_genes
    if not start_genes and os.path.exists(BUNDLED_START_GENES):
        start_genes = BUNDLED_START_GENES
        log.log('Using bundled start-gene database '
                '(gene_data/start_genes.fasta)', 2)
    completed_replicons = sorted(
        completed_replicons, reverse=True,
        key=lambda x: graph.segments[x].get_length())
    for replicon in completed_replicons:
        segment = graph.segments[replicon]
        sequence = segment.forward_sequence
        try:
            seg_name = str(segment.number)
        except AttributeError:
            seg_name = segment.full_name
        try:
            if not start_genes:
                raise CannotFindStart
            hit = find_start_gene(sequence, start_genes,
                                  args.start_gene_id, args.start_gene_cov)
        except CannotFindStart:
            # deterministic canonical start so default runs are stable
            start_pos, flip = canonical_rotation(sequence)
            log.log('  segment %s: no start gene found; canonical '
                    'rotation to %d (%s)' %
                    (seg_name, start_pos,
                     'reverse' if flip else 'forward'), 2)
            segment.rotate_sequence(start_pos, flip)
            continue
        log.log('  segment %s: %s at %d (%s)' %
                (seg_name, hit.qseqid, hit.start_pos,
                 'reverse' if hit.flip else 'forward'), 2)
        segment.rotate_sequence(hit.start_pos, hit.flip)
