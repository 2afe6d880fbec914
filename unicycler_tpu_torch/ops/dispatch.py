"""Shape-aware dispatch between the full-matrix and banded DP kernels,
plus scaled-score computation (counterpart of unicycler_tpu/ops/dispatch.py;
every call takes `device`, None = CUDA, and passes it down).

Callers (path scoring, loop votes, consensus, polish) ask for a pairwise
alignment; small problems run the exact full-matrix kernel, large ones run
the banded kernel along the main diagonal with the band expanded by the
length difference — the semantics of the reference's banded fully-global
alignment (ref src/global_align.cpp:56-75).
"""

from typing import List

import numpy as np

from .. import settings
from ..utils import trace
from . import banded as banded_ops
from . import pairwise as pw


def scaled_score(pa: pw.PairAlignment, scoring: pw.Scoring) -> float:
    """100 * (raw - worst) / (perfect - worst) over the alignment length
    (semantics of ref src/scoredalignment.cpp:122-128)."""
    align_len = sum(c for c, _ in pa.cigar)
    if align_len == 0:
        return 0.0
    perfect = scoring.match * align_len
    worst = scoring.mismatch * align_len
    if perfect <= worst:
        return 0.0
    return 100.0 * (pa.score - worst) / (perfect - worst)


def _diagonal_task(q: np.ndarray, r: np.ndarray) -> banded_ops.BandedTask:
    """A banded task whose corridor is the straight (0,0)->(n,m) line."""
    anchors_q = np.array([0, len(q)], np.int32)
    anchors_r = np.array([0, len(r)], np.int32)
    return banded_ops.BandedTask(q=q, r=r, corridor_read=anchors_q,
                                 corridor_ref=anchors_r)


def align_pair(q: np.ndarray, r: np.ndarray, scoring: pw.Scoring,
               config: pw.AlignConfig, band: int = 1000,
               need_cigar: bool = True, device=None) -> pw.PairAlignment:
    """Align one pair of code arrays, choosing kernel by size."""
    return batch_align([q], [r], scoring, config, band, need_cigar,
                       device=device)[0]


def batch_align(q_list: List[np.ndarray], r_list: List[np.ndarray],
                scoring: pw.Scoring, config: pw.AlignConfig,
                band: int = 1000, need_cigar: bool = True, device=None
                ) -> List[pw.PairAlignment]:
    """Align many pairs in (at most) two device launches: one full-matrix
    batch for small pairs, one banded batch for large. The reference scores
    candidates serially (ref path_finding.py:64-86); here hundreds of
    candidates go through a single launch."""
    if not q_list:
        return []
    from .encode import bucket_length
    results: List[pw.PairAlignment] = [None] * len(q_list)
    small_idx, large_idx = [], []
    for i, (q, r) in enumerate(zip(q_list, r_list)):
        cells = bucket_length(max(len(q), 1)) * bucket_length(max(len(r), 1))
        if cells <= settings.MAX_FULL_DP_CELLS:
            small_idx.append(i)
        else:
            large_idx.append(i)
    if small_idx:
        # A diagonal band only makes sense without free starts (a
        # free-start alignment may begin at any diagonal).
        diag_band = band if not (config.free_start_s1
                                 or config.free_start_s2) else None
        trace.add('dispatch.full_dp_pairs', len(small_idx))
        with trace.span('full_dp'):
            small = pw.align_pairs([q_list[i] for i in small_idx],
                                   [r_list[i] for i in small_idx],
                                   scoring=scoring, config=config,
                                   need_cigar=need_cigar, band=diag_band,
                                   device=device)
        for i, pa in zip(small_idx, small):
            results[i] = pa
    if large_idx:
        # Band expanded by the length difference so the corner stays
        # reachable (ref global_align.cpp:56-67).
        max_diff = max(abs(len(q_list[i]) - len(r_list[i]))
                       for i in large_idx)
        eff_band = band + max_diff // 2
        tasks = [_diagonal_task(q_list[i], r_list[i]) for i in large_idx]
        # (The JAX package's adaptive two-tier banding is off by default,
        # settings.ADAPTIVE_GLOBAL_BAND = 0, and is not carried over.)
        trace.add('dispatch.banded_pairs', len(large_idx))
        with trace.span('banded'):
            large = banded_ops.align_banded(tasks, scoring, config=config,
                                            band=eff_band,
                                            need_cigar=need_cigar,
                                            device=device)
        for i, pa in zip(large_idx, large):
            results[i] = pa
    return results
