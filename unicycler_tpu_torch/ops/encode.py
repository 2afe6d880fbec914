"""Base encoding and padded-batch packing for device alignment kernels.

Base codes: A=0 C=1 G=2 T=3 N/other=4. Padding uses distinct codes for the
two sides of an alignment (5 and 6) so a padded base can never match
anything, which lets kernels run on rectangular padded batches without
masking the substitution score explicitly.
"""

import numpy as np

Q_PAD = 5   # padding code for sequence 1 (query/read) side
R_PAD = 6   # padding code for sequence 2 (reference) side


def pad_to(codes: np.ndarray, length: int, pad_code: int) -> np.ndarray:
    out = np.full(length, pad_code, dtype=np.int8)
    out[:len(codes)] = codes
    return out


def bucket_length(n: int, minimum: int = 128) -> int:
    """Round up to the next power-of-four bucket (at least `minimum`).
    Coarse buckets trade padded compute (cheap) for far fewer compiled
    shapes and per-bucket launches."""
    b = minimum
    while b < n:
        b *= 4
    return b


def pack_pairs(q_list, r_list, q_bucket=None, r_bucket=None):
    """Pack lists of int8 code arrays into padded (B, L) batches.

    Returns (q_batch, q_lens, r_batch, r_lens) as numpy arrays.
    """
    if q_bucket is None:
        q_bucket = bucket_length(max((len(q) for q in q_list), default=1))
    if r_bucket is None:
        r_bucket = bucket_length(max((len(r) for r in r_list), default=1))
    q_batch = np.stack([pad_to(q, q_bucket, Q_PAD) for q in q_list])
    r_batch = np.stack([pad_to(r, r_bucket, R_PAD) for r in r_list])
    q_lens = np.array([len(q) for q in q_list], dtype=np.int32)
    r_lens = np.array([len(r) for r in r_list], dtype=np.int32)
    return q_batch, q_lens, r_batch, r_lens


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    comp = np.array([3, 2, 1, 0, 4, 5, 6], dtype=codes.dtype)
    return comp[codes[::-1]]
