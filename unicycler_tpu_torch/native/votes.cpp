// Polish votes of a whole round in two passes (asm/polish._vote through
// ops/votes.add_batch): indel left-alignment and per-column vote
// accumulation over every alignment at once. Each is an exact twin of its
// per-alignment Python version in ops/votes.py (left_align_indels,
// ColumnVotes.add_alignment); tests/test_torch_votes_native.py holds them
// to it.
//
// Every alignment a of a batch is given as flat arrays: its CIGAR runs
// counts/ops[run_off[a] .. run_off[a+1]) (ops 0 = M, 1 = I, 2 = D), its
// read codes and qualities codes/quals[code_off[a] .. code_off[a+1]), its
// start i0[a] in the read and j0[a] in the target, and the target's index
// target[a].

#include <cstdint>

extern "C" {

// Shift every I/D run as far left as score-equivalence allows, merging
// runs as left_align_indels does. ref_codes/ref_off hold the targets'
// codes in the frame of j0. Writes the runs of alignment a to
// out_counts/out_ops[out_off[a] .. out_off[a+1]) (room for twice the
// input runs). Returns the number of runs written, or -1 when a shift's
// comparison would read past the end of a read or a target (where the
// Python loop raises IndexError).
std::int64_t left_align_batch(
        std::int64_t n_aln, const std::int64_t* counts,
        const std::int8_t* ops, const std::int64_t* run_off,
        const std::int8_t* codes, const std::int64_t* code_off,
        const std::int64_t* i0, const std::int64_t* j0,
        const std::int64_t* target, const std::int8_t* ref_codes,
        const std::int64_t* ref_off, std::int64_t* out_counts,
        std::int8_t* out_ops, std::int64_t* out_off) {
    std::int64_t top = 0;
    out_off[0] = 0;
    for (std::int64_t a = 0; a < n_aln; ++a) {
        const std::int64_t start = top;
        const std::int8_t* q = codes + code_off[a];
        const std::int64_t q_len = code_off[a + 1] - code_off[a];
        const std::int8_t* r = ref_codes + ref_off[target[a]];
        const std::int64_t r_len = ref_off[target[a] + 1] - ref_off[target[a]];
        std::int64_t i = i0[a], j = j0[a];
        for (std::int64_t k = run_off[a]; k < run_off[a + 1]; ++k) {
            const std::int64_t c = counts[k];
            const std::int8_t op = ops[k];
            const bool last_m = top > start && out_ops[top - 1] == 0;
            if (op == 0) {
                if (last_m) {
                    out_counts[top - 1] += c;
                } else {
                    out_counts[top] = c;
                    out_ops[top++] = 0;
                }
                i += c;
                j += c;
                continue;
            }
            const std::int64_t prev_len = last_m ? out_counts[top - 1] : 0;
            // a deletion consumes the target [j, j+c), an insertion the
            // read [i, i+c)
            const std::int8_t* s = op == 2 ? r : q;
            const std::int64_t s_len = op == 2 ? r_len : q_len;
            std::int64_t& p = op == 2 ? j : i;
            std::int64_t shift = 0;
            while (shift < prev_len && p - 1 - shift >= 0) {
                const std::int64_t x = p - 1 - shift, y = p + c - 1 - shift;
                if (x >= s_len || y >= s_len) return -1;
                if (s[x] != s[y]) break;
                ++shift;
            }
            p += c;
            if (shift) {
                out_counts[top - 1] -= shift;
                if (out_counts[top - 1] == 0) --top;
            }
            if (top > start && out_ops[top - 1] == op) {
                out_counts[top - 1] += c;
            } else {
                out_counts[top] = c;
                out_ops[top++] = op;
            }
            if (shift) {
                out_counts[top] = shift;
                out_ops[top++] = 0;
            }
        }
        out_off[a + 1] = top;
    }
    return top;
}

// Accumulate every alignment's votes into its target's ColumnVotes
// arrays, given by address: base[t] (n[t] x 4 int32), qual[t] (n[t] x 4
// int64), gap_diff[t] and cover_diff[t] (n[t] + 1 int64). Requires
// i0 >= 0. An M cell votes where 0 <= j < n and i < the read's length and
// its code is 0..3; coverage and gap difference arrays take each M and D
// run's ends clipped to 0..n. Each insertion run becomes a record, in
// alignment order and then run order: its unclipped column j, its
// alignment, its read offset i, its length, and the sum of the read's
// qualities over [i, i+c) cut at the read's end. Returns the number of
// records (room for one per I run).
std::int64_t vote_batch(
        std::int64_t n_aln, const std::int64_t* counts,
        const std::int8_t* ops, const std::int64_t* run_off,
        const std::int8_t* codes, const std::uint8_t* quals,
        const std::int64_t* code_off, const std::int64_t* i0,
        const std::int64_t* j0, const std::int64_t* target,
        const std::int64_t* col_n, std::int32_t* const* base,
        std::int64_t* const* qual, std::int64_t* const* gap_diff,
        std::int64_t* const* cover_diff, std::int64_t* rec_col,
        std::int64_t* rec_aln, std::int64_t* rec_off, std::int64_t* rec_len,
        std::int64_t* rec_qsum) {
    std::int64_t n_rec = 0;
    for (std::int64_t a = 0; a < n_aln; ++a) {
        const std::int8_t* q = codes + code_off[a];
        const std::uint8_t* qv = quals + code_off[a];
        const std::int64_t q_len = code_off[a + 1] - code_off[a];
        const std::int64_t t = target[a];
        const std::int64_t n = col_n[t];
        std::int32_t* b = base[t];
        std::int64_t* bq = qual[t];
        std::int64_t i = i0[a], j = j0[a];
        for (std::int64_t k = run_off[a]; k < run_off[a + 1]; ++k) {
            const std::int64_t c = counts[k];
            const std::int8_t op = ops[k];
            if (op == 0 || op == 2) {
                const std::int64_t lo = j < 0 ? 0 : (j > n ? n : j);
                const std::int64_t e = j + c;
                const std::int64_t hi = e < 0 ? 0 : (e > n ? n : e);
                std::int64_t* diff = op == 0 ? cover_diff[t] : gap_diff[t];
                diff[lo] += 1;
                diff[hi] -= 1;
            }
            if (op == 0) {
                // cells k0 <= x < k1 keep 0 <= j + x < n and i + x < q_len
                std::int64_t k0 = j < 0 ? -j : 0;
                std::int64_t k1 = c;
                if (n - j < k1) k1 = n - j;
                if (q_len - i < k1) k1 = q_len - i;
                for (std::int64_t x = k0; x < k1; ++x) {
                    const std::int8_t code = q[i + x];
                    if (code < 0 || code > 3) continue;
                    b[(j + x) * 4 + code] += 1;
                    bq[(j + x) * 4 + code] += qv[i + x];
                }
            } else if (op == 1) {
                std::int64_t sum = 0;
                const std::int64_t end = i + c < q_len ? i + c : q_len;
                for (std::int64_t x = i; x < end; ++x) sum += qv[x];
                rec_col[n_rec] = j;
                rec_aln[n_rec] = a;
                rec_off[n_rec] = i;
                rec_len[n_rec] = c;
                rec_qsum[n_rec++] = sum;
            }
            if (op != 2) i += c;
            if (op != 1) j += c;
        }
    }
    return n_rec;
}

}  // extern "C"
