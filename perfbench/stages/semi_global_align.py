"""Stage `semi_global_align`: long reads aligned to a finished reference
(upstream's `unicycler_align`) by the program's entry
align/semi_global.semi_global_align_long_reads, called as
pipeline/main.py and unicycler_align call it: one call over the whole
read set, no FASTA, FASTQ or SAM file, the automatic low-score threshold
(worked out by each call, as each unicycler_align run does), no overlap
allowed between a read's alignments, the minimum alignment length of
settings.MIN_LONG_READ_ALIGNMENT_LENGTH and the configuration's
sensitivity level.

Set-up makes the genome (a chromosome with the configuration's repeat
families planted, gen/bridging.repeat_replicons, and the plasmid) and a
pool of `pool_jobs` read sets, each covering the genome at the
configuration's `depth` with the same read lengths (gen/longreads.py),
and runs one more call over a set of the same size as the warm-up (it
loads the kernels and builds the minimiser index, which later calls
reuse, as the pipeline's calls do). A job is one call over the next
pool set, made into fresh Read objects; the pool wraps, and
`jobs_wrapped` counts it. A job's input is its reads' bases. Of each
alignment a job keeps only the numbers the check reads.

The check, once the window has closed:
- cigar_off: of every alignment of every completed job, those whose SAM
  CIGAR, walked over the read and the reference (reference/cigar.py),
  does not give the reported raw score, the DP's score, the reported
  ends or the clips. Exact: limit 0.
- reads_off: of a sample of the completed jobs' reads drawn from the
  seed, the longest among them, the reads whose best raw score differs
  from the reference's best semi-global score of the read against its
  true origin with `window_margin` bases on each side (reference/dp.py,
  int32, on the run's device). A read the aligner leaves unaligned, or
  aligns worse than its origin allows, is off. The program's best is
  taken over all the read's alignments, since a read inside a repeat copy
  scores the same on every copy of its allele.
"""

import time
import types

import numpy as np

from gen import bridging, longreads
from reference import bases, cigar as ref_cigar, dp


class Stage(object):

    def __init__(self, cell):
        self.config, self.traffic = cell['config'], cell['traffic']
        self.seed, self.device = cell['seed'], cell['device']
        self.scoring = tuple(int(x) for x in self.config['scores'].split(','))
        # per completed job: (pool slot, per read: [alignment tuples])
        self.done = []
        self.wraps = 0
        self.counts = {}

    # -- data: the benchmark's own, made from the seed -------------------

    def make_data(self):
        cfg, tr = self.config, self.traffic
        chrom_len, plasmid_len = cfg['replicons']
        _, chrom, plasmid, _, _, _ = bridging.repeat_replicons(
            [int(self.seed) & (2 ** 64 - 1), 1], chrom_len, plasmid_len,
            [tuple(f) for f in cfg['repeat_families']])
        self.replicons = [chrom, plasmid]
        self.ref_codes = [bases.codes(s) for s in self.replicons]
        lengths = longreads.depth_lengths(
            dict(tr, depth=cfg['depth']), sum(map(len, self.replicons)))
        rng = longreads.seed_rng(self.seed, 2)
        # reads lie inside their replicon: the aligner takes each
        # reference as linear; pool slot pool_jobs is the warm-up's
        inside = [False] * len(self.replicons)
        self.pool = [longreads.cover_reads(rng, self.replicons, inside,
                                           lengths, tr['reads'])
                     for _ in range(tr['pool_jobs'] + 1)]

    # -- the program -----------------------------------------------------

    def setup(self):
        from unicycler_tpu_torch import settings
        from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
        from unicycler_tpu_torch.io.fastx import Reference
        self.make_data()
        self.refs = [Reference(name, seq) for name, seq in
                     zip(self.config['replicon_names'], self.replicons)]
        self.ref_index = {n: i for i, n in
                          enumerate(self.config['replicon_names'])}
        self.scheme = AlignmentScoringScheme(self.config['scores'])
        self.min_len = settings.MIN_LONG_READ_ALIGNMENT_LENGTH
        self._align(len(self.pool) - 1)

    def _align(self, slot):
        """One call over pool set `slot`; returns its reads."""
        from unicycler_tpu_torch.align.semi_global import \
            semi_global_align_long_reads
        from unicycler_tpu_torch.io.fastx import Read
        reads = [Read('r%d' % k, seq, None)
                 for k, (seq, _) in enumerate(self.pool[slot])]
        read_dict = {r.name: r for r in reads}
        semi_global_align_long_reads(
            self.refs, None, read_dict, [r.name for r in reads], None, 1,
            self.scheme, [None], False, self.min_len, None, None, 0,
            self.config['sensitivity_level'], None, device=self.device)
        return reads

    def job(self, i):
        """One call over pool set i mod pool_jobs; returns its input
        bases."""
        slot = i % self.traffic['pool_jobs']
        if i and not slot:
            self.wraps += 1
        reads = self._align(slot)
        self.done.append((slot, [[self._keep(a) for a in r.alignments]
                                 for r in reads]))
        return sum(len(seq) for seq, _ in self.pool[slot])

    def _keep(self, a):
        """What the check reads of one alignment: (replicon, rev_comp,
        read start, read end, ref start, ref end, raw score, DP score or
        None, the program's CIGAR runs, the read's end gap)."""
        pair = getattr(a, '_pair', None)
        return (self.ref_index[a.ref.name], bool(a.rev_comp),
                a.read_start_pos, a.read_end_pos, a.ref_start_pos,
                a.ref_end_pos, a.raw_score,
                None if pair is None else pair.score, a._runs,
                a.read_end_gap)

    def release(self):
        """Drop the program's state that holds device memory."""
        self.refs = None

    def info(self):
        return dict(self.counts, jobs_wrapped=self.wraps)

    # -- the check -------------------------------------------------------

    def claims(self):
        """The completed jobs' alignments as plain tuples: (job, read,
        replicon, rev_comp, read start, read end, ref start, ref end, raw
        score, DP score or None, SAM CIGAR parts). The parts are made by
        the program's own Alignment.cigar_parts from the kept runs."""
        from unicycler_tpu_torch.align.alignment import Alignment
        parts_of = Alignment.cigar_parts.fget
        out = []
        for j, (_, per_read) in enumerate(self.done):
            for k, alns in enumerate(per_read):
                for (rep, rev, rs, re_, fs, fe, raw, dp_score, runs,
                     gap) in alns:
                    parts = parts_of(types.SimpleNamespace(
                        _cigar_parts=None, _runs=runs, read_start_pos=rs,
                        read_end_gap=gap))
                    out.append((j, k, rep, rev, rs, re_, fs, fe, raw,
                                dp_score, list(parts or [])))
        return out

    def sample(self, n_jobs=None):
        """The sampled reads: [(job, read)], the longest first, drawn from
        the seed among the first n_jobs completed jobs (all by default)."""
        slots = [s for s, _ in self.done] if n_jobs is None else \
            [j % self.traffic['pool_jobs'] for j in range(n_jobs)]
        items = [(j, k) for j, s in enumerate(slots)
                 for k in range(len(self.pool[s]))]
        lens = [len(self.pool[slots[j]][k][0]) for j, k in items]
        longest = int(np.argmax(lens))
        rng = longreads.seed_rng(self.seed, 3)
        rest = [int(x) for x in rng.permutation(len(items)) if x != longest]
        want = self.traffic['check']['sample_reads']
        return [items[x] for x in [longest] + rest[:want - 1]], slots

    def windows(self, picks, slots):
        """Per sampled read: (query codes in the true orientation, the
        true origin's window codes)."""
        margin = self.traffic['check']['window_margin']
        out = []
        for j, k in picks:
            seq, truth = self.pool[slots[j]][k]
            ref = self.ref_codes[truth.replicon]
            lo = max(0, truth.start - margin)
            hi = min(len(ref), truth.end + margin)
            q = bases.codes(seq)
            if truth.rev_comp:
                q = bases.revcomp(q)
            out.append((q, ref[lo:hi]))
        return out

    def reference_best(self, wins, dtype=None):
        """The reference's best scores of the windows, in blocks of reads
        of like length, the longest first, each block up to `block_cells`
        padded cells a row (few padded cells, few row steps)."""
        import torch
        budget = self.traffic['check']['block_cells']
        order = sorted(range(len(wins)), key=lambda x: -len(wins[x][1]))
        best = [0] * len(wins)
        a = 0
        while a < len(order):
            width = len(wins[order[a]][1])
            part = order[a:a + max(1, budget // max(1, width))]
            got = dp.semiglobal_best([wins[x][0] for x in part],
                                     [wins[x][1] for x in part],
                                     self.scoring, self.device,
                                     dtype=dtype or torch.int32)
            for x, v in zip(part, got):
                best[x] = v
            a += len(part)
        return best

    def check(self, claims):
        """[(name, value, limit)] of the numbers compared."""
        limits = self.traffic['check']['limits']
        t0 = time.perf_counter()
        slots = [s for s, _ in self.done]
        codes = {}
        off = 0
        for (j, k, rep, rev, rs, re_, fs, fe, raw, dp_score,
             parts) in claims:
            if (j, k, rev) not in codes:
                q = bases.codes(self.pool[slots[j]][k][0])
                codes[(j, k, rev)] = bases.revcomp(q) if rev else q
            faults = ref_cigar.check(codes[(j, k, rev)], self.ref_codes[rep],
                                     (rs, re_, fs, fe), parts,
                                     (raw, dp_score), self.scoring)
            off += bool(faults)
        t1 = time.perf_counter()
        picks, slots = self.sample()
        best = {}
        for j, k, _, _, _, _, _, _, raw, _, _ in claims:
            best[(j, k)] = max(best.get((j, k), raw), raw)
        program = [best.get(p, 0) for p in picks]
        wins = self.windows(picks, slots)
        ref = self.reference_best(wins)
        self.counts = {
            'alignments': len(claims), 'sampled_reads': len(picks),
            'sampled_bases': sum(len(w[0]) for w in wins),
            'reads_total': sum(len(per_read) for _, per_read in self.done),
            'reads_unaligned': sum(not alns for _, per_read in self.done
                                   for alns in per_read),
            'check_cigar_s': t1 - t0,
            'check_reference_s': time.perf_counter() - t1}
        return [('reads_off', reads_off(ref, program), limits['reads_off']),
                ('cigar_off', off, limits['cigar_off'])]

    # -- the control -----------------------------------------------------

    def control(self, n_jobs):
        """The reference put in the program's place at int16, the next
        precision below the configuration's int32 scores: the reads_off
        its scores read, against the int32 reference, on the sample that
        a run of n_jobs jobs checks. Needs only make_data()."""
        import torch
        picks, slots = self.sample(n_jobs)
        wins = self.windows(picks, slots)
        return {'reads_off': reads_off(
            self.reference_best(wins),
            self.reference_best(wins, dtype=torch.int16))}


def reads_off(reference, program):
    """The reads whose program score differs from the reference's."""
    return sum(r != p for r, p in zip(reference, program))
