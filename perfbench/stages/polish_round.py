"""Stage `polish_round`: one round of the long-read-only mode's polish
(upstream's `unicycler -l`, whose miniasm unitigs are made of read
sequence) by the program's entry asm/polish.polish_round, as
polish_unitigs calls it: every read mapped to the unitigs
(align/minimap_like.map_reads), each mapped span aligned to its window in
one banded call (the wave route), and the votes called into a consensus.

Set-up makes the truth (the configuration's draft replicons), the draft
(the truth with the read model's errors, as the unitigs carry them),
written as a GFA to TMPDIR and loaded as the program's StringGraph, and
reads over the truth at the configuration's depth; the warm-up is one
round. A job is one round, replayed on the same draft, which the round
does not change; its input is the reads' bases.

The check, once the window has closed:
- cigar_off: of every alignment with a CIGAR that the rounds' banded
  calls gave, those whose CIGAR, walked over the task's query and window
  (reference/cigar.py), does not end at its ends or give its score.
  Exact: limit 0.
- residual_per_kbp: the differences of each round's polished sequences
  from the truth (reference/residual.py: 10 kb pieces aligned at unit
  cost), per kbp of truth; the worst round is compared.
"""

import functools
import os
import tempfile

from gen import longreads
from reference import bases, cigar as ref_cigar, residual


class Stage(object):

    def __init__(self, cell):
        self.config, self.traffic = cell['config'], cell['traffic']
        self.seed, self.device = cell['seed'], cell['device']
        self.scoring = tuple(int(x) for x in self.config['scores'].split(','))
        self.done = []      # (polished {name: sequence}, [(tasks, results)])

    # -- data: the benchmark's own, made from the seed -------------------

    def make_data(self):
        cfg, tr = self.config, self.traffic
        self.truth = longreads.genome(cfg, self.seed)
        rng = longreads.seed_rng(self.seed, 4)
        self.draft = [longreads.mutated(rng, seq, cfg['draft_errors'])
                      for seq in self.truth]
        lengths = longreads.depth_lengths(tr, sum(map(len, self.truth)))
        self.read_set = longreads.cover_reads(
            longreads.seed_rng(self.seed, 2), self.truth, cfg['circular'],
            lengths, tr['reads'])
        self.names = [str(k + 1) for k in range(len(self.truth))]

    def gfa_text(self):
        lines = ['S\t%s\t%s\n' % (name, seq)
                 for name, seq in zip(self.names, self.draft)]
        lines += ['L\t%s\t+\t%s\t+\t0M\n' % (name, name)
                  for name, circ in zip(self.names, self.config['circular'])
                  if circ]
        return ''.join(lines)

    # -- the program -----------------------------------------------------

    def setup(self):
        from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
        from unicycler_tpu_torch.graph.string_graph import StringGraph
        from unicycler_tpu_torch.io.fastx import Read
        from unicycler_tpu_torch.ops import banded
        self.make_data()
        fd, path = tempfile.mkstemp(suffix='.gfa')
        try:
            with os.fdopen(fd, 'w') as f:
                f.write(self.gfa_text())
            self.graph = StringGraph(path)
        finally:
            os.unlink(path)
        qual = self.traffic['quality']
        self.reads = [Read('read_%d' % k, seq, qual * len(seq))
                      for k, (seq, _) in enumerate(self.read_set)]
        self.ops_scoring = AlignmentScoringScheme(
            self.config['scores']).to_ops()
        # the round's banded calls, kept for the check
        self._calls = []
        inner, calls = banded.align_banded, self._calls

        @functools.wraps(inner)
        def align_banded(tasks, *args, **kwargs):
            results = inner(tasks, *args, **kwargs)
            calls.append((tasks, results))
            return results
        self._restore = (banded, inner)
        banded.align_banded = align_banded
        self._round()
        del self._calls[:]

    def _round(self):
        from unicycler_tpu_torch.asm.polish import polish_round
        polished, _, _ = polish_round(self.graph, self.reads,
                                      self.ops_scoring, device=self.device)
        return polished

    def job(self, i):
        polished = self._round()
        self.done.append((polished, self._calls[:]))
        del self._calls[:]
        return sum(len(seq) for seq, _ in self.read_set)

    def release(self):
        module, inner = self._restore
        module.align_banded = inner
        self.graph = self.reads = None

    def info(self):
        return dict(getattr(self, 'counts', {}))

    # -- the check -------------------------------------------------------

    def claims(self):
        """Each completed round's polished sequences (None where a segment
        is missing) and its alignments as plain tuples: (query codes,
        window codes, s1 start, s1 end, s2 start, s2 end, score,
        [(count, op)])."""
        out = []
        for polished, calls in self.done:
            alns = []
            for tasks, results in calls:
                for t, pa in zip(tasks, results):
                    if pa is None or not pa.cigar:
                        continue
                    cig = pa.cigar
                    if hasattr(cig, 'counts'):
                        cig = list(zip(cig.counts.tolist(),
                                       ['MID'[c] for c in
                                        cig.op_codes.tolist()]))
                    alns.append((t.q, t.r, pa.s1_start, pa.s1_end,
                                 pa.s2_start, pa.s2_end, pa.score,
                                 list(cig)))
            out.append(([polished.get(n) for n in self.names], alns))
        return out

    def residual(self, seqs):
        """Differences per kbp of truth of the sequences (strings or
        None, one per replicon)."""
        chk = self.traffic['check']
        diffs = residual.differences(
            [bases.codes(t) for t in self.truth],
            [None if s is None else bases.codes(s) for s in seqs],
            chk['piece'], chk['margin'], self.device)
        return diffs / (sum(map(len, self.truth)) / 1e3)

    def check(self, claims):
        limits = self.traffic['check']['limits']
        off = n_aln = 0
        for _, alns in claims:
            for q, r, s1s, s1e, s2s, s2e, score, cig in alns:
                n_aln += 1
                off += bool(ref_cigar.check_pair(q, r, s1s, s1e, s2s, s2e,
                                                 score, cig, self.scoring))
        # no completed round: every base is missing
        distinct = {tuple(seqs) for seqs, _ in claims} or \
            {(None,) * len(self.truth)}
        worst = max(self.residual(list(seqs)) for seqs in distinct)
        self.counts = {'alignments': n_aln, 'rounds': len(claims),
                       'distinct_outputs': len(distinct)}
        return [('residual_per_kbp', worst, limits['residual_per_kbp']),
                ('cigar_off', off, limits['cigar_off'])]

    # -- the control -----------------------------------------------------

    def control(self, n_jobs):
        """The round replaced by one that calls no vote: the draft comes
        back as it went in. Breaks the configuration's guarantee that every
        column the reads' majority contradicts is corrected. Needs only
        make_data()."""
        return {'residual_per_kbp': self.residual(self.draft)}
