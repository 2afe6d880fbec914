"""Overlap-layout-consensus string-graph assembly (the miniasm role; a copy
of unicycler_tpu/asm/olc.py, host Python).

Replaces the reference's vendored, modified miniasm (ref unicycler/src/
miniasm/{hit,asg,asm}.cpp, driven by src/miniasm_assembly.cpp:34-193).
The pipeline and parameters mirror that driving code exactly
(min_span/min_ovlp 2000, max_hang 1000, gap_fuzz 1000, bub_dist 50000,
max_ext 4, drop ratios 0.5->0.7 then 0.8), including Unicycler's
modifications: CONTIG_ reads get triple-weighted depth (hit.cpp:159-171),
are end-clipped rather than depth-trimmed (hit.cpp:173-201), and can never
be deleted as contained (hit.cpp:377-378).

Overlaps come from the minimiser mapper (AVA mode, host numpy); everything
here is host-side graph work over hit lists.
"""

from collections import defaultdict

from ..graph.string_graph import StringGraph, StringGraphLink, \
    StringGraphSegment, flip_segment_name

# classification results of hit_to_arc (miniasm.h:83-86)
HT_INT = -1
HT_QCONT = -2
HT_TCONT = -3
HT_SHORT = -4


class Hit(object):
    """One AVA overlap (query -> target), PAF-style coordinates."""
    __slots__ = ('qn', 'qs', 'qe', 'rev', 'tn', 'ts', 'te', 'ml', 'bl')

    def __init__(self, qn, qs, qe, rev, tn, ts, te, ml, bl):
        self.qn, self.qs, self.qe = qn, qs, qe
        self.rev = rev
        self.tn, self.ts, self.te = tn, ts, te
        self.ml, self.bl = ml, bl

    def flipped(self):
        """The same overlap with query and target swapped."""
        return Hit(self.tn, self.ts, self.te, self.rev,
                   self.qn, self.qs, self.qe, self.ml, self.bl)


def hit_to_arc(h, ql, tl, max_hang, int_frac, min_ovlp):
    """Classify an overlap (semantics of ma_hit2arc, miniasm.h:88-119).

    Returns (code, None) for filtered hits, or (l, arc) where arc =
    (u, v, l, ol, ml): u/v signed vertex names ('<name>+'/'-'),
    l = distance from u's start to v's start, ol = overlap length."""
    qs, qe = h.qs, h.qe
    if h.rev:
        tl5, tl3 = tl - h.te, h.ts
    else:
        tl5, tl3 = h.ts, tl - h.te
    ext5 = min(qs, tl5)
    ext3 = min(ql - qe, tl3)
    if ext5 > max_hang or ext3 > max_hang or \
            qe - qs < (qe - qs + ext5 + ext3) * int_frac:
        return HT_INT, None
    if qs <= tl5 and ql - qe <= tl3:
        return HT_QCONT, None
    if qs >= tl5 and ql - qe >= tl3:
        return HT_TCONT, None
    if qs > tl5:
        u, v, l = 0, 1 if h.rev else 0, qs - tl5
    else:
        u, v, l = 1, 0 if h.rev else 1, (ql - qe) - tl3
    if qe - qs + ext5 + ext3 < min_ovlp or \
            h.te - h.ts + ext5 + ext3 < min_ovlp:
        return HT_SHORT, None
    # u: 0 = off the query's end (q+ -> ...), 1 = off the query's start
    if u == 0:
        u_name = h.qn + '+'
        v_name = h.tn + ('-' if h.rev else '+')
    else:
        u_name = h.qn + '-'
        v_name = h.tn + ('+' if h.rev else '-')
    ol = ql - l
    return l, (u_name, v_name, l, ol, h.ml)


def is_contig(name):
    return name.startswith('CONTIG_')


class OLCAssembler(object):

    def __init__(self, read_seqs, min_dp=3, min_span=2000, min_match=100,
                 min_ovlp=2000, max_hang=1000, gap_fuzz=1000,
                 bub_dist=50000, max_ext=4, int_frac=0.8, min_iden=0.05):
        self.read_seqs = read_seqs        # name -> sequence string
        self.read_lengths = {n: len(s) for n, s in read_seqs.items()}
        self.min_dp = min_dp
        self.min_span = min_span
        self.min_match = min_match
        self.min_ovlp = min_ovlp
        self.max_hang = max_hang
        self.gap_fuzz = gap_fuzz
        self.bub_dist = bub_dist
        self.max_ext = max_ext
        self.int_frac = int_frac
        self.min_iden = min_iden
        self.subreads = {}                # name -> [start, end] or None
        self.contained = set()
        self.arcs = {}                    # (u, v) -> (l, ol, ml)

    # -- read trimming (filter_reads_using_depth, hit.cpp:123-256) --------

    def _trim_reads(self, hits, end_clip):
        events = defaultdict(list)
        for h in hits:
            if h.qn == h.tn or h.ml < h.bl * self.min_iden:
                continue
            qs, qe = h.qs + end_clip, h.qe - end_clip
            if qe <= qs:
                continue
            # CONTIG_ targets triple-weight the long read's coverage.
            weight = 3 if (not is_contig(h.qn) and is_contig(h.tn)) else 1
            for _ in range(weight):
                events[h.qn].append((qs, 1))
                events[h.qn].append((qe, -1))
        subreads = {}
        for name in self.read_seqs:
            evs = events.get(name)
            if is_contig(name):
                # contigs: clip only unaligned ends (hit.cpp:173-201)
                if not evs:
                    subreads[name] = [0, self.read_lengths[name]]
                else:
                    starts = [p for p, d in evs if d == 1]
                    ends = [p for p, d in evs if d == -1]
                    subreads[name] = [max(0, min(starts) - end_clip),
                                      min(self.read_lengths[name],
                                          max(ends) + end_clip)]
                continue
            if not evs:
                subreads[name] = None
                continue
            evs.sort(key=lambda x: (x[0], -x[1]))
            best = (0, 0)
            dp = 0
            start = None
            for pos, delta in evs:
                old_dp = dp
                dp += delta
                if old_dp < self.min_dp <= dp:
                    start = pos
                elif old_dp >= self.min_dp > dp and start is not None:
                    if pos - start > best[1] - best[0]:
                        best = (start, pos)
            if best[1] - best[0] > 0:
                subreads[name] = [max(0, best[0] - end_clip),
                                  min(self.read_lengths[name],
                                      best[1] + end_clip)]
            else:
                subreads[name] = None
        return subreads

    @staticmethod
    def _remap_hits(hits, subreads):
        """Clip hits to the trimmed reads (ma_hit_sub semantics)."""
        out = []
        for h in hits:
            qsub = subreads.get(h.qn)
            tsub = subreads.get(h.tn)
            if qsub is None or tsub is None:
                continue
            qs = max(h.qs, qsub[0]) - qsub[0]
            qe = min(h.qe, qsub[1]) - qsub[0]
            if h.rev:
                ts = max(h.ts, tsub[0]) - tsub[0]
                te = min(h.te, tsub[1]) - tsub[0]
            else:
                ts = max(h.ts, tsub[0]) - tsub[0]
                te = min(h.te, tsub[1]) - tsub[0]
            if qe <= qs or te <= ts:
                continue
            out.append(Hit(h.qn, qs, qe, h.rev, h.tn, ts, te, h.ml, h.bl))
        return out

    def _filter_span(self, hits):
        return [h for h in hits if h.qe - h.qs >= self.min_span
                and h.te - h.ts >= self.min_span]

    def _filter_overhang(self, hits, max_hang, min_ovlp):
        out = []
        for h in hits:
            ql = self.subreads[h.qn][1] - self.subreads[h.qn][0]
            tl = self.subreads[h.tn][1] - self.subreads[h.tn][0]
            code, _ = hit_to_arc(h, ql, tl, max_hang, self.int_frac,
                                 min_ovlp)
            if code != HT_INT:
                out.append(h)
        return out

    # -- containment removal (hit.cpp:348-410) ----------------------------

    def _remove_contained(self, hits):
        for h in hits:
            ql = self.subreads[h.qn][1] - self.subreads[h.qn][0]
            tl = self.subreads[h.tn][1] - self.subreads[h.tn][0]
            code, _ = hit_to_arc(h, ql, tl, self.max_hang, self.int_frac,
                                 self.min_ovlp)
            if code == HT_QCONT and not is_contig(h.qn):
                self.contained.add(h.qn)
            elif code == HT_TCONT and not is_contig(h.tn):
                self.contained.add(h.tn)
        return [h for h in hits if h.qn not in self.contained
                and h.tn not in self.contained]

    # -- graph construction + cleaning ------------------------------------

    def _make_arcs(self, hits):
        for h in hits:
            ql = self.subreads[h.qn][1] - self.subreads[h.qn][0]
            tl = self.subreads[h.tn][1] - self.subreads[h.tn][0]
            code, arc = hit_to_arc(h, ql, tl, self.max_hang, self.int_frac,
                                   self.min_ovlp)
            if arc is None:
                continue
            u, v, l, ol, ml = arc
            key = (u, v)
            if key not in self.arcs or self.arcs[key][1] < ol:
                self.arcs[key] = (l, ol, ml)
        # Keep only arcs whose complement exists (symmetric graph).
        sym = {}
        for (u, v), val in self.arcs.items():
            comp = (flip_segment_name(v), flip_segment_name(u))
            if comp in self.arcs:
                sym[(u, v)] = val
        self.arcs = sym

    def _out_arcs(self, u):
        return [(v, val) for (a, v), val in self.arcs.items() if a == u]

    def _build_adj(self):
        adj = defaultdict(list)
        for (u, v), (l, ol, ml) in self.arcs.items():
            adj[u].append((v, l, ol, ml))
        for u in adj:
            adj[u].sort(key=lambda x: x[1])
        return adj

    def _del_arc(self, u, v):
        self.arcs.pop((u, v), None)
        self.arcs.pop((flip_segment_name(v), flip_segment_name(u)), None)

    def _transitive_reduction(self):
        """Myers-2005 transitive reduction with gap fuzz (asg.cpp's
        asg_arc_del_trans)."""
        adj = self._build_adj()
        to_delete = []
        for v, arcs in adj.items():
            if not arcs:
                continue
            mark = {w: 'inplay' for w, _, _, _ in arcs}
            longest = arcs[-1][1] + self.gap_fuzz
            for w, lw, _, _ in arcs:
                if mark.get(w) != 'inplay':
                    continue
                for x, lx, _, _ in adj.get(w, []):
                    if lw + lx > longest:
                        break
                    if mark.get(x) == 'inplay':
                        mark[x] = 'eliminated'
            for w, lw, _, _ in arcs:
                if mark.get(w) == 'eliminated':
                    to_delete.append((v, w))
        for u, v in to_delete:
            self._del_arc(u, v)

    def _vertex_degrees(self):
        out_deg = defaultdict(int)
        for (u, v) in self.arcs:
            out_deg[u] += 1
        return out_deg

    def _cut_tips(self):
        """Remove short dead-end unitigs (asg.cpp's asg_cut_tip)."""
        while True:
            adj = self._build_adj()
            in_deg = defaultdict(int)
            for (u, v) in self.arcs:
                in_deg[v] += 1
            removed = set()
            for name in list(self.read_seqs):
                if name in removed or name in self.contained:
                    continue
                for sign in '+-':
                    start = name + sign
                    if in_deg.get(start, 0) != 0:
                        continue        # not a tip start
                    # walk the simple path from this dead end
                    chain = [start]
                    current = start
                    ok_tip = True
                    while len(chain) <= self.max_ext:
                        outs = adj.get(current, [])
                        if len(outs) != 1:
                            break
                        nxt = outs[0][0]
                        if in_deg.get(nxt, 0) != 1:
                            break       # merges into real graph: cuttable
                        chain.append(nxt)
                        current = nxt
                    if len(chain) > self.max_ext:
                        ok_tip = False
                    # a tip is cuttable when it's short and its last node
                    # connects into the bigger graph
                    if ok_tip and len(chain) >= 1:
                        last_outs = adj.get(chain[-1], [])
                        if last_outs:
                            for seg in chain:
                                base = seg[:-1]
                                if not is_contig(base):
                                    removed.add(base)
            if not removed:
                break
            for base in removed:
                self._remove_read(base)

    def _remove_read(self, base):
        self.contained.add(base)
        for (u, v) in [k for k in self.arcs
                       if k[0][:-1] == base or k[1][:-1] == base]:
            self.arcs.pop((u, v), None)

    def _pop_bubbles(self):
        """Simple bubble popping: for 2-out vertices whose branches
        reconverge within bub_dist, keep the higher-overlap branch
        (the role of asg_pop_bubble, simplified to 2-way bubbles)."""
        adj = self._build_adj()
        for u in list(adj):
            outs = adj.get(u, [])
            if len(outs) != 2:
                continue
            (v1, l1, ol1, _), (v2, l2, ol2, _) = outs
            n1 = [x[0] for x in adj.get(v1, [])]
            n2 = [x[0] for x in adj.get(v2, [])]
            common = set(n1) & set(n2)
            if not common:
                continue
            drop = v2 if ol1 >= ol2 else v1
            base = drop[:-1]
            if is_contig(base):
                continue
            self._remove_read(base)
            adj = self._build_adj()

    # unitig-end classifications (ref miniasm asg.cpp:213-235)
    _ET_MERGEABLE, _ET_TIP, _ET_MULTI_OUT, _ET_MULTI_NEI = 0, 1, 2, 3

    def _end_class(self, adj, v):
        """Classify the unitig end at vertex v (asg_is_utg_end: examines
        the live arcs leaving flip(v)). Returns (code, continuation)."""
        outs = adj.get(flip_segment_name(v), [])
        if len(outs) == 0:
            return self._ET_TIP, None
        if len(outs) > 1:
            return self._ET_MULTI_OUT, None
        t = outs[0][0]
        if len(adj.get(flip_segment_name(t), [])) != 1:
            return self._ET_MULTI_NEI, t
        return self._ET_MERGEABLE, t

    def _extend(self, adj, v, max_ext):
        """Walk a unitig from v for at most max_ext steps (asg_extend);
        returns (terminating classification, visited vertices)."""
        chain = [v]
        while True:
            code, nxt = self._end_class(adj, flip_segment_name(v))
            if code != self._ET_MERGEABLE:
                return code, chain
            chain.append(nxt)
            v = nxt
            max_ext -= 1
            if max_ext <= 0:
                return self._ET_MERGEABLE, chain

    def _vertices(self):
        seen = set()
        for (u, v) in self.arcs:
            seen.add(u)
            seen.add(v)
            seen.add(flip_segment_name(u))
            seen.add(flip_segment_name(v))
        return sorted(seen)

    def _cut_short_internal(self, max_ext=1):
        """Remove short unitigs whose BOTH ends attach to branching
        neighbours — internal sequences that bridge unrelated paths
        (ref asg.cpp cut_short_internal:271-289). Contig-backed reads
        are immune, like everywhere else in this pipeline."""
        adj = self._build_adj()
        cut = 0
        for v in self._vertices():
            if v[:-1] in self.contained:
                continue
            if self._end_class(adj, v)[0] != self._ET_MULTI_NEI:
                continue
            code, chain = self._extend(adj, v, max_ext)
            if code != self._ET_MULTI_NEI:
                continue
            if any(is_contig(seg[:-1]) for seg in chain):
                continue
            for seg in chain:
                self._remove_read(seg[:-1])
            cut += 1
            adj = self._build_adj()
        return cut

    def _cut_biloops(self):
        """Cut small bi-loops: w -> v -> ... -> x' while also w -> x;
        drop the weaker w -> x arc when the through-path overlap is
        stronger (ref asg.cpp cut_biloops:290-325)."""
        adj = self._build_adj()
        cut = 0
        for v in self._vertices():
            if v[:-1] in self.contained:
                continue
            if self._end_class(adj, v)[0] != self._ET_MULTI_NEI:
                continue
            code, chain = self._extend(adj, v, self.max_ext)
            if code != self._ET_MULTI_OUT:
                continue
            x = flip_segment_name(chain[-1])
            ins = adj.get(flip_segment_name(v), [])
            if len(ins) != 1:
                continue
            w = flip_segment_name(ins[0][0])
            ov = ox = 0
            for t, _, ol, _ in adj.get(w, []):
                if t == x:
                    ox = ol
                if t == v:
                    ov = ol
            if ox and ov > ox:
                self._del_arc(w, x)
                cut += 1
                adj = self._build_adj()
        return cut

    def _del_short_arcs(self, drop_ratio):
        """Drop arcs much shorter than a vertex's best overlap
        (asg_arc_del_short)."""
        adj = self._build_adj()
        deleted = 0
        for u, arcs in adj.items():
            if len(arcs) < 2:
                continue
            best_ol = max(x[2] for x in arcs)
            thresh = best_ol * drop_ratio
            for v, l, ol, _ in arcs:
                if ol < thresh:
                    self._del_arc(u, v)
                    deleted += 1
        return deleted

    # -- main entry --------------------------------------------------------

    def assemble(self, hits):
        """Run the full pipeline; returns (StringGraph, trim_ranges) where
        trim_ranges maps read name -> (start_1based, end) as written to
        all_reads.txt by the reference (hit.cpp save_read_names)."""
        # mirror each hit so both reads see it as query
        all_hits = []
        for h in hits:
            if h.qe - h.qs < self.min_span or h.ml < self.min_match:
                continue
            all_hits.append(h)
            all_hits.append(h.flipped())
        all_hits.sort(key=lambda h: h.qn)

        # 1-pass crude read selection
        self.subreads = self._trim_reads(all_hits, 0)
        all_hits = [h for h in all_hits
                    if self.subreads.get(h.qn) and self.subreads.get(h.tn)]
        all_hits = self._remap_hits(all_hits, self.subreads)
        all_hits = self._filter_span(all_hits)
        self.subreads = {n: [0, r[1] - r[0]] if r else None
                         for n, r in self.subreads.items()}
        first_pass = {n: r for n, r in self.subreads.items()}
        all_hits = self._filter_overhang(all_hits,
                                         int(self.max_hang * 1.5),
                                         int(self.min_ovlp * 0.5))

        # 2-pass fine read selection
        sub2 = self._trim_reads(all_hits, self.min_span // 2)
        all_hits = self._remap_hits(all_hits, sub2)
        all_hits = self._filter_span(all_hits)
        # merge: absolute coordinates of second trim within the first
        merged = {}
        for name, r2 in sub2.items():
            if r2 is None:
                merged[name] = None
            else:
                merged[name] = [r2[0], r2[1]]
        self.subreads = merged

        trim_ranges = {}
        for name, r in self.subreads.items():
            if r is not None:
                trim_ranges[name] = (r[0] + 1, r[1])

        all_hits = self._remove_contained(all_hits)
        self._make_arcs(all_hits)
        self._transitive_reduction()
        self._cut_tips()
        self._pop_bubbles()
        for i in range(3):
            r = 0.5 + (0.7 - 0.5) / 2 * i
            if self._del_short_arcs(r):
                self._cut_tips()
                self._pop_bubbles()
        # Step 4.4: short internal sequences and bi-loops
        # (ref miniasm_assembly.cpp:163-168)
        if self._cut_short_internal(1) + self._cut_biloops():
            self._cut_tips()
            self._pop_bubbles()
        # Step 4.5: aggressive short-overlap cut
        if self._del_short_arcs(0.8):
            self._cut_tips()
            self._pop_bubbles()

        return self._to_string_graph(), trim_ranges

    def _to_string_graph(self):
        graph = StringGraph(None)
        used = set()
        for (u, v) in self.arcs:
            used.add(u[:-1])
            used.add(v[:-1])
        for name in sorted(used):
            sub = self.subreads.get(name)
            if sub is None:
                continue
            seq = self.read_seqs[name][sub[0]:sub[1]]
            full_name = '%s:%d-%d' % (name, sub[0] + 1, sub[1])
            graph.segments[full_name] = StringGraphSegment(full_name, seq)
        name_map = {name: '%s:%d-%d' % (name, sub[0] + 1, sub[1])
                    for name, sub in self.subreads.items()
                    if sub is not None and name in used}
        for (u, v), (l, ol, ml) in sorted(self.arcs.items()):
            base_u, sign_u = u[:-1], u[-1]
            base_v, sign_v = v[:-1], v[-1]
            if base_u not in name_map or base_v not in name_map:
                continue
            start = name_map[base_u] + sign_u
            end = name_map[base_v] + sign_v
            if end not in graph.forward_links[start]:
                graph.forward_links[start].append(end)
                graph.reverse_links[end].append(start)
            link = (start, end)
            if link not in graph.links:
                graph.links[link] = StringGraphLink(start, end)
            graph.links[link].seg_1_overlap = ol
            comp = (flip_segment_name(end), flip_segment_name(start))
            if comp not in graph.links:
                graph.links[comp] = StringGraphLink(*comp)
            graph.links[comp].seg_2_overlap = ol
        return graph


def ava_overlaps(read_seqs, k=15, w=5, exclude_contig_contig=True):
    """All-vs-all overlaps via the minimiser mapper (the 'read vs read'
    preset role of ref src/minimap_align.cpp:48-62; contig-contig hits are
    excluded per ref miniasm_assembly.py:106-111)."""
    from ..io.fastx import Read
    from ..align.minimap_like import map_reads
    from ..io.fastx import Reference

    reads = [Read(n, s, None) for n, s in read_seqs.items()]
    refs = [Reference(n, s) for n, s in read_seqs.items()]
    mapped = map_reads(refs, reads, k=k, w=w)
    hits = []
    seen = set()
    for read_name, alignments in mapped.items():
        for a in alignments:
            if a.ref_name == read_name:
                continue
            if exclude_contig_contig and is_contig(read_name) \
                    and is_contig(a.ref_name):
                continue
            key = (min(read_name, a.ref_name), max(read_name, a.ref_name),
                   a.read_start // 100, a.read_strand)
            if key in seen:
                continue
            seen.add(key)
            hits.append(Hit(read_name, a.read_start, a.read_end,
                            a.read_strand == '-', a.ref_name, a.ref_start,
                            a.ref_end, a.matching_bases, a.num_bases))
    return hits
