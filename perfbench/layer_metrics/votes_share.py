"""Share of the traced window in the polish round's votes and consensus
call (span `votes` of asm/polish.polish_round: indel left-alignment,
column votes, the consensus)."""

NAMES = ('votes',)


def read(run):
    rec = run.record
    if rec is None or not any(s[0] in NAMES for s in rec.spans):
        return None
    return 100.0 * rec.span_seconds(NAMES) / rec.window_s
