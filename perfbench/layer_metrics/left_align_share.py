"""Share of the traced window in the polish round's indel left-alignment
(span `left_align` of asm/polish._vote, one per alignment, inside
`votes`)."""

NAMES = ('left_align',)


def read(run):
    rec = run.record
    if rec is None or not any(s[0] in NAMES for s in rec.spans):
        return None
    return 100.0 * rec.span_seconds(NAMES) / rec.window_s
