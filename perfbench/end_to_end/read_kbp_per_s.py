"""Kilobases of input reads that the window's completed jobs consumed,
over the time from the window's start to the end of the last completed
job (host clock)."""


def read(run):
    done = [j for j in run.jobs if j['ok']]
    if not done:
        return None
    return sum(j['bases'] for j in done) / 1e3 / done[-1]['end']
