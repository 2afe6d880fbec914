"""Seconds from the process's start to the window's start: imports, the
kernel library's load (or build), data generation and the warm-up job
(host clock)."""


def read(run):
    return run.setup_s
