"""Logging: dual stdout/file output with independent verbosity levels.

Capability parity with the reference's global Log singleton
(ref unicycler/log.py:25-120): section headers with timestamps, verbosity
gating 0-3 and optional ANSI colour, with the JAX package's writers. The
implementation is original and simpler (no tput probing; colour decided
from isatty).
"""

import datetime
import shutil
import sys
import textwrap


BOLD = '\033[1m'
UNDERLINE = '\033[4m'
DIM = '\033[2m'
RED = '\033[31m'
GREEN = '\033[32m'
YELLOW = '\033[93m'
END_FORMATTING = '\033[0m'


class Log(object):
    def __init__(self, log_filename=None, stdout_verbosity_level=1,
                 log_file_verbosity_level=None):
        self.log_filename = log_filename
        self.stdout_verbosity_level = stdout_verbosity_level
        self.log_file_verbosity_level = (
            log_file_verbosity_level if log_file_verbosity_level is not None
            else max(1, stdout_verbosity_level))
        self.colours = sys.stdout.isatty()
        self.log_file = open(log_filename, 'at') if log_filename else None

    def close(self):
        if self.log_file:
            self.log_file.close()
            self.log_file = None

    def _strip(self, text):
        for code in (BOLD, UNDERLINE, DIM, RED, GREEN, YELLOW, END_FORMATTING):
            text = text.replace(code, '')
        return text

    def write(self, text, verbosity=1, end='\n'):
        if verbosity <= self.stdout_verbosity_level:
            out = text if self.colours else self._strip(text)
            sys.stdout.write(out + end)
            sys.stdout.flush()
        if self.log_file and verbosity <= self.log_file_verbosity_level:
            self.log_file.write(self._strip(text) + end)
            self.log_file.flush()


logger = Log(log_filename=None, stdout_verbosity_level=1)


def log(text='', verbosity=1, end='\n'):
    logger.write(text, verbosity, end)


def log_section_header(message, verbosity=1):
    """Bold underlined header with a dim timestamp (ref log.py:85-100)."""
    time_str = '(' + datetime.datetime.now().strftime('%Y-%m-%d %H:%M:%S') + ')'
    log('', verbosity)
    log(BOLD + UNDERLINE + message + END_FORMATTING + ' ' + DIM + time_str
        + END_FORMATTING, verbosity)


def log_explanation(text, verbosity=1, extra_empty_lines_after=1):
    """Dim word-wrapped explanation paragraph (ref log.py:123-143)."""
    width = min(shutil.get_terminal_size().columns, 100) - 1
    for line in textwrap.wrap(text, width):
        log(DIM + line + END_FORMATTING, verbosity)
    for _ in range(extra_empty_lines_after):
        log('', verbosity)


def log_number_list(numbers, verbosity=1):
    """Wrapped comma-separated number list (ref log.py:146)."""
    width = min(shutil.get_terminal_size().columns, 100) - 1
    text = ', '.join(str(n) for n in numbers)
    for line in textwrap.wrap(text, width, initial_indent='  ',
                              subsequent_indent='  '):
        log(line, verbosity)


def log_progress(fraction, message, verbosity=1):
    """Carriage-return progress line (ref log.py:103-120)."""
    if verbosity <= logger.stdout_verbosity_level:
        sys.stdout.write('\r' + message + ' ' + ('%.1f' % (100.0 * fraction)) + '%')
        sys.stdout.flush()
