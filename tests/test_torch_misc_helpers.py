"""The port's copies of the JAX package's remaining misc.py and log.py
helpers (formatting, random bases, ranges, SPAdes version parsing, code
reverse complement, explanation and progress writers), each called with
the same arguments in both packages; outputs must be equal exactly."""

import io
import random
from contextlib import redirect_stdout

import numpy as np
import pytest

import torch_parity  # noqa: F401

from unicycler_tpu import log as jlog
from unicycler_tpu import misc as jmisc

from unicycler_tpu_torch import log as tlog
from unicycler_tpu_torch import misc as tmisc

TEXT = 'Overlap removal: 3 links'
CASES = [
    ('colour', (TEXT, 'bold_red')), ('colour', (TEXT, 'green underline')),
    ('colour', (TEXT, 'yellow')), ('colour', (TEXT, 'dim')),
    ('colour', (TEXT, 'blue')), ('green', (TEXT,)), ('bold_green', (TEXT,)),
    ('red', (TEXT,)), ('magenta', (TEXT,)), ('bold_red', (TEXT,)),
    ('bold', (TEXT,)), ('bold_underline', (TEXT,)), ('underline', (TEXT,)),
    ('dim', (TEXT,)), ('dim_underline', (TEXT,)), ('bold_yellow', (TEXT,)),
    ('bold_yellow_underline', (TEXT,)), ('bold_red_underline', (TEXT,)),
    ('remove_formatting', ('\033[31m\033[1m' + TEXT + '\033[0m',)),
    ('len_without_format', ('\033[2m' + TEXT + '\033[0m',)),
    ('len_without_format', (12345,)),
    ('complement_base', ('A',)), ('complement_base', ('k',)),
    ('complement_base', ('N',)),
    ('ranges_overlap', ([(0, 10), (20, 30)], [(9, 12)])),
    ('ranges_overlap', ([(0, 10)], [(10, 12), (40, 50)])),
    ('total_range_length', ([(0, 10), (5, 15), (30, 20)],)),
    ('total_range_length', ([],)),
    ('round_to_nearest_odd', (4.0,)), ('round_to_nearest_odd', (6.4,)),
    ('round_to_nearest_odd', (7.0,)), ('round_to_nearest_odd', (-2.5,)),
    ('spades_version_from_spades_output', ('SPAdes genome assembler '
                                           'v3.15.5\n',)),
    ('spades_version_from_spades_output', ('SPAdes v.3.13.0',)),
    ('spades_version_from_spades_output', ('version 4.0.0 build',)),
    ('spades_version_from_spades_output', ('no version here',)),
    ('spades_status_from_version', ('2.5.1',)),
    ('spades_status_from_version', ('3.13.1',)),
    ('spades_status_from_version', ('3.15.5',)),
    ('spades_status_from_version', ('5.0.0',)),
]


@pytest.mark.parametrize('name,args', CASES,
                         ids=['%s-%d' % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_misc_helper_matches_jax(name, args):
    assert getattr(tmisc, name)(*args) == getattr(jmisc, name)(*args)


def test_constants_match_jax():
    assert tmisc.MAGENTA == jmisc.MAGENTA


@pytest.mark.parametrize('name,args', [('get_random_base', ()),
                                       ('get_random_sequence', (50,))])
def test_random_helpers_match_jax(name, args):
    random.seed(11)
    want = [getattr(jmisc, name)(*args) for _ in range(5)]
    random.seed(11)
    assert [getattr(tmisc, name)(*args) for _ in range(5)] == want


def test_np_revcomp_codes_matches_jax():
    codes = np.random.default_rng(2).integers(0, 5, 200).astype(np.int8)
    got = tmisc.np_revcomp_codes(codes)
    want = jmisc.np_revcomp_codes(codes)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _captured(log_mod, fn, *args, **kwargs):
    saved = log_mod.logger
    log_mod.logger = log_mod.Log(log_filename=None, stdout_verbosity_level=2)
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            getattr(log_mod, fn)(*args, **kwargs)
    finally:
        log_mod.logger = saved
    return out.getvalue()


@pytest.mark.parametrize('fn,args,kwargs', [
    ('log_explanation', (' '.join(['word'] * 60),), {}),
    ('log_explanation', ('short', 1), {'extra_empty_lines_after': 2}),
    ('log_explanation', ('hidden', 3), {}),
    ('log_progress', (0.4567, 'Aligning reads:'), {}),
    ('log_progress', (1.0, 'Done', 3), {}),
])
def test_log_writers_match_jax(fn, args, kwargs):
    want = _captured(jlog, fn, *args, **kwargs)
    assert _captured(tlog, fn, *args, **kwargs) == want
