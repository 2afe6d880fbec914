"""A configuration, a cell, a stage and metrics dropped in as new files
are found by name, with no file of the harness edited."""

import json
import os

import pytest

import cells

DUMMY_STAGE = '''
class Stage(object):
    def __init__(self, cell):
        self.cell = cell
        self.n = 0

    def setup(self):
        self.size = self.cell['config']['size']

    def job(self, i):
        self.n += 1
        return self.size * self.cell['traffic']['per_job']

    def claims(self):
        return self.n

    def release(self):
        pass

    def info(self):
        return {'jobs': self.n}

    def check(self, claims):
        return [('jobs_seen', 0 if claims == self.n else 1, 0)]
'''

DUMMY_METRIC = '''
def read(run):
    return float(len(run.jobs))
'''


def _dummy(tmp_path):
    root = cells.tree(tmp_path)
    here = os.path.join(root, 'perfbench')
    with open(os.path.join(here, 'stages', 'dummy_entry.py'), 'w') as f:
        f.write(DUMMY_STAGE)
    for kind in ('layer_metrics', 'end_to_end'):
        with open(os.path.join(here, kind, 'jobs_done.%s.py' % kind),
                  'w') as f:
            f.write(DUMMY_METRIC)
    b = cells.bench()
    cells.add_cell(root, b, 'dummy-cfg', {'size': 5000},
                   {'stage': 'dummy_entry', 'per_job': 3}, inherit=False)
    b['end_to_end'].append({'name': 'jobs_done.end_to_end', 'unit': 'jobs',
                            'better': 'higher', 'bound': 0.1,
                            'source': 'host_clock',
                            'workloads': ['dummy-cfg']})
    b['per_layer'].append({'name': 'jobs_done.layer_metrics',
                           'unit': 'jobs', 'better': 'higher',
                           'source': 'program_counter', 'layer': 'dummy',
                           'moves': 'read_kbp_per_s',
                           'workloads': ['dummy-cfg']})
    return root, b


def test_dummy_cell_and_metrics_are_found(tmp_path):
    from harness import spec
    root, b = _dummy(tmp_path)
    cell = spec.Cell('dummy-cfg', b, root)
    assert cell.config == {'size': 5000}
    assert cell.traffic['stage'] == 'dummy_entry'
    assert hasattr(cell.stage(), 'Stage')
    assert 'jobs_done.end_to_end' in cell.readers('end_to_end')
    assert 'read_kbp_per_s' in cell.readers('end_to_end')
    layer = cell.readers('layer_metrics')
    assert 'jobs_done.layer_metrics' in layer
    # metrics that list other cells are not read here
    assert 'roofline.wave' not in layer


@pytest.mark.parametrize('trace', [0, 1])
def test_dummy_cell_runs(tmp_path, trace):
    import run
    root, b = _dummy(tmp_path)
    code, res = run.main(['--workload', 'dummy-cfg', '--seed', str(2 ** 40),
                          '--seconds', '0.05', '--trace', str(trace)],
                         device='cpu', bench=b, root=root)
    assert code == 0 and res['correct']
    assert list(res)[-1] == 'checks'
    name = 'jobs_done.layer_metrics' if trace else 'jobs_done.end_to_end'
    assert res['metrics'][name]['value'] == res['attempted'] >= 1
    if not trace:
        assert res['metrics']['read_kbp_per_s']['value'] > 0
        json.dumps(res)


def test_unknown_workload_is_refused():
    from harness import spec
    with pytest.raises(SystemExit):
        spec.Cell('no.such.cell', cells.bench())
