"""A cell's files, found by the names in BENCHMARK.json:

- configs/<config>.json, the configuration (its `file` entry);
- traffic/<traffic>.json, the traffic mix, which names its stage;
- stages/<stage>.py, the set-up, the job and the check of an entry;
- end_to_end/<metric>.py and layer_metrics/<metric>.py, one reader per
  metric, with a function read(run) that returns the value or None.

Adding a configuration, a cell or a metric adds files and entries; no
file here names one.
"""

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DIR = 'perfbench'


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell(object):
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name, bench=None, root=ROOT):
        bench = bench or load_json(os.path.join(root, 'BENCHMARK.json'))
        self.here = here = os.path.join(root, DIR)
        cells = {w['name']: w for w in bench['workloads']}
        if name not in cells:
            raise SystemExit('error: no workload %r in BENCHMARK.json (%s)'
                             % (name, ', '.join(sorted(cells))))
        self.name = name
        self.workload = cells[name]
        self.chips = self.workload['chips']
        configs = {c['name']: c for c in bench['configs']}
        self.config_entry = configs[self.workload['config']]
        self.config = load_json(os.path.join(root,
                                             self.config_entry['file']))
        self.traffic = load_json(os.path.join(
            here, 'traffic', self.workload['traffic'] + '.json'))
        self.stage_path = os.path.join(here, 'stages',
                                       self.traffic['stage'] + '.py')
        self.end_to_end = [m for m in bench['end_to_end'] if applies(m, name)]
        reported = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in bench['per_layer']
                          if applies(m, name) and m['moves'] in reported]

    def stage(self):
        return load_module(self.stage_path, 'stage_' + self.traffic['stage'])

    def readers(self, kind):
        """{metric name: read function} of 'end_to_end' or 'layer_metrics'."""
        metrics = self.end_to_end if kind == 'end_to_end' else self.per_layer
        return {m['name']: load_module(
            os.path.join(self.here, kind, m['name'] + '.py'),
            'metric_' + m['name'].replace('.', '_').replace('-', '_')).read
            for m in metrics}


def applies(metric, cell):
    """A metric with a `workloads` list is read in those cells; one without
    in every cell that reports what it moves."""
    return cell in metric.get('workloads', [cell])
