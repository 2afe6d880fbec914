"""Tiny cells for the CPU tests: a copy of the benchmark's folder under a
temporary root, with small configurations and traffic added as files."""

import copy
import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def tree(tmp_path):
    """A root holding a copy of perfbench/ (without caches); returns its
    path."""
    root = str(tmp_path)
    shutil.copytree(HERE, os.path.join(root, 'perfbench'),
                    ignore=shutil.ignore_patterns('.cache', '__pycache__',
                                                  'tests'))
    return root


def add_cell(root, b, name, config, traffic, base_cell='align.bact5m',
             inherit=True):
    """Write configs/<name>.json and traffic/<name>.json and add the
    configuration and a cell `name` (with every per-layer metric of
    base_cell where `inherit`) to the bench dict b."""
    here = os.path.join(root, 'perfbench')
    with open(os.path.join(here, 'configs', name + '.json'), 'w') as f:
        json.dump(config, f)
    with open(os.path.join(here, 'traffic', name + '.json'), 'w') as f:
        json.dump(traffic, f)
    b['configs'].append(dict(b['configs'][0], name=name,
                             file='perfbench/configs/%s.json' % name))
    base = [w for w in b['workloads'] if w['name'] == base_cell][0]
    b['workloads'].append(dict(base, name=name, config=name, traffic=name))
    for m in b['per_layer'] if inherit else []:
        if base_cell in m.get('workloads', [base_cell]) and 'workloads' in m:
            m['workloads'].append(name)
    return b


def tiny_align(depth=0.15, replicons=(30000, 6000), n50=1500,
               max_len=3000, sample=3, families=((600, 2, 60),)):
    """(config, traffic) of align.bact5m cut to a CPU test."""
    with open(os.path.join(HERE, 'configs', 'bact5m-align.json')) as f:
        config = json.load(f)
    with open(os.path.join(HERE, 'traffic', 'align.json')) as f:
        traffic = json.load(f)
    config = dict(config, replicons=list(replicons), depth=depth,
                  repeat_families=[list(f) for f in families])
    traffic = copy.deepcopy(traffic)
    traffic['reads'].update(n50=n50, max_len=max_len)
    traffic['check'].update(sample_reads=sample, block_cells=6000)
    return config, traffic
