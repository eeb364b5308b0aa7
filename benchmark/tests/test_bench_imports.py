"""Nothing the harness or the references import is JAX or the JAX
package; the references import nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _loaded(modules):
    code = ('import sys; sys.path.insert(0, %r)\n' % str(ROOT)
            + ''.join(f'import {m}\n' for m in modules)
            + 'print(sorted({m.split(".")[0] for m in sys.modules}))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(ast.literal_eval(out.strip().splitlines()[-1]))


def _modules(folder, package):
    return [f'{package}.{p.stem}' for p in sorted(folder.glob('*.py'))
            if p.stem != '__init__']


def test_harness_loads_no_jax():
    mods = (_modules(BENCH, 'benchmark')
            + _modules(BENCH / 'drivers', 'benchmark.drivers')
            + ['glenet_tpu_torch.models.detectors',
               'glenet_tpu_torch.train.state'])
    mods.remove('benchmark.conftest')
    assert not _loaded(mods) & set(harness.FORBIDDEN)


def test_references_load_no_program():
    loaded = _loaded(_modules(BENCH / 'reference', 'benchmark.reference'))
    assert not loaded & (set(harness.FORBIDDEN) | {'glenet_tpu_torch'})


def test_reference_sources_name_no_program():
    for path in (BENCH / 'reference').glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            for n in names:
                assert n.split('.')[0] not in (set(harness.FORBIDDEN)
                                               | {'glenet_tpu_torch'}), path
