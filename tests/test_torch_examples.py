'''The examples' own regression tests through the PyTorch port.

Each case runs one ``test`` method of an example in a subprocess, in a
temporary directory, on the CPU.  The subprocess maps ``nutils_tpu`` and its
submodules to ``nutils_tpu_torch`` in ``sys.modules`` before it imports the
example, so the files under ``examples/`` and their regression data stay as
they are, and asserts afterwards that no ``jax`` module was loaded.

    python -m pytest tests/test_torch_examples.py -m slow -q
    python tests/test_torch_examples.py laplace test_simple   # one case
'''

import os
import subprocess
import sys
import tempfile

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))

# (example, test method): every test method of the 13 examples
CASES = [
    ('laplace', 'test_simple'), ('laplace', 'test_mixed'), ('laplace', 'test_spline'),
    ('poisson', 'test_simple'),
    ('elasticity', 'test_simple'), ('elasticity', 'test_mixed'), ('elasticity', 'test_quadratic'),
    ('elasticity', 'test_poisson'),
    ('finitestrain', 'test_simple'), ('finitestrain', 'test_mixed'), ('finitestrain', 'test_spline'),
    ('cylinderflow', 'test_rot0'), ('cylinderflow', 'test_rot1'),
    ('platewithhole', 'test_spline'), ('platewithhole', 'test_mixed'), ('platewithhole', 'test_nurbs0'),
    ('platewithhole', 'test_nurbs2'),
    ('drivencavity', 'test_baseline'), ('drivencavity', 'test_strong'), ('drivencavity', 'test_compatible'),
    ('burgers', 'test_1d_p0'), ('burgers', 'test_1d_p1'), ('burgers', 'test_1d_p2'),
    ('burgers', 'test_1d_p1_legendre'), ('burgers', 'test_1d_p2_legendre'),
    ('torsion', 'test_torque'), ('torsion', 'test_stretch'),
    ('adaptivity', 'test_square_quadratic'), ('adaptivity', 'test_triangle_quadratic'),
    ('adaptivity', 'test_mixed_linear'),
    ('cahnhilliard', 'test_initial'), ('cahnhilliard', 'test_square'), ('cahnhilliard', 'test_multipatchcircle'),
    ('coil', 'test_dc'), ('coil', 'test_ac_5'),
    ('turek', 'test_csm'), ('turek', 'test_dyncsm'), ('turek', 'test_dyncfd'), ('turek', 'test_dynfsi'),
]

_SCRIPT = r'''
import importlib, pkgutil, sys, unittest
root, example, method = sys.argv[1:4]
sys.path.insert(0, root)
import nutils_tpu_torch
sys.modules['nutils_tpu'] = nutils_tpu_torch
for info in pkgutil.walk_packages(nutils_tpu_torch.__path__, 'nutils_tpu_torch.'):
    mod = importlib.import_module(info.name)
    sys.modules['nutils_tpu' + info.name[len('nutils_tpu_torch'):]] = mod
sys.path.insert(0, root + '/examples')
mod = importlib.import_module(example)
cases = [getattr(mod, n) for n in dir(mod)
         if isinstance(getattr(mod, n), type) and issubclass(getattr(mod, n), unittest.TestCase)
         and method in vars(getattr(mod, n))]
assert len(cases) == 1, f'{example}.{method}: {len(cases)} test classes'
result = unittest.TextTestRunner(verbosity=0).run(cases[0](method))
jax = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))
assert not jax, f'jax was imported: {jax[:5]}'
sys.exit(0 if result.wasSuccessful() else 1)
'''


def run_case(example, method, timeout=900):
    '''Run one example test method through the port; the finished process.'''
    env = dict(os.environ, NUTILS_TPU_TORCH_DEVICE='cpu', PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        return subprocess.run([sys.executable, '-c', _SCRIPT, ROOT, example, method], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=timeout, check=False)


@pytest.mark.slow
@pytest.mark.parametrize('example,method', CASES, ids=[f'{e}-{m}' for e, m in CASES])
def test_example_through_the_port(example, method):
    out = run_case(example, method)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-8000:]


if __name__ == '__main__':
    proc = run_case(*sys.argv[1:3])
    print(proc.stdout[-4000:], proc.stderr[-8000:])
    sys.exit(proc.returncode)
