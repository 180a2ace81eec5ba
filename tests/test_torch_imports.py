'''The PyTorch port imports and solves without jax or nutils_tpu, and never
moves to the CPU by itself.'''

import os
import subprocess
import sys

import pytest
import torch

_SCRIPT = '''
import sys
import numpy
import nutils_tpu_torch
from nutils_tpu_torch import function, mesh
from nutils_tpu_torch.solver import System
from nutils_tpu_torch.utils import config
with config.device('cpu'):
    topo, geom = mesh.unitsquare(8, 'square')
    u = topo.field('u', btype='std', degree=1)
    g = function.grad(u, geom)
    f = function.sin(geom[0]) * function.cosh(geom[1])
    energy = topo.integral(((g @ g) / 2 + (u * u) / 2 - f * u) * function.J(geom), degree=2)
    jac, res = System(energy, trial='u').assemble_jacobian_residual({'u': numpy.zeros(81)})
    x = jac.solve(res, solver='cg', rtol=1e-10)
assert numpy.linalg.norm(res - jac @ x) <= 1e-9 * numpy.linalg.norm(res)
print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'nutils_tpu'
             or m.startswith('nutils_tpu.')))
'''


_NS_SCRIPT = '''
import sys
import numpy
from nutils_tpu_torch import function, mesh
from nutils_tpu_torch.expression import Namespace
from nutils_tpu_torch.solver import System
from nutils_tpu_torch.utils import config
with config.device('cpu'):
    topo, geom = mesh.unitsquare(6, %(etype)r)
    ns = Namespace()
    ns.x = geom
    ns.define_for('x', gradient='∇', jacobians=('dV',))
    ns.u = topo.field('u', btype='std', degree=2, shape=[2])
    ns.p = topo.field('p', btype='std', degree=1)
    ns.v = function.replace_arguments(ns.u, 'u:v')
    ns.q = function.replace_arguments(ns.p, 'p:q')
    ns.δ = function.eye(2)
    ns.u0_i = 'sin(x_0) cos(x_1) δ_i0 - cos(x_0) sin(x_1) δ_i1'
    ns.dt = 0.01
    ns.nu = 0.001
    ns.eps = 0.001
    res = topo.integral('(v_i (u_i - u0_i) / dt + v_i u_j ∇_j(u_i) + nu ∇_j(v_i) ∇_j(u_i)'
                        ' - p ∇_i(v_i) + q ∇_i(u_i) + eps p q) dV' @ ns, degree=6)
    system = System(res, trial='u,p', test='v,q')
    rng = numpy.random.default_rng(0)
    args = {t: 0.1 * rng.standard_normal(s) for t, s in zip(system.trials, system.trial_shapes)}
    jac, res = system.assemble_jacobian_residual(args)
    for method in %(methods)r:
        dx = jac.solve_leniently(res, solver=method, rtol=1e-3)
        assert jac._solve_stats['op_form'] == %(form)r and jac._solve_stats['method'] == method
        assert numpy.linalg.norm(res - jac @ dx) <= 1e-3 * numpy.linalg.norm(res)
print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'nutils_tpu'
             or m.startswith('nutils_tpu.')))
'''


def _run_alone(script):
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.run([sys.executable, '-c', script], capture_output=True, text=True, env=env,
                          cwd=root, timeout=120, check=False)


def test_no_jax_after_a_solve():
    out = _run_alone(_SCRIPT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_no_jax_after_a_navier_stokes_step():
    # the block-grid assembly and the GMRES solve with the Schur diagonal
    out = _run_alone(_NS_SCRIPT % dict(etype='square', methods=['gmres'], form='blockgrid'))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_no_jax_after_a_triangle_navier_stokes_step():
    # the unstructured mesh, the CSR assembly through the value scatter, and
    # the GMRES and BiCGStab solves on the CSR operator
    out = _run_alone(_NS_SCRIPT % dict(etype='triangle', methods=['gmres', 'bicgstab'], form='csr'))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


_HOST_SCRIPT = '''
import sys
import numpy
from nutils_tpu_torch import SI, cli, export, function, hierarchical, mesh, native, testing, trim, unit, warnings
from nutils_tpu_torch.solver import System
from nutils_tpu_torch.utils import config
with config.device('cpu'):
    topo, geom = mesh.unitsquare(6, 'square')
    cut = topo.trim(numpy.linalg.norm(geom) - .5, maxrefine=2, name='hole')
    assert isinstance(cut, trim.TrimmedTopology)
    refined = topo.refined_by([0, 1])
    assert isinstance(refined, hierarchical.HierarchicalTopology)
    u = function.dotarg('u', cut.basis('std', degree=1))
    sqr = cut.integral((u - geom[0]) ** 2 * function.J(geom), degree=2)
    args = System(sqr, trial='u').solve()
    export.vtk('out', cut.sample('bezier', 2).tri, cut.sample('bezier', 2).eval(geom), u=cut.sample('bezier', 2).eval(u, args))
    assert SI.parse('2m') == SI.Length('2m')
print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'nutils_tpu'
             or m.startswith('nutils_tpu.') or m.startswith('matplotlib')))
'''


def test_no_jax_after_a_trimmed_and_refined_topology(tmp_path):
    # the new host modules: trimming, hierarchical refinement, the native
    # pattern builder, SI, unit, warnings, export (its VTK writer, which
    # needs no matplotlib), testing and cli
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
    out = subprocess.run([sys.executable, '-c', _HOST_SCRIPT], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root), cwd=tmp_path, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


_MULTIPATCH_SCRIPT = '''
import sys
import numpy
from nutils_tpu_torch import cache, expression_v1, function, mesh, multipatch, trimesh, unstructured
from nutils_tpu_torch.utils import config
with config.device('cpu'):
    topo, geom = mesh.unitcircle(2, 'multipatch')
    assert len(topo) == 5 * 2 * 2 and isinstance(topo.basis('patch'), function.Array)
    smp = topo.locate(geom, numpy.array([[0., 0.], [.3, -.2]]), tol=1e-10)
    assert numpy.allclose(smp.eval(geom), [[0., 0.], [.3, -.2]], atol=1e-10)
    tri, _ = mesh.unitsquare(2, 'triangle')
    assert tri.basis('bubble').ndofs == 17
    w, _v = function.eig(function.asarray(numpy.array([[0., 1.], [-1., 0.]])))
    assert numpy.allclose(sorted(function.eval(w).imag), [-1, 1])
    ns = expression_v1.Namespace()
    ns.x = geom
print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'nutils_tpu'
             or m.startswith('nutils_tpu.') or m == 'triton'))
'''


def test_no_jax_after_multipatch_locate_and_eig(tmp_path):
    # the modules of the A6 remainder and A8: multipatch, point location,
    # the rest of mesh, trimesh, expression_v1, cache, the general eig
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
    out = subprocess.run([sys.executable, '-c', _MULTIPATCH_SCRIPT], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root), cwd=tmp_path, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_precision_is_pinned():
    import nutils_tpu_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == 'highest'


def test_cuda_default_raises_without_a_card():
    from nutils_tpu_torch.utils import config
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with config.device('cuda'), pytest.raises(RuntimeError, match='cuda'):
        config.torch_device()
