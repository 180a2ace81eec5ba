'''The unstructured topology of the PyTorch port against nutils_tpu:
``unitsquare(n, 'triangle')`` and ``'mixed'`` at 4 and 5 elements a side.
Vertex and element tables, connectivity, boundary groups, basis dofs and
coefficients, and sample points and weights agree exactly: they are the
same host numpy arithmetic, so a difference is a difference in numbering.'''

import numpy
import pytest

from nutils_tpu import element as element_jax
from nutils_tpu import function as function_jax
from nutils_tpu import mesh as mesh_jax
from nutils_tpu_torch import element as element_torch
from nutils_tpu_torch import function as function_torch
from nutils_tpu_torch import mesh as mesh_torch
from nutils_tpu_torch.utils import config

CASES = [(etype, n) for etype in ('triangle', 'mixed') for n in (4, 5)]


@pytest.fixture(scope='module', params=CASES, ids=[f'{e}{n}' for e, n in CASES])
def meshes(request):
    etype, n = request.param
    with config.device('cpu'):
        return mesh_jax.unitsquare(n, etype), mesh_torch.unitsquare(n, etype)


def test_vertex_and_element_tables(meshes):
    (tj, _gj), (tt, _gt) = meshes
    pj, pt = tj.parent, tt.parent
    assert pj.nverts == pt.nverts and len(pj) == len(pt)
    assert [type(r).__name__ for r in pj._refs] == [type(r).__name__ for r in pt._refs]
    assert all(numpy.array_equal(a, b) for a, b in zip(pj._elem_verts, pt._elem_verts))
    assert [(type(r).__name__, ids.tolist()) for r, ids in pj._buckets] == \
        [(type(r).__name__, ids.tolist()) for r, ids in pt._buckets]


def test_connectivity_and_boundary(meshes):
    (tj, _gj), (tt, _gt) = meshes
    pj, pt = tj.parent, tt.parent
    assert len(pj.connectivity) == len(pt.connectivity)
    assert all(numpy.array_equal(a, b) for a, b in zip(pj.connectivity, pt.connectivity))
    assert pj._boundary_edges == pt._boundary_edges
    for name in ('left', 'right', 'top', 'bottom'):
        assert tj.boundary[name]._edges == tt.boundary[name]._edges, name


@pytest.mark.parametrize('btype,degree', [('std', 1), ('std', 2), ('std', 3), ('lagrange', 2)])
def test_basis_dofs_and_coefficients(meshes, btype, degree):
    (tj, _gj), (tt, _gt) = meshes
    bj, bt = tj.basis(btype, degree=degree), tt.basis(btype, degree=degree)
    assert bj.ndofs == bt.ndofs
    for _ref, ids in tj.parent._buckets:
        (dj, cj), (dt, ct) = bj.get_tables(ids), bt.get_tables(ids)
        assert numpy.array_equal(dj, dt)
        assert numpy.array_equal(numpy.asarray(cj), numpy.asarray(ct))


def test_sample_points_and_weights(meshes):
    (tj, _gj), (tt, _gt) = meshes
    sj, st = tj.sample('gauss', 6), tt.sample('gauss', 6)
    parts_j = getattr(sj, 'samples', [sj])
    parts_t = getattr(st, 'samples', [st])
    assert len(parts_j) == len(parts_t)
    for a, b in zip(parts_j, parts_t):
        assert a.batch_key == b.batch_key
        assert numpy.array_equal(a.weights, b.weights)
        assert numpy.array_equal(a.specs[0].coords, b.specs[0].coords)
        assert numpy.array_equal(a.specs[0].index, b.specs[0].index)


def test_geometry_and_boundary_integrals(meshes):
    # the geometry is the JAX package's: the area and the length of every
    # named boundary group
    (tj, gj), (tt, gt) = meshes
    with config.device('cpu'):
        assert float(tt.integrate(function_torch.J(gt), degree=2)) == pytest.approx(1, rel=1e-13)
        xt = tt.sample('bezier', 2).eval(gt)
        for name in ('left', 'right', 'top', 'bottom'):
            length = tt.boundary[name].integrate(function_torch.J(gt), degree=1)
            assert float(length) == pytest.approx(1, rel=1e-13), name
    xj = tj.sample('bezier', 2).eval(gj)
    assert numpy.allclose(numpy.asarray(xt), numpy.asarray(xj), rtol=0, atol=1e-15)
    assert float(tj.integrate(function_jax.J(gj), degree=2)) == pytest.approx(1, rel=1e-13)


def test_coefficient_tables_are_computed_once():
    # one table per (reference type, degree), read-only, equal to the JAX
    # package's per-element result
    for make in (lambda m: m.simplex(2), lambda m: m.hypercube(2)):
        ref_t, ref_t2, ref_j = make(element_torch), make(element_torch), make(element_jax)
        for degree in (1, 2, 3):
            for name in ('bernstein_coeffs', 'lagrange_coeffs'):
                a = getattr(element_torch, name)(ref_t, degree)
                assert a is getattr(element_torch, name)(ref_t2, degree)
                assert not a.flags.writeable
                assert numpy.array_equal(a, getattr(element_jax, name)(ref_j, degree))


def test_unported_parts_name_their_roadmap_item():
    # the parts that raised "not ported yet (ROADMAP A6)" until the A6
    # remainder landed: the bubble basis, locate on an unstructured and on a
    # hierarchical topology, and unitsquare(..., 'multipatch'), each now
    # against the JAX package
    points = numpy.array([[.1, .2], [.55, .45], [.9, .05], [.3, .8]])
    with config.device('cpu'):
        (tt, gt), (tj, gj) = mesh_torch.unitsquare(2, 'triangle'), mesh_jax.unitsquare(2, 'triangle')
        bt, bj = tt.basis('bubble'), tj.basis('bubble')
        assert bt.ndofs == bj.ndofs == 9 + 8
        st, sj = tt.sample('gauss', 3), tj.sample('gauss', 3)
        assert numpy.allclose(numpy.asarray(st.eval(bt)), numpy.asarray(sj.eval(bj)), rtol=0, atol=1e-14)
        for make in (lambda t: t, lambda t: t.refined_by([0, 3])):
            lt, lj = make(tt).locate(gt, points, tol=1e-12), make(tj).locate(gj, points, tol=1e-12)
            assert numpy.allclose(numpy.asarray(lt.eval(gt)), points, rtol=0, atol=1e-12)
            assert numpy.allclose(numpy.asarray(lt.eval(bt)), numpy.asarray(lj.eval(bj)), rtol=0, atol=1e-12)
        (mt, gmt), (mj, gmj) = mesh_torch.unitsquare(2, 'multipatch'), mesh_jax.unitsquare(2, 'multipatch')
        assert len(mt) == len(mj) == 20
        xt = numpy.asarray(mt.sample('gauss', 2).eval(gmt))
        assert numpy.allclose(xt, numpy.asarray(mj.sample('gauss', 2).eval(gmj)), rtol=0, atol=1e-14)
        for side in ('bottom', 'top', 'left', 'right'):
            length = float(mt.boundary[side].integrate(function_torch.J(gmt), degree=2))
            assert length == pytest.approx(float(mj.boundary[side].integrate(function_jax.J(gmj), degree=2)),
                                           rel=1e-14) and length == pytest.approx(1, rel=1e-13)
