'''The host modules of the PyTorch port that the examples import
(``SI``, ``unit``, ``warnings``, ``export``, ``testing``, ``cli``,
``expression_v1``, ``cache``): the cases of ``tests/test_SI_matrix.py``,
``tests/test_SI_export.py``, ``tests/test_cli_harness.py`` and
``tests/test_export.py`` that draw no figure, and those of
``tests/test_expression_v1.py`` and ``tests/test_cache.py``, through the
port; and the same quantities, VTK files and packed
regression data through both packages.'''

import numpy
import pytest

import _torch_ported_cases as pc

PLOTS = ('test_triplot_png', 'test_vtk_3d', 'test_triplot_filename', 'test_triplot_axes_mode',
         'test_triplot_rejects_bad_points', 'test_plotlines_both_orientations')
CASES = pc.cases('test_SI_matrix') + pc.cases('test_SI_export', exclude=PLOTS) \
    + pc.cases('test_cli_harness') + pc.cases('test_export', exclude=PLOTS) \
    + pc.cases('test_expression_v1') + pc.cases('test_cache')


@pytest.mark.parametrize('name,fname,kwargs', [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_jax_case_through_the_port(name, fname, kwargs, tmp_path, monkeypatch):
    pc.run(name, fname, kwargs, {'tmp_path': tmp_path, 'monkeypatch': monkeypatch})


@pytest.mark.parametrize('text', ['9.81m/s2', '2.5kN*m', '1.2GPa', '300K', '4km/h'])
def test_si_parse_as_the_jax_package(text):
    from nutils_tpu import SI as SIj
    from nutils_tpu_torch import SI
    got, want = SI.parse(text), SIj.parse(text)
    assert type(got).__name__ == type(want).__name__
    assert float(numpy.asarray(got.unwrap() if hasattr(got, 'unwrap') else got)) == \
        float(numpy.asarray(want.unwrap() if hasattr(want, 'unwrap') else want))


def test_vtk_bytes_as_the_jax_package(tmp_path):
    from nutils_tpu import export as exportj
    from nutils_tpu_torch import export
    rng = numpy.random.default_rng(0)
    points = rng.standard_normal((6, 2))
    tri = numpy.array([[0, 1, 2], [2, 3, 4], [3, 4, 5]])
    data = dict(u=rng.standard_normal(6), v=rng.standard_normal((3, 2)))
    export.vtk(str(tmp_path / 'port'), tri, points, **data)
    exportj.vtk(str(tmp_path / 'jax'), tri, points, **data)
    assert (tmp_path / 'port.vtk').read_bytes() == (tmp_path / 'jax.vtk').read_bytes()


@pytest.mark.parametrize('seed', [0, 1])
def test_packed_data_as_the_jax_package(seed):
    from nutils_tpu_torch import testing
    from nutils_tpu_torch.utils import numeric
    from nutils_tpu.utils import numeric as numericj
    a = numpy.random.default_rng(seed).standard_normal(40) * 10.0 ** numpy.arange(-8, 12, .5)
    packed = numeric.base64_pack(a, 2e-15, 2e-3, 'int16')
    assert packed == numericj.base64_pack(a, 2e-15, 2e-3, 'int16')
    case = testing.TestCase()
    case.assertAlmostEqual64(a, packed)
    with pytest.raises(AssertionError):
        case.assertAlmostEqual64(a * 1.01, packed)
