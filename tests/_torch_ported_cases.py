'''The JAX package's own test cases through the PyTorch port: a test module
of ``tests/`` read with ``nutils_tpu`` replaced by ``nutils_tpu_torch``,
its ``test_*`` functions expanded over their ``parametrize`` marks and run
with their fixtures on the CPU.  Holds no tests.'''

import inspect
import itertools
import pathlib
import sys
import types

TESTS = pathlib.Path(__file__).resolve().parent
_MODULES = {}


def port_module(name):
    '''Test module ``name`` of ``tests/`` with the port in place of the JAX
    package (loaded once, registered in ``sys.modules`` under its own name
    with a ``_torch_port_`` prefix).'''
    mod = _MODULES.get(name)
    if mod is None:
        src = (TESTS / f'{name}.py').read_text().replace('nutils_tpu', 'nutils_tpu_torch')
        modname = f'_torch_port_{name}'
        mod = types.ModuleType(modname)
        mod.__file__ = str(TESTS / f'{name}.py')
        sys.modules[modname] = mod
        exec(compile(src, f'{name}.py (through nutils_tpu_torch)', 'exec'), mod.__dict__)
        _MODULES[name] = mod
    return mod


def _params(fn):
    '''[(id, kwargs)] of a test function's parametrize marks (their
    product), or one case without arguments.'''
    axes = []
    for mark in reversed(getattr(fn, 'pytestmark', [])):
        if mark.name != 'parametrize':
            continue
        names, values = mark.args[:2]
        names = [n.strip() for n in names.split(',')] if isinstance(names, str) else list(names)
        rows = []
        for v in values:
            v = getattr(v, 'values', v)  # pytest.param
            v = v if len(names) > 1 else (v,)
            rows.append(dict(zip(names, v)))
        axes.append(rows)
    out = []
    for combo in itertools.product(*axes):
        kw = {}
        for part in combo:
            kw.update(part)
        out.append(('-'.join(str(v) for v in kw.values()), kw))
    return out or [('', {})]


def cases(name, select=None, exclude=()):
    '''[(test id, module name, function name, kwargs)] of the test
    functions of module ``name`` (those named in ``select`` where given,
    none named in ``exclude``).'''
    mod = port_module(name)
    out = []
    for fname, fn in vars(mod).items():
        if not fname.startswith('test_') or not callable(fn) or fname in exclude \
                or (select is not None and fname not in select):
            continue
        for pid, kw in _params(fn):
            out.append((f'{name}::{fname}' + (f'[{pid}]' if pid else ''), name, fname, kw))
    return out


def run(name, fname, kwargs, builtins):
    '''Run test function ``fname`` of module ``name`` through the port with
    the parametrized ``kwargs``; its other arguments from the module's
    fixtures or ``builtins`` (pytest's ``tmp_path``, ``monkeypatch``).'''
    from nutils_tpu_torch.utils import config
    mod = port_module(name)
    made = {}

    def value(arg):
        if arg in kwargs:
            return kwargs[arg]
        if arg in builtins:
            return builtins[arg]
        if arg not in made:
            fix = getattr(mod, arg)
            f = fix._get_wrapped_function()
            made[arg] = f(*[value(a) for a in inspect.signature(f).parameters])
            if inspect.isgenerator(made[arg]):
                made[arg] = next(made[arg])
        return made[arg]

    fn = getattr(mod, fname)
    with config.device('cpu'):
        fn(*[value(a) for a in inspect.signature(fn).parameters])
