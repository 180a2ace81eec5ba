'''Disk memoization of expensive pure functions.

A copy of ``nutils_tpu.cache``, the counterpart of the reference's cache
module (reference: cache.py): ``@cache.function`` hashes the function
identity and its arguments and reuses a pickled result from the cache
directory when enabled; ``System.solve`` memoizes its result the same way.
Enable by setting the ``NUTILS_TPU_CACHE`` environment variable to a
directory, or with the :func:`enable` context manager.
'''

import contextlib
import functools
import hashlib
import os
import pickle

from .utils import _log as log

_cachedir = [os.environ.get('NUTILS_TPU_CACHE') or None]


@contextlib.contextmanager
def enable(directory):
    '''Enable disk caching within the context.'''
    old = _cachedir[0]
    _cachedir[0] = directory
    try:
        yield
    finally:
        _cachedir[0] = old


@contextlib.contextmanager
def disable():
    old = _cachedir[0]
    _cachedir[0] = None
    try:
        yield
    finally:
        _cachedir[0] = old


def _digest(func, args, kwargs):
    h = hashlib.sha1()
    h.update(f'{func.__module__}.{func.__qualname__}'.encode())
    try:
        payload = pickle.dumps((args, sorted(kwargs.items())), protocol=4)
    except Exception:
        return None
    h.update(payload)
    return h.hexdigest()


def function(func):
    '''Memoize ``func`` on disk when caching is enabled.  Arguments must be
    picklable; unpicklable calls fall through to a plain call.

    >>> import tempfile
    >>> from nutils_tpu_torch import cache
    >>> calls = []
    >>> @cache.function
    ... def slow(x):
    ...     calls.append(x)
    ...     return x * x
    >>> with tempfile.TemporaryDirectory() as tmp:
    ...     with cache.enable(tmp):
    ...         a = slow(3)   # computed, stored
    ...         b = slow(3)   # replayed from disk
    >>> (a, b, calls)
    (9, 9, [3])
    '''

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        cachedir = _cachedir[0]
        if not cachedir:
            return func(*args, **kwargs)
        key = _digest(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        path = os.path.join(cachedir, func.__qualname__ + '-' + key)
        if os.path.exists(path):
            try:
                with open(path, 'rb') as f:
                    value = pickle.load(f)
                log.info(f'cache hit: {func.__qualname__}')
                return value
            except Exception:
                pass
        value = func(*args, **kwargs)
        try:
            os.makedirs(cachedir, exist_ok=True)
            tmp = path + '.tmp'
            with open(tmp, 'wb') as f:
                pickle.dump(value, f, protocol=4)
            os.replace(tmp, path)
        except Exception:
            pass
        return value
    return wrapper


class Recursion:
    '''Memoized iterator with fixed recursion length (reference: cache.py:251).

    Subclass as ``class Sub(Recursion, length=n)`` and implement
    ``resume(history)`` (or ``resume_index(history, index)``): ``history``
    holds the last ``length`` items already produced (possibly fewer when
    resuming early in the sequence) and the method yields the remaining items.
    With caching enabled, every yielded item is pickled to
    ``<cachedir>/<class>-<digest>/NNNN``; re-iterating replays the cached
    items and *resumes* computation from the last valid file with the trailing
    history — the reference's checkpoint/resume mechanism for time-stepping
    loops.  Iterating an instance always starts the sequence from scratch.
    '''

    length = 1

    def __init_subclass__(cls, *, length=None, **kwargs):
        super().__init_subclass__(**kwargs)
        if length is not None:
            cls.length = int(length)

    def __new__(cls, *args, **kwargs):
        self = super().__new__(cls)
        self._cache_args = (args, kwargs)
        return self

    def _digest(self):
        h = hashlib.sha1()
        h.update(f'{type(self).__module__}.{type(self).__qualname__}'.encode())
        args, kwargs = getattr(self, '_cache_args', ((), {}))
        try:
            h.update(pickle.dumps((args, sorted(kwargs.items())), protocol=4))
        except Exception:
            return None
        return h.hexdigest()

    def __iter__(self):
        length = type(self).length
        cachedir = _cachedir[0]
        key = self._digest() if cachedir else None
        if not cachedir or key is None:
            yield from self.resume_index([], 0)
            return
        path = os.path.join(cachedir, type(self).__qualname__ + '-' + key)
        os.makedirs(path, exist_ok=True)
        history = []
        i = 0
        while True:  # replay cached iterations
            fname = os.path.join(path, f'{i:04d}')
            if not os.path.exists(fname):
                break
            try:
                with open(fname, 'rb') as f:
                    stop, value = pickle.load(f)
            except Exception:
                break  # damaged tail: recompute from here
            if stop:
                return
            history.append(value)
            if len(history) > length:
                history = history[1:]
            log.info(f'cache hit: {type(self).__qualname__}[{i}]')
            yield value
            i += 1
        resume = self.resume_index(history, i)
        while True:  # compute and store the remaining iterations
            try:
                with disable():  # no nested caching inside resume
                    value = next(resume)
            except StopIteration:
                stop, value = True, None
            else:
                stop = False
            try:
                tmp = os.path.join(path, f'{i:04d}.tmp')
                with open(tmp, 'wb') as f:
                    pickle.dump((stop, value), f, protocol=4)
                os.replace(tmp, os.path.join(path, f'{i:04d}'))
            except Exception:
                pass
            if stop:
                return
            yield value
            i += 1

    def resume(self, history):
        raise NotImplementedError

    def resume_index(self, history, index):
        '''Resume recursion from ``history`` at iteration ``index``.'''
        return self.resume(history)


def load(key):
    '''Fetch a pickled value by key, or None (cache disabled / miss).'''
    cachedir = _cachedir[0]
    if not cachedir:
        return None
    path = os.path.join(cachedir, key)
    try:
        with open(path, 'rb') as f:
            return pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError):
        return None


def store(key, value):
    '''Store a pickled value by key (no-op when caching is disabled).'''
    cachedir = _cachedir[0]
    if not cachedir:
        return
    try:
        os.makedirs(cachedir, exist_ok=True)
        tmp = os.path.join(cachedir, key + '.tmp')
        with open(tmp, 'wb') as f:
            pickle.dump(value, f, protocol=4)
        os.replace(tmp, os.path.join(cachedir, key))
    except (OSError, pickle.PicklingError):
        pass
