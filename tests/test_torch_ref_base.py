"""Counterpart of ``tests/test_base.py``, case for case: the port's
``BaseProcessor`` parameters, logger and utils."""

import numpy as np
import pytest

from shennong_tpu_torch.base import BaseProcessor
from shennong_tpu_torch.logger import get_logger, null_logger
from shennong_tpu_torch.utils import (
    dict_equal, get_njobs, json_dumps, json_loads, list2array, array2list)


class _Inner(BaseProcessor):
    def __init__(self, gamma=3):
        self.gamma = gamma

    @property
    def name(self):
        return 'inner'


class _Outer(BaseProcessor):
    def __init__(self, alpha=1, beta='x', sub=None):
        self.alpha = alpha
        self.beta = beta
        self.sub = sub if sub is not None else _Inner()

    @property
    def name(self):
        return 'outer'


def test_get_params():
    proc = _Outer()
    params = proc.get_params(deep=False)
    assert params['alpha'] == 1
    assert params['beta'] == 'x'

    deep = proc.get_params(deep=True)
    assert deep['sub__gamma'] == 3


def test_set_params():
    proc = _Outer()
    proc.set_params(alpha=5, sub__gamma=7)
    assert proc.alpha == 5
    assert proc.sub.gamma == 7
    with pytest.raises(ValueError, match='invalid parameter'):
        proc.set_params(nope=1)
    assert proc.set_params() is proc


def test_varargs_rejected():
    class Bad(BaseProcessor):
        def __init__(self, *args):
            pass

        @property
        def name(self):
            return 'bad'

    with pytest.raises(RuntimeError, match='explicitly'):
        Bad._get_param_names()


def test_repr_and_logger():
    proc = _Outer()
    assert repr(proc) == '_Outer'
    proc2 = _Inner()
    proc2._logger = get_logger('inner', 'info')
    assert proc2.log.name == 'inner'
    proc2.set_logger('debug')
    assert proc2.log.level == 10


def test_get_logger_bad_level():
    with pytest.raises(ValueError, match='invalid logging level'):
        get_logger('x', 'not_a_level')
    assert null_logger().handlers


def test_get_njobs():
    assert get_njobs(1) == 1
    assert get_njobs() >= 1
    assert get_njobs(10**6) == get_njobs()
    with pytest.raises(ValueError):
        get_njobs(0)
    with pytest.raises(ValueError):
        get_njobs(-4)


def test_dict_equal():
    d1 = {'a': np.array([1, 2]), 'b': 'x'}
    d2 = {'a': [1, 2], 'b': 'x'}
    assert dict_equal(d1, d2)
    assert not dict_equal(d1, {'a': [1, 3], 'b': 'x'})
    assert list2array({'a': [1, 2]})['a'].shape == (2,)
    assert array2list({'a': np.array([1, 2])})['a'] == [1, 2]


def test_json_numpy_roundtrip():
    data = {
        'arr': np.arange(6, dtype=np.float32).reshape(2, 3),
        'scalar': np.float64(1.5),
        'int': np.int32(3),
        'nested': {'x': np.array([True, False])}}
    text = json_dumps(data)
    loaded = json_loads(text)
    assert np.array_equal(loaded['arr'], data['arr'])
    assert loaded['arr'].dtype == np.float32
    assert loaded['scalar'] == 1.5
    assert loaded['int'] == 3
    assert np.array_equal(loaded['nested']['x'], [True, False])
