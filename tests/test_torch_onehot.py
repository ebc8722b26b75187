"""The port's one-hot processors against the JAX package's, on the CPU.

``OneHotProcessor`` and ``FramedOneHotProcessor`` of
``shennong_tpu_torch.processor.onehot`` give the JAX package's data,
times and properties on the alignments of ``tests/data/alignment.txt``,
with the token inventory read off each alignment or fixed by
``tokens``, and raise its errors. Both are host numpy: equal, not
close.
"""

import numpy as np
import pytest

from shennong_tpu.alignment import AlignmentCollection as JCollection
from shennong_tpu.processor import onehot as jonehot
from shennong_tpu_torch import processor
from shennong_tpu_torch.alignment import AlignmentCollection
from shennong_tpu_torch.processor import onehot
from shennong_tpu_torch.utils import dict_equal


@pytest.fixture(scope='module')
def alignments():
    import os
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'data', 'alignment.txt')
    return AlignmentCollection.load(path), JCollection.load(path)


def assert_same(ours, theirs):
    np.testing.assert_array_equal(ours.data, theirs.data)
    np.testing.assert_array_equal(ours.times, theirs.times)
    assert ours.data.dtype == theirs.data.dtype
    assert ours.times.dtype == theirs.times.dtype
    assert dict_equal(ours.properties, theirs.properties)
    assert ours.is_valid()


def extra_tokens(alignments):
    ours, _ = alignments
    return sorted(ours.get_tokens_inventory()) + ['zz', 'aa']


@pytest.mark.parametrize('name', ['OneHotProcessor', 'FramedOneHotProcessor'])
@pytest.mark.parametrize('with_tokens', [False, True])
def test_matches_jax(alignments, name, with_tokens):
    ours, theirs = alignments
    tokens = extra_tokens(alignments) if with_tokens else None
    proc = getattr(processor, name)(tokens=tokens)
    jproc = getattr(jonehot, name)(tokens=tokens)
    assert proc.get_params() == jproc.get_params()
    for item in ours:
        features = proc.process(ours[item])
        assert_same(features, jproc.process(theirs[item]))
        assert features.data.sum(axis=1).tolist() == [1] * features.nframes
    if with_tokens:
        assert proc.ndims == jproc.ndims == len(set(tokens))
    else:
        with pytest.raises(ValueError, match='tokens are not defined'):
            proc.ndims
        # processing did not fix the processor's inventory
        assert proc.tokens is None


@pytest.mark.parametrize('params', [
    dict(sample_rate=8000, frame_shift=0.02, frame_length=0.05),
    dict(window_type='hanning'), dict(window_type='rectangular'),
    dict(window_type='blackman', blackman_coeff=0.3)])
def test_framed_parameters_match_jax(alignments, params):
    ours, theirs = alignments
    proc = onehot.FramedOneHotProcessor(**params)
    jproc = jonehot.FramedOneHotProcessor(**params)
    for attribute in ('sample_rate', 'frame_shift', 'frame_length'):
        assert getattr(proc, attribute) == getattr(jproc, attribute)
    for item in ours:
        assert_same(proc.process(ours[item]), jproc.process(theirs[item]))


def test_unknown_token_raises(alignments):
    ours, theirs = alignments
    item = next(iter(ours))
    with pytest.raises(ValueError) as error:
        onehot.OneHotProcessor(tokens=['a']).process(ours[item])
    with pytest.raises(ValueError) as jerror:
        jonehot.OneHotProcessor(tokens=['a']).process(theirs[item])
    assert str(error.value) == str(jerror.value)
