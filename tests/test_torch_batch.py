"""The port's host batch helpers against the JAX package's.

``parallel.batch.load_signals`` and ``make_batches`` of
``shennong_tpu_torch`` and ``shennong_tpu`` on the same WAVs: the
samples equal (native loader and Python loader), segments bounded by
their times, the padding rows and ``nvalid`` equal, and a multichannel
file rejected by both.
"""

import numpy as np
import pytest
import scipy.io.wavfile

from shennong_tpu.parallel import batch as jbatch
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch.parallel import batch
from shennong_tpu_torch.utterances import Utterances

LENGTHS = (12000, 30500, 8000, 21000, 16001)


@pytest.fixture(scope='module')
def entries(tmp_path_factory):
    path = tmp_path_factory.mktemp('batch')
    rng = np.random.RandomState(3)
    out = []
    for index, nsamples in enumerate(LENGTHS):
        wav = str(path / f'u{index}.wav')
        scipy.io.wavfile.write(
            wav, 16000, (rng.randn(nsamples) * 3000).astype(np.int16))
        out.append((f'u{index}', wav, f's{index % 2}', 0.0,
                    nsamples / 16000))
    # a segment inside the longest file
    out.append(('seg', out[1][1], 's0', 0.25, 1.5))
    return out


def load_both(entries, njobs):
    return (batch.load_signals(Utterances(entries), njobs=njobs),
            jbatch.load_signals(JUtterances(entries), njobs=njobs))


def assert_same_items(ours, theirs):
    assert [name for name, _ in ours] == [name for name, _ in theirs]
    for (name, mine), (_, ref) in zip(ours, theirs):
        assert mine.dtype == ref.dtype == np.float32, name
        np.testing.assert_array_equal(mine, ref, err_msg=name)


@pytest.mark.parametrize('njobs', [1, 3])
def test_load_signals_native(entries, njobs):
    ours, theirs = load_both(entries, njobs)
    assert_same_items(ours, theirs)
    assert len(dict(ours)['seg']) == 20000


@pytest.mark.parametrize('njobs', [1, 4])
def test_load_signals_python(entries, njobs, monkeypatch):
    """The Python loader (what audio the native one does not read
    takes), on ``njobs`` threads, gives the same samples."""
    from shennong_tpu import native as jnative
    from shennong_tpu_torch import native

    native_items = batch.load_signals(Utterances(entries))
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(jnative, 'available', lambda: False)
    ours, theirs = load_both(entries, njobs)
    assert_same_items(ours, theirs)
    assert_same_items(ours, native_items)


def test_load_signals_rejects_multichannel(tmp_path):
    wav = str(tmp_path / 'stereo.wav')
    scipy.io.wavfile.write(
        wav, 16000, np.zeros((1000, 2), dtype=np.int16))
    with pytest.raises(ValueError, match='one channel') as ours:
        batch.load_signals(Utterances([('st', wav)]))
    with pytest.raises(ValueError) as theirs:
        jbatch.load_signals(JUtterances([('st', wav)]))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize('batch_size,pad', [(2, 1), (4, 3), (8, 4)])
def test_make_batches(entries, batch_size, pad):
    items = batch.load_signals(Utterances(entries))
    ours = list(batch.make_batches(items, batch_size, pad))
    theirs = list(jbatch.make_batches(items, batch_size, pad))
    assert len(ours) == len(theirs)
    for mine, ref in zip(ours, theirs):
        names, signals, nsamples, nvalid = mine
        assert names == ref[0] and nvalid == ref[3]
        assert signals.dtype == ref[1].dtype == np.float32
        np.testing.assert_array_equal(signals, ref[1])
        np.testing.assert_array_equal(nsamples, ref[2])
        assert signals.shape[0] % pad == 0
        # padding rows are silent and count one sample
        assert not signals[nvalid:].any()
        assert (nsamples[nvalid:] == 1).all()
