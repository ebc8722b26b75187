"""Counterpart of ``tests/test_utterances.py``, case for case: the
port's ``Utterance`` and ``Utterances`` on the conftest's WAVs."""

import numpy as np
import pytest

from shennong_tpu_torch import Utterance, Utterances


def test_formats(wav_file):
    assert Utterance('u', wav_file).format == 1
    assert Utterance('u', wav_file, 'spk').format == 2
    assert Utterance('u', wav_file, 0.0, 1.0).format == 3
    assert Utterance('u', wav_file, 'spk', 0.0, 1.0).format == 4


def test_bad_formats(wav_file):
    with pytest.raises(ValueError, match='invalid utterance'):
        Utterance('u')
    with pytest.raises(ValueError, match='cannot cast'):
        Utterance('u', wav_file, 'abc', 'def')
    with pytest.raises(ValueError, match='tstart < tstop'):
        Utterance('u', wav_file, 1.0, 0.5)
    with pytest.raises(ValueError, match='tstart < tstop'):
        Utterance('u', wav_file, -1.0, 0.5)


def test_missing_audio():
    with pytest.raises(ValueError, match='not found'):
        Utterance('u', '/no/such/file.wav')


def test_duration_and_segment(wav_file):
    utt = Utterance('u', wav_file, 'spk', 0.2, 0.7)
    assert utt.duration == pytest.approx(0.5)
    audio = utt.load_audio()
    assert audio.nsamples == 8000

    full = Utterance('u', wav_file)
    assert full.duration == pytest.approx(22713 / 16000)


def test_truncation_warning(wav_file):
    with pytest.warns(UserWarning, match='truncated'):
        utt = Utterance('u', wav_file, 0.5, 100.0)
    assert utt.tstop == pytest.approx(22713 / 16000)


def test_collection(wav_file):
    utts = Utterances([
        ('u2', wav_file, 'spk1', 0.0, 0.5),
        ('u1', wav_file, 'spk1', 0.5, 1.0),
        ('u3', wav_file, 'spk2', 1.0, 1.4)])
    assert len(utts) == 3
    assert utts.has_speakers()
    assert sorted(utts.by_speaker().keys()) == ['spk1', 'spk2']
    assert len(utts.by_speaker()['spk1']) == 2
    assert utts['u1'].speaker == 'spk1'
    assert utts.duration() == pytest.approx(1.4)
    assert utts.format(type=str).startswith('<utterance-id>')


def test_collection_errors(wav_file):
    with pytest.raises(ValueError, match='empty'):
        Utterances([])
    with pytest.raises(ValueError, match='duplicates'):
        Utterances([('u1', wav_file), ('u1', wav_file)])
    with pytest.raises(ValueError, match='not homogeneous'):
        Utterances([('u1', wav_file), ('u2', wav_file, 'spk')])
    with pytest.raises(ValueError, match='no speaker information'):
        Utterances([('u1', wav_file)]).by_speaker()


def test_load_save(wav_file, tmpdir):
    utts = Utterances([
        ('u1', wav_file, 'spk1', 0.0, 0.5),
        ('u2', wav_file, 'spk2', 0.5, 1.0)])
    path = str(tmpdir.join('utts.txt'))
    utts.save(path)
    loaded = Utterances.load(path)
    assert loaded == utts

    with pytest.raises(ValueError, match='not found'):
        Utterances.load(str(tmpdir.join('missing.txt')))


def test_fit_to_duration(wav_file):
    utts = Utterances([
        ('u1', wav_file, 'spk1', 0.0, 0.5),
        ('u2', wav_file, 'spk1', 0.5, 1.0)])

    fitted = utts.fit_to_duration(0.75)
    assert fitted.duration() == pytest.approx(0.75)

    with pytest.raises(ValueError, match='requested'):
        utts.fit_to_duration(10)
    with pytest.warns(UserWarning, match='requested'):
        fitted = utts.fit_to_duration(10, truncate=True)
    assert fitted.duration() == pytest.approx(1.0)
    with pytest.raises(ValueError, match='positive'):
        utts.fit_to_duration(0)
