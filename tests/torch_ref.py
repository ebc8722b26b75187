"""The conftest's fixtures for the port: ``tests/test_torch_ref_*.py``
import them by name, so that a ported case reads as the JAX package's
case does.

Each fixture builds the port's own object from the same file or array
as the conftest's fixture of the same name (which builds the JAX
package's): the same WAVs written from ``make_speech_like_signal``'s
seeds, the same real recordings of ``tests/data/``.
"""

import pytest

from shennong_tpu_torch.audio import Audio


@pytest.fixture(scope='module')
def audio(wav_file):
    return Audio.load(wav_file)


@pytest.fixture(scope='module')
def audio_8k(wav_file_8k):
    return Audio.load(wav_file_8k)


@pytest.fixture(scope='module')
def real_audio(real_wav_file):
    return Audio.load(real_wav_file)


@pytest.fixture(scope='module')
def real_audio_8k(real_wav_file_8k):
    return Audio.load(real_wav_file_8k)


@pytest.fixture(scope='module')
def mfcc(audio):
    from shennong_tpu_torch.processor.mfcc import MfccProcessor
    return MfccProcessor(dither=0).process(audio, device='cpu')
