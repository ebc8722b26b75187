"""Speech feature extraction processors (Audio -> Features).

The processors: spectrogram, filterbank, MFCC, PLP (with RASTA),
frame energy, bottleneck features, Kaldi and CREPE pitch with their
post-processors, one-hot encodings of alignments, and the UBM-GMM and
VTLN trainers.
Imports are lazy (PEP 562), as in :mod:`shennong_tpu.processor`.
"""

_REGISTRY = {
    'SpectrogramProcessor': 'spectrogram',
    'FilterbankProcessor': 'filterbank',
    'MfccProcessor': 'mfcc',
    'PlpProcessor': 'plp',
    'EnergyProcessor': 'energy',
    'KaldiPitchProcessor': 'pitch_kaldi',
    'KaldiPitchPostProcessor': 'pitch_kaldi',
    'CrepePitchProcessor': 'pitch_crepe',
    'CrepePitchPostProcessor': 'pitch_crepe',
    'BottleneckProcessor': 'bottleneck',
    'OneHotProcessor': 'onehot',
    'FramedOneHotProcessor': 'onehot',
    'DiagUbmProcessor': 'ubm',
    'VtlnProcessor': 'vtln',
}

__all__ = sorted(_REGISTRY)


def __getattr__(name):
    if name in _REGISTRY:
        import importlib
        module = importlib.import_module(
            f'shennong_tpu_torch.processor.{_REGISTRY[name]}')
        return getattr(module, name)
    raise AttributeError(
        f'module {__name__!r} has no attribute {name!r}')
