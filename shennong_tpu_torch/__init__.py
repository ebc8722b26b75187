"""shennong_tpu_torch: the PyTorch and CUDA port of shennong_tpu.

The port runs the feature extraction stack of :mod:`shennong_tpu` on
PyTorch, with the pitch Viterbi written by hand in CUDA for NVIDIA
Hopper (``csrc/viterbi.cu``). Module names mirror the JAX package
(``ops/framing.py`` here is the counterpart of
``shennong_tpu/ops/framing.py``) so each function can be held against
its reference.

The device is always explicit: processors, the fused pass-1 program
and :func:`shennong_tpu_torch.pipeline.extract_features` take a
``device`` argument, and nothing falls back to the CPU when CUDA is
missing. Float32 matmuls and convolutions run in full float32 (TF32
off), the counterpart of the reference's ``Precision.HIGHEST``.

The port imports nothing of :mod:`shennong_tpu`: it keeps its own copy
of the host layer (audio IO and the native runtime in ``native/``,
features containers, serializers, utterance indexes, the pipeline
manager), so it runs where neither that package nor jax is installed.
"""

import datetime
import textwrap

import torch

from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.utterances import Utterance, Utterances

__version__ = '0.1'

# the reference pins Precision.HIGHEST on its parity-critical matmuls
# (shennong_tpu/ops/pitch.py:205,404,429); cuDNN defaults to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')

__all__ = ['Audio', 'Features', 'FeaturesCollection', 'Utterance',
           'Utterances']


def url():
    """URL of the project documentation"""
    return 'https://github.com/shennong-tpu/shennong-tpu'


def version(type=str, full=False):
    """The package version, as a string or a tuple"""
    if type not in (str, tuple, 'str', 'tuple'):
        raise ValueError(
            'version type must be str or tuple, it is {}'.format(type))

    vers = tuple(__version__.split('.'))
    if not full:
        vers = vers[:3]
    return vers if type in (tuple, 'tuple') else '.'.join(vers)


def version_long():
    """Version plus copyright and license info, for --version output"""
    return textwrap.dedent('''\
    shennong-tpu-torch-{}
    PyTorch and CUDA port of the shennong speech features toolbox ({})
    licence GPL3: this is free software, see the source for copying conditions
    '''.format(version(), datetime.date.today().year))
