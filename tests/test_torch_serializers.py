"""The serializers' files read across the packages.

Each package extracts the main path (MFCC + Kaldi pitch + CMVN + deltas,
every random source at 0) from two segments of ``tests/data/test.wav``
and ``test.flac``, and saves the collection in each of the six formats
(``.npz``, ``.mat``, ``.pkl``, ``.h5f``, the csv folder and ``.ark``);
the other package loads the file. What it reads must be what was
written: the same keys, and per utterance the same data and times, bit
for bit, and the same properties. ``.mat`` keeps values, not dtypes or
the layout of properties, in either package: there the data and times
are compared as float64 and the properties against what the writing
package reads back from its own file. ``.h5f`` skips without h5py.

A pickle names the module of each class it holds, so a ``.pkl`` loads
as the writer's classes (``shennong_tpu_torch.features.Features`` in the
JAX package, and the other way round): the one difference allowed, and
the test asserts it, then compares the contents.
"""

import copy
import os

import numpy as np
import pytest

from shennong_tpu import Utterances as JUtterances
from shennong_tpu import pipeline as jpipeline
from shennong_tpu.features_collection import (
    FeaturesCollection as JFeaturesCollection)
from shennong_tpu_torch import Utterances, pipeline
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.utils import dict_equal

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
ENTRIES = [('u1', os.path.join(DATA, 'test.wav'), 'spk1', 0.0, 0.8),
           ('u2', os.path.join(DATA, 'test.flac'), 'spk2', 0.5, 1.4)]
FORMATS = ['.npz', '.mat', '.pkl', '.h5f', '', '.ark']


def config(module):
    conf = module.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    conf['mfcc']['dither'] = 0
    conf['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    return conf


@pytest.fixture(scope='module')
def written():
    """The collection each package extracted, by package."""
    return {
        'port': pipeline.extract_features(
            config(pipeline), Utterances(ENTRIES), device='cpu'),
        'jax': jpipeline.extract_features(
            config(jpipeline), JUtterances(ENTRIES))}


@pytest.mark.parametrize('ext', FORMATS)
@pytest.mark.parametrize('direction', ['port to jax', 'jax to port'])
def test_files_read_across_packages(written, tmp_path, ext, direction):
    if ext == '.h5f':
        pytest.importorskip('h5py')
    writer, reader = direction.split(' to ')
    collection = written[writer]
    readers = {'port': FeaturesCollection, 'jax': JFeaturesCollection}
    path = str(tmp_path / ('features' + ext))
    collection.save(path)
    loaded = readers[reader].load(path)
    assert sorted(loaded.keys()) == sorted(collection.keys()) == ['u1', 'u2']
    mine = readers[writer].load(path) if ext == '.mat' else None
    for name, features in collection.items():
        theirs = loaded[name]
        if ext == '.pkl':
            assert type(theirs) is type(features)
        else:
            assert type(theirs).__module__.startswith(
                'shennong_tpu_torch' if reader == 'port' else 'shennong_tpu.')
        if ext == '.mat':
            assert np.array_equal(theirs.data.astype(np.float64),
                                  features.data.astype(np.float64)), name
            assert np.array_equal(theirs.times.astype(np.float64),
                                  features.times.astype(np.float64)), name
            assert dict_equal(copy.deepcopy(theirs.properties),
                              copy.deepcopy(mine[name].properties)), name
        else:
            assert theirs.dtype == features.dtype, name
            assert np.array_equal(theirs.data, features.data), name
            assert np.array_equal(theirs.times, features.times), name
            assert dict_equal(theirs.properties, features.properties), name
