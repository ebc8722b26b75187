"""The parameter carriers of the CREPE and bottleneck networks, on the
CPU: ``weights.crepe_from_numpy`` and ``weights.bottleneck_from_numpy``
reject missing keys and inconsistent shapes, and a JAX parameter dict
goes through ``crepe_from_numpy`` to the JAX forward's salience (1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shennong_tpu.models import crepe as jcrepe
from shennong_tpu_torch.models import crepe
from shennong_tpu_torch.weights import bottleneck_from_numpy, crepe_from_numpy

from tests.test_torch_bottleneck import synthetic_params

torch.set_num_threads(2)


def test_crepe_round_trip(monkeypatch):
    """The JAX package's loaded parameters (jax arrays) give the JAX
    forward's salience through the port's module."""
    params = jcrepe.load_params('tiny')
    model = crepe_from_numpy({k: np.asarray(v) for k, v in params.items()})
    assert model.channels == (128, 16, 16, 16, 32, 64)
    assert not any(p.requires_grad for p in model.parameters())
    frames = np.random.RandomState(0).randn(5, 1024).astype(np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(frames)).numpy()
    ref = np.asarray(jcrepe.forward(params, jnp.asarray(frames)))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    # the module runs long inputs in pieces with the same result
    monkeypatch.setattr(crepe, 'ACTIVATION_BYTES', 2 * 4 * 128 * 256)
    with torch.no_grad():
        pieces = model(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(pieces, ours, atol=1e-6, rtol=0)


@pytest.mark.parametrize('key,shape,match', [
    ('conv1/kernel', (512, 2, 128), 'conv1/kernel'),
    ('conv3/kernel', (64, 17, 16), 'conv3/kernel'),
    ('conv2/gamma', (15,), 'conv2/gamma'),
    ('conv6/var', (63,), 'conv6/var'),
    ('classifier/kernel', (255, 360), 'classifier'),
    ('classifier/bias', (359,), 'classifier'),
    ('conv4/bias', None, 'miss conv4/bias'),
])
def test_crepe_carrier_rejects(key, shape, match):
    params = dict(crepe.load_params('tiny'))
    if shape is None:
        del params[key]
    else:
        params[key] = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        crepe_from_numpy(params)


def test_bottleneck_carrier():
    tensors, context = bottleneck_from_numpy(synthetic_params())
    assert context == 5
    assert all(t.dtype == torch.float32 for t in tensors.values())
    assert 'context' not in tensors
    assert tuple(tensors['W8'].shape) == (90, 80)


@pytest.mark.parametrize('change,match', [
    (lambda p: p.pop('bn_std'), 'miss bn_std'),
    (lambda p: p.update(W2=np.zeros((91, 90), np.float32)), 'W2'),
    (lambda p: p.update(b6=np.zeros(89, np.float32)), 'b6'),
    (lambda p: p.pop('b7'), 'b7'),
    (lambda p: p.update(bn_mean=np.zeros(399)), 'bn_mean'),
    (lambda p: p.update(input_std=np.zeros(143)), 'input_std'),
    (lambda p: p.update(W5=np.zeros((401, 90), np.float32)), 'W5'),
    (lambda p: [p.pop(k) for k in ('W5', 'W6', 'W7', 'W8')],
     'second stage'),
])
def test_bottleneck_carrier_rejects(change, match):
    params = synthetic_params()
    change(params)
    with pytest.raises(ValueError, match=match):
        bottleneck_from_numpy(params)
