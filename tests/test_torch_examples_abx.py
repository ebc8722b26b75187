"""The port's ABX examples against the JAX examples, on the CPU.

``abx_benchmark`` ('ci', mfcc) and ``abx_score`` run in process with
``device='cpu'`` beside the JAX examples themselves: their printed
tables are the same text (the errors and the learned warps equal).
``abx_score``'s cut of the JAX package's features into phone segments
is the JAX example's, bit for bit, and its MFCCs are within 1e-3 of the
float64 Kaldi oracle, or no further from it than the JAX package's:
the band-passed noise of its corpus leaves mel bands nearly empty, and
there both packages' float32 logs stray up to 2.2e-3 from the oracle.
``multihost_cmvn`` runs its two processes over gloo and a file store.
"""

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import torch

from tests.test_torch_examples_scripts import load

torch.set_num_threads(2)


def jax_output(monkeypatch, name, argv):
    """What the JAX example ``name`` prints when run with ``argv``."""
    monkeypatch.setattr(sys, 'argv', [name + '.py'] + argv)
    out = io.StringIO()
    with redirect_stdout(out):
        load(name, jax=True).main()
    return out.getvalue()


def test_abx_benchmark(monkeypatch):
    printed = jax_output(monkeypatch, 'abx_benchmark',
                         ['--config', 'ci', '--features', 'mfcc'])
    report = load('abx_benchmark').run('ci', features='mfcc', device='cpu')
    # the JAX example prints the same tables between its first line and
    # its 'total' line
    tables = printed.split('\n', 1)[1].rsplit('\ntotal', 1)[0].rstrip('\n')
    assert report['table'] == tables
    assert set(report['errors']['across']) == {'mfcc'}
    assert 'vtln+cmvn' in report['errors']['across']['mfcc']


def test_abx_score(monkeypatch, tmp_path):
    module = load('abx_score')
    printed = jax_output(monkeypatch, 'abx_score', [str(tmp_path / 'jax')])
    report = module.run(str(tmp_path / 'torch'), device='cpu')
    assert report['table'] in printed
    across = {label: errors[0] for label, errors in report['errors'].items()}
    assert across['mfcc + cmvn (by speaker)'] < across['mfcc raw']

    # the cut: the JAX example's segments of the JAX package's features
    from shennong_tpu import pipeline as jpipeline
    from shennong_tpu.eval import segments_from_alignment
    from shennong_tpu_torch.audio import Audio
    from shennong_tpu_torch.features import Features
    from shennong_tpu_torch.features_collection import FeaturesCollection
    from tests import kaldi_oracle

    jax_module = load('abx_score', jax=True)
    utterances, alignments = jax_module.build_corpus(str(tmp_path / 'jax'))
    config = jpipeline.get_default_config('mfcc')
    config['mfcc']['dither'] = 0.0
    theirs = jpipeline.extract_features(config, utterances)
    ref = [(token, data, name) for name, feats in theirs.items()
           for token, data in segments_from_alignment(
               feats, alignments[name], min_frames=2)]
    segments, tokens, speakers = module.cut(FeaturesCollection({
        name: Features(feats.data, feats.times, feats.properties)
        for name, feats in theirs.items()}), report['alignments'])
    assert len(segments) == len(ref) == 4 * 3 * 4
    assert tokens == [token for token, _, _ in ref]
    assert speakers == [name for _, _, name in ref]
    for mine, (_, data, _) in zip(segments, ref):
        np.testing.assert_array_equal(mine, data)

    # the features: the float64 Kaldi oracle's, as near as the JAX
    # package comes
    ours = report['features']['mfcc raw']
    for utt in utterances:
        oracle = kaldi_oracle.mfcc(
            Audio.load(utt.audio_file).data.astype(np.float64))
        gap = np.abs(ours[utt.name].data - oracle).max()
        assert gap < max(1e-3, np.abs(theirs[utt.name].data - oracle).max())


def test_multihost_cmvn(tmp_path):
    """Two processes over gloo and a file store: the statistics the
    same bits as one process's, the global mean and deviation those of
    the JAX example's arithmetic on the JAX package's MFCCs of the same
    shards (1e-3 relative). The JAX example sums in float32, which
    loses the energy column's deviation (0.066 about a mean of 23, a
    condition number of 1.2e5, so 3% of it); the port sums in float64,
    and the test takes the example's arithmetic in float64."""
    import jax.numpy as jnp

    from shennong_tpu.ops import mel as jmel
    from shennong_tpu.ops.framing import FrameOptions, num_frames
    from shennong_tpu.ops.spectral import MfccOpts, mfcc_batch

    module = load('multihost_cmvn')
    report = module.launch(2, device='cpu', workdir=str(tmp_path))
    assert report['equal']
    np.testing.assert_array_equal(report['stats'], report['single'])
    assert 'processes: 2, global frames: 384' in report['logs'][0]

    # the JAX example's worker, both shards in one process
    opts = MfccOpts(frame=FrameOptions(dither=0.0))
    mel = jnp.asarray(jmel.mel_banks(
        23, opts.frame.padded_window_size, 16000.0, 20.0, 0.0, 100.0,
        -500.0, 1.0)[0])
    local = []
    for rank in range(2):
        rng = np.random.RandomState(rank)
        feats = np.asarray(mfcc_batch(
            jnp.asarray((rng.randn(4, 8000) * 5000).astype(np.float32)),
            jnp.asarray(np.full(4, 8000, np.int32)), mel, opts,
            num_frames(8000, opts.frame)), dtype=np.float64)
        local.append(np.concatenate([
            [feats.reshape(-1, 13).shape[0]], feats.sum(axis=(0, 1)),
            (feats ** 2).sum(axis=(0, 1))]))
    total = np.sum(local, axis=0)
    count, mean = total[0], total[1:14] / total[0]
    std = np.sqrt(np.maximum(total[14:] / count - mean ** 2, 0))
    assert report['frames'] == count == 384
    np.testing.assert_allclose(report['mean'], mean, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(report['std'], std, rtol=1e-3)
