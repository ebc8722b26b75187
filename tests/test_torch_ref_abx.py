"""Counterpart of ``tests/test_abx.py``, case for case: the port's ABX
evaluator (``shennong_tpu_torch.eval.abx``) on the CPU, with the JAX
cases' inputs, oracle and bounds (the DTW 1e-5 relative, 1e-6 absolute
against the literal oracle; the ABX errors' directions). On the CPU the
DTW is the plain version of its kernel (K2); ``chip_smoke.py`` holds
the kernel on the card. The JAX module's own text follows.

ABX phone-discriminability evaluation (shennong_tpu.eval.abx).

The reference's headline quality numbers are ABX error rates computed
by external ABXpy tooling on its features (reference
``doc/source/intro_features.rst:99-160``); its corpora cannot enter
this environment, so quality is replicated *qualitatively* here: on a
controlled multi-speaker corpus where speakers differ by a spectral
tilt, per-speaker CMVN must reduce the across-speaker ABX error of
raw MFCCs — the direction of the reference's published table
(27.2% raw -> 24.0% +CMVN across-speaker English).
"""

import numpy as np
import pytest
import torch

from shennong_tpu_torch.eval import (
    abx_error, dtw_divergences, pairwise_distances,
    segments_from_alignment)


# --------------------------------------------------------------- oracle

def dtw_oracle(x, y, metric='cosine'):
    """Literal O(Ta*Tb) DTW with steps right/down/diagonal.

    Tracks the realized path length (cells on the optimal path) and
    normalizes by it — ABXpy's normalizer. Cost ties resolve to the
    shortest path, matching the evaluator's lexicographic rule.
    Returns (divergence, cost, length).
    """
    if metric == 'cosine':
        xn = x / np.maximum(
            np.linalg.norm(x, axis=1, keepdims=True), 1e-6)
        yn = y / np.maximum(
            np.linalg.norm(y, axis=1, keepdims=True), 1e-6)
        costs = 1.0 - xn @ yn.T
    else:
        costs = np.sqrt(np.maximum(
            (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
            - 2 * x @ y.T, 0))
    rows, cols = costs.shape
    acc = np.full((rows, cols), np.inf)
    plen = np.zeros((rows, cols), np.int64)
    acc[0, 0] = costs[0, 0]
    plen[0, 0] = 1
    for j in range(1, cols):
        acc[0, j] = acc[0, j - 1] + costs[0, j]
        plen[0, j] = j + 1
    for i in range(1, rows):
        acc[i, 0] = acc[i - 1, 0] + costs[i, 0]
        plen[i, 0] = i + 1
        for j in range(1, cols):
            best = min(
                (acc[i - 1, j], plen[i - 1, j]),
                (acc[i, j - 1], plen[i, j - 1]),
                (acc[i - 1, j - 1], plen[i - 1, j - 1]))
            acc[i, j] = costs[i, j] + best[0]
            plen[i, j] = best[1] + 1
    return (acc[-1, -1] / plen[-1, -1], acc[-1, -1],
            int(plen[-1, -1]))


def test_dtw_matches_literal_oracle():
    rng = np.random.RandomState(0)
    lengths = [(1, 1), (1, 7), (5, 1), (12, 12), (23, 9), (8, 31)]
    max_a = max(a for a, _ in lengths)
    max_b = max(b for _, b in lengths)
    xs = np.zeros((len(lengths), max_a, 4), np.float32)
    ys = np.zeros((len(lengths), max_b, 4), np.float32)
    for row, (na, nb) in enumerate(lengths):
        xs[row, :na] = rng.randn(na, 4)
        ys[row, :nb] = rng.randn(nb, 4)
    nx = np.array([a for a, _ in lengths], np.int32)
    ny = np.array([b for _, b in lengths], np.int32)
    for metric in ('cosine', 'euclidean'):
        got = np.asarray(dtw_divergences(
            torch.from_numpy(xs), nx, torch.from_numpy(ys), ny,
            metric=metric))
        oracle = [
            dtw_oracle(xs[r, :na], ys[r, :nb], metric)
            for r, (na, nb) in enumerate(lengths)]
        want = [div for div, _, _ in oracle]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # the normalizer is the realized path length, not nx + ny:
        # on these random draws at least one optimal path is shorter
        # than the full staircase, so the old normalizer would fail
        assert any(
            length < na + nb
            for (_, _, length), (na, nb) in zip(oracle, lengths)
            if na > 1 and nb > 1)
        # and at least one path is longer than the diagonal bound
        assert all(
            max(na, nb) <= length <= na + nb - 1 or (na, nb) == (1, 1)
            for (_, _, length), (na, nb) in zip(oracle, lengths))


def test_dtw_cost_ties_resolve_to_shortest_path():
    """With exactly-representable {0, 1} costs many optimal paths tie
    in cost; the evaluator and the literal oracle must agree on the
    lexicographic (cost, shortest-length) resolution."""
    eye = np.eye(4, dtype=np.float32)
    cases = [
        # identical one-hot rows: all-zero cost plateau
        ([0, 0, 0, 0, 0], [0, 0, 0]),
        # orthogonal rows: all-one costs, min length = max(na, nb)
        ([1, 1, 1], [2, 2, 2, 2, 2, 2]),
        # mixed plateau: equal-cost paths of different lengths
        ([0, 0, 1, 1, 3], [0, 1, 1, 3]),
        ([0, 1, 0, 1], [1, 0, 1, 0, 1]),
    ]
    max_a = max(len(a) for a, _ in cases)
    max_b = max(len(b) for _, b in cases)
    xs = np.zeros((len(cases), max_a, 4), np.float32)
    ys = np.zeros((len(cases), max_b, 4), np.float32)
    for row, (a, b) in enumerate(cases):
        xs[row, :len(a)] = eye[a]
        ys[row, :len(b)] = eye[b]
    nx = np.array([len(a) for a, _ in cases], np.int32)
    ny = np.array([len(b) for _, b in cases], np.int32)
    got = np.asarray(dtw_divergences(
        torch.from_numpy(xs), nx, torch.from_numpy(ys), ny,
        metric='cosine'))
    want = [
        dtw_oracle(xs[r, :na], ys[r, :nb], 'cosine')[0]
        for r, (na, nb) in enumerate(zip(nx, ny))]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the all-ones case pins the normalizer exactly: cost ties make
    # every monotone path equal-cost, so length must be max(na, nb)
    div1, cost1, len1 = dtw_oracle(xs[1, :3], ys[1, :6], 'cosine')
    assert len1 == 6 and abs(div1 - 1.0) < 1e-6
    np.testing.assert_allclose(got[1], 1.0, atol=1e-6)


def test_dtw_identical_segments_are_closest():
    rng = np.random.RandomState(1)
    seg = rng.randn(10, 6).astype(np.float32)
    other = rng.randn(10, 6).astype(np.float32)
    x = np.stack([seg, seg])
    y = np.stack([seg, other])
    n = np.array([10, 10], np.int32)
    div = np.asarray(dtw_divergences(
        torch.from_numpy(x), n, torch.from_numpy(y), n))
    assert div[0] < 1e-5
    assert div[1] > div[0]


def test_pairwise_distances_symmetric_zero_diagonal():
    rng = np.random.RandomState(2)
    segments = [
        rng.randn(rng.randint(3, 15), 5) for _ in range(9)]
    dist = pairwise_distances(segments, batch=4, device='cpu')
    assert dist.shape == (9, 9)
    assert np.allclose(dist, dist.T)
    assert np.allclose(np.diag(dist), 0)
    assert (dist[~np.eye(9, dtype=bool)] > 0).all()


def test_pairwise_rejects_empty_segment():
    with pytest.raises(ValueError, match='non-empty'):
        pairwise_distances([np.zeros((0, 3))], device='cpu')


# --------------------------------------------------------- ABX scoring

def _cluster_corpus(separation, nspeakers=3, tokens=4, seed=0):
    """Segments from 2 phones x speakers x tokens; phones are noisy
    cluster centers, ``separation`` scales how far apart."""
    rng = np.random.RandomState(seed)
    centers = {'a': rng.randn(6), 'b': rng.randn(6)}
    segments, phones, speakers = [], [], []
    for phone, center in centers.items():
        for speaker in range(nspeakers):
            for _ in range(tokens):
                frames = rng.randint(4, 9)
                segments.append(
                    separation * center
                    + rng.randn(frames, 6).astype(np.float32))
                phones.append(phone)
                speakers.append(f's{speaker}')
    return segments, phones, speakers


@pytest.mark.parametrize('task', ['across', 'within'])
def test_abx_separated_clusters_score_zero(task):
    segments, phones, speakers = _cluster_corpus(separation=40.0)
    dist = pairwise_distances(segments, metric='euclidean', device='cpu')
    assert abx_error(dist, phones, speakers, task=task) < 0.02


@pytest.mark.parametrize('task', ['across', 'within'])
def test_abx_random_features_score_chance(task):
    segments, phones, speakers = _cluster_corpus(
        separation=0.0, nspeakers=4, tokens=6)
    dist = pairwise_distances(segments, metric='euclidean', device='cpu')
    assert abs(abx_error(dist, phones, speakers, task=task) - 0.5) < 0.12


def test_abx_needs_two_phones():
    dist = np.zeros((4, 4))
    with pytest.raises(ValueError, match='no valid ABX cell'):
        abx_error(dist, ['a'] * 4, ['s0', 's0', 's1', 's1'])


def test_segments_from_alignment(mfcc):
    from shennong_tpu_torch.alignment import Alignment
    alignment = Alignment.from_list([
        (0.0, 0.4, 'x'), (0.4, 0.8, 'y'), (0.8, 1.2, 'x')])
    segments = segments_from_alignment(mfcc, alignment)
    assert [token for token, _ in segments] == ['x', 'y', 'x']
    total = sum(seg.shape[0] for _, seg in segments)
    assert 0 < total <= mfcc.nframes
    assert all(seg.shape[1] == mfcc.ndims for _, seg in segments)
    only_x = segments_from_alignment(mfcc, alignment, tokens={'x'})
    assert [token for token, _ in only_x] == ['x', 'x']


# ----------------------------------- qualitative reference replication

def _tilted_speech(phone, speaker, token, rate=16000):
    """A synthetic phone realization: two close formant bands define
    the phone; the speaker applies a strong stationary random-FIR
    coloring — exactly the nuisance per-speaker CMVN removes in the
    log domain. The formants are deliberately confusable so the
    speaker filter dominates raw frame distances."""
    import zlib

    import scipy.signal

    formants = {
        'aa': (700, 1200), 'ao': (600, 950), 'ah': (650, 1350)}
    f1, f2 = formants[phone]
    rng = np.random.RandomState(
        zlib.crc32(f'{phone}-{speaker}-{token}'.encode()))
    nsamples = int(0.25 * rate)
    excitation = rng.randn(nsamples)
    signal = np.zeros(nsamples)
    for freq in (f1, f2):
        sos = scipy.signal.butter(
            2, [freq * 0.85, freq * 1.15], 'bandpass',
            fs=rate, output='sos')
        signal += scipy.signal.sosfilt(sos, excitation)
    # per-speaker stationary coloring: a fixed long random FIR whose
    # log-spectral signature is comparable in size to the phone cues
    srng = np.random.RandomState(1000 + speaker)
    fir = srng.randn(24) * (0.95 ** np.arange(24))
    fir[0] = 1.0
    signal = scipy.signal.lfilter(fir, [1.0], signal)
    return (signal / np.abs(signal).max() * 12000).astype(np.int16)


def test_cmvn_improves_across_speaker_abx():
    """Per-speaker CMVN lowers across-speaker ABX error on MFCCs when
    speakers differ by stationary spectral coloring — the qualitative
    content of the reference's Buckeye table (raw 27.2% -> CMVN
    24.0%, ``intro_features.rst:99-117``)."""
    from shennong_tpu_torch.audio import Audio
    from shennong_tpu_torch.processor import MfccProcessor
    from shennong_tpu_torch.postprocessor import CmvnPostProcessor

    proc = MfccProcessor(dither=0.0)
    segments, phones, speakers = [], [], []
    per_speaker = {}
    for phone in ('aa', 'ao', 'ah'):
        for speaker in range(3):
            for token in range(3):
                audio = Audio(
                    _tilted_speech(phone, speaker, token), 16000)
                feats = proc.process(audio, device='cpu')
                segments.append(feats)
                phones.append(phone)
                speakers.append(f's{speaker}')
                per_speaker.setdefault(f's{speaker}', []).append(
                    len(segments) - 1)

    raw = [np.asarray(f.data) for f in segments]
    error_raw = abx_error(
        pairwise_distances(raw, device='cpu'), phones, speakers, task='across')

    normalized = list(raw)
    for speaker, indices in per_speaker.items():
        cmvn = CmvnPostProcessor(dim=segments[0].ndims)
        for index in indices:
            cmvn.accumulate(segments[index])
        for index in indices:
            normalized[index] = np.asarray(
                cmvn.process(segments[index]).data)
    error_cmvn = abx_error(
        pairwise_distances(normalized, device='cpu'), phones, speakers,
        task='across')

    # the speaker coloring must actually hurt the raw features, and
    # CMVN must remove most of that nuisance (reference table shape:
    # raw 27.2% -> CMVN 24.0%; here the nuisance is purely stationary
    # so the improvement is larger)
    assert error_raw > 0.15, error_raw
    assert error_cmvn < error_raw - 0.10, (error_raw, error_cmvn)
    assert error_cmvn < 0.10, error_cmvn


def _scaled_phone(phone, alpha, token, rate=16000, duration=0.3):
    """A phone realization from a speaker whose vocal tract scales
    every formant by ``alpha`` — the exact nuisance VTLN models.
    Adjacent phones sit ~14% apart in formant space, so a +-12%
    speaker scaling makes phone p of one speaker collide with phone
    p+-1 of another."""
    import zlib

    import scipy.signal

    formants = {
        'ao': (560, 920), 'aa': (640, 1060), 'ah': (730, 1220)}
    f1, f2 = formants[phone]
    rng = np.random.RandomState(
        zlib.crc32(f'{phone}-{alpha}-{token}'.encode()))
    nsamples = int(duration * rate)
    excitation = rng.randn(nsamples)
    signal = np.zeros(nsamples)
    for freq in (f1 * alpha, f2 * alpha):
        sos = scipy.signal.butter(
            2, [freq * 0.88, freq * 1.12], 'bandpass',
            fs=rate, output='sos')
        signal += scipy.signal.sosfilt(sos, excitation)
    return (signal / np.abs(signal).max() * 12000).astype(np.int16)


def test_vtln_improves_across_speaker_abx(tmp_path):
    """VTLN warps recover a synthetic per-speaker vocal-tract scaling
    (monotone in the true factor) and lower across-speaker ABX error
    below per-speaker CMVN alone — the qualitative content of the
    reference's Buckeye table (CMVN 24.0% -> VTLN+CMVN 20.0%,
    ``intro_features.rst:99-117, 183-203``)."""
    from shennong_tpu_torch.audio import Audio
    from shennong_tpu_torch.processor import MfccProcessor
    from shennong_tpu_torch.processor.vtln import VtlnProcessor
    from shennong_tpu_torch.postprocessor import CmvnPostProcessor
    from shennong_tpu_torch.utterances import Utterances

    alphas = {'s0': 0.89, 's1': 1.0, 's2': 1.13}
    phones = ('ao', 'aa', 'ah')

    # --- training corpus: per speaker, two utterances concatenating
    # phone tokens (separate token ids from the evaluation set)
    items = []
    for speaker, alpha in alphas.items():
        for utt in range(2):
            parts = [
                _scaled_phone(phone, alpha, f'train-{utt}-{tok}')
                for phone in phones for tok in range(3)]
            wav = str(tmp_path / f'{speaker}-u{utt}.wav')
            Audio(np.concatenate(parts), 16000).save(wav)
            items.append((f'{speaker}-u{utt}', wav, speaker))
    utterances = Utterances(items)

    from shennong_tpu_torch.processor.ubm import DiagUbmProcessor
    ubm_params = DiagUbmProcessor(
        num_gauss=8, num_iters=2, num_iters_init=2,
        num_frames=10000).get_params()
    ubm_params['features']['mfcc']['dither'] = 0
    vtln = VtlnProcessor(
        num_iters=3, min_warp=0.85, max_warp=1.25, warp_step=0.05,
        subsample=2, ubm=ubm_params)
    vtln.features['mfcc']['dither'] = 0
    warps = vtln.process(utterances, group_by='speaker', device='cpu')

    # warps must track the true scaling monotonically (and actually
    # move: at least two grid steps between the extreme speakers)
    ordered = [warps[s] for s in ('s0', 's1', 's2')]
    assert (sorted(ordered) == ordered
            or sorted(ordered, reverse=True) == ordered), warps
    assert abs(ordered[2] - ordered[0]) >= 0.099, warps

    # --- evaluation: fresh tokens, MFCC with and without the learned
    # warps, both under per-speaker CMVN
    proc = MfccProcessor(dither=0.0)
    plain, warped, phone_labels, speaker_labels = [], [], [], []
    per_speaker = {}
    for phone in phones:
        for speaker, alpha in alphas.items():
            for tok in range(3):
                audio = Audio(
                    _scaled_phone(phone, alpha, f'eval-{tok}'), 16000)
                plain.append(proc.process(audio, device='cpu'))
                warped.append(
                    proc.process(
                        audio, vtln_warp=warps[speaker], device='cpu'))
                phone_labels.append(phone)
                speaker_labels.append(speaker)
                per_speaker.setdefault(speaker, []).append(
                    len(plain) - 1)

    def cmvn_normalized(feature_list):
        out = [None] * len(feature_list)
        for speaker, indices in per_speaker.items():
            cmvn = CmvnPostProcessor(dim=feature_list[0].ndims)
            for index in indices:
                cmvn.accumulate(feature_list[index])
            for index in indices:
                out[index] = np.asarray(
                    cmvn.process(feature_list[index]).data)
        return out

    error_cmvn = abx_error(
        pairwise_distances(cmvn_normalized(plain), device='cpu'),
        phone_labels, speaker_labels, task='across')
    error_vtln = abx_error(
        pairwise_distances(cmvn_normalized(warped), device='cpu'),
        phone_labels, speaker_labels, task='across')

    # the scaling must genuinely confuse unwarped features, and the
    # learned warps must remove most of that confusion (oracle warps
    # 1/alpha reach ~0.02 on this corpus; cmvn-only sits at ~0.14)
    assert error_cmvn > 0.10, error_cmvn
    assert error_vtln < error_cmvn - 0.05, (error_cmvn, error_vtln)
    assert error_vtln < 0.08, error_vtln
