"""The harness of MFCC or RASTA-PLP with Kaldi pitch, CMVN by speaker
with the VAD, and deltas: ``get_default_config(features,
with_pitch='kaldi', with_cmvn=True, with_delta=True)`` (the
configurations ``mfcc_pitch`` and ``rastaplp_pitch``), held against the
plain float64 reference :mod:`perfbench.reference.pipeline`. It is the
default of a configuration file without a ``"harness"`` key.

- Shape: the smaller of the front end's and the pitch's frame counts
  (Kaldi's arithmetic), and (order + 1) cepstra plus the three pitch
  columns.
- Numbers: ``feat_rms`` and ``pitch_off`` (:mod:`perfbench.check`).
- Trace: each utterance's pitch frames and the Viterbi's lag count,
  which ``viterbi_roofline`` reads.
- Set-up: nothing beside the corpus.
"""

import torch

from perfbench import check
from perfbench.harness import Harness
from perfbench.reference.pipeline import Reference


class KaldiPitch(Harness):

    def __init__(self, config, sample_rate):
        super().__init__(config, sample_rate)
        self._frames = None

    def _counts(self):
        """A reference on the CPU, for its frame arithmetic only."""
        if self._frames is None:
            self._frames = Reference(self.config, self.sample_rate, 'cpu')
        return self._frames

    def expected_shape(self, nsamples):
        reference = self._counts()
        rows = min(reference.front.num_frames(nsamples),
                   reference.pitch.num_frames(nsamples))
        columns = (int(self.config['delta']['order']) + 1) * int(
            self.config[reference.kind]['num_ceps']) + check.PITCH_COLUMNS
        return rows, columns

    def compare(self, entries, compared, outputs, device, seed):
        """:func:`check.numbers` for the program's outputs, and the delta
        pitch's two ``feat_rms`` readings, per frame and smoothed."""
        config, rate = self.config, self.sample_rate
        plain = Reference(config, rate, device).extract(entries, compared)
        generator = torch.Generator(device=device).manual_seed(int(seed) + 2)
        dithered = Reference(config, rate, device, generator=generator)
        front = {name: block.cpu().numpy() for name, block in
                 dithered.front_end(entries, compared).items()}
        columns = next(iter(front.values())).shape[1]
        reach = check.dither_rms(plain, front, columns)
        numbers, delta_rms = check.numbers(
            outputs, plain, reach,
            check.noise_reach(config['pitch']['postprocessing']))
        return numbers, {'delta_rms': delta_rms}

    def trace_inputs(self, samples):
        reference = self._counts()
        return {'pitch_frames': [reference.pitch.num_frames(n)
                                 for n in samples],
                'lags': int(reference.pitch.lags.shape[0])}


def build(config, sample_rate):
    return KaldiPitch(config, sample_rate)
