"""MFCC extraction (Kaldi compute-mfcc-feats).

Counterpart of :mod:`shennong_tpu.processor.mfcc`, running
:func:`shennong_tpu_torch.ops.spectral.mfcc_batch` on a given device.
"""

import numpy as np

from shennong_tpu_torch.ops.spectral import MfccOpts, mfcc_batch
from shennong_tpu_torch.processor.base import MelFeaturesProcessor


class MfccProcessor(MelFeaturesProcessor):
    """Mel Frequency Cepstral Coefficients"""

    def __init__(self, sample_rate=16000, frame_shift=0.01,
                 frame_length=0.025, dither=1.0, preemph_coeff=0.97,
                 remove_dc_offset=True, window_type='povey',
                 round_to_power_of_two=True, blackman_coeff=0.42,
                 snip_edges=True, num_bins=23, low_freq=20,
                 high_freq=0, vtln_low=100, vtln_high=-500,
                 num_ceps=13, use_energy=True, energy_floor=0.0,
                 raw_energy=True, cepstral_lifter=22.0,
                 htk_compat=False):
        super().__init__(
            sample_rate=sample_rate, frame_shift=frame_shift,
            frame_length=frame_length, dither=dither,
            preemph_coeff=preemph_coeff,
            remove_dc_offset=remove_dc_offset, window_type=window_type,
            round_to_power_of_two=round_to_power_of_two,
            blackman_coeff=blackman_coeff, snip_edges=snip_edges,
            num_bins=num_bins, low_freq=low_freq, high_freq=high_freq,
            vtln_low=vtln_low, vtln_high=vtln_high)

        self.num_ceps = num_ceps
        self.use_energy = use_energy
        self.energy_floor = energy_floor
        self.raw_energy = raw_energy
        self.cepstral_lifter = cepstral_lifter
        self.htk_compat = htk_compat

    @property
    def name(self):
        return 'mfcc'

    @property
    def num_ceps(self):
        """How many cepstral coefficients to keep (C0 included)

        Cannot exceed num_bins.

        """
        return self._num_ceps

    @num_ceps.setter
    def num_ceps(self, value):
        self._num_ceps = int(value)

    @property
    def use_energy(self):
        """Replace C0 with the frame log-energy"""
        return self._use_energy

    @use_energy.setter
    def use_energy(self, value):
        self._use_energy = bool(value)

    @property
    def energy_floor(self):
        """Absolute floor applied to the frame energy"""
        return self._energy_floor

    @energy_floor.setter
    def energy_floor(self, value):
        self._energy_floor = float(value)

    @property
    def raw_energy(self):
        """Measure energy on the raw frame, prior to pre-emphasis
        and windowing"""
        return self._raw_energy

    @raw_energy.setter
    def raw_energy(self, value):
        self._raw_energy = bool(value)

    @property
    def cepstral_lifter(self):
        """Cepstral liftering constant (0 disables liftering)"""
        return self._cepstral_lifter

    @cepstral_lifter.setter
    def cepstral_lifter(self, value):
        self._cepstral_lifter = float(value)

    @property
    def htk_compat(self):
        """HTK-style column layout

        Moves the energy/C0 column last and rescales C0 by sqrt(2).
        Note this alone does not make the output HTK-identical.

        """
        return self._htk_compat

    @htk_compat.setter
    def htk_compat(self, value):
        self._htk_compat = bool(value)

    @property
    def ndims(self):
        return self.num_ceps

    def options(self):
        """All parameters bundled as a static MfccOpts"""
        if self._num_ceps > self._num_bins:
            raise ValueError(
                f'We must have num_ceps <= num_bins, but {self._num_ceps} '
                f'> {self._num_bins}')
        return MfccOpts(
            frame=self.frame_options(), mel=self.mel_options(),
            num_ceps=self._num_ceps, use_energy=self._use_energy,
            energy_floor=self._energy_floor, raw_energy=self._raw_energy,
            cepstral_lifter=self._cepstral_lifter,
            htk_compat=self._htk_compat)

    def _compute(self, signal, vtln_warp, device, generator):
        opts = self.options()
        signals, nsamples, nframes, generator = self._signal_batch(
            signal, device, generator)
        if nframes == 0:
            return np.zeros((0, self.ndims), dtype=np.float32)
        feats = mfcc_batch(
            signals, nsamples, self.mel_weights(vtln_warp), opts, nframes,
            generator=generator)
        # float32 output, matching Kaldi's BaseFloat matrices
        return feats[0].cpu().numpy()
