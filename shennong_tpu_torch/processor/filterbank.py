"""Mel-filterbank feature extraction.

Counterpart of :mod:`shennong_tpu.processor.filterbank`, running
:func:`shennong_tpu_torch.ops.spectral.fbank_batch` on a given device.
"""

import numpy as np

from shennong_tpu_torch.ops.spectral import FbankOpts, fbank_batch
from shennong_tpu_torch.processor.base import MelFeaturesProcessor


class FilterbankProcessor(MelFeaturesProcessor):
    """Mel-filterbank features"""

    def __init__(self, sample_rate=16000, frame_shift=0.01,
                 frame_length=0.025, dither=1.0, preemph_coeff=0.97,
                 remove_dc_offset=True, window_type='povey',
                 round_to_power_of_two=True, blackman_coeff=0.42,
                 snip_edges=True, num_bins=23, low_freq=20,
                 high_freq=0, vtln_low=100, vtln_high=-500,
                 use_energy=False, energy_floor=0.0, raw_energy=True,
                 htk_compat=False, use_log_fbank=True, use_power=True):
        super().__init__(
            sample_rate=sample_rate, frame_shift=frame_shift,
            frame_length=frame_length, dither=dither,
            preemph_coeff=preemph_coeff,
            remove_dc_offset=remove_dc_offset, window_type=window_type,
            round_to_power_of_two=round_to_power_of_two,
            blackman_coeff=blackman_coeff, snip_edges=snip_edges,
            num_bins=num_bins, low_freq=low_freq, high_freq=high_freq,
            vtln_low=vtln_low, vtln_high=vtln_high)

        self.use_energy = use_energy
        self.energy_floor = energy_floor
        self.raw_energy = raw_energy
        self.htk_compat = htk_compat
        self.use_log_fbank = use_log_fbank
        self.use_power = use_power

    @property
    def name(self):
        return 'filterbank'

    @property
    def use_energy(self):
        """Prepend a frame-energy column to the filterbank output"""
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
    def htk_compat(self):
        """HTK-style column layout (energy column last)

        Note this alone does not make the output HTK-identical.

        """
        return self._htk_compat

    @htk_compat.setter
    def htk_compat(self, value):
        self._htk_compat = bool(value)

    @property
    def use_log_fbank(self):
        """Log-compress the filterbank outputs (else linear)"""
        return self._use_log_fbank

    @use_log_fbank.setter
    def use_log_fbank(self, value):
        self._use_log_fbank = bool(value)

    @property
    def use_power(self):
        """Feed the power spectrum to the filters (else magnitude)"""
        return self._use_power

    @use_power.setter
    def use_power(self, value):
        self._use_power = bool(value)

    @property
    def ndims(self):
        return self.num_bins + 1 if self.use_energy else self.num_bins

    def options(self):
        """All parameters bundled as a static FbankOpts"""
        return FbankOpts(
            frame=self.frame_options(), mel=self.mel_options(),
            use_energy=self._use_energy,
            energy_floor=self._energy_floor,
            raw_energy=self._raw_energy, htk_compat=self._htk_compat,
            use_log_fbank=self._use_log_fbank,
            use_power=self._use_power)

    def _compute(self, signal, vtln_warp, device, generator):
        signals, nsamples, nframes, generator = self._signal_batch(
            signal, device, generator)
        if nframes == 0:
            return np.zeros((0, self.ndims), dtype=np.float32)
        feats = fbank_batch(
            signals, nsamples, self.mel_weights(vtln_warp), self.options(),
            nframes, generator=generator)
        return feats[0].cpu().numpy()
