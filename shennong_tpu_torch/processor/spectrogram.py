"""Spectrogram (log power spectrum) extraction.

Counterpart of :mod:`shennong_tpu.processor.spectrogram`, running
:func:`shennong_tpu_torch.ops.spectral.spectrogram_batch` on a given
device.
"""

import numpy as np

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.ops.spectral import SpectrogramOpts, spectrogram_batch
from shennong_tpu_torch.processor.base import FramesProcessor


class SpectrogramProcessor(FramesProcessor):
    """Spectrogram"""

    def __init__(self, sample_rate=16000, frame_shift=0.01,
                 frame_length=0.025, dither=1.0,
                 preemph_coeff=0.97, remove_dc_offset=True,
                 window_type='povey', round_to_power_of_two=True,
                 blackman_coeff=0.42, snip_edges=True,
                 energy_floor=0.0, raw_energy=True):
        super().__init__(
            sample_rate=sample_rate, frame_shift=frame_shift,
            frame_length=frame_length, dither=dither,
            preemph_coeff=preemph_coeff,
            remove_dc_offset=remove_dc_offset, window_type=window_type,
            round_to_power_of_two=round_to_power_of_two,
            blackman_coeff=blackman_coeff, snip_edges=snip_edges)

        self.energy_floor = energy_floor
        self.raw_energy = raw_energy

    @property
    def name(self):
        return 'spectrogram'

    @property
    def ndims(self):
        return int(self.frame_options().padded_window_size / 2 + 1)

    @property
    def energy_floor(self):
        return self._energy_floor

    @energy_floor.setter
    def energy_floor(self, value):
        self._energy_floor = float(value)

    @property
    def raw_energy(self):
        return self._raw_energy

    @raw_energy.setter
    def raw_energy(self, value):
        self._raw_energy = bool(value)

    def options(self):
        """All parameters bundled as a static SpectrogramOpts"""
        return SpectrogramOpts(
            frame=self.frame_options(),
            energy_floor=self._energy_floor,
            raw_energy=self._raw_energy)

    def process(self, signal, *, device, generator=None):
        """Compute the log power spectrum of ``signal`` on ``device``.

        Column 0 holds the frame log energy, columns 1 and beyond the
        log power at each FFT bin (the VTLN warp accepted by Kaldi for
        spectrograms is a no-op and is not exposed, as in the
        reference). ``generator`` is the source of the dither, on
        ``device`` (a fresh, randomly seeded one when None and
        ``dither`` is non-zero). Signals of more than
        ``AUTO_CHUNK_FRAMES`` frames go through :func:`process_chunked`.
        """
        self._check_signal(signal)
        chunked = self._maybe_chunk(
            signal, device=device, generator=generator)
        if chunked is not None:
            return chunked
        signals, nsamples, nframes, generator = self._signal_batch(
            signal, device, generator)
        if nframes == 0:
            data = np.zeros((0, self.ndims), dtype=np.float32)
        else:
            feats = spectrogram_batch(
                signals, nsamples, self.options(), nframes,
                generator=generator)
            data = feats[0].cpu().numpy()
        return Features(
            data, self.times(data.shape[0]),
            properties=self.get_properties())
