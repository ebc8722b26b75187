"""Per-frame energy extraction (the C0 of MFCC, standalone).

Counterpart of :mod:`shennong_tpu.processor.energy`, running
:func:`shennong_tpu_torch.ops.spectral.energy_batch` on a given device.
"""

import numpy as np

from shennong_tpu.features import Features
from shennong_tpu_torch.ops.spectral import EnergyOpts, energy_batch
from shennong_tpu_torch.processor.base import FramesProcessor

_COMPRESSIONS = ('off', 'log', 'sqrt')


class EnergyProcessor(FramesProcessor):
    """Frame energy with optional log/sqrt compression"""

    def __init__(self, sample_rate=16000, frame_shift=0.01,
                 frame_length=0.025, dither=1.0, preemph_coeff=0.97,
                 remove_dc_offset=True, window_type='povey',
                 round_to_power_of_two=True, blackman_coeff=0.42,
                 snip_edges=True, raw_energy=True, compression='log'):
        super().__init__(
            sample_rate=sample_rate, frame_shift=frame_shift,
            frame_length=frame_length, dither=dither,
            preemph_coeff=preemph_coeff,
            remove_dc_offset=remove_dc_offset, window_type=window_type,
            round_to_power_of_two=round_to_power_of_two,
            blackman_coeff=blackman_coeff, snip_edges=snip_edges)

        self.compression = compression
        self.raw_energy = raw_energy

    @property
    def name(self):
        return 'energy'

    @property
    def ndims(self):
        return 1

    @property
    def compression(self):
        """Compression applied to the frame energies

        One of 'log' (natural log), 'sqrt', or 'off' (linear).

        """
        return self._compression

    @compression.setter
    def compression(self, value):
        if value not in _COMPRESSIONS:
            raise ValueError(
                'compression must be in {}, it is {}'.format(
                    ', '.join(_COMPRESSIONS), value))
        self._compression = value

    @property
    def raw_energy(self):
        """Measure energy on the raw frame, prior to pre-emphasis
        and windowing"""
        return self._raw_energy

    @raw_energy.setter
    def raw_energy(self, value):
        self._raw_energy = bool(value)

    def options(self):
        """All parameters bundled as a static EnergyOpts"""
        import dataclasses
        frame = self.frame_options()
        if self._raw_energy:
            frame = dataclasses.replace(
                frame, preemph_coeff=0.0, window_type='rectangular')
        return EnergyOpts(
            frame=frame, raw_energy=self._raw_energy,
            compression=self._compression)

    def process(self, signal, *, device, generator=None):
        """Compute the compressed frame energies of ``signal`` on
        ``device`` ([nframes, 1] float64).

        With ``raw_energy`` the pre-emphasis and window are disabled
        (baked into the static options). ``generator`` is the source of
        the dither, on ``device`` (a fresh, randomly seeded one when
        None and ``dither`` is non-zero). Signals of more than
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
            data = np.zeros((0, 1))
        else:
            energy = energy_batch(
                signals, nsamples, self.options(), nframes,
                compression=self._compression, generator=generator)
            data = energy[0].cpu().numpy().astype(np.float64)[:, None]
        return Features(
            data, self.times(data.shape[0]), self.get_properties())
