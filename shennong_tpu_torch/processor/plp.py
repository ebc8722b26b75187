"""PLP / RASTA-PLP feature extraction.

Counterpart of :mod:`shennong_tpu.processor.plp`, running
:func:`shennong_tpu_torch.ops.plp.plp_batch` on a given device, and
the host-side streaming :class:`RastaFilter`.
"""

import numpy as np

from shennong_tpu_torch.ops import mel as melmod
from shennong_tpu_torch.ops.plp import (
    _RASTA_DEN1, _RASTA_NUM, PlpOpts, _lfilter_zi_fir, plp_batch)
from shennong_tpu_torch.processor.base import MelFeaturesProcessor


class RastaFilter:
    """Streaming RASTA bandpass filter over mel frames.

    Host-side per-frame twin of the batched filter in
    :func:`shennong_tpu_torch.ops.plp.rasta_filter` (reference
    ``shennong/processor/plp.py:64-146``): the first four frames are
    buffered (zeros are emitted) while the FIR warm-up seeds the
    direct-form-II-transposed state, then the filter switches to its
    IIR denominator. Useful for online processing; the batch computer
    does not use it.

    Parameters
    ----------
    size : int
        Frame dimension (mel band count).
    """

    def __init__(self, size):
        self.size = int(size)
        self.reset()

    def reset(self):
        """Initializes the filter state"""
        self._nframes = 0
        self._state = None

    def filter(self, frame, do_log=True):
        """RASTA-filter one frame.

        With ``do_log`` the filter runs in the log domain (log on the
        way in, exp on the way out), as the PLP recipe requires.
        Returns zeros for the first four (warm-up) frames.
        """
        frame = np.asarray(frame, dtype=np.float64)
        if frame.shape != (self.size,):
            raise ValueError(
                f'frame must have shape ({self.size},), '
                f'it is {frame.shape}')
        if do_log:
            frame = np.log(frame + np.finfo(np.float32).eps)

        num = _RASTA_NUM.astype(np.float64)
        if self._state is None:
            self._state = (
                _lfilter_zi_fir(num)[:, None].astype(np.float64)
                * frame[None, :])

        state = self._state
        if self._nframes < 4:  # FIR warm-up, output discarded
            out = np.zeros(self.size)
            self._state = np.stack([
                num[1] * frame + state[1],
                num[2] * frame + state[2],
                num[3] * frame + state[3],
                num[4] * frame])
        else:
            out = num[0] * frame + state[0]
            self._state = np.stack([
                num[1] * frame + state[1] - _RASTA_DEN1 * out,
                num[2] * frame + state[2],
                num[3] * frame + state[3],
                num[4] * frame])
        self._nframes += 1

        # with do_log the warm-up zeros pass through the exp, giving
        # ones, exactly like the reference filter
        return np.exp(out) if do_log else out


class PlpProcessor(MelFeaturesProcessor):
    """Perceptive linear predictive features"""

    def __init__(self, sample_rate=16000, frame_shift=0.01,
                 frame_length=0.025, rasta=False, dither=1.0,
                 preemph_coeff=0.97, remove_dc_offset=True,
                 window_type='povey', round_to_power_of_two=True,
                 blackman_coeff=0.42, snip_edges=True, num_bins=23,
                 low_freq=20, high_freq=0, vtln_low=100,
                 vtln_high=-500, lpc_order=12, num_ceps=13,
                 use_energy=True, energy_floor=0.0, raw_energy=True,
                 compress_factor=1.0 / 3.0, cepstral_lifter=22,
                 cepstral_scale=1.0, htk_compat=False):
        super().__init__(
            sample_rate=sample_rate, frame_shift=frame_shift,
            frame_length=frame_length, dither=dither,
            preemph_coeff=preemph_coeff,
            remove_dc_offset=remove_dc_offset, window_type=window_type,
            round_to_power_of_two=round_to_power_of_two,
            blackman_coeff=blackman_coeff, snip_edges=snip_edges,
            num_bins=num_bins, low_freq=low_freq, high_freq=high_freq,
            vtln_low=vtln_low, vtln_high=vtln_high)

        self.rasta = rasta
        self.lpc_order = lpc_order
        self.num_ceps = num_ceps
        self.use_energy = use_energy
        self.energy_floor = energy_floor
        self.raw_energy = raw_energy
        self.compress_factor = compress_factor
        self.cepstral_lifter = cepstral_lifter
        self.cepstral_scale = cepstral_scale
        self.htk_compat = htk_compat

    @property
    def name(self):
        return 'plp'

    @property
    def rasta(self):
        """Enable RASTA bandpass filtering of the mel trajectories"""
        return self._rasta

    @rasta.setter
    def rasta(self, value):
        self._rasta = bool(value)

    @property
    def lpc_order(self):
        """Linear-prediction model order"""
        return self._lpc_order

    @lpc_order.setter
    def lpc_order(self, value):
        self._lpc_order = int(value)

    @property
    def num_ceps(self):
        """How many cepstral coefficients to keep (C0 included)

        Must be positive and at most lpc_order + 1.

        """
        return self._num_ceps

    @num_ceps.setter
    def num_ceps(self, value):
        value = int(value)
        if value <= 0:
            raise ValueError('num_ceps must be > 0')
        if value > self.lpc_order + 1:
            raise ValueError(
                'We must have num_ceps <= lpc_order+1, but {} > {}+1'
                .format(value, self.lpc_order))
        self._num_ceps = value

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
    def compress_factor(self):
        """Exponent of the intensity-to-loudness power law"""
        return np.float32(self._compress_factor)

    @compress_factor.setter
    def compress_factor(self, value):
        self._compress_factor = float(value)

    @property
    def cepstral_lifter(self):
        """Cepstral liftering constant (0 disables liftering)"""
        return self._cepstral_lifter

    @cepstral_lifter.setter
    def cepstral_lifter(self, value):
        self._cepstral_lifter = float(value)

    @property
    def cepstral_scale(self):
        """Global multiplier on the cepstral outputs"""
        return self._cepstral_scale

    @cepstral_scale.setter
    def cepstral_scale(self, value):
        self._cepstral_scale = float(value)

    @property
    def htk_compat(self):
        """HTK-style column layout (energy/C0 column last)

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
        """All parameters bundled as a static PlpOpts"""
        # re-check here because the params can be set independently
        # in any order (the num_ceps setter alone cannot see a later
        # lpc_order change)
        if self._num_ceps > self._lpc_order + 1:
            raise ValueError(
                'We must have num_ceps <= lpc_order+1, but {} > {}+1'
                .format(self._num_ceps, self._lpc_order))
        return PlpOpts(
            frame=self.frame_options(), mel=self.mel_options(),
            rasta=self._rasta, lpc_order=self._lpc_order,
            num_ceps=self._num_ceps, use_energy=self._use_energy,
            energy_floor=self._energy_floor,
            raw_energy=self._raw_energy,
            compress_factor=self._compress_factor,
            cepstral_lifter=self._cepstral_lifter,
            cepstral_scale=self._cepstral_scale,
            htk_compat=self._htk_compat)

    def equal_loudness(self, vtln_warp):
        """Equal-loudness coefficients for the given VTLN warp"""
        opts = self.frame_options()
        _, centers = melmod.mel_banks(
            self._num_bins, opts.padded_window_size, opts.sample_rate,
            self._low_freq, self._high_freq, self._vtln_low,
            self._vtln_high, float(vtln_warp))
        return melmod.equal_loudness_vector(centers)

    def _compute(self, signal, vtln_warp, device, generator):
        opts = self.options()
        signals, nsamples, nframes, generator = self._signal_batch(
            signal, device, generator)
        if nframes == 0:
            return np.zeros((0, self.ndims), dtype=np.float32)
        feats = plp_batch(
            signals, nsamples, self.mel_weights(vtln_warp),
            self.equal_loudness(vtln_warp), opts, nframes,
            generator=generator)
        return feats[0].cpu().numpy()
