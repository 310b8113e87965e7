"""Float32 SNN Hilbert beamformer design (counterpart of
``haghighatshoarmuir2024_tpu/models/snn_beamformer.py:35-216``; reference:
micloc/snn_beamformer.py:24-422).

Per DoA of the grid: the template's delayed copies → STHT → order-2
Butterworth bandpass → real stack → RZCC spikes → LIF filter → covariance of
the stable three quarters; then per DoA the top eigenvector of the folded
complex covariance (bipolar spikes) or the DC-removed singular vector
(unipolar).  The grid axis is a batch axis, taken ``design_chunk`` DoAs at a
time (the JAX package's ``chunked_vmap``) by every stage but the sequential
bandpass scan.  The reference loops over angles with scipy/LAPACK.

``apply_to_template`` is not ported: it needs ``received_signal``'s noise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import FS
from ..geometry import ArrayGeometry, resolve_device
from ..ops.fir import full_fp32
from ..ops.iir import butter_bandpass, iir_scan
from ..ops.interp import delayed_copies, resample_to_fs
from ..ops.lif import lif_filter, lif_impulse_response
from ..ops.linalg import dc_removed_sing_vec, fold_complex_cov, top_eigvec_psd, unfold_complex_vec
from ..ops.spikes import ZeroCrossingSpikeEncoder, rzcc_encode
from ..ops.stht import stht, stht_kernel


class SNNBeamformer:
    """SNN beamformer with RZCC spike input (micloc/snn_beamformer.py:24-422),
    computing on ``device``: the card by default, the CPU with
    ``device="cpu"``."""

    def __init__(
        self,
        geometry: ArrayGeometry,
        kernel_duration: float,
        freq_range,
        tau_vec,
        bipolar_spikes: bool = False,
        fs: float = FS,
        design_chunk: int = 32,
        device=None,
    ):
        self.geometry = geometry
        self.fs = fs
        self.design_chunk = int(design_chunk)
        self.device = resolve_device(device)

        self.kernel_duration = kernel_duration
        self.kernel_length = int(fs * kernel_duration)
        self.kernel = stht_kernel(self.kernel_length)

        self.tau_vec = np.asarray(tau_vec, dtype=np.float64)

        freq_range = np.asarray(freq_range, dtype=np.float64)
        if len(freq_range) != 2 or freq_range[0] > freq_range[1]:
            raise ValueError("freq_range should be a vector consisting of two frequencies f_low < f_high!")
        self.freq_range = freq_range
        self.bandpass_filter = butter_bandpass(2, freq_range, fs)

        # RZCC robust width = half the zero-crossing distance at f_high
        # (micloc/snn_beamformer.py:74-76)
        self.robust_width = int(fs / freq_range[1]) // 2
        self.bipolar_spikes = bool(bipolar_spikes)
        self.spk_encoder = ZeroCrossingSpikeEncoder(fs=fs, robust_width=self.robust_width,
                                                    bipolar=self.bipolar_spikes)

    @classmethod
    def from_config(cls, config, geometry: ArrayGeometry, device=None):
        """From an object with the fields of the JAX package's
        ``SNNBeamformerConfig`` (``config.py``)."""
        return cls(
            geometry=geometry,
            kernel_duration=config.kernel_duration,
            freq_range=config.freq_range,
            tau_vec=[config.tau_syn, config.tau_mem],
            bipolar_spikes=config.bipolar_spikes,
            fs=config.fs,
            design_chunk=config.design_chunk,
            device=device,
        )

    def _neuron_ir(self, T: int) -> np.ndarray:
        tau_syn, tau_mem = float(self.tau_vec[0]), float(self.tau_vec[1])
        return lif_impulse_response(tau_syn, tau_mem, self.fs, max_len=T)

    def _analytic(self, X: torch.Tensor) -> torch.Tensor:
        """(T, ..., M) signals → their STHT analytic signals as the real
        stack [Re || Im] (T, ..., 2M)."""
        inphase, quad = stht(X, self.kernel)
        return torch.cat([inphase, quad], dim=-1)

    def _bandpass(self, stack: torch.Tensor) -> torch.Tensor:
        """The order-2 bandpass of a real stack along dim 0.  JAX filters the
        complex analytic signal with the real coefficients
        (``iir_filter(method="scan")``); with real coefficients that is the
        same arithmetic on the real and imaginary parts, so both go through
        one real ``iir_scan``."""
        b, a = self.bandpass_filter
        return iir_scan(b, a, stack)[0]

    def _membrane(self, Xr: torch.Tensor, neuron_ir: np.ndarray) -> torch.Tensor:
        """Real stack (T, ..., 2M) → LIF membrane of its RZCC spikes."""
        spikes = rzcc_encode(Xr.movedim(0, -2), self.robust_width, self.bipolar_spikes)
        return lif_filter(spikes.movedim(-2, 0), neuron_ir)

    def design_covariances(self, sig_temp: torch.Tensor, t0: float, delays: torch.Tensor,
                           neuron_ir: np.ndarray) -> torch.Tensor:
        """(G, 2M, 2M) covariances of the LIF-filtered spike trains of the
        G DoAs of ``delays`` (G, M), over the stable last three quarters of
        the frame (JAX ``_design_covariances``, ``snn_beamformer.py:39-64``).
        float32, TF32 off: JAX forces ``Precision.HIGHEST`` there.

        Every stage takes ``design_chunk`` DoAs at a time but the bandpass,
        whose sequential scan costs per time step, not per element: it runs
        once over the whole grid's (T, G, 2M) stack (0.3 GB at the flagship)
        instead of once per chunk."""
        full_fp32()
        G, chunk = delays.shape[0], self.design_chunk
        stack = torch.cat([
            self._analytic(delayed_copies(sig_temp, t0, delays[s:s + chunk], self.fs).transpose(0, 1))
            for s in range(0, G, chunk)
        ], dim=1)
        Xr = self._bandpass(stack)  # (T, G, 2M)
        covs = []
        for s in range(0, G, chunk):
            vmem = self._membrane(Xr[:, s:s + chunk], neuron_ir)  # (T, g, 2M)
            vs = vmem[vmem.shape[0] // 4:]
            covs.append(torch.einsum("tgm,tgn->gmn", vs, vs) / vs.shape[0])
        return torch.cat(covs)

    def bf_from_covs(self, cov: torch.Tensor) -> torch.Tensor:
        """(G, 2M, 2M) covariances → (G, 2M) beamforming vectors (JAX
        ``_bf_from_covs``, ``snn_beamformer.py:67-73``)."""
        if self.bipolar_spikes:
            return unfold_complex_vec(top_eigvec_psd(fold_complex_cov(cov)))
        return dc_removed_sing_vec(cov)

    def design_from_template(self, template: Tuple[np.ndarray, np.ndarray], doa_list) -> torch.Tensor:
        """Beamforming matrix ``2M x G`` (float32, on ``device``) from a
        ``(time, signal)`` template (micloc/snn_beamformer.py:82-211)."""
        time_temp, sig_temp = resample_to_fs(*template, self.fs)
        delays = self.geometry.delays_np(np.asarray(doa_list, dtype=np.float64), normalized=True)
        cov = self.design_covariances(
            torch.as_tensor(sig_temp, dtype=torch.float32, device=self.device),
            float(np.float32(time_temp[0])),
            torch.as_tensor(delays, dtype=torch.float32, device=self.device),
            self._neuron_ir(len(sig_temp)),
        )
        return self.bf_from_covs(cov).T

    def apply_to_signal(self, bf_mat, sig_in_vec) -> torch.Tensor:
        """(time, T x M signal) → LIF membrane after beamforming, ``T x G``
        (micloc/snn_beamformer.py:283-370; JAX ``snn_beamformer.py:180-216``)."""
        time_vec, sig_in = sig_in_vec
        time_vec = np.asarray(time_vec, dtype=np.float64)
        bf_mat = torch.as_tensor(bf_mat, dtype=torch.float32, device=self.device)
        num_mic = bf_mat.shape[0] // 2
        T, num_chan = np.shape(sig_in)
        if num_chan != num_mic:
            raise ValueError(
                f"number of channels in the input signal {num_chan} should be the same "
                f"as the number of microphones {num_mic}!"
            )
        # resample on the host if the grid is not uniform at 1/fs
        # (micloc/snn_beamformer.py:308-321)
        if not np.allclose(np.diff(time_vec), 1.0 / self.fs):
            sig_np = np.asarray(torch.as_tensor(sig_in).cpu(), dtype=np.float64)
            time_new = np.arange(time_vec[0], time_vec[-1], step=1.0 / self.fs)
            sig_in = np.stack([np.interp(time_new, time_vec, sig_np[:, m]) for m in range(num_mic)], axis=1)
            time_vec = time_new
        x = torch.as_tensor(sig_in, dtype=torch.float32, device=self.device)
        vmem = self._membrane(self._bandpass(self._analytic(x)), self._neuron_ir(len(time_vec)))
        full_fp32()
        return torch.matmul(vmem, bf_mat)
