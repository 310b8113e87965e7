"""Quantized SNN localization pipeline — the port's ``Demo`` (counterpart
of ``haghighatshoarmuir2024_tpu/models/xylo/pipeline.py``; reference:
micloc/xylo_snn_localization.py:74-542).

Slice 1 ports the flagship batched forward, ``forward_batch`` with
``method="matched"`` or ``"peak"`` (JAX ``pipeline.py:747-859``):

1. encode: STHT (blocked-Toeplitz FIR) → order-1 Butterworth bandpass with
   its integrator folded into a lifted blocked cumsum → ``cs`` (T, B, C);
2. fused bipolar RZCC on (T, B·C): kernels K1/K2
   (``ops/cuda/suppress_kernel.py``);
3. integer-LIF spike counts from the two polarity masks: kernel K3
   (``ops/cuda/lif_kernel.py``);
4. rate, fold over bands, matched-profile (or peak) argmax on the DoA grid.

The beamforming design and the calibration profiles are read from the
bundled designs of the JAX package (``utils/cache.py``) or from a checkpoint
the JAX ``Demo.save`` wrote (:meth:`Demo.load`); the design path itself is
not ported yet.  Tensors live on ``device``; CPU tensors run the kernels'
plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import FS
from ...geometry import ArrayGeometry, resolve_device
from ...ops.cuda import lif_kernel
from ...ops.cuda.suppress_kernel import rzcc_encode_bipolar_tm
from ...ops.filterbank import ButterworthFilterbank
from ...ops.fir import full_fp32
from ...ops.iir import iir_cumsum_blocked
from ...ops.stht import stht, stht_kernel
from ...utils.cache import design_cache_key, load_bundled
from .quantize import XyloConfig, global_quantize, validate_config
from .spec import build_localization_spec

_NO_DESIGN = (
    "the beamforming design / calibration path is not ported yet (ROADMAP "
    "queue 1 item 6): use a configuration bundled with the JAX package, or "
    "Demo.load() a checkpoint written by the JAX Demo.save()"
)


class Demo:
    """Quantized Xylo-style SNN localization, bipolar RZCC spikes.

    The constructor has the JAX signature plus ``device``.  ``design_chunk``
    is accepted for parity and unused (there is no design run);
    ``use_cache=False`` would force a design run and so raises.
    """

    def __init__(
        self,
        geometry: ArrayGeometry,
        freq_bands,
        doa_list,
        recording_duration: float = 0.25,
        kernel_duration: float = 10e-3,
        bipolar_spikes: bool = True,
        xylosim_version: bool = True,
        fs: float = FS,
        target_dt: float = 1e-3,
        design_chunk: int = 32,
        use_cache: bool = True,
        enforce_hw_limits: bool = True,
        device="cpu",
    ):
        self.geometry = geometry
        self.freq_bands = np.atleast_2d(np.asarray(freq_bands, dtype=np.float64))
        self.doa_list = np.asarray(doa_list, dtype=np.float64)
        self.recording_duration = recording_duration
        self.kernel_duration = kernel_duration
        self.bipolar_spikes = bool(bipolar_spikes)
        self.xylosim_version = bool(xylosim_version)
        self.enforce_hw_limits = bool(enforce_hw_limits)
        self.fs = fs
        self.device = resolve_device(device)
        if not self.bipolar_spikes:
            raise NotImplementedError("unipolar spikes run on kernel K5, not ported yet (ROADMAP queue 2)")

        key = design_cache_key(
            r_vec=geometry.r_vec,
            theta_vec=geometry.theta_vec,
            speed=geometry.speed,
            freq_bands=self.freq_bands,
            doa_list=self.doa_list,
            recording_duration=recording_duration,
            kernel_duration=kernel_duration,
            bipolar=bipolar_spikes,
            fs=fs,
            version=1,
        )
        cached = load_bundled(key) if use_cache else None
        if cached is None or any(f"bf_{i}" not in cached for i in range(len(self.freq_bands))):
            raise NotImplementedError(f"no bundled design for this configuration (key {key}); " + _NO_DESIGN)
        bf_mats = [cached[f"bf_{i}"] for i in range(len(self.freq_bands))]
        for i, m in enumerate(bf_mats):
            if not np.all(np.isfinite(m)):
                raise FloatingPointError(f"beamforming design for band {i} contains non-finite values")
        self._setup(bf_mats)
        self._initialize_snn_module(target_dt)

    # ----------------------------------------------------------------- set-up
    def _setup(self, bf_mats) -> None:
        """Everything derived from the design and the constructor arguments
        (shared by ``__init__`` and :meth:`load`)."""
        self.bf_mats = list(bf_mats)
        self.tau_vecs = np.asarray(
            [[1.0 / (2 * np.pi * float(np.mean(b)))] * 2 for b in self.freq_bands]
        )
        self.filterbank = ButterworthFilterbank(freq_bands=self.freq_bands, order=1, fs=self.fs)
        # STHT kernel and RZCC robust width of the SNN beamformer
        # (haghighatshoarmuir2024_tpu/models/snn_beamformer.py:112-132)
        self.kernel = stht_kernel(int(self.fs * self.kernel_duration))
        self.robust_width = int(self.fs / self.freq_bands[0][1]) // 2
        self._doa_t = torch.as_tensor(self.doa_list, device=self.device)
        self._profiles = None
        self._profiles_t = None

    def _initialize_snn_module(self, target_dt: float) -> None:
        """Spec assembly + quantization (JAX ``pipeline.py:334-361``;
        micloc/xylo_snn_localization.py:173-313)."""
        self.spec = build_localization_spec(
            bf_mats=self.bf_mats,
            tau_vecs=[tuple(tv) for tv in self.tau_vecs],
            fs=self.fs,
            target_dt=target_dt,
            bipolar_spikes=self.bipolar_spikes,
            threshold=1.0,
        )
        self.xylo_config = global_quantize(self.spec)
        problems = validate_config(
            self.xylo_config,
            hardware=not self.xylosim_version,
            resource_limits=self.enforce_hw_limits,
        )
        if problems:
            if self.xylosim_version:
                raise ValueError("invalid Xylo configuration: " + "; ".join(problems))
            # the reference's automatic fallback to the simulator
            # (micloc/xylo_snn_localization.py:292-313)
            print("Xylo hardware constraints violated; falling back to the "
                  "software simulator: " + "; ".join(problems))
            self.xylosim_version = True

    @classmethod
    def load(cls, path: str, device="cpu") -> "Demo":
        """A Demo from the ``.npz`` that the JAX ``Demo.save`` writes
        (JAX ``pipeline.py:466-561``): geometry, ``bf_i``, the quantized
        config's integers and the profiles, restored verbatim."""
        z = np.load(path, allow_pickle=False)
        rec_dur, ker_dur, fs, bipolar, dt = z["params"]
        self = cls.__new__(cls)
        self.geometry = ArrayGeometry(z["r_vec"], z["theta_vec"], float(z["speed"]))
        self.freq_bands = np.atleast_2d(z["freq_bands"])
        self.doa_list = np.asarray(z["doa_list"])
        self.recording_duration = float(rec_dur)
        self.kernel_duration = float(ker_dur)
        self.bipolar_spikes = bool(bipolar)
        self.xylosim_version = True
        self.enforce_hw_limits = True
        self.fs = float(fs)
        self.device = resolve_device(device)
        if not self.bipolar_spikes:
            raise NotImplementedError("unipolar spikes run on kernel K5, not ported yet (ROADMAP queue 2)")
        bf_mats = []
        while f"bf_{len(bf_mats)}" in z:
            bf_mats.append(z[f"bf_{len(bf_mats)}"])
        self._setup(bf_mats)
        self.xylo_config = XyloConfig(
            w_in=z["w_in"], w_rec=z["w_rec"], w_out=z["w_out"],
            dash_syn=z["dash_syn"], dash_mem=z["dash_mem"],
            dash_syn_out=z["dash_syn_out"], dash_mem_out=z["dash_mem_out"],
            threshold=z["threshold"], threshold_out=z["threshold_out"],
            dt=float(dt), weight_scale=float(z["weight_scale"]),
        )
        if "profiles" in z:
            self._set_profiles(z["profiles"])
        return self

    # ------------------------------------------------------- matched profiles
    def _set_profiles(self, profiles) -> None:
        self._profiles = np.asarray(profiles)
        self._profiles_t = torch.as_tensor(self._profiles, dtype=torch.float32, device=self.device)

    def calibrate_profiles(self, template=None):
        """Load the G×G matched-profile table bundled for this configuration
        (keyed like JAX ``calibrate_profiles``, ``pipeline.py:564-621``).
        Computing a new table runs the design path, which is not ported."""
        if template is None:
            t = np.arange(0, self.recording_duration, 1.0 / self.fs)
            f_mid = float(np.mean(self.freq_bands[0]))
            template = (t, np.sin(2 * np.pi * f_mid * t))
        _, sig = template
        key = design_cache_key(
            kind="profiles",
            r_vec=self.geometry.r_vec,
            theta_vec=self.geometry.theta_vec,
            freq_bands=self.freq_bands,
            doa_list=self.doa_list,
            recording_duration=self.recording_duration,
            kernel_duration=self.kernel_duration,
            bipolar=self.bipolar_spikes,
            fs=self.fs,
            sig=np.asarray(sig, np.float32),
            version=1,
        )
        cached = load_bundled(key)
        if cached is None:
            raise NotImplementedError(f"no bundled profiles for this configuration (key {key}); " + _NO_DESIGN)
        self._set_profiles(cached["profiles"])
        return self._profiles

    # ------------------------------------------------------------- the stages
    def _as_batch(self, sig_batch) -> torch.Tensor:
        x = torch.as_tensor(sig_batch, dtype=torch.float32, device=self.device)
        M = len(self.geometry)
        if x.dim() != 3 or x.shape[-1] != M:
            raise ValueError(f"sig_batch must be (B, T, {M}) for this {M}-mic geometry; got {tuple(x.shape)}")
        return x

    def encode(self, sig_batch) -> torch.Tensor:
        """(B, T, M) audio → integrated bandpassed analytic stack ``cs``
        (T, B, C), C = 2M per band (JAX ``_encode_cumsum``,
        ``pipeline.py:119-162``, in its TPU form: blocked-Toeplitz STHT and
        the lifted blocked cumsum)."""
        x = self._as_batch(sig_batch).transpose(0, 1)  # (T, B, M)
        inphase, quad = stht(x, self.kernel)
        sig_real = torch.cat([inphase, quad], dim=-1)  # (T, B, 2M)
        css = [iir_cumsum_blocked(b, a, sig_real) for b, a in self.filterbank.ba_list]
        return torch.cat(css, dim=-1)

    def rzcc(self, cs: torch.Tensor):
        """``cs`` (T, B, C) → the two RZCC polarity masks (T, B, C) bool."""
        T, B, C = cs.shape
        kp, kn = rzcc_encode_bipolar_tm(
            cs.reshape(T, B * C), self.robust_width, 2 * self.robust_width
        )
        return kp.reshape(T, B, C), kn.reshape(T, B, C)

    def lif_counts(self, kp: torch.Tensor, kn: torch.Tensor) -> torch.Tensor:
        """Polarity masks → hidden spike counts (B, N) int32; spike_bound=1
        (RZCC masks are binary) lets the kernel drop provably dead clips."""
        return lif_kernel.lif_count_rates_bipolar(self.xylo_config, kp, kn, spike_bound=1)

    def estimate(self, counts: torch.Tensor, T: int, method: str = "peak"):
        """Counts → (doa (B,), folded rate (B, G)) (JAX ``pipeline.py:776-786,
        854-859``)."""
        G = len(self.doa_list)
        rate = counts.to(torch.float32) / T * self.fs
        rate_doa = rate.reshape(rate.shape[0], -1, G).mean(dim=1)
        return self.estimate_doa_from_rate(rate_doa, method), rate_doa

    def estimate_doa_from_rate(self, rate_doa: torch.Tensor, method: str = "peak") -> torch.Tensor:
        """Folded rates (B, G) → DoAs (B,) (JAX ``estimate_doa_from_rate``,
        ``pipeline.py:396-442``, row by row): ``"peak"`` is the
        reference-parity argmax, ``"matched"`` the argmax of the correlation
        with the calibrated profiles.  The multiband ``matched_stacked`` and
        ``matched_auto`` estimators are not ported (ROADMAP queue 1 item 9)."""
        if method == "matched":
            if self._profiles_t is None:
                raise ValueError("call calibrate_profiles() before the matched estimator")
            full_fp32()  # f32-exact: a TF32 product can flip near-tie argmaxes
            r = rate_doa - rate_doa.mean(dim=-1, keepdim=True)
            idx = torch.argmax(torch.matmul(r, self._profiles_t.T), dim=-1)
        elif method == "peak":
            idx = torch.argmax(rate_doa, dim=-1)
        elif method in ("matched_stacked", "matched_auto"):
            raise NotImplementedError(f"method={method!r} is multiband, not ported yet (ROADMAP queue 1 item 9)")
        else:
            raise ValueError(f"method must be 'peak' or 'matched' (got {method!r})")
        return self._doa_t[idx]

    def forward_batch(self, sig_batch, method: str = "peak"):
        """Batched flagship chain: (B, T, M) audio → (doa (B,), rate (B, G)).

        ``method="peak"`` is the reference-parity argmax estimator;
        ``method="matched"`` correlates against the calibrated profiles
        (requires :meth:`calibrate_profiles`)."""
        cs = self.encode(sig_batch)
        kp, kn = self.rzcc(cs)
        counts = self.lif_counts(kp, kn)
        return self.estimate(counts, cs.shape[0], method)
