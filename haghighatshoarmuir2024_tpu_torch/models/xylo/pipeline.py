"""Quantized SNN localization pipeline — the port's ``Demo`` (counterpart
of ``haghighatshoarmuir2024_tpu/models/xylo/pipeline.py``; reference:
micloc/xylo_snn_localization.py:74-542).

Construction (JAX ``pipeline.py:216-331``): per frequency band an
:class:`~..snn_beamformer.SNNBeamformer` designed from a sinusoid template at
the band centre, on ``device`` — or the design the :class:`DesignCache`
holds for this configuration (the user directory, then the files bundled
with the JAX package) — becomes the input weights of a 2-layer SNN,
quantized to Xylo-A2 integers.  :meth:`calibrate_profiles` reads a cached
matched-profile table or computes it through :meth:`rates_batch`, folded or
band-stacked.

Inference, time-major on ``device``:

1. encode: STHT (blocked-Toeplitz FIR) → order-1 Butterworth bandpass with
   its integrator folded into a lifted blocked cumsum (on the card the hand
   kernel ``csrc/iir_lifted.cu``) → ``cs`` (T, B, C);
2. fused bipolar RZCC on (T, B·C): kernels K1/K2
   (``ops/cuda/suppress_kernel.py``); a unipolar model keeps the positive
   plane;
3. integer-LIF spike counts (``ops/cuda/lif_kernel.py``): kernel K3 from the
   two polarity masks (bipolar :meth:`forward_batch`), kernel K5 from one
   raster, the bool masks as they are (unipolar :meth:`forward_batch`, and :meth:`forward` for both
   polarities);
4. the unfolded (B, F·G) rates; fold over bands and the matched (or peak)
   argmax on the DoA grid (matched scores on the card by the hand kernel
   ``csrc/matched.cu``), or the band-stacked estimators on the unfolded
   rates (``matched_stacked``, ``matched_auto``).

On the card a frame's or a stream's answer does not depend on how many
others share its call: the lifted IIR and matched scoring sum in one fixed
order per column and per frame.

CPU tensors run the kernels' plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import FS
from ...geometry import ArrayGeometry, as_device_tensor, resolve_device
from ...ops.cuda import lif_kernel
from ...ops.cuda.matched_kernel import band_scores, matched_scores, row_sums
from ...ops.cuda.suppress_kernel import rzcc_encode_bipolar_tm
from ...ops.filterbank import ButterworthFilterbank
from ...ops.fir import full_fp32
from ...ops.iir import iir_cumsum_blocked
from ...ops.interp import signal_from_template
from ...ops.stht import stht
from ...utils.cache import DesignCache, design_cache_key
from ..snn_beamformer import SNNBeamformer
from .quantize import XyloConfig, global_quantize, validate_config
from .sim import XyloSim
from .spec import build_localization_spec

METHODS = ("peak", "periodic_ml", "trimmed_periodic_ml", "matched", "matched_stacked", "matched_auto")
STACKED = ("matched_stacked", "matched_auto")  # the estimators of the unfolded (F·G) rates


# ----------------------------------------------------- band-stacked scoring
def _sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.sum(dim)``; on the card by :func:`row_sums`, one fixed order a
    row, so a frame's sum does not depend on how many frames share the call."""
    if x.device.type == "cpu":
        return x.sum(dim=dim)
    return row_sums(x.movedim(dim, -1))


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.mean(dim)``; on the card the :func:`_sum` over the length."""
    if x.device.type == "cpu":
        return x.mean(dim=dim)
    return _sum(x, dim) / x.shape[dim]


def _cos1(x: torch.Tensor) -> torch.Tensor:
    """Mean-remove and unit-normalize the trailing axis (JAX ``_cos1``,
    ``pipeline.py:48-54``); on the card every sum in one fixed order a row."""
    xc = x - _mean(x, -1)[..., None]
    if x.device.type == "cpu":
        return xc / torch.linalg.vector_norm(xc, dim=-1, keepdim=True).clamp_min(1e-12)
    return xc / torch.sqrt(_sum(xc * xc, -1))[..., None].clamp_min(1e-12)


def _blockcos(x: torch.Tensor, G: int) -> torch.Tensor:
    """Mean-remove and unit-normalize each G-wide band block of the trailing
    axis (JAX ``_blockcos``, ``pipeline.py:33-45``): a noise-dominated band
    then adds a bounded cosine to the summed score."""
    return _cos1(x.reshape(*x.shape[:-1], -1, G)).reshape(x.shape)


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median of the trailing axis as ``jnp.median`` takes it: the mean
    of the two middle values of an even length (``torch.median`` returns the
    lower one)."""
    s = x.sort(dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _auto_blend_scores(rate: torch.Tensor, prof_stacked: torch.Tensor, G: int,
                       weight: str = "peak2") -> torch.Tensor:
    """The SNR-adaptive blend of the band-stacked matched scores (JAX
    ``_auto_blend_scores``, ``pipeline.py:57-102``): the F per-band cosine
    score vectors and the folded-profile cosine, each weighted by its own
    peak (``"peak"``), squared peak (``"peak2"``, the default) or peak over
    the median (``"contrast"``), summed.  ``rate`` (..., F·G) unfolded,
    ``prof_stacked`` (P, F·G) → (..., P) scores, float32 products (TF32
    off)."""
    full_fp32()
    F = rate.shape[-1] // G
    P = prof_stacked.shape[0]
    cb = _blockcos(rate, G).reshape(*rate.shape[:-1], F, G)
    pb = _blockcos(prof_stacked, G).reshape(P, F, G)
    Sb = band_scores(cb, pb)  # one fixed order of summation a frame on the card
    rf = _cos1(_mean(rate.reshape(*rate.shape[:-1], F, G), -2))
    pf = _cos1(_mean(prof_stacked.reshape(P, F, G), -2))
    Sf = matched_scores(rf, pf, center=False)
    comp = torch.cat([Sb, Sf[..., None, :]], dim=-2)  # (..., F + 1, P)
    pk = comp.amax(dim=-1)
    if weight == "peak":
        w = pk
    elif weight == "peak2":
        w = pk**2
    elif weight == "contrast":
        w = torch.clamp_min(pk - _median(comp), 0.0)
    else:
        raise ValueError(f"unknown auto-blend weight {weight!r}")
    return _sum(comp * w[..., None], -2)


class Demo:
    """Quantized Xylo-style SNN localization with RZCC spikes, bipolar or
    unipolar.

    The constructor has the JAX signature plus ``device``, where the design
    runs and the tensors live: the card (``"cuda"``) by default, the CPU only
    with ``device="cpu"``; without a GPU the default raises.
    ``use_cache=True`` takes the design the :class:`DesignCache` holds for
    this configuration (the port's user directory, then the files bundled
    with the JAX package) and saves one it had to compute there;
    ``use_cache=False`` designs and saves nothing.
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
        device=None,
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
        self._setup(design_chunk)

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
        cache = DesignCache() if use_cache else None
        cached = cache.load(key) if cache is not None else None
        # per-band beamformer design (micloc/xylo_snn_localization.py:115-145)
        bf_mats = []
        for i, (band, beamf) in enumerate(zip(self.freq_bands, self.beamfs)):
            if cached is not None and f"bf_{i}" in cached:
                bf_mats.append(cached[f"bf_{i}"])
                continue
            t = np.arange(0, recording_duration, step=1 / fs)
            sig = np.sin(2 * np.pi * float(np.mean(band)) * t)
            bf_mats.append(beamf.design_from_template((t, sig), self.doa_list).cpu().numpy())
        # fail fast on a degenerate design: the quantizer would turn NaN into
        # INT_MIN weights and the SNN would go silent
        for i, m in enumerate(bf_mats):
            if not np.all(np.isfinite(m)):
                raise FloatingPointError(f"beamforming design for band {i} contains non-finite values")
        if cache is not None and cached is None:
            cache.save(key, {f"bf_{i}": m for i, m in enumerate(bf_mats)})
        self.bf_mats = bf_mats
        self._initialize_snn_module(target_dt)

    # ----------------------------------------------------------------- set-up
    def _setup(self, design_chunk: int = 32) -> None:
        """Everything derived from the constructor arguments (shared by
        ``__init__`` and :meth:`load`): the per-band beamformers with the
        taus 1/(2π f_mid) (micloc/xylo_snn_localization.py:115-145), the
        shared order-1 filterbank, the STHT kernel and the RZCC robust width
        of band 0."""
        self.tau_vecs = np.asarray(
            [[1.0 / (2 * np.pi * float(np.mean(b)))] * 2 for b in self.freq_bands]
        )
        self.beamfs = [
            SNNBeamformer(
                geometry=self.geometry, kernel_duration=self.kernel_duration, freq_range=band,
                tau_vec=list(tv), bipolar_spikes=self.bipolar_spikes, fs=self.fs,
                design_chunk=design_chunk, device=self.device,
            )
            for band, tv in zip(self.freq_bands, self.tau_vecs)
        ]
        self.filterbank = ButterworthFilterbank(freq_bands=self.freq_bands, order=1, fs=self.fs)
        self.kernel = self.beamfs[0].kernel
        self.robust_width = self.beamfs[0].robust_width
        self._doa_t = torch.as_tensor(self.doa_list, device=self.device)
        self._profiles = None
        self._profiles_t = None
        self._profiles_stacked = None
        self._stacked_t = None
        self._stacked_cos_t = None
        self._lif = None

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
        self.xylo = XyloSim.from_config(self.xylo_config, output_mode="Spike", dt=target_dt, device=self.device)

    # ------------------------------------------------------------ checkpoints
    def save(self, path: str) -> None:
        """Write the ``.npz`` of the JAX ``Demo.save`` (JAX
        ``pipeline.py:466-500``): geometry, ``bf_i``, the quantized config's
        integers and, if calibrated, the profiles; a band-stacked table that
        a loaded checkpoint brought is written back as it came.  Either
        package's :meth:`load` reads it."""
        cfg = self.xylo_config
        arrays = {
            "r_vec": self.geometry.r_vec,
            "theta_vec": self.geometry.theta_vec,
            "speed": np.asarray(self.geometry.speed),
            "freq_bands": self.freq_bands,
            "doa_list": self.doa_list,
            "params": np.asarray([self.recording_duration, self.kernel_duration, float(self.fs),
                                  float(self.bipolar_spikes), cfg.dt]),
            "weight_scale": np.asarray(cfg.weight_scale),
        }
        for name in ("w_in", "w_rec", "w_out", "dash_syn", "dash_mem", "dash_syn_out",
                     "dash_mem_out", "threshold", "threshold_out"):
            arrays[name] = np.asarray(getattr(cfg, name))
        for i, m in enumerate(self.bf_mats):
            arrays[f"bf_{i}"] = m
        if self._profiles is not None:
            arrays["profiles"] = self._profiles
        if self._profiles_stacked is not None:
            arrays["profiles_stacked"] = self._profiles_stacked
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, device=None) -> "Demo":
        """A Demo from the ``.npz`` that either package's ``Demo.save`` writes
        (JAX ``pipeline.py:502-561``): geometry, ``bf_i``, the quantized
        config's integers, the profiles and the band-stacked profiles, restored
        verbatim, on ``device`` (the card unless ``"cpu"`` is asked for)."""
        device = resolve_device(device)
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
        self.device = device
        self._setup()
        self.bf_mats = []
        while f"bf_{len(self.bf_mats)}" in z:
            self.bf_mats.append(z[f"bf_{len(self.bf_mats)}"])
        self.xylo_config = XyloConfig(
            w_in=z["w_in"], w_rec=z["w_rec"], w_out=z["w_out"],
            dash_syn=z["dash_syn"], dash_mem=z["dash_mem"],
            dash_syn_out=z["dash_syn_out"], dash_mem_out=z["dash_mem_out"],
            threshold=z["threshold"], threshold_out=z["threshold_out"],
            dt=float(dt), weight_scale=float(z["weight_scale"]),
        )
        self.xylo = XyloSim.from_config(self.xylo_config, output_mode="Spike", dt=float(dt), device=device)
        if "profiles" in z:
            self._set_profiles(z["profiles"])
        if "profiles_stacked" in z:
            self._set_profiles_stacked(z["profiles_stacked"])
        return self

    # ------------------------------------------------------- matched profiles
    def _set_profiles(self, profiles) -> None:
        self._profiles = np.asarray(profiles)
        self._profiles_t = torch.as_tensor(self._profiles, dtype=torch.float32, device=self.device)

    def _set_profiles_stacked(self, profiles) -> None:
        """The G×(F·G) table, on the device as it is (``matched_auto``) and
        block-normalized once in numpy float32 (``matched_stacked``; JAX
        ``pipeline.py:883-887``)."""
        self._profiles_stacked = np.asarray(profiles)
        prof = np.asarray(profiles, np.float32)
        G = len(self.doa_list)
        pb = prof.reshape(prof.shape[0], -1, G)
        pb = pb - pb.mean(axis=-1, keepdims=True)
        pb = pb / np.maximum(np.linalg.norm(pb, axis=-1, keepdims=True), 1e-12)
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=self.device)  # noqa: E731
        self._stacked_t = as_t(prof)
        self._stacked_cos_t = as_t(pb.reshape(prof.shape))

    def calibrate_profiles(self, template=None, batch: int = 32, use_cache: bool = True,
                           band_stacked: bool = False):
        """The matched-profile table: row g is the rate profile of the
        quantized pipeline for a noiseless source at grid DoA g,
        mean-removed and unit-normalized (JAX ``pipeline.py:564-650``).
        G×G of the folded rates, or with ``band_stacked=True`` G×(F·G) of
        the unfolded per-band rates (``matched_stacked``, ``matched_auto``).

        ``use_cache=True`` reads the table the :class:`DesignCache` holds for
        this configuration and template, and saves one it had to compute;
        it is computed ``batch`` DoAs per :meth:`rates_batch`."""
        if template is None:
            t = np.arange(0, self.recording_duration, 1.0 / self.fs)
            f_mid = float(np.mean(self.freq_bands[0]))
            template = (t, np.sin(2 * np.pi * f_mid * t))
        t, sig = template
        key = design_cache_key(
            kind="profiles_stacked" if band_stacked else "profiles",
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
        cache = DesignCache() if use_cache else None
        cached = cache.load(key) if cache is not None else None
        if cached is not None:
            profiles = cached["profiles"]
        else:
            # float32 synthesis, as the JAX package runs it on the TPU
            t_dev = torch.as_tensor(np.asarray(t), dtype=torch.float32, device=self.device)
            sig_dev = torch.as_tensor(np.asarray(sig), dtype=torch.float32, device=self.device)
            profs = []
            for start in range(0, len(self.doa_list), batch):
                frames = torch.stack([
                    signal_from_template(self.geometry, t_dev, sig_dev, float(d), fs=self.fs)
                    for d in self.doa_list[start:start + batch]
                ])
                rate = self.rates_batch(frames)
                profs.append((rate if band_stacked else self.fold(rate)).cpu().numpy())
            profiles = np.concatenate(profs, axis=0)
            profiles = profiles - profiles.mean(axis=1, keepdims=True)
            profiles = profiles / np.maximum(np.linalg.norm(profiles, axis=1, keepdims=True), 1e-12)
            if cache is not None:
                cache.save(key, {"profiles": profiles})
        if band_stacked:
            self._set_profiles_stacked(profiles)
            return self._profiles_stacked
        self._set_profiles(profiles)
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

    def raster(self, kp: torch.Tensor, kn: torch.Tensor) -> torch.Tensor:
        """The polarity masks (T, B, C) → the bool input raster (T, B, C'):
        ``[kp & ~kn, kn]`` (2C channels, a valley wins a collision) for a
        bipolar model, ``kp`` for a unipolar one."""
        return torch.cat([kp & ~kn, kn], dim=-1) if self.bipolar_spikes else kp

    def spike_encoding(self, sig_in) -> torch.Tensor:
        """Audio (T, M), or a batch (B, T, M), → the input spike raster of
        JAX ``spike_encoding`` (``pipeline.py:364-376``, ``_spikes_from_cumsum``
        ``:166-195``): :meth:`raster` as int32, (T, 2C) for a bipolar model,
        (T, C) for a unipolar one; a batch gives (B, T, ·).  :meth:`encode`
        then K1/K2 (:meth:`rzcc`)."""
        x = torch.as_tensor(sig_in, dtype=torch.float32, device=self.device)
        single = x.dim() == 2
        spikes = self.raster(*self.rzcc(self.encode(x[None] if single else x)))
        spikes = spikes.to(torch.int32).transpose(0, 1)  # (B, T, C')
        return spikes[0] if single else spikes

    def xylo_process(self, spikes_in) -> torch.Tensor:
        """Input raster → the hidden raster (T, F·G) int32, or (B, T, F·G)
        for a batch, from a reset :class:`XyloSim` (JAX ``pipeline.py:378-383``;
        micloc/xylo_snn_localization.py:358-377)."""
        self.xylo.reset_state()
        _, _, rec = self.xylo(spikes_in)
        return rec["Spikes"]

    def lif_params(self) -> lif_kernel.LifParams:
        """The config's LIF integers on ``device``, uploaded once (the
        weights as K5 reads them at its first call, :meth:`forward`); the
        no-saturation proof is made for binary spikes (``spike_bound=1``)."""
        if self._lif is None:
            self._lif = lif_kernel.lif_params(self.xylo_config, self.device, spike_bound=1)
        return self._lif

    def lif_counts(self, kp: torch.Tensor, kn: torch.Tensor) -> torch.Tensor:
        """Polarity masks → hidden spike counts (B, N) int32.  Bipolar: the
        two masks straight into K3; unipolar: the positive plane as a bool
        raster into K5 (JAX ``pipeline.py:822-843``).  RZCC masks are binary,
        so spike_bound=1 lets the kernel drop provably dead clips."""
        if self.bipolar_spikes:
            return lif_kernel.lif_count_rates_bipolar(self.lif_params(), kp, kn, spike_bound=1)
        return lif_kernel.lif_count_rates(self.lif_params(), kp, time_major=True, spike_bound=1)

    def fold(self, rate: torch.Tensor) -> torch.Tensor:
        """Unfolded (..., F·G) rates → the band-averaged (..., G) profile
        (micloc/xylo_snn_localization.py:379-398)."""
        return rate.reshape(*rate.shape[:-1], -1, len(self.doa_list)).mean(dim=-2)

    def estimate(self, counts: torch.Tensor, T: int, method: str = "peak"):
        """Counts → (doa (B,), folded rate (B, G)) (JAX ``pipeline.py:776-786,
        854-932``): the stacked estimators score the unfolded rates, the
        others the folded ones."""
        rate = counts.to(torch.float32) / T * self.fs
        rate_doa = self.fold(rate)
        return self.estimate_doa_from_rate(rate if method in STACKED else rate_doa, method), rate_doa

    def extract_rate(self, spikes, fold: bool = True, time_dim: int = 0) -> torch.Tensor:
        """A hidden raster (T, ..., F·G), time along ``time_dim`` (1 for
        the (B, T, F·G) of a batch through :meth:`xylo_process`) → its spike
        rates, folded over the bands to (..., G), or with ``fold=False`` the
        unfolded (..., F·G) rates that ``matched_stacked``/``matched_auto``
        take (JAX ``extract_rate``, ``pipeline.py:385-394``)."""
        rate = torch.as_tensor(spikes, device=self.device).to(torch.float32).mean(dim=time_dim) * self.fs
        return self.fold(rate) if fold else rate

    def doa_scores(self, rate: torch.Tensor, method: str = "peak") -> torch.Tensor:
        """The (..., G) scores whose argmax is the DoA of the ``"peak"`` and
        matched estimators (JAX server ``_scores``, ``server.py:426-452``):
        the rates themselves (``"peak"``), their correlation with the
        calibrated profiles (``"matched"``), the per-band cosine scores of
        the unfolded rates against the band-stacked table
        (``"matched_stacked"``, :func:`_blockcos`) or their SNR-adaptive
        blend (``"matched_auto"``, :func:`_auto_blend_scores`).

        The matched estimators need their table (``calibrate_profiles()``,
        or with ``band_stacked=True``) and raise ``ValueError`` without it or
        for rates of another width than the table's."""
        rate = as_device_tensor(rate, self.device)
        if method == "peak":
            return rate
        if method not in ("matched",) + STACKED:
            raise ValueError(f"method {method!r} has no score profile; use 'peak' or a matched estimator")
        table = self._profiles_t if method == "matched" else self._stacked_t
        if table is None:
            raise ValueError(
                "call calibrate_profiles() before method='matched' / calibrate_profiles(band_stacked=True) "
                "before method='matched_stacked' / 'matched_auto'")
        if rate.shape[-1] != table.shape[-1]:
            raise ValueError(
                f"rate length {rate.shape[-1]} does not match the profile table width {table.shape[-1]} — "
                "matched_stacked/matched_auto take extract_rate(..., fold=False)")
        full_fp32()  # f32-exact: a TF32 product can flip near-tie argmaxes
        G = len(self.doa_list)
        if method == "matched_auto":
            return _auto_blend_scores(rate, table, G)
        if method == "matched_stacked":
            return matched_scores(_blockcos(rate, G), self._stacked_cos_t, center=False)
        return matched_scores(rate, table)  # one fixed order of summation a frame on the card

    def estimate_doa_from_rate(self, rate: torch.Tensor, method: str = "peak") -> torch.Tensor:
        """Rates (..., G), or (..., F·G) unfolded for the stacked
        estimators (an array that is not a tensor lands on the model's
        device), → DoAs (...) (JAX ``estimate_doa_from_rate``,
        ``pipeline.py:396-463``, row by row; micloc/xylo_snn_localization.py:400-444):

        - ``"peak"``, ``"matched"``, ``"matched_stacked"``, ``"matched_auto"``:
          the argmax of :meth:`doa_scores`;
        - ``"periodic_ml"``: the angle of ``mean_g rate_g·e^{iθ_g}``;
        - ``"trimmed_periodic_ml"``: the same over the window
          ``arange(-n // 2, n // 2 + 1) - argmax`` (n = G // 2), the
          reference's index quirk kept; indices wrap once and then clamp,
          as JAX's gather does."""
        if method not in METHODS:
            raise ValueError(f"only the following estimation methods are supported:\n{list(METHODS)}")
        rate = as_device_tensor(rate, self.device)
        if method in ("peak", "matched") + STACKED:
            return self._doa_t[torch.argmax(self.doa_scores(rate, method), dim=-1)]
        G = len(self.doa_list)
        rate = rate.to(torch.float64)
        phase = torch.exp(1j * self._doa_t)
        if method == "periodic_ml":
            return torch.angle((rate * phase).mean(dim=-1))
        n = G // 2
        window = torch.arange(-n // 2, n // 2 + 1, device=rate.device)
        idx = window - torch.argmax(rate, dim=-1, keepdim=True)
        idx = torch.clamp(torch.where(idx < 0, idx + G, idx), 0, G - 1)
        return torch.angle((torch.gather(rate, -1, idx) * phase[idx]).mean(dim=-1))

    # -------------------------------------------------------------- entries
    def forward(self, sig_in, method: str = "peak"):
        """One frame: (T, M) audio → (doa, rate (G,)) by the peak estimator
        (JAX ``_forward_jit``, ``pipeline.py:666-722``) or with
        ``method="matched"`` the calibrated matched one (``_forward_matched_jit``,
        ``:724-745``; needs :meth:`calibrate_profiles`).  The spikes go to
        K5 as one bool raster (T, 1, C') (:meth:`raster`); spike_bound=1 as
        the masks are binary."""
        if method not in ("peak", "matched"):
            raise ValueError(f"Demo.forward takes method 'peak' or 'matched', not {method!r}")
        x = torch.as_tensor(sig_in, dtype=torch.float32, device=self.device)
        M = len(self.geometry)
        if x.dim() != 2 or x.shape[-1] != M:
            raise ValueError(f"sig_in must be (T, {M}) for this {M}-mic geometry; got {tuple(x.shape)}")
        cs = self.encode(x[None])
        spikes = self.raster(*self.rzcc(cs))
        counts = lif_kernel.lif_count_rates(self.lif_params(), spikes, time_major=True, spike_bound=1)
        doa, rate_doa = self.estimate(counts, cs.shape[0], method)
        return doa[0], rate_doa[0]

    def rates_batch(self, sig_batch) -> torch.Tensor:
        """(B, T, M) audio → the unfolded hidden rates (B, F·G), band-major
        (JAX ``_rates_batch_jit``, ``pipeline.py:790-846``): the shared body
        of :meth:`forward_batch` and of the calibration."""
        cs = self.encode(sig_batch)
        kp, kn = self.rzcc(cs)
        return self.lif_counts(kp, kn).to(torch.float32) / cs.shape[0] * self.fs

    def forward_batch(self, sig_batch, method: str = "peak"):
        """Batched chain: (B, T, M) audio → (doa (B,), folded rate (B, G)).

        ``method`` is any of :meth:`estimate_doa_from_rate`'s; ``"matched"``
        requires :meth:`calibrate_profiles`, ``"matched_stacked"`` and
        ``"matched_auto"`` ``calibrate_profiles(band_stacked=True)``, and
        score the unfolded rates (JAX ``pipeline.py:747-765, 863-932``)."""
        rate = self.rates_batch(sig_batch)
        rate_doa = self.fold(rate)
        return self.estimate_doa_from_rate(rate if method in STACKED else rate_doa, method), rate_doa
