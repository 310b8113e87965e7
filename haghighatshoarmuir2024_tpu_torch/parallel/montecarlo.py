"""Monte-Carlo accuracy harness (counterpart of
``haghighatshoarmuir2024_tpu/parallel/montecarlo.py``), as plain batching on
one device.

The reference's evaluation is a serial double loop, SNRs × trials of
(random DoA → synthesize → encode → SNN → rate → peak → error)
(paper_plots/target_xylo_localization.py:291-298).  Here a trial batch
draws its DoAs and noise from a ``torch.Generator`` on the device and takes
all its frames through one ``estimate_fn`` call, (B, T, M) → (B,) DoAs.
Each SNR replays the same draws, as JAX's sweep reuses its keys for every
SNR.  The port cannot reproduce ``jax.random``'s draws: its statistics are
the card's own.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..geometry import resolve_device
from ..ops.interp import interp_uniform


def folded_angle_error(est: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """The reference's error metric ``arcsin|sin(est − true)|``
    (paper_plots/target_xylo_localization.py:607-608)."""
    return torch.arcsin(torch.abs(torch.sin(est - true)))


def snr_with_bandwidth_correction(snr_db, fs, freq_range):
    """SNR corrected for the filtering gain, ``snr − 10·log10((fs/2)/(f_hi − f_lo))``
    (paper_plots/target_snn_localization.py:382-393)."""
    f_lo, f_hi = freq_range
    return snr_db - 10.0 * np.log10((fs / 2) / (f_hi - f_lo))


def synthesize_batch(geometry, time_temp: torch.Tensor, sig_temp: torch.Tensor, doas: torch.Tensor, fs: float,
                     delay_sign: int = 1) -> torch.Tensor:
    """(B, T, M) array signals, one per DoA of ``doas`` (B,): each the
    ``ops.interp.signal_from_template`` of its DoA (the template at
    ``t + delay``, or ``t − delay`` with ``delay_sign=-1``), in
    ``time_temp``'s dtype on its device."""
    delays = delay_sign * geometry.delays(doas.to(time_temp.dtype))  # (B, M)
    tq = time_temp[None, :, None] + delays[:, None, :]
    return interp_uniform(tq, sig_temp, float(time_temp[0]), 1.0 / fs)


def make_trial_fn(geometry, time_temp, sig_temp, estimate_fn: Callable, fs: float, delay_sign: int = 1,
                  device=None):
    """The trial-batch function ``trial(generator, snr_db, n) → (doa_true
    (n,), doa_est (n,))`` on ``device`` (the card unless ``"cpu"``).

    Each trial draws its DoA uniform in [0, 2π) and then white noise of the
    frame's shape from ``generator``, synthesizes the frame from the
    template (float32), adds the noise at sigma ``sqrt(mean(sig²) / snr)``
    of its own frame, and all n frames go through one
    ``estimate_fn((n, T, M)) → (n,)`` call, or ``(n, K)`` for K
    estimators read from one forward.  ``doa_true`` and ``noise``
    (standard normal, (n, T, M)) may be given instead of drawn.
    ``delay_sign=-1`` synthesizes with the reference's MUSIC convention.
    """
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(time_temp), dtype=torch.float32, device=dev)
    s = torch.as_tensor(np.asarray(sig_temp), dtype=torch.float32, device=dev)

    def trial(generator: Optional[torch.Generator], snr_db: float, n: int, doa_true=None, noise=None):
        if doa_true is None:
            doa_true = 2 * np.pi * torch.rand(n, generator=generator, dtype=torch.float32, device=dev)
        doa_true = torch.as_tensor(doa_true, dtype=torch.float32, device=dev)
        sig = synthesize_batch(geometry, t, s, doa_true, fs, delay_sign)
        if noise is None:
            noise = torch.randn(sig.shape, generator=generator, dtype=torch.float32, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        snr = 10.0 ** (float(snr_db) / 10.0)
        sigma = torch.sqrt(torch.mean(sig**2, dim=(1, 2), keepdim=True) / snr)
        return doa_true, estimate_fn(sig + sigma * noise)

    trial.device = dev
    return trial


def monte_carlo_sweep(trial_fn: Callable, snr_db_vec: Sequence[float], num_sims: int, seed: int = 0,
                      batch_size: Optional[int] = None, draws=None) -> dict:
    """``num_sims`` trials per SNR, ``batch_size`` at a time (all at once
    when None), the generator on ``trial_fn.device`` seeded with ``seed``
    anew for each SNR.  ``draws = (doa_true (num_sims,), noise (num_sims,
    T, M))`` replaces the generator's draws (JAX's own, say) and is replayed
    for every SNR, as JAX's sweep reuses its keys.  Returns JAX's keys:
    ``snr_db``, ``errors`` (num_snr, num_sims) in radians, ``mae`` and
    ``median`` per SNR.

    A trial whose estimate is (n, K), K estimators read from one forward
    (JAX ``_multi_estimator_sweep``, experiments/target_xylo_localization.py:
    181-200), gives ``errors`` (num_snr, num_sims, K) and ``mae``/``median``
    (num_snr, K)."""
    snr_db_vec = np.asarray(snr_db_vec, dtype=np.float32)
    chunk = num_sims if batch_size is None else min(int(batch_size), num_sims)
    gen = torch.Generator(device=trial_fn.device)
    errs = []
    for snr_db in snr_db_vec:
        gen.manual_seed(int(seed))
        es = []
        for s in range(0, num_sims, chunk):
            n = min(chunk, num_sims - s)
            given = {} if draws is None else {"doa_true": draws[0][s:s + n], "noise": draws[1][s:s + n]}
            doa_true, doa_est = trial_fn(gen, float(snr_db), n, **given)
            if doa_est.dim() == 2:
                doa_true = doa_true[:, None]
            err = folded_angle_error(doa_est.to(torch.float64), doa_true.to(torch.float64))
            es.append(err.cpu().numpy())
        errs.append(np.concatenate(es))
    errs = np.stack(errs)
    return {"snr_db": snr_db_vec, "errors": errs, "mae": errs.mean(axis=1), "median": np.median(errs, axis=1)}
