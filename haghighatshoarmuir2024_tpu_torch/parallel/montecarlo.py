"""Monte-Carlo accuracy harness (counterpart of
``haghighatshoarmuir2024_tpu/parallel/montecarlo.py``), as plain batching on
one device or split over the data axis of a device mesh.

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

from collections import Counter
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..geometry import as_device_tensor, resolve_device
from ..ops.interp import interp_uniform
from .mesh import device_scope

# the bytes of every shard's errors gathered on the host, by shard index,
# summed over the sharded launches since it was last cleared
# (experiments/multichip_scaling.py reads it)
gathered_bytes: Counter = Counter()


def folded_angle_error(est, true, device=None) -> torch.Tensor:
    """The reference's error metric ``arcsin|sin(est − true)|``
    (paper_plots/target_xylo_localization.py:607-608).  An ``est`` that is
    not a tensor lands on ``device``, the card unless the caller passes
    ``"cpu"``, and ``true`` on ``est``'s device."""
    est = as_device_tensor(est, device)
    true = torch.as_tensor(true, device=est.device)
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
    frame's shape from ``generator`` (``trial.draw(generator, n)``),
    synthesizes the frame from the template (float32), adds the noise at
    sigma ``sqrt(mean(sig²) / snr)`` of its own frame, and all n frames go
    through one ``estimate_fn((n, T, M)) → (n,)`` call, or ``(n, K)`` for K
    estimators read from one forward.  ``doa_true`` and ``noise`` (standard
    normal, (n, T, M)) may be given instead of drawn, both or neither; given
    as tensors, the trial runs on their device (a shard's: ``estimate_fn``
    then gets frames on that device).  ``delay_sign=-1`` synthesizes with
    the reference's MUSIC convention.
    """
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(time_temp), dtype=torch.float32, device=dev)
    s = torch.as_tensor(np.asarray(sig_temp), dtype=torch.float32, device=dev)
    templates = {dev: (t, s)}
    num_mic = len(geometry)

    def draw(generator: Optional[torch.Generator], n: int):
        doa_true = 2 * np.pi * torch.rand(n, generator=generator, dtype=torch.float32, device=dev)
        noise = torch.randn((n, t.shape[0], num_mic), generator=generator, dtype=torch.float32, device=dev)
        return doa_true, noise

    def trial(generator: Optional[torch.Generator], snr_db: float, n: int, doa_true=None, noise=None):
        if (doa_true is None) != (noise is None):
            raise ValueError("give both doa_true and noise, or neither")
        if doa_true is None:
            doa_true, noise = draw(generator, n)
        on = doa_true.device if torch.is_tensor(doa_true) else dev
        if on not in templates:
            templates[on] = (t.to(on), s.to(on))
        t_on, s_on = templates[on]
        doa_true = torch.as_tensor(doa_true, dtype=torch.float32, device=on)
        sig = synthesize_batch(geometry, t_on, s_on, doa_true, fs, delay_sign)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=on)
        snr = 10.0 ** (float(snr_db) / 10.0)
        sigma = torch.sqrt(torch.mean(sig**2, dim=(1, 2), keepdim=True) / snr)
        return doa_true, estimate_fn(sig + sigma * noise)

    trial.device = dev
    trial.draw = draw
    return trial


def _sharded_errors(trial_fn: Callable, devices: list, snr_db: float, doa_true, noise) -> np.ndarray:
    """One launch's trials split over the shards on ``devices``: the draws
    padded to a multiple of the shards by a modular repeat (JAX
    ``montecarlo.py:101-107``; the pad may exceed the draws, 2 trials on 8
    shards padding by 6, where a plain slice would come up short), each
    shard's piece through ``trial_fn`` on its device, one shard after
    another, and the per-trial errors alone gathered on the host once every
    shard's work is queued, the pad cut off."""
    doa_true = torch.as_tensor(doa_true, dtype=torch.float32)
    noise = torch.as_tensor(noise, dtype=torch.float32)
    n, n_shards = doa_true.shape[0], len(devices)
    idx = torch.arange(n + (-n) % n_shards, device=doa_true.device) % n
    errs = []
    for d, doa_i, noise_i in zip(devices, torch.chunk(doa_true[idx], n_shards), torch.chunk(noise[idx], n_shards)):
        with device_scope(d):
            errs.append(_errors(*trial_fn(None, snr_db, doa_i.shape[0], doa_true=doa_i.to(d), noise=noise_i.to(d))))
    host = [e.cpu() for e in errs]
    for i, e in enumerate(host):
        gathered_bytes[i] += e.numel() * e.element_size()
    return torch.cat(host).numpy()[:n]


def monte_carlo_sweep(trial_fn: Callable, snr_db_vec: Sequence[float], num_sims: int, seed: int = 0,
                      batch_size: Optional[int] = None, draws=None, mesh=None) -> dict:
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
    (num_snr, K).

    With a ``mesh`` (``parallel.make_mesh``) each launch's trials split
    over its ``data`` axis (JAX ``montecarlo.py:79-125``): the draws are
    made as without it, on one generator in the same order, and each shard
    runs ``trial_fn`` on its piece on its own device, one after another
    (the estimate is opaque: its host synchronizations are its own); only
    the per-trial errors come back, so ``errors`` equals the unsharded
    sweep's wherever the model rounds alike at both widths.  On a
    mesh of several devices ``trial_fn``'s ``estimate_fn`` must take frames
    on each of them (a replica of its model on each,
    ``parallel.replicate_demo``)."""
    snr_db_vec = np.asarray(snr_db_vec, dtype=np.float32)
    chunk = num_sims if batch_size is None else min(int(batch_size), num_sims)
    gen = torch.Generator(device=trial_fn.device)
    devices = None if mesh is None else mesh.axis_devices("data")
    errs = []
    for snr_db in snr_db_vec:
        gen.manual_seed(int(seed))
        es = []
        for s in range(0, num_sims, chunk):
            n = min(chunk, num_sims - s)
            given = None if draws is None else (draws[0][s:s + n], draws[1][s:s + n])
            if devices is not None:
                es.append(_sharded_errors(trial_fn, devices, float(snr_db), *(given or trial_fn.draw(gen, n))))
                continue
            kw = {} if given is None else {"doa_true": given[0], "noise": given[1]}
            es.append(_errors(*trial_fn(gen, float(snr_db), n, **kw)).cpu().numpy())
        errs.append(np.concatenate(es))
    errs = np.stack(errs)
    return {"snr_db": snr_db_vec, "errors": errs, "mae": errs.mean(axis=1), "median": np.median(errs, axis=1)}


def _errors(doa_true: torch.Tensor, doa_est: torch.Tensor) -> torch.Tensor:
    """The folded errors in float64, (n,) or (n, K) for K estimators."""
    if doa_est.dim() == 2:
        doa_true = doa_true[:, None]
    return folded_angle_error(doa_est.to(torch.float64), doa_true.to(torch.float64))
