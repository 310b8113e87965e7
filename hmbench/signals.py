"""The general traffic generator: microphone-array audio from a seed, made
on the card in a few large calls.

A source is a plane wave from a direction θ: microphone m at radius r_m and
angle θ_m hears the source signal at ``t + τ_m``, ``τ_m = −r_m·cos(θ_m − θ)/c``
(the reference's ``signal_from_template``, micloc/xylo_snn_localization.py:
44-71), plus white noise at a given SNR over the source's power.  The source
signal is a tone (its phase computed exactly) or a sampled template read by
linear interpolation, clamped at its ends.

Every random draw comes from one ``torch.Generator`` on the card seeded with
the run's seed, in a fixed order, so the same seed gives the same audio.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class ArraySpec:
    """A configuration's microphone array: radii, angles and the speed of
    sound.  ``center_circular``: ``num_mic − 1`` microphones evenly on a
    circle from angle 0, the last at the centre."""

    def __init__(self, spec: dict):
        if spec["kind"] != "center_circular":
            raise ValueError(f"unknown array kind {spec['kind']!r}")
        n = int(spec["num_mic"])
        self.r = np.array([*(float(spec["radius_m"]) * np.ones(n - 1)), 0.0])
        self.theta = np.array([*np.linspace(0, 2 * np.pi, n - 1, endpoint=True), 0.0])
        self.speed = float(spec["speed_m_s"])

    @property
    def num_mic(self) -> int:
        return len(self.r)

    def delays(self, doa: torch.Tensor) -> torch.Tensor:
        """(...,) directions → (..., M) delays in seconds, float64."""
        r = torch.as_tensor(self.r, dtype=torch.float64, device=doa.device)
        th = torch.as_tensor(self.theta, dtype=torch.float64, device=doa.device)
        return -r * torch.cos(th - doa.to(torch.float64)[..., None]) / self.speed


def generator(seed: int, device) -> torch.Generator:
    """The run's generator on ``device``, seeded with any whole number (the
    seed is reduced to 64 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2**64))


def uniform(gen: torch.Generator, n: int, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, dtype=torch.float64, device=device)


def array_audio(array: ArraySpec, source: dict, doa: torch.Tensor, snr_db: torch.Tensor, samples: int, fs: float,
                gen: torch.Generator, freq_hz: torch.Tensor | None = None) -> torch.Tensor:
    """(S, samples, M) float32 audio of S sources, one direction, SNR and,
    for a tone, frequency each (``freq_hz`` overrides the source's).

    ``source``: ``{"kind": "tone", "freq_hz": f}`` (unit amplitude, power
    1/2) or ``{"kind": "template", "sig": array}`` (sampled at ``fs`` from
    t = 0, power its mean square)."""
    dev = doa.device
    t = torch.arange(samples, dtype=torch.float64, device=dev) / fs
    tq = t[None, :, None] + array.delays(doa)[:, None, :]  # (S, T, M)
    if source["kind"] == "tone":
        f = freq_hz if freq_hz is not None else torch.full_like(doa, float(source["freq_hz"]), dtype=torch.float64)
        sig = torch.sin(2 * math.pi * f.to(torch.float64)[:, None, None] * tq)
        power = 0.5
    elif source["kind"] == "template":
        tmpl = torch.as_tensor(np.asarray(source["sig"]), dtype=torch.float64, device=dev)
        n = tmpl.shape[0]
        idx = (tq * fs).clamp(0.0, n - 1.0)
        i0 = torch.floor(idx).to(torch.int64).clamp(max=n - 2)
        w = idx - i0
        sig = tmpl[i0] + (tmpl[i0 + 1] - tmpl[i0]) * w
        power = float((tmpl**2).mean())
    else:
        raise ValueError(f"unknown source kind {source['kind']!r}")
    sigma = torch.sqrt(power / 10.0 ** (snr_db.to(torch.float64) / 10.0))
    noise = torch.randn(sig.shape, generator=gen, dtype=torch.float32, device=dev)
    return (sig.to(torch.float32) + sigma.to(torch.float32)[:, None, None] * noise).contiguous()
