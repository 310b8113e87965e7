"""The port's kernels and paths on the card, held to the port's plain
versions, its CPU path and scipy: one counterpart for each test function of
``tests_tpu/test_device_parity.py``, with its parameter cases, and the width
contract of the streaming step.

  * the integer LIF kernels (K5 and the raster pack; the pack and K3 from two
    masks; K6 over ragged carried chunks) against the port's integer
    simulator, bit-exact;
  * the suppression kernels (K7; K1 and K2 at two wide windows) against the
    plain peak selection, bit-exact;
  * ``forward_batch`` on the card against the CPU path on the same saved
    model, at the JAX test's rate-profile tolerance; the band-stacked
    matched estimators against scoring the card's rates on the host;
  * the u4 ingest with its upsampler, SRP-PHAT, MUSIC tracking and the
    eigensolver against host references;
  * the lifted IIR (the ``iir_lifted`` kernel) against the scan, float64
    and across carried seams, and the streaming step's width contract
    (``chip_smoke.py`` phases 26-27).
"""
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from haghighatshoarmuir2024_tpu_torch.geometry import CenterCircularArray
from haghighatshoarmuir2024_tpu_torch.models.xylo.quantize import XyloConfig
from haghighatshoarmuir2024_tpu_torch.models.xylo.sim import sim_hidden_batch
from haghighatshoarmuir2024_tpu_torch.ops import peaks
from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel as lk
from haghighatshoarmuir2024_tpu_torch.ops.cuda import suppress_kernel as sk
from haghighatshoarmuir2024_tpu_torch.ops.interp import signal_from_template

FS = 48_000
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    return torch.device("cuda", 0)


def make_config(seed, C=12, N=20, rec_coef=0, w_scale=20):
    """The random config of ``tests/test_pallas_lif.py`` (numpy, same draws)."""
    rng = np.random.default_rng(seed)
    return XyloConfig(
        w_in=rng.integers(-w_scale, w_scale + 1, size=(C, N)).astype(np.int32),
        w_rec=np.full((N, N), rec_coef, np.int32), w_out=np.ones((N, 1), np.int32),
        dash_syn=rng.integers(1, 7, size=N).astype(np.int32), dash_mem=rng.integers(1, 7, size=N).astype(np.int32),
        dash_syn_out=np.ones(1, np.int32), dash_mem_out=np.ones(1, np.int32),
        threshold=rng.integers(30, 200, size=N).astype(np.int32), threshold_out=np.ones(1, np.int32),
        dt=1e-3, weight_scale=1.0)


def make_spikes(seed, B=3, T=50, C=12, p=0.15, max_count=2):
    """(B, T, C) int32 spike counts, ``tests/test_pallas_lif.py``'s draws."""
    rng = np.random.default_rng(seed + 1000)
    return (rng.random((B, T, C)) < p).astype(np.int32) * rng.integers(1, max_count + 1, size=(B, T, C)).astype(
        np.int32)


def scan_counts(config, spikes_btc):
    """The port's integer simulator on the CPU: (B, N) counts."""
    return sim_hidden_batch(config, torch.as_tensor(spikes_btc), device="cpu").sum(dim=1).numpy()


def _on(dev, a):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


# --------------------------------------------------------------- LIF kernels
@pytest.mark.parametrize("seed,rec_coef", [(41, -2), (42, 0), (43, -1)])
def test_lif_count_compiled_matches_scan(dev, seed, rec_coef):
    config = make_config(seed, rec_coef=rec_coef)
    spikes = make_spikes(seed, B=4, T=100)
    got = lk.lif_count_rates(config, _on(dev, spikes))
    np.testing.assert_array_equal(got.cpu().numpy(), scan_counts(config, spikes))
    assert cs.check_raster_pack(torch, lk, _on(dev, spikes.transpose(1, 0, 2)).to(torch.int8), "tests_gpu") == 0


def test_lif_count_compiled_saturating_matches_scan(dev):
    config = make_config(11, w_scale=5000)
    config.threshold[:] = 25_000
    spikes = make_spikes(11, p=0.9, max_count=3)
    got = lk.lif_count_rates(config, _on(dev, spikes)).cpu().numpy()
    np.testing.assert_array_equal(got, scan_counts(config, spikes))
    assert got.sum() > 0  # the saturating regime fired


@pytest.mark.parametrize("B", [3, 4, 17])
def test_lif_count_bipolar_compiled_matches_scan(dev, B):
    rng = np.random.default_rng(47 + B)
    C, T = 6, 96
    config = make_config(47, C=2 * C, rec_coef=-1, w_scale=30)
    kp = (rng.random((T, B, C)) < 0.2).astype(np.int8)
    kn = (rng.random((T, B, C)) < 0.2).astype(np.int8)
    got = lk.lif_count_rates_bipolar(config, _on(dev, kp), _on(dev, kn), spike_bound=1)
    enc_btc = np.concatenate([kp & (1 - kn), kn], axis=-1).astype(np.int32).transpose(1, 0, 2)
    np.testing.assert_array_equal(got.cpu().numpy(), scan_counts(config, enc_btc))
    assert cs.check_pack(torch, lk, _on(dev, kp).bool(), _on(dev, kn).bool(), "tests_gpu") == 0


def test_lif_stateful_compiled_chunked_equals_full(dev):
    config = make_config(53, rec_coef=-2)
    spikes = make_spikes(53, T=96)
    B, N = spikes.shape[0], config.w_in.shape[1]
    state = [torch.zeros((B, N), dtype=torch.int32, device=dev) for _ in range(3)]
    total = np.zeros((B, N), np.int64)
    for part in np.split(spikes, [40, 64], axis=1):  # ragged: 40 + 24 + 32
        counts, *state = lk.lif_count_stateful(config, _on(dev, part), *state)
        total += counts.cpu().numpy()
    np.testing.assert_array_equal(total, scan_counts(config, spikes))


# ------------------------------------------------------- suppression kernels
def test_select_by_distance_compiled_matches_xla(dev):
    rng = np.random.default_rng(3)
    x = torch.as_tensor(np.cumsum(rng.standard_normal((5, 2050)).astype(np.float32), axis=-1), device=dev)
    cand = peaks.local_maxima_mask(x)
    for d in (3, 13):
        ref = peaks.select_by_distance(cand, x, d)
        got = sk.select_by_distance_tm(cand.T.contiguous(), x.T.contiguous(), d).T
        assert torch.equal(got.cpu(), ref.cpu()), f"distance {d}"


def _rzcc_case(dev, seed, T, d, W, plateau=False):
    rng = np.random.default_rng(seed)
    cs_ = np.cumsum(rng.standard_normal((6, T)).astype(np.float32), axis=-1)
    if plateau:
        cs_[:, 500:504] = cs_[:, 500:501]  # an exact plateau
    x = torch.as_tensor(np.ascontiguousarray(cs_.T), device=dev)
    kp, kn = sk.rzcc_encode_bipolar_tm(x, d, W)
    rp, rn = sk.rzcc_encode_bipolar_tm_plain(x, d, W)
    assert torch.equal(kp.cpu(), rp.cpu()) and torch.equal(kn.cpu(), rn.cpu())


def test_rzcc_encode_bipolar_compiled_matches_xla(dev):
    _rzcc_case(dev, 7, 4000, 13, 26, plateau=True)


@pytest.mark.parametrize("d,W", [(24, 48), (80, 24)], ids=["tb1280", "tb512-1round"])
def test_rzcc_encode_wide_window_compiled_matches_xla(dev, d, W):
    _rzcc_case(dev, 11, 6000, d, W)


# --------------------------------------------------- end-to-end device parity
def _frames(geometry, doas, dur, sig_fn, noise, seed):
    t = torch.arange(0, dur, 1 / FS, dtype=torch.float64)
    sig = sig_fn(t)
    rng = np.random.default_rng(seed)
    out = [signal_from_template(geometry, t, sig, float(d), fs=FS).numpy().astype(np.float32) for d in doas]
    return t.numpy(), sig.numpy(), np.stack([o + noise * rng.standard_normal(o.shape).astype(np.float32)
                                             for o in out])


def _small_demo(dev, freq_bands, G):
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo

    return Demo(geometry=CenterCircularArray(radius=4.5e-2, num_mic=7), freq_bands=freq_bands,
                doa_list=np.linspace(-np.pi, np.pi, G), recording_duration=0.1, kernel_duration=5e-3,
                bipolar_spikes=True, fs=FS, design_chunk=8, use_cache=False, device=dev)


@pytest.mark.parametrize("freq_bands", [[[1600, 1900]], [[1600, 1900], [1900, 2200]]], ids=["one-band", "two-band"])
def test_forward_batch_rate_profile_parity_vs_cpu(dev, freq_bands):
    """``forward_batch`` on the card (K1, K2, pack, K3, the lifted IIR
    kernel) against the CPU path driving the same saved model, to the JAX
    test's rate-profile tolerance and DoAs within a grid step."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo

    demo = _small_demo(dev, freq_bands, 57)
    _, _, batch = _frames(demo.geometry, (0.6, -1.2), 0.1, lambda t: torch.sin(2 * np.pi * 1750 * t), 0.05, 0)
    _, rate_dev = demo.forward_batch(batch, method="peak")
    with tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "model.npz")
        demo.save(path)
        _, rate_cpu = Demo.load(path, device="cpu").forward_batch(batch, method="peak")
    rate_dev, rate_cpu = rate_dev.cpu().numpy(), rate_cpu.numpy()
    rel = np.linalg.norm(rate_dev - rate_cpu, axis=-1) / np.maximum(np.linalg.norm(rate_cpu, axis=-1), 1e-9)
    assert np.all(rel < 0.05), rel
    assert np.all(np.abs(rate_dev.argmax(-1) - rate_cpu.argmax(-1)) <= 1)


# ---------------------------------------------------- serving ingest parity
def test_ingest_u4_upsample_compiled_matches_host(dev):
    """The u4 wire's decode (nibbles through the 16-entry table) and the
    polyphase upsampler on the card, as the server runs them, against the
    host decode and ``upsample_poly``."""
    from haghighatshoarmuir2024_tpu_torch.ops.mulaw import mulaw4_decode, mulaw4_decode_table, mulaw4_encode, pack4
    from haghighatshoarmuir2024_tpu_torch.ops.resample import (TAPS_PER_PHASE, design_upsample_fir, phase_table,
                                                               upsample_poly, upsample_poly_stream)

    rng = np.random.default_rng(5)
    B, Tw, M, F = 8, 3000, 7, 4
    x = np.clip(rng.standard_normal((B, Tw, M)) * 0.4, -1, 1).astype(np.float32)
    packed = np.stack([pack4(mulaw4_encode(x[b])) for b in range(B)])
    tbl4 = torch.as_tensor(mulaw4_decode_table(), device=dev)
    r = torch.as_tensor(packed, device=dev).long()
    xw = torch.stack([tbl4[(r >> 4) & 0xF], tbl4[r & 0xF]], dim=2).reshape(B, packed.shape[1] * 2, M)
    K = TAPS_PER_PHASE - 1
    y, carry = upsample_poly_stream(xw, torch.zeros((B, K, M), device=dev), phase_table(design_upsample_fir(F), F), F)
    dec = np.stack([mulaw4_decode(mulaw4_encode(x[b])) for b in range(B)])
    gold = np.stack([upsample_poly(dec[b], design_upsample_fir(F), F) for b in range(B)])
    np.testing.assert_allclose(y.cpu().numpy(), gold, rtol=0, atol=3e-5)
    np.testing.assert_array_equal(carry.cpu().numpy(), dec[:, -K:, :])


def test_matched_stacked_forward_tpu_consistent(dev):
    """The band-stacked matched estimators on the card against scoring the
    card's own rates on the host, and within a grid step of the truth."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo.pipeline import _auto_blend_scores, _blockcos

    demo = _small_demo(dev, [[1600, 1900], [1900, 2200]], 33)
    grid = demo.doa_list
    sig_fn = lambda t: torch.sin(2 * np.pi * 1750 * t) + torch.sin(2 * np.pi * 2050 * t)  # noqa: E731
    doas_true = np.array([-2.0, 0.5, 2.5])
    t, sig, batch = _frames(demo.geometry, doas_true, 0.1, sig_fn, 0.0, 0)
    demo.calibrate_profiles(template=(t, sig), use_cache=False, band_stacked=True)
    step = grid[1] - grid[0]
    rate = demo.rates_batch(batch).cpu()
    prof = torch.as_tensor(np.asarray(demo._profiles_stacked, np.float32))
    G = len(grid)
    host = {"matched_stacked": _blockcos(rate, G) @ _blockcos(prof, G).T,
            "matched_auto": _auto_blend_scores(rate, prof, G)}
    for method, scores in host.items():
        doa_dev, _ = demo.forward_batch(batch, method=method)
        np.testing.assert_allclose(doa_dev.cpu().numpy(), grid[scores.argmax(-1).numpy()], atol=1e-6)
        err = np.abs(np.arcsin(np.abs(np.sin(doa_dev.cpu().numpy() - doas_true))))
        assert np.all(err <= step + 1e-6), (method, err)


def test_srp_phat_device_matches_host_reference(dev):
    from haghighatshoarmuir2024_tpu_torch.models.srp_phat import SRPPHAT

    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 65)
    srp = SRPPHAT(geometry, freq_range=[1400, 2100], doa_list=grid, fs=FS, frame_duration=0.25, device=dev)
    assert srp._steer_re.dtype == torch.float32  # real planes, not complex
    doa_true = 0.9
    _, _, x = _frames(geometry, (doa_true,), 0.25, lambda t: torch.sin(2 * np.pi * 1750 * t), 0.0, 7)
    x = x[0]
    sigma = np.sqrt(np.mean(x ** 2) / 10.0)
    x = (x + sigma * np.random.default_rng(7).standard_normal(x.shape)).astype(np.float32)
    p_dev = srp.apply_to_signal(torch.as_tensor(x, device=dev)).cpu().numpy()
    X = np.fft.rfft(x.astype(np.float64), axis=0)[srp._bins]
    pi, pj = [p[0] for p in srp._pairs], [p[1] for p in srp._pairs]
    cross = X[:, pi] * np.conj(X[:, pj])
    Rf = (cross / np.maximum(np.abs(cross), 1e-12)).T.reshape(-1)
    p_host = (Rf.real @ srp._steer_re.cpu().numpy().astype(np.float64)
              - Rf.imag @ srp._steer_im.cpu().numpy().astype(np.float64)) / len(srp._pairs)
    assert np.argmax(p_dev) == np.argmax(p_host)
    peak = np.abs(p_host).max()
    np.testing.assert_allclose(p_dev / peak, p_host / peak, rtol=0, atol=0.03)
    est = grid[int(np.argmax(p_dev))]
    assert abs(np.arcsin(abs(np.sin(est - doa_true)))) <= grid[1] - grid[0] + 1e-6


# ------------------------------------------------------- lifted IIR encode
@pytest.mark.parametrize("band,T,L", [((1600.0, 1900.0), 12_000, 16), ((500.0, 3000.0), 24_000, 8)])
def test_iir_blocked_cumsum_device_parity(dev, band, T, L):
    """The ``iir_lifted`` kernel against cumsum(scan) on the card, float64
    lfilter and its plain version, within 3 sqrt(T) eps_f32 of each
    column's largest value (chip_smoke phase 27)."""
    errs = cs.check_iir_scan(torch, dev, band, T, L)
    assert max(errs.values()) <= cs.iir_bound(T)


def test_iir_blocked_cumsum_carried_seam_device(dev):
    sb, fs, T, seed = cs.IIR_SEAMS[0]
    assert sb == 32
    assert max(cs.check_iir_seam(torch, dev, sb, fs, T, seed).values()) <= cs.iir_bound(T)


def test_iir_blocked_cumsum_sb48_seam_device(dev):
    sb, fs, T, seed = cs.IIR_SEAMS[1]
    assert sb == 48
    assert max(cs.check_iir_seam(torch, dev, sb, fs, T, seed).values()) <= cs.iir_bound(T)


def test_multi_target_music_tracking_device_matches_host(dev):
    """Noise-subspace MUSIC → ``top_k_peaks`` → the gated tracker on the
    card against the host ``MultiDoaTracker`` fed the same peaks; both
    targets tracked through a bearing crossing."""
    from haghighatshoarmuir2024_tpu_torch.models.music import MUSIC
    from haghighatshoarmuir2024_tpu_torch.utils.tracking import MultiDoaTracker, track_multi_angles

    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 225)
    music = MUSIC(geometry, (1000.0, 2000.0), grid, frame_duration=0.25, fs=FS, device=dev)
    dur, frame = 3.0, 0.25
    t = torch.arange(0, dur, 1 / FS, dtype=torch.float64)
    tr1 = torch.as_tensor(np.deg2rad(-70 + 100 * t.numpy() / t[-1].item()).astype(np.float32))
    tr2 = torch.as_tensor(np.deg2rad(70 - 100 * t.numpy() / t[-1].item()).astype(np.float32))
    x = (signal_from_template(geometry, t, torch.sin(2 * np.pi * 1500 * t), tr1, fs=FS, delay_sign=-1)
         + signal_from_template(geometry, t, torch.sin(2 * np.pi * 1600 * t), tr2, fs=FS, delay_sign=-1)).numpy()
    rng = np.random.default_rng(0)
    x = (x + np.sqrt(np.mean(x ** 2) / 10) * rng.standard_normal(x.shape)).astype(np.float32)
    n, Tf = int(dur / frame), int(frame * FS)
    z, valid = np.zeros((n, 2), np.float32), np.zeros((n, 2), bool)
    for k in range(n):
        p = music.beamforming(torch.as_tensor(x[k * Tf:(k + 1) * Tf], device=dev), 2, 2048, num_sources=2)
        idx, _, ok = peaks.top_k_peaks(p, 2, distance=len(grid) // 32, rel_height=0.2)
        z[k], valid[k] = grid[idx.cpu().numpy()], ok.cpu().numpy()
    thetas, confirmed = track_multi_angles(torch.as_tensor(z), torch.as_tensor(valid), num_tracks=4, max_misses=4,
                                           device=dev)
    thetas, confirmed = thetas.cpu().numpy(), confirmed.cpu().numpy()
    trk = MultiDoaTracker(4, max_misses=4)
    for i in range(n):
        th_h, cf_h = trk.update(z[i], valid[i])
        np.testing.assert_array_equal(confirmed[i], cf_h)
        np.testing.assert_allclose(np.sin(thetas[i] - th_h), 0.0, atol=1e-5)
    assert confirmed[-1].sum() == 2
    fc = (np.arange(n) + 0.5) * frame
    tru1, tru2 = np.interp(fc, t.numpy(), tr1.numpy()), np.interp(fc, t.numpy(), tr2.numpy())
    fold = lambda e, tr: np.rad2deg(np.arcsin(np.abs(np.sin(e - tr))))  # noqa: E731
    slots = np.nonzero(confirmed[2])[0]
    s1 = int(slots[np.argmin(fold(thetas[2, slots], tru1[2]))])
    s2 = int(slots[np.argmin(fold(thetas[2, slots], tru2[2]))])
    assert s1 != s2
    assert fold(thetas[2:, s1], tru1[2:]).max() < 15.0
    assert fold(thetas[2:, s2], tru2[2:]).max() < 15.0


# ------------------------------------------- interference-removal design
def test_generalized_top_eigvec_on_device(dev):
    assert cs.check_eigvec(torch, dev) < cs.EIG_TOL


# ------------------------------------------------ the width contract
def test_stream_answer_independent_of_batch_width(dev):
    """A step of 1, 4, 7, 12 and 24 streams against the same lanes of the
    96-stream step on the flagship's serving demo: every stage of the
    step's own route bit for bit (chip_smoke phase 26), and the matched
    scores of the first w frames against the same frames among 96."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
    from haghighatshoarmuir2024_tpu_torch.models.xylo.flagship import flagship_config, flagship_frames
    from haghighatshoarmuir2024_tpu_torch.runtime import StreamingLocalizer

    demo = Demo(**flagship_config(dev))
    demo.calibrate_profiles()
    frames, _ = flagship_frames(demo, 96, seed=cs.SEED)
    diffs = cs.width_diagnostic(torch, StreamingLocalizer(demo), frames, (1, 4, 7, 12, 24), cs.WIDTH_STEPS)
    bad = {w: {k: d[k] for k in cs.WIDTH_GATED if d[k]} for w, d in diffs.items()}
    assert not any(bad.values()), bad
    scores = cs.scoring_diagnostic(torch, demo, demo.rates_batch(frames), cs.SCORE_WIDTHS)
    assert not any(any(v) for v in scores.values()), scores
