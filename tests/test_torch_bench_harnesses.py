"""The port's harnesses that time and check its paths
(``haghighatshoarmuir2024_tpu_torch/experiments/``: flagship_attribution,
serving_throughput, reduced_rate, multiband_bench, wire_accuracy,
design_time_probe, phase_analysis) against their JAX twins in
``experiments/`` on the CPU, on the same numpy inputs, at a small size
(a 17-point grid, 0.1-0.25 s frames, 2-4 trials or streams).

The Xylo models are JAX's: both packages' design caches point at one
temporary directory, so the port reads the design and table JAX wrote (a
design's unit phase is LAPACK's choice in either package and the quantized
weights follow it).  Where a JAX twin's harness cannot run at a small size
(its batch of 96 timed, its 449-point grid), the test runs the lines of its
trial on JAX's model.  Tolerances:

- DoAs equal, grid rows 0 and G-1 one direction; MAEs equal;
- the synthesized frames within 2e-4 of their peak (float32 on both sides:
  ``SYNTH_TOL``);
- the wire round trips bit-equal (numpy on both sides);
- phase_analysis's numbers within 1e-4 relative of JAX's, but for the
  band-limited noise's statistics from each package's own float32 scan of
  the high-Q bandpass: JAX's XLA contracts ``b·x − a·y`` of the recurrence
  into one fused multiply-add, the port rounds the product first, and the
  scans part by 2e-4 of their peak (6e-4 relative, measured); from JAX's
  filtered signal the port's statistics are within 1e-4.
"""
import contextlib
import glob
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "experiments"))
import common as jax_common  # noqa: E402
import phase_analysis as jax_phase  # noqa: E402
import wire_accuracy as jax_wire  # noqa: E402

import haghighatshoarmuir2024_tpu as jpkg  # noqa: E402
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo  # noqa: E402
from haghighatshoarmuir2024_tpu.ops import iir as jax_iir  # noqa: E402
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template as jax_signal_from_template  # noqa: E402
from haghighatshoarmuir2024_tpu.runtime import StreamingLocalizer as JaxStreamingLocalizer  # noqa: E402
from haghighatshoarmuir2024_tpu.utils import cache as jax_cache  # noqa: E402

import haghighatshoarmuir2024_tpu_torch as tpkg  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import (design_time_probe, flagship_attribution,  # noqa: E402
                                                          multiband_bench, phase_analysis, reduced_rate,
                                                          serving_throughput, wire_accuracy)
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.models.xylo import multiband as mb  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.runtime import StreamingLocalizer  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.utils import cache as torch_cache  # noqa: E402

FS, G = 48_000, 17
GRID = np.linspace(-np.pi, np.pi, G)
GEO = dict(radius=4.5e-2, num_mic=7)
# float32 synthesis, JAX's against the port's, as a fraction of the frame's
# peak: a query time t + delay rounds to a float32 step of t·6e-8 s, and the
# two packages' cosines differ in the last bit of a few delays, so a sample's
# interpolation index may move by up to T·6e-8 samples (7e-4 at T = 12 000);
# a tone of 1.6-2.6 kHz then moves by up to 1e-4 of its peak (measured 5.9e-5)
SYNTH_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Long Python loops of small tensor ops: one intra-op thread under the
    lane's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _caches(tmp_path_factory):
    """No committed XLA executables; JAX's and the port's design caches in
    one temporary directory, so the port finds the designs JAX makes."""
    d = str(tmp_path_factory.mktemp("designs"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        mp.setattr(jax_cache, "_DEFAULT_DIR", d)
        mp.setenv(torch_cache.CACHE_ENV, d)
        yield d


def quiet(fn, *args, **kwargs):
    """A JAX twin's function without its printed lines, in float32."""
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()), \
            jax.enable_x64(False):
        return fn(*args, **kwargs)


def grid_index(doa, grid=GRID) -> np.ndarray:
    idx = np.abs(np.asarray(doa, np.float64).reshape(-1)[:, None] - grid[None, :]).argmin(axis=1)
    return idx % (len(grid) - 1)


def models(fs=FS, duration=0.25, bands=((1600, 1900),), template=None, **kw):
    """JAX's model of a configuration, calibrated, and the port's on JAX's
    design and table (read from the shared cache)."""
    cfg = dict(freq_bands=[list(b) for b in bands], doa_list=GRID, recording_duration=duration,
               kernel_duration=10e-3, bipolar_spikes=True, fs=fs, **kw)
    with jax.enable_x64(False):
        jd = JaxDemo(geometry=jpkg.CenterCircularArray(**GEO), **cfg)
        jd.calibrate_profiles(template=template)
    td = Demo(geometry=tpkg.CenterCircularArray(**GEO), **cfg, device="cpu")
    td.calibrate_profiles(template=template)
    np.testing.assert_array_equal(td._profiles, np.asarray(jd._profiles))
    return jd, td


# ------------------------------------------------------------ flagship_attribution
def test_torch_flagship_attribution_stages_equal_forward_batch():
    """The attribution's prefixes compute what ``forward_batch`` computes:
    the counts of encode → RZCC → LIF estimate to its DoAs and rates, and
    the harness's run reports its stages, JAX's names, summing to the total."""
    _, demo = models(duration=0.05)
    x, doas, _ = serving_throughput.stream_chunks(demo, 2, 0.05, (1600, 1900))
    fns = flagship_attribution.prefixes(demo, x)
    torch.testing.assert_close(fns["encode"](), demo.encode(x), rtol=0, atol=0)
    counts = fns["encode+RZCC+LIF"]()
    torch.testing.assert_close(counts, fns["[isolated] LIF"](), rtol=0, atol=0)
    for method in ("peak", "matched"):
        doa, rate = demo.forward_batch(x, method=method)
        e_doa, e_rate = demo.estimate(counts, x.shape[1], method)
        assert torch.equal(doa, e_doa) and torch.equal(rate, e_rate)
    assert torch.equal(fns["forward_batch (peak)"]()[0], demo.forward_batch(x, method="peak")[0])
    res = flagship_attribution.run(reps=1, rounds=1, demo=demo, frames=(x, doas))
    s = res["stages_ms"]
    assert list(s) == ["encode", "RZCC (in-program)", "LIF (in-program)", "fold+argmax epilogue",
                       "matched epilogue", "TOTAL (matched)"]
    assert sum(v for k, v in s.items() if k != "TOTAL (matched)") == pytest.approx(s["TOTAL (matched)"], rel=1e-9)
    assert set(res["k2_flag_reads"].values()) == {0}  # the CPU path has no kernel and no flag read
    assert res["device_ms"] is res["idle_ms"] is res["device_gap_ms"] is None  # no CUPTI trace off the card
    assert res["doa"] == demo.forward_batch(x, method="matched")[0].tolist()
    out = io.StringIO()
    flagship_attribution.print_stages(res, file=out)
    assert "TOTAL (matched)" in out.getvalue() and "[isolated" in out.getvalue()


def test_torch_flagship_attribution_gap_splits_into_device_and_idle():
    """The isolated stages' sum is encode + RZCC + LIF alone plus the
    epilogues' in-program shares, and its gap to the batch on the events'
    clock is the device gap plus the idle gap, each reading split as events
    = device + idle."""
    rng = np.random.default_rng(0)
    names = flagship_attribution.SUMMED + ("encode+RZCC", "forward_batch (peak)")
    events = {k: float(v) for k, v in zip(names, rng.uniform(0.1, 2.5, len(names)))}
    stages = flagship_attribution.attribute(events)
    assert flagship_attribution.isolated_sum(events) == pytest.approx(
        events["encode"] + events["[isolated] RZCC"] + events["[isolated] LIF"] + stages["fold+argmax epilogue"]
        + stages["matched epilogue"], rel=1e-12)
    busy = {k: events[k] * float(f) for k, f in zip(flagship_attribution.SUMMED, rng.uniform(0.5, 1.0, 5))}
    idle = {k: events[k] - busy[k] for k in flagship_attribution.SUMMED}
    gap = flagship_attribution.isolated_sum(events) - events["forward_batch (matched)"]
    parts = [flagship_attribution.isolated_sum(t) - t["forward_batch (matched)"] for t in (busy, idle)]
    assert gap == pytest.approx(sum(parts), rel=1e-12)
    assert parts[0] == pytest.approx(busy["encode"] + busy["[isolated] RZCC"] + busy["[isolated] LIF"]
                                     - busy["encode+RZCC+LIF"], rel=1e-12)


# ------------------------------------------------------------ serving_throughput
def jax_chunks(batch, chunk_sec, band, sources=1):
    """JAX ``main``'s stream chunks (``serving_throughput.py:71-93``)."""
    geo = jpkg.CenterCircularArray(**GEO)
    t, sig = jax_common.sinusoid_template(float(np.mean(band)), chunk_sec, fs=FS)
    doas = np.linspace(-np.pi, np.pi, batch, endpoint=False)
    with jax.enable_x64(False):
        chunks = np.stack([np.asarray(jax_signal_from_template(geo, t, sig, float(d), fs=FS))
                           for d in doas]).astype(np.float32)
        if sources == 2:
            sig2 = np.sin(2 * np.pi * (float(np.mean(band)) + 100.0) * np.arange(0, chunk_sec, 1 / FS))
            doas_b = np.arctan2(np.sin(doas + 2.0), np.cos(doas + 2.0))
            chunks = chunks + np.stack([np.asarray(jax_signal_from_template(geo, np.arange(0, chunk_sec, 1 / FS),
                                                                            sig2, float(d), fs=FS))
                                        for d in doas_b]).astype(np.float32)
    return chunks + 0.1 * np.random.default_rng(0).standard_normal(chunks.shape).astype(np.float32)


@pytest.mark.parametrize("sources", [1, 2])
def test_torch_serving_batched_step_matches_jax(sources):
    """The harness's streams equal JAX's within ``SYNTH_TOL``; three
    carried steps of the batched runtime on JAX's chunks give JAX's DoAs
    (JAX's runtime in its TPU form); ``main`` prints JAX's keys."""
    B, Tc_s, band = 4, 0.1, (1600, 1900)
    jd, td = models(duration=Tc_s)
    want = jax_chunks(B, Tc_s, band, sources)
    got, doas, doas_b = serving_throughput.stream_chunks(td, B, Tc_s, band, sources)
    assert np.abs(got.numpy() - want).max() <= SYNTH_TOL * np.abs(want).max()
    jsl = JaxStreamingLocalizer(jd)
    jsl._on_tpu = True
    jsl.N_state = len(jsl._bp[0][1]) - 1
    tsl = StreamingLocalizer(td)
    ts = tsl.init_state(batch=B)
    with jax.enable_x64(False):
        js = jsl.init_state(batch=B)
        for _ in range(3):
            js, _ = jsl.process_chunk(js, jnp.asarray(want))
            ts = tsl.process_chunk(ts, want, return_spikes=False)
        j_doa = np.asarray(jsl.estimate_doa(js, "matched"))
    np.testing.assert_array_equal(grid_index(tsl.estimate_doa(ts, "matched").numpy()), grid_index(j_doa))
    m = serving_throughput.main(batch=B, chunk_sec=Tc_s, n_steps=2, num_grid=G, sources=sources, demo=td,
                                latency_reps=(1, 1))
    assert list(m) == ["serving-audio-sec/sec", "serving-step-ms", "streams",
                       "doa-ok-frac@5deg" if sources == 1 else "nearest-source-frac@5deg", "sources",
                       "latency-ms-blocking", "latency-ms-pipelined"]
    assert m["streams"] == B and m["sources"] == sources


@pytest.mark.parametrize("shm,wire,up", [(False, "i16", 1), (True, "u4", 4)])
def test_torch_serving_daemon_round(shm, wire, up):
    """One TCP and one shared-memory run of ``daemon_main`` on localhost:
    every stream answered, each answer the direct step's on the decoded
    wire chunks, JAX's keys, and no shared-memory ring left behind; then
    the same run through the C producer clients, answering alike."""
    B, Tc_s, n_steps = 2, 0.1, 1
    _, td = models(duration=Tc_s)
    answers = {}
    m = serving_throughput.daemon_main(batch=B, chunk_sec=Tc_s, n_steps=n_steps, num_grid=G, use_shm=shm,
                                       wire=wire, wire_upsample=up, demo=td, answers=answers)
    assert list(m)[:7] == [("shm" if shm else "daemon") + "-audio-sec/sec", "daemon-step-ms", "streams",
                           "doa-ok-frac@5deg", "sources", "wire", "native-clients"]
    assert m["wire"] == wire + ("@12k" if up == 4 else "")
    chunks, _, _ = serving_throughput.stream_chunks(td, B, Tc_s, (1600, 1900))
    sent = serving_throughput.wire_chunks(chunks, wire, up)
    want = serving_throughput.direct_answers(td, sent, n_steps + 1, wire, up)
    np.testing.assert_array_equal(np.float32([answers[i] for i in range(B)]), want)
    assert not glob.glob(f"/dev/shm/hm2024_bench_{os.getpid()}_*")
    # the C producer clients (native/streamc.cpp) on the same chunks: the Python clients' answers
    native = {}
    m = serving_throughput.daemon_main(batch=B, chunk_sec=Tc_s, n_steps=n_steps, num_grid=G, use_shm=shm,
                                       wire=wire, wire_upsample=up, demo=td, answers=native, native_clients=True)
    assert m["native-clients"] is True
    np.testing.assert_array_equal(np.float32([native[i] for i in range(B)]), want)
    assert not glob.glob(f"/dev/shm/hm2024_bench_{os.getpid()}_*")


# ------------------------------------------------------------ reduced_rate
def jax_rate_estimates(jd, fs, num_sims, snrs, band=(1600, 1900), seed=0):
    """The trial lines of JAX ``run_rate`` (``reduced_rate.py:68-90``) on
    JAX's model: the DoAs, the matched and the peak estimates."""
    geometry = jd.geometry
    t = np.arange(0, 0.25, 1 / fs)
    sig = np.sin(2 * np.pi * float(np.mean(band)) * t).astype(np.float32)
    rng = np.random.default_rng(seed)
    out = []
    with jax.enable_x64(False):
        fwd = jax.jit(jax.vmap(jd._forward_matched_jit))
        for snr_db in snrs:
            doas = rng.uniform(-np.pi, np.pi, size=num_sims)
            frames = np.asarray(jax.jit(jax.vmap(lambda d: jax_signal_from_template(geometry, t, sig, d, fs=fs)))(
                jnp.asarray(doas))).astype(np.float32)
            p_sig = frames.var(axis=(1, 2), keepdims=True)
            sigma = np.sqrt(p_sig / 10 ** (snr_db / 10))
            frames = frames + sigma * rng.standard_normal(frames.shape).astype(np.float32)
            d_est, rate = fwd(jnp.asarray(frames))
            out.append((doas, frames, np.asarray(d_est), GRID[np.argmax(np.asarray(rate), axis=-1)]))
    return out


@pytest.mark.parametrize("fs", [48_000, 24_000, 12_000])
def test_torch_reduced_rate_matches_jax(fs):
    """A rate's trials on JAX's model: the frames within ``SYNTH_TOL``,
    equal matched and peak DoAs, equal MAEs.  At 12 kHz (no bundled design,
    tau 1.1 samples) the quantizer gives JAX's ``dash`` and weights."""
    jd, td = models(fs=fs)
    for name in ("w_in", "w_rec", "w_out", "dash_syn", "dash_mem", "threshold"):
        np.testing.assert_array_equal(getattr(td.xylo_config, name), np.asarray(getattr(jd.xylo_config, name)))
    snrs = [0.0, 10.0]
    want = jax_rate_estimates(jd, fs, 3, snrs)
    rng = np.random.default_rng(0)
    for (doas, frames, est_m, est_p), snr in zip(want, snrs):
        got, got_doas = reduced_rate.trial_batch(td, rng, 3, snr, (1600, 1900))
        np.testing.assert_array_equal(got_doas, doas)
        assert np.abs(got.numpy() - frames).max() <= SYNTH_TOL * np.abs(frames).max()
        d, rate = td.forward_batch(torch.as_tensor(frames), method="matched")
        np.testing.assert_array_equal(grid_index(d.numpy()), grid_index(est_m))
        np.testing.assert_array_equal(grid_index(GRID[rate.argmax(dim=-1).numpy()]), grid_index(est_p))
    row = reduced_rate.run_rate(fs, 3, snrs, G, demo=td, throughput=False)
    err = lambda e, d: float(np.mean(np.degrees(np.arcsin(np.abs(np.sin(e - d))))))  # noqa: E731
    assert row["matched_mae_deg"] == pytest.approx([err(w[2], w[0]) for w in want], abs=1e-9)
    assert row["peak_mae_deg"] == pytest.approx([err(w[3], w[0]) for w in want], abs=1e-9)
    assert row["tau_samples"] == pytest.approx(fs / (2 * np.pi * 1750.0))


# ------------------------------------------------------------ multiband_bench
def test_torch_multiband_bench_matches_jax():
    """The three-band harness (a 17-point grid) on JAX's model and frames
    (noise from JAX's ``PRNGKey(0)``): JAX's keys, and the ok-fractions of
    JAX's ``forward_batch`` on the same frames."""
    bands = [tuple(b) for b in mb.BANDS]
    jd, td = models(bands=bands, enforce_hw_limits=False, template=mb.wideband_template(FS))
    t, sig = mb.wideband_template(FS)
    doas = np.linspace(-np.pi, np.pi, 4, endpoint=False)
    with jax.enable_x64(False):
        geo = jpkg.CenterCircularArray(**GEO)
        frames = np.stack([np.asarray(jax_signal_from_template(geo, t, sig, float(d), fs=FS)) for d in doas])
        frames = (frames + 0.1 * np.asarray(jax.random.normal(jax.random.PRNGKey(0), frames.shape))).astype(np.float32)
        j_m, _ = jd.forward_batch(jnp.asarray(frames), method="matched")
        j_p, _ = jd.forward_batch(jnp.asarray(frames), method="peak")
    res = multiband_bench.run(n_rep=1, demo=td, frames=(torch.as_tensor(frames), doas))
    assert list(res) == ["experiment", "fs", "freq_bands", "batch", "throughput_audio_sec_per_sec", "ms_per_batch",
                         "design_s", "calib_s", "compile_s", "doa_ok_frac_matched_5deg", "doa_ok_frac_peak_25deg"]
    assert res["freq_bands"] == mb.BANDS and res["batch"] == 4
    ok = lambda e, tol: float(np.mean(np.rad2deg(np.arcsin(np.abs(np.sin(np.asarray(e) - doas)))) < tol))  # noqa: E731
    assert res["doa_ok_frac_matched_5deg"] == ok(j_m, 5.0)
    assert res["doa_ok_frac_peak_25deg"] == ok(j_p, 25.0)
    np.testing.assert_array_equal(grid_index(td.forward_batch(frames, method="matched")[0].numpy()),
                                  grid_index(np.asarray(j_m)))


# ------------------------------------------------------------ wire_accuracy
@pytest.mark.parametrize("wire,up", wire_accuracy.WIRES)
def test_torch_wire_roundtrip_bit_equal(wire, up):
    """Every wire's round trip bit-equal to JAX's on the same frame."""
    x = np.random.default_rng(1).standard_normal((4800, 7))
    x = (x / np.abs(x).max() * 0.98).astype(np.float32)
    np.testing.assert_array_equal(wire_accuracy.roundtrip(x, wire, up), jax_wire.roundtrip(x, wire, up))


def test_torch_wire_accuracy_matches_jax():
    """JAX's ``run`` (2 trials at 2 dB, a 17-point grid) and the port's on
    JAX's model: equal MAEs for every wire."""
    want = quiet(jax_wire.run, num_sims=2, num_grid=G, snrs=(2.0,))
    _, td = models()
    assert wire_accuracy.run(2, G, snrs=(2.0,), demo=td) == want


# ------------------------------------------------------------ design_time_probe
def test_torch_design_time_probe_keys():
    """JAX's keys (``design_time_probe.py:75-83``), on a 17-point grid."""
    res = design_time_probe.run(G, device="cpu")
    assert list(res) == ["experiment", "design_first_call_s", "design_warm_call_s", "design_compile_share_s",
                         "demo_init_total_s", "demo_minus_design_s"]
    assert res["experiment"] == "design_time_probe" and res["design_warm_call_s"] > 0


# ------------------------------------------------------------ phase_analysis
def test_torch_phase_analysis_matches_jax():
    """Every number within 1e-4 relative of JAX's ``main``; the band-limited
    noise's from each package's own scan within 1e-3, from JAX's filtered
    signal within 1e-4 (module docstring)."""
    want = quiet(jax_phase.main)
    got = phase_analysis.run(device="cpu")
    assert list(got) == list(want)
    for group, rows in want.items():
        assert list(got[group]) == list(rows)
        for k, v in rows.items():
            assert got[group][k] == pytest.approx(v, rel=1e-3 if group == "random_wideband_phase" else 1e-4)
    with jax.enable_x64(False):
        b, a = jax_iir.butter_bandpass(2, (1600, 1900), FS)
        noise = np.random.default_rng(0).standard_normal(int(round(0.25 * FS)))
        sig = np.asarray(jax_iir.iir_filter(b, a, jnp.asarray(noise), axis=0, method="scan"))
    for k, v in phase_analysis.wideband_stats(sig, torch.device("cpu")).items():
        assert v == pytest.approx(want["random_wideband_phase"][k], rel=1e-4)


# ------------------------------------------------------------ on the card by default
@pytest.mark.parametrize("name,argv", [
    ("flagship_attribution", ["--quick"]), ("serving_throughput", ["--quick"]),
    ("serving_throughput", ["--quick", "--daemon"]), ("reduced_rate", ["--quick"]),
    ("multiband_bench", ["--quick"]), ("wire_accuracy", ["--quick"]), ("design_time_probe", ["--quick"]),
    ("phase_analysis", ["--quick"]), ("snn_localization_benchmark", ["--quick"]),
    ("analyse_array_localization", ["--quick"]), ("reverb_robustness", ["--quick"]),
])
def test_torch_harnesses_default_to_the_card(name, argv, monkeypatch):
    """Without ``--device`` each harness asks for the card, and raises
    rather than running on the CPU."""
    import importlib

    mod = importlib.import_module(f"haghighatshoarmuir2024_tpu_torch.experiments.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = mod.cli if name == "serving_throughput" else mod.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(argv)
