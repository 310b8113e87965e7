"""The port's speech harnesses beside ``run_speech`` against their JAX twins
on the CPU, at the JAX package's own test sizes, on the synthetic speech
fallback (the LibriSpeech sample is not in the repository):

- ``experiments/multiband_speech.py``: ``run`` (one band against three, eight
  estimators) and ``run_cross_segment`` at ``tests/test_experiment_speech.py:73``'s
  size (2 trials, a 16-point grid, 0.1 s, chunks of 2, the SNRs cut to 0 and
  20 dB in both packages as that test cuts them; the cross-segment SNRs are
  the harness's), on JAX's design and tables (one shared design cache) and
  JAX's draws replayed through ``draws=``: every trial's DoA the same grid
  index in every estimator column;
- ``experiments/xylo_ordering_sensitivity.py --speech`` at 2 trials and one
  SNR (10 dB; a 17-point grid, 0.05 s): on the same numpy draws and JAX's
  input rasters each step convention's MAE equal to JAX's, and the port's
  own rasters of its frames within ``RASTER_APART`` of JAX's (at this size
  a moved spike can flip a trial's peak: the MAE of 2 trials is not
  compared on the two packages' own rasters);
- ``experiments/short_hilbert_transform.py``: the kernel responses and the
  RZCC timing (numpy on the host, and the RZCC of one tone) within 1e-12 of
  JAX's, relative, and the spike count equal; the STHT's errors against
  scipy's Hilbert transform within 1e-6 of JAX's, absolute: both packages
  compute the STHT in float32 (JAX's CLI by FFT, the port by the
  blocked-Toeplitz form of its encode), and the errors themselves are that
  rounding, 1e-7 to 6e-7;
- the command lines print JAX's keys.

The JAX twins run in float32 (``jax.enable_x64(False)``), as their CLIs
do, on JAX's speech template as its own tests compute it, under x64
(``x64_speech_template`` of ``tests/test_torch_speech_harnesses.py``).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_speech_harnesses import (_one_torch_thread, caches, grid_index, jax_draws, jax_mb,  # noqa: E402,F401
                                         jax_ordering, jax_stht, quiet, recorded, same_keys, x64_speech_template)

from haghighatshoarmuir2024_tpu_torch.experiments import (multiband_speech, short_hilbert_transform,  # noqa: E402
                                                          xylo_ordering_sensitivity)
from haghighatshoarmuir2024_tpu_torch.experiments.common import speech_template  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.parallel import montecarlo  # noqa: E402

SIZE = dict(num_sims=2, num_grid=16, duration=0.1)
JAX_CHUNK = 2  # JAX's test's chunk; the port's CHUNK (16) also gives one forward of the 2 trials
SNRS = [0.0, 20.0]
RASTER_APART = 1e-3  # test_torch_streaming.py's bound on raster entries apart from the same audio
ORDERING = ["--speech", "--sims", "2", "--snrs", "10", "--grid", "17", "--duration", "0.05", "--json"]


@pytest.fixture(scope="module")
def multiband_runs(caches):
    """Both packages' ``run`` and ``run_cross_segment``, the port on JAX's
    designs, tables and draws; every DoA either scores, in order."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mb, "speech_template", x64_speech_template)
        mp.setattr(jax_mb, "SNRS", SNRS)
        mp.setattr(multiband_speech, "SNRS", SNRS)
        draws = jax_draws(SIZE["num_sims"], len(speech_template(SIZE["duration"])[0]), 0)
        for name, jax_fn, port_fn in (("run", jax_mb.run, multiband_speech.run),
                                      ("cross", jax_mb.run_cross_segment, multiband_speech.run_cross_segment)):
            jcalls = recorded(mp, [jax_mb])
            with jax.enable_x64(False):
                want = jax_fn(**SIZE, chunk=JAX_CHUNK)
            tcalls = recorded(mp, [montecarlo])
            got = port_fn(**SIZE, device="cpu", draws=draws)
            out[name] = dict(want=want, got=got, jax_doa=jcalls, port_doa=tcalls)
            mp.undo()
            mp.setattr(jax_mb, "speech_template", x64_speech_template)
            mp.setattr(jax_mb, "SNRS", SNRS)
            mp.setattr(multiband_speech, "SNRS", SNRS)
    return out


@pytest.mark.parametrize("name", ["run", "cross"])
def test_torch_multiband_speech_matches_jax_draws(multiband_runs, name):
    r, G = multiband_runs[name], SIZE["num_grid"]
    # run: the single band's two columns at each SNR, then the three bands' eight; cross: two columns at three SNRs
    shapes = [(SIZE["num_sims"], 2)] * 2 + [(SIZE["num_sims"], 8)] * 2 if name == "run" else [(SIZE["num_sims"], 2)] * 3
    assert [d.shape for d in r["jax_doa"]] == [d.shape for d in r["port_doa"]] == shapes
    for j, p in zip(r["jax_doa"], r["port_doa"]):
        np.testing.assert_array_equal(grid_index(p, G), grid_index(j, G))
    same_keys(r["got"], r["want"])
    flat = lambda d: {k: v for k, v in d.items() if k.endswith("_mae_deg")}  # noqa: E731
    for part in ([r["got"]] if name == "cross" else [r["got"]["single_band_1000_2000"], r["got"]["three_band_500_3000"]]):
        want = r["want"] if name == "cross" else r["want"][next(k for k, v in r["got"].items() if v is part)]
        for k, v in flat(part).items():  # equal DoAs: the MAE rows JAX rounds to 0.01 in float32
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-4, err_msg=k)


def test_torch_ordering_sensitivity_speech_matches_jax(caches, monkeypatch, capsys):
    """The harness on the same numpy draws and the same input rasters: JAX's
    rasters, recorded as its simulator takes them, go to the port's
    simulator in place of the port's own encode of its frames, which must
    agree with them but for ``RASTER_APART`` of the entries (float32
    synthesis and encode round apart at near ties); then every step
    convention's MAE equals JAX's."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    import xylo_ordering_sensitivity as jax_os

    rasters, apart = [], []
    real_sim = jax_os.sim_hidden_batch

    def record(cfg, spikes_in, **kwargs):
        if not rasters or rasters[-1] is not spikes_in:
            rasters.append(spikes_in)
        return real_sim(cfg, spikes_in, **kwargs)

    monkeypatch.setattr(jax_os, "speech_template", x64_speech_template)
    monkeypatch.setattr(jax_os, "sim_hidden_batch", record)
    with jax.enable_x64(False):
        want = jax_ordering(ORDERING)
    real_encoding = Demo.spike_encoding

    def shared(self, frames):
        own = real_encoding(self, frames)
        jax_raster = torch.as_tensor(np.asarray(rasters[len(apart)]), dtype=own.dtype)
        apart.append(float((own != jax_raster).to(torch.float64).mean()))
        return jax_raster

    monkeypatch.setattr(Demo, "spike_encoding", shared)
    got = xylo_ordering_sensitivity.main(ORDERING + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(json.dumps(got))
    assert len(apart) == len(rasters) == 1 and max(apart) < RASTER_APART
    assert got["target"] == want["target"] == "speech" and sorted(got) == sorted(want)
    for variant, per_snr in want["mae_by_variant"].items():
        np.testing.assert_allclose(got["mae_by_variant"][variant]["10.0"], per_snr["10.0"], rtol=0, atol=1e-9)
    assert abs(got["worst_delta_deg"] - want["worst_delta_deg"]) <= 1e-9


def test_torch_short_hilbert_transform_matches_jax(capsys):
    with jax.enable_x64(False):
        want = quiet(jax_stht.main)
    got = short_hilbert_transform.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == {"experiment": "short_hilbert_transform", "results": got}
    same_keys(got, want)
    for d, w in want["kernel_response"].items():
        for k, v in w.items():
            assert abs(got["kernel_response"][d][k] - v) <= 1e-12 * abs(v), (d, k)
    for d, w in want["stht_vs_hilbert"].items():
        for k, v in w.items():
            assert abs(got["stht_vs_hilbert"][d][k] - v) <= 1e-6 and got["stht_vs_hilbert"][d][k] < 1e-5, (d, k)
    assert got["rzcc_timing"]["num_pos_spikes"] == want["rzcc_timing"]["num_pos_spikes"] == 100
    for k in ("phase_mean", "phase_std"):
        assert abs(got["rzcc_timing"][k] - want["rzcc_timing"][k]) <= 1e-12


@pytest.mark.parametrize("flag", [[], ["--cross-segment"]])
def test_torch_multiband_speech_cli_prints_jax_keys(multiband_runs, flag, capsys):
    """On the designs and tables the runs above left in the cache."""
    argv = ["--sims", "1", "--grid", str(SIZE["num_grid"]), "--duration", str(SIZE["duration"]), "--device", "cpu"]
    out = multiband_speech.main(argv + flag)
    assert json.loads(capsys.readouterr().out) == out
    want = multiband_runs["cross" if flag else "run"]["want"]
    assert out["experiment"] == ("multiband_speech_cross_segment" if flag else "multiband_speech")
    assert sorted(out["results"]) == sorted(want)
