"""The calibration tables of the port's speech-target Xylo harness
(``run_speech``: the design tone over the model's 1.0 s, the chirp and the
speech of the trials) against the JAX package's on the CPU, bipolar, at the
JAX package's test size, with the tolerances of
``tests/test_torch_speech_harnesses.py`` (its docstring); and the harness's
command line, which prints JAX's keys."""
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_speech_harnesses import SIZE, _one_torch_thread, caches, check_calibration_tables, xylo  # noqa: E402,F401


def test_torch_speech_calibration_tables_match_jax(caches):  # noqa: F811
    check_calibration_tables(bipolar=True)


def test_torch_speech_cli_prints_jax_keys(capsys, caches):  # noqa: F811
    """``--speech`` at the test size, on the design and tables the test
    above left in the cache: the JSON of JAX's ``main_speech``."""
    argv = ["--speech", "--sims", "1", "--grid", str(SIZE["num_grid"]), "--duration", str(SIZE["duration"]),
            "--device", "cpu"]
    out = xylo.main(argv)
    printed = json.loads(capsys.readouterr().out)
    assert printed == out and out["experiment"] == "target_xylo_speech_bipolar"
    res = out["results"]
    assert sorted(res) == ["beam_profiles", "calibration_robustness", "speech_mc"]
    assert sorted(res["beam_profiles"]) == ["+0dB", "+10dB", "+20dB", "-10dB"]
    assert all(sorted(v) == ["matched_speech_err_deg", "matched_tone_err_deg", "peak_err_deg", "sidelobe_db"]
               for v in res["beam_profiles"].values())
    assert sorted(res["speech_mc"]) == ["matched_speech_cal", "matched_tone_cal", "reference_peak", "snr_db"]
    assert len(res["speech_mc"]["matched_speech_cal"]["mae_deg"]) == 11
    assert sorted(res["calibration_robustness"]) == ["chirp", "speech", "tone"]
