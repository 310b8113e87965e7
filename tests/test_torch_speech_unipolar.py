"""The port's speech-target Xylo harness with a unipolar model
(``run_speech(bipolar=False)``, the CLI's ``--speech --unipolar``) against
its JAX twin on the CPU, at the JAX package's test size, with the checks
and tolerances of ``tests/test_torch_speech_harnesses.py`` (its docstring):
stage A on the same numpy noise, stages B and C on JAX's draws (every DoA
equal but for near ties), and the port's own three calibration tables from
JAX's design against JAX's."""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_speech_harnesses import (_one_torch_thread, caches, check_calibration_tables,  # noqa: E402,F401
                                         speech_run, test_torch_speech_beam_profiles_match_jax as beam_check,
                                         test_torch_speech_mc_and_robustness_match_jax_draws as mc_check)


@pytest.fixture(scope="module")
def speech_runs(caches):  # noqa: F811
    return speech_run(bipolar=False)


def test_torch_unipolar_speech_beam_profiles_match_jax(speech_runs):
    beam_check(speech_runs)


def test_torch_unipolar_speech_mc_and_robustness_match_jax_draws(speech_runs):
    mc_check(speech_runs)


def test_torch_unipolar_speech_calibration_tables_match_jax(speech_runs):
    check_calibration_tables(bipolar=False)
