"""The port's three Xylo experiment harnesses
(``haghighatshoarmuir2024_tpu_torch/experiments/``: target_xylo_localization,
xylo_ordering_sensitivity, target_push_to_hidden) run end to end on the CPU
at a small size (``--quick``, a 17-point grid, 0.05 s frames, the design in
a temporary cache) and print the JSON keys of their JAX twins
(``experiments/target_xylo_localization.py:445-470``,
``experiments/xylo_ordering_sensitivity.py:180-184``,
``experiments/target_push_to_hidden.py:88-97``): the summaries through
JAX's own ``common.summarize``, the rest as those lines write them."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "experiments"))
import common as jax_common  # noqa: E402

from haghighatshoarmuir2024_tpu_torch.experiments import (target_push_to_hidden, target_xylo_localization,  # noqa: E402
                                                          xylo_ordering_sensitivity)
from haghighatshoarmuir2024_tpu_torch.experiments.common import summarize  # noqa: E402

SMALL = ["--grid", "17", "--duration", "0.05", "--device", "cpu"]
VARIANT_NAMES = ["decay_first/subtract", "decay_first/zero", "integrate_first/subtract", "integrate_first/zero"]
ENVELOPE_KEYS = ["mae_deg_by_variant", "mae_deg_max", "mae_deg_min", "num_sims", "snr_db"]
POWER_KEYS = ["energy_dynamic_J", "energy_neuron_J", "energy_spike_J", "energy_synaptic_J", "neuron_updates",
              "power_avg_W", "power_avg_uW", "spike_events", "synops_in", "synops_out", "synops_rec",
              "synops_total", "timesteps"]


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HM2024_TORCH_CACHE", str(tmp_path))


def printed(capsys) -> dict:
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def test_torch_target_xylo_localization_quick(capsys):
    res = target_xylo_localization.main(["--quick", "--sims", "2"] + SMALL)
    assert printed(capsys) == res
    assert res["experiment"] == "target_xylo_bipolar_localization"
    fake = {"snr_db": np.zeros(2), "mae": np.zeros(2), "median": np.zeros(2)}
    assert summarize(fake) == jax_common.summarize(fake)
    sm = res["results"]
    assert sorted(sm) == ["matched_estimator", "reference_estimator", "reference_estimator_convention_envelope"]
    for k in ("matched_estimator", "reference_estimator"):
        assert sorted(sm[k]) == sorted(jax_common.summarize(fake))
        assert len(sm[k]["mae_deg"]) == 11 and all(np.isfinite(sm[k]["mae_deg"]))
    env = sm["reference_estimator_convention_envelope"]
    assert sorted(env) == ENVELOPE_KEYS and sorted(env["mae_deg_by_variant"]) == VARIANT_NAMES
    assert env["num_sims"] == 2 and all(lo <= hi for lo, hi in zip(env["mae_deg_min"], env["mae_deg_max"]))


def test_torch_xylo_ordering_sensitivity_quick(capsys):
    res = xylo_ordering_sensitivity.main(["--quick", "--json", "--snrs", "0", "10"] + SMALL)
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(res))
    assert "ordering ambiguity costs <=" in out
    assert sorted(res) == ["grid", "mae_by_variant", "sims", "snrs", "target", "worst_delta_deg"]
    assert res["target"] == "tone" and res["sims"] == 4 and res["grid"] == 17
    assert sorted(res["mae_by_variant"]) == VARIANT_NAMES
    for per_snr in res["mae_by_variant"].values():
        assert sorted(per_snr) == ["0.0", "10.0"] and all(len(v) == 2 for v in per_snr.values())


def test_torch_target_push_to_hidden_quick(capsys):
    res = target_push_to_hidden.main(["--quick"] + SMALL)
    assert printed(capsys) == res
    assert sorted(res) == ["experiment", "localization", "power", "w_in_max_fan_out", "w_rec_nonzeros"]
    assert sorted(res["power"]) == POWER_KEYS and res["power"]["timesteps"] == 96.0
    assert res["power"]["power_avg_uW"] > 220.0
    loc = res["localization"]
    assert sorted(loc) == ["errors_deg", "mae_deg", "snr_db"] and len(loc["errors_deg"]) == 4
