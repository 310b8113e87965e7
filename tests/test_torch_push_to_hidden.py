"""The push-to-hidden deployment (``models/xylo/push_to_hidden.py``,
``XyloSimPushToHidden``) and the energy proxy (``models/xylo/power.py``)
against the JAX package on the CPU.

The JAX ``DemoPushToHidden`` designs the band (65-point grid, 0.1 s, 5 ms
STHT kernel); its design goes into the port's design cache under the same
key, so the port's ``DemoPushToHidden`` quantizes the same matrices.
Bit-exact: the config and its fan-out truncation, the stage-1 parameters,
``evolve_to_hidden`` (recorded states too), the block recurrent form
``[[0, W], [0, R]]`` for a zero, uniform and dense R, two calls across the
one-step seam against one call, and ``xylo_process``.  The census and the
power estimate within rtol 1e-12 (integer sums, float64 products)."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import DemoPushToHidden as JaxDemoPushToHidden
from haghighatshoarmuir2024_tpu.models.xylo import EnergyModel as JaxEnergyModel
from haghighatshoarmuir2024_tpu.models.xylo import count_operations as jax_count_operations
from haghighatshoarmuir2024_tpu.models.xylo import estimate_power as jax_estimate_power
from haghighatshoarmuir2024_tpu.models.xylo.quantize import XyloConfig as JaxXyloConfig
from haghighatshoarmuir2024_tpu.models.xylo.sim import XyloSimPushToHidden as JaxXyloSimPushToHidden
from haghighatshoarmuir2024_tpu.models.xylo.sim import _sim_hidden as jax_sim_hidden
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.xylo import (DemoPushToHidden, EnergyModel, XyloConfig,
                                                          count_operations, estimate_power)
from haghighatshoarmuir2024_tpu_torch.models.xylo.sim import XyloSim, XyloSimPushToHidden
from haghighatshoarmuir2024_tpu_torch.utils.cache import DesignCache, design_cache_key

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "experiments"))
import target_push_to_hidden as jax_harness  # noqa: E402

from haghighatshoarmuir2024_tpu_torch.experiments import target_push_to_hidden as harness  # noqa: E402

FS, G = 48_000, 65
SMALL = dict(freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, G), recording_duration=0.1,
             kernel_duration=5e-3, bipolar_spikes=True, fs=FS)
FIELDS = ("w_in", "w_rec", "w_out", "dash_syn", "dash_mem", "dash_syn_out", "dash_mem_out", "threshold",
          "threshold_out")


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        mp.setenv("HM2024_TORCH_CACHE", str(tmp_path_factory.mktemp("torch_cache")))
        jp = JaxDemoPushToHidden(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), **SMALL,
                                 use_cache=False)
        geo = tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7)
        key = design_cache_key(
            r_vec=geo.r_vec, theta_vec=geo.theta_vec, speed=geo.speed,
            freq_bands=np.atleast_2d(np.asarray(SMALL["freq_bands"], dtype=np.float64)),
            doa_list=np.asarray(SMALL["doa_list"], dtype=np.float64), recording_duration=0.1,
            kernel_duration=5e-3, bipolar=True, fs=FS, version=1)
        DesignCache().save(key, {"bf_0": jp.bf_mats[0]})
        tp = DemoPushToHidden(geometry=geo, **SMALL, device="cpu")
    t = np.arange(0, 0.1, 1 / FS)
    frame = np.asarray(signal_from_template(jp.geometry, t, np.sin(2 * np.pi * 1750 * t), 0.7, fs=FS))
    frame = (frame + 0.2 * np.random.default_rng(0).standard_normal(frame.shape)).astype(np.float32)
    return jp, tp, frame


def input_spikes(n: int, T: int, seed: int, p: float = 0.1) -> np.ndarray:
    return (np.random.default_rng(seed).random((T, n)) < p).astype(np.int32)


def test_torch_push_to_hidden_config_matches_jax(demos):
    jp, tp, _ = demos
    np.testing.assert_array_equal(tp.bf_mats[0], jp.bf_mats[0])
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tp.xylo_config, name)),
                                      np.asarray(getattr(jp.xylo_config, name)), err_msg=name)
    assert tp.xylo_config.weight_scale == jp.xylo_config.weight_scale
    np.testing.assert_array_equal(tp.spec.w_in, jp.spec.w_in)
    # the reference's <= quirk: the uniform w_rec is zeroed entirely, each
    # w_in row keeps at most 62 entries
    assert np.count_nonzero(tp.xylo_config.w_rec) == 0
    assert np.count_nonzero(tp.xylo_config.w_in, axis=1).max() <= DemoPushToHidden.MAX_FAN_OUT - 1
    sim, jsim = tp.xylo, jp.xylo
    assert (sim.n_stage1, sim.n_stage2) == (jsim.n_stage1, jsim.n_stage2)
    assert sim.injection_weight == int(jsim._inj)
    for mine, ref in ((sim.dash_syn_in, jsim._dash_syn_in), (sim.dash_mem_in, jsim._dash_mem_in),
                      (sim.threshold_in, jsim._threshold_in)):
        np.testing.assert_array_equal(mine, np.asarray(ref))


@pytest.mark.parametrize("record", [False, True])
def test_torch_push_to_hidden_evolve_matches_jax(demos, record):
    jp, tp, _ = demos
    x = input_spikes(tp.xylo.n_stage1, 300, seed=1)
    jp.xylo.reset_state()
    tp.xylo.reset_state()
    j_spk, j_state, j_rec = jp.xylo.evolve_to_hidden(x, record=record)
    t_spk, t_state, t_rec = tp.xylo.evolve_to_hidden(x, record=record)
    np.testing.assert_array_equal(t_spk.numpy(), np.asarray(j_spk))
    assert sorted(t_rec) == sorted(j_rec)
    for k in j_rec:
        np.testing.assert_array_equal(t_rec[k].numpy(), np.asarray(j_rec[k]), err_msg=k)
    for stage in ("stage1", "stage2"):
        for g, r in zip(t_state[stage], j_state[stage]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(t_spk[:, tp.xylo.n_stage1:].sum()) > 0


def block_case(tp, rec: str):
    """A push-to-hidden simulator on the demo's config with stage 2's
    recurrence R set to zero (as truncated), uniform or dense."""
    cfg = tp.xylo_config
    n2 = cfg.n_hidden
    rng = np.random.default_rng(2)
    w_rec = {"zero": np.zeros((n2, n2)), "uniform": np.full((n2, n2), -2),
             "dense": rng.integers(-3, 4, size=(n2, n2)) * (rng.random((n2, n2)) < 0.2)}[rec].astype(np.int32)
    fields = {name: np.asarray(getattr(cfg, name)) for name in FIELDS}
    fields["w_rec"] = w_rec
    sim = tp.xylo
    args = (sim.injection_weight, sim.dash_syn_in, sim.dash_mem_in, sim.threshold_in)
    t = XyloSimPushToHidden(XyloConfig(**fields, dt=cfg.dt, weight_scale=cfg.weight_scale), *args, device="cpu")
    j = JaxXyloSimPushToHidden(JaxXyloConfig(**fields, dt=cfg.dt, weight_scale=cfg.weight_scale), *args)
    return t, j, w_rec


@pytest.mark.parametrize("rec", ["zero", "uniform", "dense"])
def test_torch_push_to_hidden_equals_block_recurrent_form(demos, rec):
    """The two stages scanned apart equal one ``XyloSim`` run of the block
    config ``[[0, W], [0, R]]`` (the port's dense scan and JAX's), and the
    decomposed form equals JAX's."""
    _, tp, _ = demos
    t, j, w_rec = block_case(tp, rec)
    n1, n2 = t.n_stage1, t.n_stage2
    x = input_spikes(n1, 200, seed=3)
    ours, _, _ = t.evolve_to_hidden(x)
    ref, _, _ = j.evolve_to_hidden(x)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    bc = t.block_config()
    np.testing.assert_array_equal(bc.w_rec[n1:, n1:], w_rec)
    _, _, rec_b = XyloSim(bc, device="cpu")(x)
    block = rec_b["Spikes"]
    np.testing.assert_array_equal(ours.numpy(), block.numpy())
    state0 = tuple(jnp.zeros(n1 + n2, jnp.int32) for _ in range(3))
    j_block, _, _ = jax_sim_hidden(jnp.asarray(x @ bc.w_in), jnp.asarray(bc.w_rec), jnp.asarray(0, jnp.int32),
                                   jnp.asarray(bc.dash_syn), jnp.asarray(bc.dash_mem), jnp.asarray(bc.threshold),
                                   state0, uniform_rec=False, record=False)
    np.testing.assert_array_equal(block.numpy(), np.asarray(j_block))
    assert int(ours[:, n1:].sum()) > 0


@pytest.mark.parametrize("split", [1, 57, 150])
@pytest.mark.parametrize("rec", ["zero", "dense"])
def test_torch_push_to_hidden_seam_two_calls_equal_one(demos, rec, split):
    """The first stage-2 input of a call is the previous call's last
    stage-1 spike: two calls equal one call on the joined raster, and JAX's
    two calls."""
    _, tp, _ = demos
    t, j, _ = block_case(tp, rec)
    x = input_spikes(t.n_stage1, 200, seed=4, p=0.2)
    whole, _, _ = t.evolve_to_hidden(x)
    t.reset_state()
    parts = [t.evolve_to_hidden(x[:split])[0], t.evolve_to_hidden(x[split:])[0]]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), whole.numpy())
    j_parts = [np.asarray(j.evolve_to_hidden(x[:split])[0]), np.asarray(j.evolve_to_hidden(x[split:])[0])]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), np.concatenate(j_parts))
    # the seam carries a spike across
    assert int(parts[0][-1, :t.n_stage1].sum()) > 0 or split == 1


def test_torch_push_to_hidden_xylo_process_matches_jax(demos):
    jp, tp, frame = demos
    raster = np.array(jp.spike_encoding(frame))
    ref = np.asarray(jp.xylo_process(raster))
    got = tp.xylo_process(raster)
    assert got.shape == (raster.shape[0], G)
    np.testing.assert_array_equal(got.numpy(), ref)
    batch = tp.xylo_process(np.stack([raster, raster[::-1].copy()]))
    np.testing.assert_array_equal(batch[0].numpy(), ref)
    np.testing.assert_array_equal(batch[1].numpy(), np.asarray(jp.xylo_process(raster[::-1].copy())))


def assert_dicts_close(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("model", [None, (3e-12, 1e-12, 4e-12, 1e-4)])
def test_torch_estimate_power_matches_jax(demos, model):
    jp, tp, frame = demos
    raster = np.array(jp.spike_encoding(frame))
    hidden = np.array(jp.xylo_process(raster))
    t_model = EnergyModel() if model is None else EnergyModel(*model)
    j_model = JaxEnergyModel() if model is None else JaxEnergyModel(*model)
    got = estimate_power(tp.xylo_config, torch.as_tensor(raster), torch.as_tensor(hidden), 0.1, t_model)
    ref = jax_estimate_power(jp.xylo_config, raster, hidden, audio_duration=0.1, model=j_model)
    assert_dicts_close(got, ref)
    assert got["power_avg_uW"] > t_model.p_static * 1e6
    assert_dicts_close(count_operations(tp.xylo_config, raster, hidden),
                       jax_count_operations(jp.xylo_config, raster, hidden))


def test_torch_power_workload_matches_jax_harness(demos):
    """The harness's random-spike workload (2 ms at 1 kHz from seed 0):
    the port's power dict equals the JAX twin's."""
    jp, tp, _ = demos
    assert_dicts_close(harness.power_measurement(tp), jax_harness.power_measurement(jp))
