"""Public entry points that take an array-like, as the JAX package's do
through ``jnp.asarray``: a numpy input answers as JAX answers it, and lands
where the port puts data.

- ``utils.peak_location.find_peak_location`` and
  ``ops.spikes.ZeroCrossingSpikeEncoder.evolve`` on numpy input with
  ``device="cpu"`` equal the JAX functions on the same input (the peak index
  and the spikes exact);
- ``parallel.montecarlo.folded_angle_error`` (within 1e-12: float64 sine
  and arcsine of two libraries, an ulp apart at most) and
  ``parallel.mesh.pad_to_multiple`` (exact) on numpy input with
  ``device="cpu"`` equal JAX's; ``Demo.estimate_doa_from_rate`` on numpy
  rates equals the same rates as a tensor, on the model's device;
- with no ``device`` a numpy input asks for the card, which raises here
  (``torch.cuda.is_available`` patched false, as on a host without one),
  and a tensor stays where it is.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_numpy_inputs.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from haghighatshoarmuir2024_tpu.ops import spikes as jax_spikes
from haghighatshoarmuir2024_tpu.parallel import mesh as jax_mesh
from haghighatshoarmuir2024_tpu.parallel import montecarlo as jax_montecarlo
from haghighatshoarmuir2024_tpu.utils import peak_location as jax_peak_location

from haghighatshoarmuir2024_tpu_torch.ops import spikes
from haghighatshoarmuir2024_tpu_torch.parallel import mesh, montecarlo
from haghighatshoarmuir2024_tpu_torch.utils import peak_location

FS = 48_000
ANGLE_TOL = 1e-12


def noisy_peaks(seed: int, T: int = 200) -> np.ndarray:
    """A (T,) float64 row: a smooth bump at a random place on noise, with a
    second, narrower one."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    c1, c2 = rng.integers(10, T - 10, 2)
    return (np.exp(-0.5 * ((t - c1) / 6.0) ** 2) + 0.7 * np.exp(-0.5 * ((t - c2) / 2.0) ** 2)
            + 0.2 * rng.standard_normal(T))


def tones(seed: int, T: int = 600, C: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None] / FS
    return np.sin(2 * np.pi * rng.uniform(500, 4000, C) * t + rng.uniform(0, np.pi, C)) \
        + 0.2 * rng.standard_normal((T, C))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("win,periodic", [(5, True), (9, False), (1, True)])
def test_torch_find_peak_location_numpy_row(seed, win, periodic):
    x = noisy_peaks(seed)
    got = peak_location.find_peak_location(x, win, periodic=periodic, device="cpu")
    want = int(jax_peak_location.find_peak_location(x, win, periodic=periodic))
    assert got.device.type == "cpu" and int(got) == want
    assert torch.equal(got, peak_location.find_peak_location(torch.as_tensor(x), win, periodic=periodic))


@pytest.mark.parametrize("bipolar", [False, True])
@pytest.mark.parametrize("robust_width", [1, 4])
def test_torch_rzcc_encoder_numpy_signal(bipolar, robust_width):
    x = tones(robust_width)
    got = spikes.ZeroCrossingSpikeEncoder(FS, robust_width, bipolar).evolve(x, device="cpu")
    want = np.asarray(jax_spikes.ZeroCrossingSpikeEncoder(FS, robust_width, bipolar).evolve(x))
    assert got.device.type == "cpu" and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).sum() > 0 and (np.asarray(want) < 0).any() == bipolar


def test_torch_folded_angle_error_numpy():
    rng = np.random.default_rng(0)
    est, true = rng.uniform(-np.pi, np.pi, 64), rng.uniform(-np.pi, np.pi, 64)
    got = montecarlo.folded_angle_error(est, true, device="cpu")
    want = np.asarray(jax_montecarlo.folded_angle_error(jnp.asarray(est), jnp.asarray(true)))
    assert got.device.type == "cpu" and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ANGLE_TOL)
    tensor_est = torch.as_tensor(est)
    assert torch.equal(montecarlo.folded_angle_error(tensor_est, true), got)


@pytest.mark.parametrize("shape,multiple,axis", [((5, 3), 4, 0), ((6, 7), 3, 0), ((2, 5), 8, 1)])
def test_torch_pad_to_multiple_numpy(shape, multiple, axis):
    x = np.random.default_rng(1).standard_normal(shape)
    got, n = mesh.pad_to_multiple(x, multiple, axis, device="cpu")
    want, jn = jax_mesh.pad_to_multiple(jnp.asarray(x), multiple, axis)
    assert n == jn and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def demo():
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
    from haghighatshoarmuir2024_tpu_torch.models.xylo.flagship import flagship_config

    return Demo(**flagship_config("cpu"))


@pytest.mark.parametrize("method", ["peak", "periodic_ml", "trimmed_periodic_ml"])
def test_torch_estimate_doa_from_rate_numpy(demo, method):
    """Numpy rates (float32, as ``extract_rate`` gives them) land on the
    model's device and give the tensor route's DoAs."""
    rate = np.random.default_rng(2).random((5, len(demo.doa_list))).astype(np.float32)
    got = demo.estimate_doa_from_rate(rate, method)
    assert got.device == torch.device(demo.device)
    assert torch.equal(got, demo.estimate_doa_from_rate(torch.as_tensor(rate), method))
    assert torch.equal(demo.doa_scores(rate), torch.as_tensor(rate))


NUMPY_ROUTES = {
    "find_peak_location": lambda x, **kw: peak_location.find_peak_location(x[:, 0], 5, **kw),
    "ZeroCrossingSpikeEncoder.evolve": lambda x, **kw: spikes.ZeroCrossingSpikeEncoder(FS, 2, True).evolve(x, **kw),
    "folded_angle_error": lambda x, **kw: montecarlo.folded_angle_error(x[:, 0], x[:, 1], **kw),
    "pad_to_multiple": lambda x, **kw: mesh.pad_to_multiple(x, 7, **kw)[0],
}


@pytest.mark.parametrize("route", list(NUMPY_ROUTES))
def test_torch_numpy_input_lands_on_the_card(route, monkeypatch):
    """Without ``device`` a numpy input asks for the card, which raises
    ``RuntimeError`` on a host without one (it never runs on the CPU
    unasked); a CPU tensor stays on the CPU and answers as the numpy input
    with ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = tones(5, T=200, C=2)
    call = NUMPY_ROUTES[route]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(x)
    got = call(torch.as_tensor(x))
    assert got.device.type == "cpu"
    assert torch.equal(got, call(x, device="cpu"))
