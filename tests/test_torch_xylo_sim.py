"""The port's integer simulator (``models/xylo/sim.py``: ``XyloSim``,
``sim_hidden_batch``, ``scan_hidden``) against the JAX package's
(``_sim_hidden``, ``XyloSim``, ``sim_hidden_batch``) on the CPU, on the same
numpy inputs: all four step conventions with a zero, a uniform and a dense
``w_rec``, with and without the recorded ``Isyn``/``Vmem``, the readout
layer, ``synops``, state carried across calls, ``reset_state``, and
``evolve_to_hidden``'s default convention.  Everything is integer:
bit-exact.  The numpy golden of ``tests/test_xylo_sim.py`` pins the default
convention here too."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from haghighatshoarmuir2024_tpu.models.xylo.quantize import XyloConfig as JaxXyloConfig
from haghighatshoarmuir2024_tpu.models.xylo.sim import XyloSim as JaxXyloSim
from haghighatshoarmuir2024_tpu.models.xylo.sim import _sim_hidden as jax_sim_hidden
from haghighatshoarmuir2024_tpu.models.xylo.sim import sim_hidden_batch as jax_sim_hidden_batch

from haghighatshoarmuir2024_tpu_torch.models.xylo import XyloConfig, XyloSim, sim_hidden_batch
from haghighatshoarmuir2024_tpu_torch.models.xylo.sim import scan_hidden
from test_xylo_sim import _numpy_golden

CONVENTIONS = list(itertools.product(("decay_first", "integrate_first"), ("subtract", "zero")))
REC_KINDS = ("zero", "uniform", "dense")


def make_config(rec: str, n_in: int = 5, n_hid: int = 9, n_out: int = 2, gain: int = 1, seed: int = 0) -> dict:
    """The fields of a small random config (``test_xylo_sim._tiny_config``'s
    form) with the recurrence ``rec``; ``gain`` scales the weights until the
    16-bit state saturates."""
    rng = np.random.default_rng(seed)
    w_rec = {"zero": np.zeros((n_hid, n_hid)), "uniform": np.full((n_hid, n_hid), -3),
             "dense": rng.integers(-6, 7, size=(n_hid, n_hid))}[rec]
    return dict(
        w_in=gain * rng.integers(-30, 31, size=(n_in, n_hid)), w_rec=gain * w_rec,
        w_out=rng.integers(-30, 31, size=(n_hid, n_out)),
        dash_syn=rng.integers(1, 5, size=n_hid), dash_mem=rng.integers(1, 5, size=n_hid),
        dash_syn_out=np.ones(n_out), dash_mem_out=np.full(n_out, 2),
        threshold=np.full(n_hid, 40), threshold_out=np.full(n_out, 40),
    )


def configs(fields: dict):
    ints = {k: np.asarray(v, np.int32) for k, v in fields.items()}
    return (JaxXyloConfig(**ints, dt=1e-3, weight_scale=1.0), XyloConfig(**ints, dt=1e-3, weight_scale=1.0))


def spikes(T: int, n_in: int, seed: int, p: float = 0.3, max_count: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.random((T, n_in)) < p) * rng.integers(1, max_count + 1, size=(T, n_in))).astype(np.int32)


def eq(got, ref):
    np.testing.assert_array_equal(got.numpy() if torch.is_tensor(got) else np.asarray(got), np.asarray(ref))


def eq_state(got, ref):
    for g, r in zip(got, ref):
        eq(g, r)


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("rec", REC_KINDS)
@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_torch_xylo_sim_matches_jax(ordering, reset, rec, record):
    """One call of the full network (input projection, hidden scan, readout)
    with ``record_power``: every output and the final states bit-exact."""
    jcfg, tcfg = configs(make_config(rec))
    x = spikes(300, jcfg.n_in, seed=1)
    j = JaxXyloSim(jcfg, ordering=ordering, reset=reset)
    t = XyloSim(tcfg, ordering=ordering, reset=reset, device="cpu")
    j_out, j_state, j_rec = j(x, record=record, record_power=True)
    t_out, t_state, t_rec = t(x, record=record, record_power=True)
    eq(t_out, j_out)
    assert sorted(t_rec) == sorted(j_rec)
    for k in j_rec:
        assert t_rec[k].dtype == torch.int32
        eq(t_rec[k], j_rec[k])
    eq_state(t_state["hidden"], j_state["hidden"])
    eq_state(t_state["out"], j_state["out"])
    assert int(t_rec["Spikes"].sum()) > 0


@pytest.mark.parametrize("rec", REC_KINDS)
@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_torch_xylo_sim_saturating_state_matches_jax(ordering, reset, rec):
    """Weights 40x larger: the synaptic state hits the 16-bit clamps (the
    recorded ``Isyn`` reaches them), still bit-exact."""
    jcfg, tcfg = configs(make_config(rec, gain=40, seed=3))
    x = spikes(200, jcfg.n_in, seed=4, p=0.5, max_count=3)
    _, _, j_rec = JaxXyloSim(jcfg, ordering=ordering, reset=reset)(x, record=True)
    _, _, t_rec = XyloSim(tcfg, ordering=ordering, reset=reset, device="cpu")(x, record=True)
    for k in ("Spikes", "Isyn", "Vmem"):
        eq(t_rec[k], j_rec[k])
    # the clamp's ends, after integrate_first's decay of the clamped sum
    ds = np.asarray(tcfg.dash_syn) if ordering == "integrate_first" else 31
    hi, lo = 2**15 - 1 - ((2**15 - 1) >> ds), -(2**15) - (-(2**15) >> ds)
    isyn = t_rec["Isyn"].numpy()
    assert np.any((isyn == hi) | (isyn == lo))


@pytest.mark.parametrize("rec", REC_KINDS)
@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_torch_xylo_sim_state_carried_across_calls(ordering, reset, rec):
    """Two calls carry the state: equal to JAX's two calls and to one call
    on the joined raster; ``reset_state`` starts again from zero."""
    jcfg, tcfg = configs(make_config(rec, seed=5))
    x = spikes(240, jcfg.n_in, seed=6)
    j = JaxXyloSim(jcfg, ordering=ordering, reset=reset)
    t = XyloSim(tcfg, ordering=ordering, reset=reset, device="cpu")
    parts = []
    for lo, hi in ((0, 97), (97, 240)):
        j_out, j_state, j_rec = j(x[lo:hi], record=True)
        t_out, t_state, t_rec = t(x[lo:hi], record=True)
        eq(t_out, j_out)
        for k in ("Spikes", "Isyn", "Vmem"):
            eq(t_rec[k], j_rec[k])
        eq_state(t_state["hidden"], j_state["hidden"])
        eq_state(t_state["out"], j_state["out"])
        parts.append(t_rec["Spikes"])
    t.reset_state()
    _, _, whole = t(x, record=False)
    eq(torch.cat(parts), whole["Spikes"].numpy())
    t.reset_state()
    eq(t(x[:97])[2]["Spikes"], parts[0].numpy())


@pytest.mark.parametrize("rec", REC_KINDS)
@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_torch_evolve_to_hidden_runs_the_default_convention(ordering, reset, rec):
    """``evolve_to_hidden`` bypasses ``w_in`` and runs decay_first/subtract
    whatever the instance was given, as JAX's does (``sim.py:239-257``)."""
    jcfg, tcfg = configs(make_config(rec, seed=7))
    rng = np.random.default_rng(8)
    cur = rng.integers(-60, 61, size=(180, jcfg.n_hidden)).astype(np.int32)
    j_spk, j_state, j_rec = JaxXyloSim(jcfg, ordering=ordering, reset=reset).evolve_to_hidden(cur, record=True)
    t = XyloSim(tcfg, ordering=ordering, reset=reset, device="cpu")
    t_spk, t_state, t_rec = t.evolve_to_hidden(cur, record=True)
    eq(t_spk, j_spk)
    for k in ("Spikes", "Isyn", "Vmem"):
        eq(t_rec[k], j_rec[k])
    eq_state(t_state["hidden"], j_state["hidden"])
    default, _, _ = XyloSim(tcfg, device="cpu").evolve_to_hidden(cur)
    eq(t_spk, default.numpy())


@pytest.mark.parametrize("rec", REC_KINDS)
@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_torch_sim_hidden_batch_matches_jax(ordering, reset, rec):
    jcfg, tcfg = configs(make_config(rec, seed=9))
    batch = np.stack([spikes(160, jcfg.n_in, seed=s) for s in (10, 11, 12)])
    ref = jax_sim_hidden_batch(jcfg, batch, ordering=ordering, reset=reset)
    got = sim_hidden_batch(tcfg, torch.as_tensor(batch), ordering=ordering, reset=reset, device="cpu")
    assert got.shape == (3, 160, jcfg.n_hidden) and got.dtype == torch.int32
    eq(got, ref)


@pytest.mark.parametrize("rec", REC_KINDS)
def test_torch_xylo_sim_batch_rows_equal_single_calls(rec):
    """A (B, T, N_in) batch through the port's ``XyloSim`` gives each row's
    single-call outputs (the port's batched form; JAX's takes one row)."""
    _, tcfg = configs(make_config(rec, seed=13))
    batch = np.stack([spikes(120, tcfg.n_in, seed=s) for s in (14, 15)])
    b_out, b_state, b_rec = XyloSim(tcfg, ordering="integrate_first", device="cpu")(
        batch, record=True, record_power=True)
    for i, row in enumerate(batch):
        out, state, rec_i = XyloSim(tcfg, ordering="integrate_first", device="cpu")(row, record=True,
                                                                                     record_power=True)
        eq(b_out[i], out.numpy())
        for k in rec_i:
            eq(b_rec[k][i], rec_i[k].numpy())
        for g, r in zip(b_state["hidden"], state["hidden"]):
            eq(g[i], r.numpy())


@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_torch_scan_hidden_matches_jax_sim_hidden(ordering, reset):
    """The scan itself from a nonzero state with a dense recurrence, against
    ``_sim_hidden`` with its recorded states."""
    rng = np.random.default_rng(16)
    N, T = 11, 150
    inp = rng.integers(-90, 91, size=(T, N)).astype(np.int32)
    w_rec = rng.integers(-8, 9, size=(N, N)).astype(np.int32)
    ds, dm = rng.integers(1, 6, size=N).astype(np.int32), rng.integers(1, 6, size=N).astype(np.int32)
    th = rng.integers(20, 60, size=N).astype(np.int32)
    state0 = (rng.integers(-300, 300, size=N).astype(np.int32), rng.integers(-300, 300, size=N).astype(np.int32),
              (rng.random(N) < 0.5).astype(np.int32))
    j_spk, j_state, j_rec = jax_sim_hidden(
        jnp.asarray(inp), jnp.asarray(w_rec), jnp.asarray(0, jnp.int32), jnp.asarray(ds), jnp.asarray(dm),
        jnp.asarray(th), tuple(jnp.asarray(s) for s in state0), uniform_rec=False, record=True,
        ordering=ordering, reset=reset)
    t_spk, counts, t_state, t_rec = scan_hidden(torch.as_tensor(inp), ds, dm, th, state0, w_rec=w_rec,
                                                ordering=ordering, reset=reset, record_state=True, count=True)
    eq(t_spk, j_spk)
    eq(counts, np.asarray(j_spk).sum(axis=0))
    eq(t_rec["Isyn"], j_rec["Isyn"])
    eq(t_rec["Vmem"], j_rec["Vmem"])
    eq_state(t_state, j_state)


@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_torch_xylo_sim_matches_numpy_golden(ordering, reset):
    """``tests/test_xylo_sim.py``'s serial numpy twin, on its own config
    and input."""
    _, tcfg = configs(make_config("zero", n_in=4, n_hid=6))
    x = (np.random.default_rng(1).random((200, 4)) < 0.3).astype(np.int32)
    _, _, rec = XyloSim(tcfg, ordering=ordering, reset=reset, device="cpu")(x)
    eq(rec["Spikes"], _numpy_golden(tcfg, x, ordering=ordering, reset=reset))


def test_torch_xylo_sim_rejects_unknown_conventions():
    _, tcfg = configs(make_config("zero"))
    with pytest.raises(ValueError):
        XyloSim(tcfg, ordering="decay_last", device="cpu")
    with pytest.raises(ValueError):
        sim_hidden_batch(tcfg, torch.zeros((1, 5, tcfg.n_in), dtype=torch.int32), reset="halve", device="cpu")
