"""Streaming runtime of the PyTorch port against the JAX package's
``StreamingLocalizer`` in its TPU form, run here on the CPU.

The JAX runtime picks its TPU form (lifted blocked-cumsum bandpass with the
carried TDF2 state, the fused RZCC and the stateful bipolar LIF) from the
backend; these tests select it on the CPU by setting ``_on_tpu`` and
``N_state`` before the first step, without touching the JAX package.  The
design is the small one of ``tests/test_streaming.py`` (65-point grid, 5 ms
STHT kernel), built and calibrated in JAX, saved, and ``Demo.load``-ed into
the port.

Parity per stage on identical inputs: the carried lifted IIR to the
tolerance of ``test_torch_encode.py`` (1e-5·max), masks bit-exact from the
same analysis window, counts and final LIF state bit-exact from the same
masks.  End to end the float encodes differ in summation order; measured
over 3 streams × 3 chunks of 6000 samples, no spike and no count differed
(54 733 spikes), and the bound asserted is that of ``test_torch_slice.py``:
counts within 2, under 1 % of them different, DoAs identical."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.ops.iir import iir_filter
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template
from haghighatshoarmuir2024_tpu.ops.pallas.lif_kernel import lif_count_stateful_bipolar as jax_k4
from haghighatshoarmuir2024_tpu.ops.pallas.suppress_kernel import rzcc_encode_bipolar_tm as jax_rzcc
from haghighatshoarmuir2024_tpu.runtime import StreamingLocalizer as JaxStreamingLocalizer

from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
from haghighatshoarmuir2024_tpu_torch.ops.cuda.lif_kernel import lif_count_stateful_bipolar
from haghighatshoarmuir2024_tpu_torch.ops.cuda.suppress_kernel import rzcc_encode_bipolar_tm
from haghighatshoarmuir2024_tpu_torch.ops.iir import butter_bandpass, iir_cumsum_blocked
from haghighatshoarmuir2024_tpu_torch.runtime import StreamingLocalizer, StreamState

FS, TC, B = 48_000, 6000, 3
DOAS = (0.7, -1.4, 2.3)
TOL = 1e-5
# the carried encoder state after 3 chunks: the JAX runtime's quadrature FIR
# runs 128-sample Toeplitz blocks (the port's, 512), and the integrator total
# sums three chunks of float32 block sums; measured 1.1e-5·max on `pending`
TOL_STATE = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _no_jax_persistent_cache():
    """Build JAX Demos without seeding the committed XLA executables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        yield


@pytest.fixture(scope="module")
def demos(tmp_path_factory, _no_jax_persistent_cache):
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                 freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 65),
                 recording_duration=0.25, kernel_duration=5e-3, bipolar_spikes=True, fs=FS,
                 use_cache=False)
    jd.calibrate_profiles(use_cache=False)
    path = tmp_path_factory.mktemp("demo") / "small.npz"
    jd.save(str(path))
    return jd, Demo.load(str(path), device="cpu")


def jax_layout(state):
    """A port StreamState as numpy arrays in the JAX package's layout: every
    field leads with the stream axis."""
    out = {}
    for k, v in vars(state).items():
        a = v.numpy()
        out[k] = np.swapaxes(a, 0, 1) if k in ("fir_tail", "delay_line", "pending") else a
    return out


def jax_tpu_form(jd):
    sl = JaxStreamingLocalizer(jd)
    sl._on_tpu = True
    sl.N_state = len(sl._bp[0][1]) - 1
    return sl


@pytest.fixture(scope="module")
def streams(demos):
    jd, _ = demos
    t = np.arange(0, 3 * TC / FS, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    clean = np.stack([np.asarray(signal_from_template(jd.geometry, t, sig, d, fs=FS)) for d in DOAS])
    noise = 0.3 * np.random.default_rng(0).standard_normal(clean.shape)
    return (clean + noise).astype(np.float32)  # (B, 3·Tc, 7)


@pytest.fixture(scope="module")
def runs(demos, streams):
    """Both runtimes over 3 chunks of the 3 streams."""
    jd, td = demos
    jsl, tsl = jax_tpu_form(jd), StreamingLocalizer(td)
    js, ts = jsl.init_state(batch=B), tsl.init_state(batch=B)
    out = {"jsl": jsl, "tsl": tsl, "j_spikes": [], "t_spikes": [], "t_states": [ts]}
    for k in range(3):
        chunk = streams[:, k * TC:(k + 1) * TC]
        js, jsp = jsl.process_chunk(js, jnp.asarray(chunk))
        ts, tsp = tsl.process_chunk(ts, chunk)
        out["j_spikes"].append(np.asarray(jsp))
        out["t_spikes"].append(tsp.numpy())
        out["t_states"].append(ts)
        if k == 1:
            out["js_2"] = js
    out["js"], out["ts"] = js, ts
    return out


@pytest.mark.parametrize("T,sb", [
    (144, 48),  # nb = 3, Q = 3: level-2 lifting at the 0.125 s chunk's block size
    (96, 32),   # nb = 3: the smallest level-2 case
    (64, 32),   # nb = 2: level-1 recurrence
])
def test_torch_iir_cumsum_carried_state_matches_jax(T, sb):
    b, a = butter_bandpass(1, [1600, 1900], FS)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((T, 2, 7)).astype(np.float32)
    zi = (rng.standard_normal((2, 7, 3)) * [0.1, 0.1, 5.0]).astype(np.float32)  # TDF2 state + integrator total
    yj, sj = iir_filter(b, a, jnp.asarray(x), axis=0, method="blocked_cumsum", zi=jnp.asarray(zi),
                        return_state=True, sb=sb)
    yt, st = iir_cumsum_blocked(b, a, torch.as_tensor(x), zi=torch.as_tensor(zi), return_state=True, sb=sb)
    yj, sj = np.asarray(yj), np.asarray(sj)
    assert yt.shape == (T, 2, 7) and st.shape == (2, 7, 3)
    assert np.abs(yt.numpy() - yj).max() <= TOL * np.abs(yj).max()
    assert np.abs(st.numpy() - sj).max() <= TOL * np.abs(sj).max()


def test_torch_iir_cumsum_chunked_equals_full():
    b, a = butter_bandpass(1, [1600, 1900], FS)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((3 * TC, 2, 7)).astype(np.float32))
    full = iir_cumsum_blocked(b, a, x, sb=48)
    state, parts = None, []
    for k in range(3):
        y, state = iir_cumsum_blocked(b, a, x[k * TC:(k + 1) * TC], zi=state, return_state=True, sb=48)
        parts.append(y)
    assert float((torch.cat(parts) - full).abs().max()) <= TOL * float(full.abs().max())
    with pytest.raises(ValueError, match="multiple of the block size"):
        iir_cumsum_blocked(b, a, x[:100], return_state=True, sb=48)


def test_torch_streaming_masks_bitexact_on_same_window(runs, streams):
    """K1/K2's plain twin and the JAX fused RZCC on the same (L, B, C)
    analysis window: the one the port builds for chunk 3."""
    tsl, prev = runs["tsl"], runs["t_states"][2]
    integrated = tsl._encode(prev, torch.as_tensor(streams[:, 2 * TC:]).transpose(0, 1))[-1]
    window = torch.cat([prev.pending, integrated], dim=0)
    L, _, C = window.shape
    assert L == tsl.guard + tsl.pending + TC
    tp, tn = rzcc_encode_bipolar_tm(window.reshape(L, B * C), tsl.rw, 2 * tsl.rw)
    jp, jn = jax_rzcc(jnp.asarray(window.numpy().reshape(L, B * C)), tsl.rw, 2 * tsl.rw)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    kp = tp[tsl.guard:tsl.guard + TC].reshape(TC, B, C)
    kn = tn[tsl.guard:tsl.guard + TC].reshape(TC, B, C)
    np.testing.assert_array_equal(torch.cat([kp & ~kn, kn], dim=-1).numpy(), runs["t_spikes"][2])
    assert int(kp.sum() + kn.sum()) > 0


def test_torch_streaming_counts_bitexact_on_same_masks(runs):
    """The stateful LIF on chunk 3's decided masks from chunk 2's LIF state."""
    tsl, prev, ts = runs["tsl"], runs["t_states"][2], runs["t_states"][3]
    spikes = torch.as_tensor(runs["t_spikes"][2])  # (Tc, B, 2C) = [kp & ~kn, kn]
    C = spikes.shape[-1] // 2
    kp, kn = spikes[..., :C] != 0, spikes[..., C:] != 0
    state = (prev.isyn, prev.vmem, prev.spk)
    got = lif_count_stateful_bipolar(tsl.demo.xylo_config, kp, kn, *state)
    ref = jax_k4(runs["jsl"].demo.xylo_config, jnp.asarray(kp.numpy()), jnp.asarray(kn.numpy()),
                 *(jnp.asarray(s.numpy()) for s in state), spike_bound=1)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal((prev.counts + got[0]).numpy(), ts.counts.numpy())
    assert int(got[0].sum()) > 0


def test_torch_streaming_end_to_end_matches_jax(runs):
    jsl, tsl, js, ts = runs["jsl"], runs["tsl"], runs["js"], runs["ts"]
    for j, t in zip(runs["j_spikes"], runs["t_spikes"]):
        assert t.shape == j.shape == (TC, B, 2 * tsl.C) and t.dtype == np.int8
        assert (j != t).mean() < 1e-3
    jcounts, tcounts = np.asarray(js.counts), ts.counts.numpy()
    assert np.abs(jcounts - tcounts).max() <= 2
    assert (jcounts != tcounts).mean() < 0.01
    assert tcounts.sum() > 0
    for method in ("matched", "peak"):
        np.testing.assert_array_equal(tsl.estimate_doa(ts, method).numpy(),
                                      np.asarray(jsl.estimate_doa(js, method)))
    err = np.rad2deg(np.abs(np.arcsin(np.abs(np.sin(tsl.estimate_doa(ts, "matched").numpy() - DOAS)))))
    assert (err < 5.0).all()
    # the carried encoder state: pure copies exactly, filter state to float tolerance
    jn, tn = {k: np.asarray(v) for k, v in js._asdict().items()}, jax_layout(ts)
    for k in ("fir_tail", "delay_line", "steps"):
        np.testing.assert_array_equal(tn[k], jn[k])
    for k in ("iir_state", "int_carry", "pending"):
        assert tn[k].shape == jn[k].shape
        assert np.abs(tn[k] - jn[k]).max() <= TOL_STATE * np.abs(jn[k]).max()


def test_torch_streaming_from_jax_mid_stream_state(streams, runs):
    """Both runtimes resume from the same mid-stream state: the JAX state
    after two chunks, carried into the port with StreamState.from_numpy."""
    jsl, tsl, js = runs["jsl"], runs["tsl"], runs["js_2"]
    ts = StreamState.from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    assert ts.pending.shape == (tsl.guard + tsl.pending, B, tsl.C) and ts.steps.tolist() == [2 * TC] * B
    chunk = streams[:, 2 * TC:]
    js, jsp = jsl.process_chunk(js, jnp.asarray(chunk))
    ts, tsp = tsl.process_chunk(ts, chunk)
    assert (np.asarray(jsp) != tsp.numpy()).mean() < 1e-3
    assert np.abs(np.asarray(js.counts) - ts.counts.numpy()).max() <= 2
    for k, v in jax_layout(ts).items():
        assert v.shape == np.asarray(getattr(js, k)).shape


def test_torch_streaming_single_stream_equals_batch_row(runs, streams):
    tsl = runs["tsl"]
    s1 = tsl.init_state()
    for k in range(3):
        s1, sp = tsl.process_chunk(s1, streams[1, k * TC:(k + 1) * TC])
        assert sp.shape == (TC, 2 * tsl.C)
        np.testing.assert_array_equal(sp.numpy(), runs["t_spikes"][k][:, 1])
    np.testing.assert_array_equal(s1.counts.numpy()[0], runs["ts"].counts.numpy()[1])
    np.testing.assert_array_equal(tsl.estimate_doa(s1, "matched").numpy(),
                                  tsl.estimate_doa(runs["ts"], "matched").numpy()[1:2])


def test_torch_streaming_chunk_without_block_size_warns(runs, streams):
    """Tc = 1001 has no divisor in (32, 48, 40, 24, 16, 8): the bandpass runs
    the sequential scan, with a warning where the reference is silent; its
    spikes still match the JAX runtime's scan fallback."""
    jsl, tsl = runs["jsl"], runs["tsl"]
    assert tsl.block_size(1001) is None and tsl.block_size(TC) == 48
    chunk = streams[:, :1001]
    with pytest.warns(RuntimeWarning, match="sequential scan"):
        ts, tsp = tsl.process_chunk(tsl.init_state(batch=B), chunk)
    _, jsp = jsl.process_chunk(jsl.init_state(batch=B), jnp.asarray(chunk))
    assert (np.asarray(jsp) != tsp.numpy()).mean() < 1e-3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsl.process_chunk(tsl.init_state(batch=B), streams[:, :TC], return_spikes=False)


def test_torch_streaming_rejects_mismatched_chunk(runs):
    tsl = runs["tsl"]
    with pytest.raises(ValueError, match="chunk must be"):
        tsl.process_chunk(tsl.init_state(batch=2), np.zeros((3, 100, 7), np.float32))


# ------------------------------------------- a single stream: JAX's own step
UNIPOLAR = dict(freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 65), recording_duration=0.25,
                kernel_duration=5e-3, bipolar_spikes=False, fs=FS)


@pytest.fixture(scope="module")
def unipolar_demos(tmp_path_factory, _no_jax_persistent_cache):
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), **UNIPOLAR, use_cache=False)
    path = tmp_path_factory.mktemp("unipolar") / "small.npz"
    jd.save(str(path))
    return jd, Demo.load(str(path), device="cpu")


def jax_step_closures(jsl) -> dict:
    """The pieces of JAX's single-stream step (``_step_jit``,
    ``runtime/streaming.py:274-289``) from its Python body: ``encode``,
    ``decide`` (``find_peaks_mask(both, rw, max_plateau=2·rw)``, ``:236-249``)
    and the float LIF scan ``lif_scan`` with its ``w_in``."""
    fn = jsl._step_jit.__wrapped__
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@pytest.mark.parametrize("polarity", ["bipolar", "unipolar"])
def test_torch_single_stream_matches_jax_step(polarity, demos, unipolar_demos):
    """One stream through JAX's single-stream step (its TPU form: the lifted
    bandpass, then ``find_peaks_mask`` and a float ``lax.scan`` LIF) and
    through the port's single stream, a batch of one through K1/K2 and K4
    (bipolar) or K6 (unipolar), from the same mid-stream state: JAX's after
    one chunk, carried into the port with ``StreamState.from_numpy``; then
    three chunks.  On the port's analysis window of each chunk, JAX's
    ``decide`` gives the port's raster bit for bit, and JAX's LIF scan from
    the port's LIF state on that raster gives its counts and state.  End to
    end the float encodes differ in summation order: the bounds of the batch
    tests above (raster entries apart under 1e-3, counts within 2)."""
    jd, td = demos if polarity == "bipolar" else unipolar_demos
    jsl, tsl = jax_tpu_form(jd), StreamingLocalizer(td)
    parts = jax_step_closures(jsl)
    t = np.arange(0, 4 * TC / FS, 1 / FS)
    clean = np.asarray(signal_from_template(jd.geometry, t, np.sin(2 * np.pi * 1750 * t), -0.8, fs=FS))
    stream = (clean + 0.3 * np.random.default_rng(7).standard_normal(clean.shape)).astype(np.float32)
    js, _ = jsl.process_chunk(jsl.init_state(), jnp.asarray(stream[:TC]))
    ts = StreamState.from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    assert ts.batch == 1 and ts.steps.tolist() == [TC]
    C_out = 2 * tsl.C if polarity == "bipolar" else tsl.C
    spikes_seen = 0
    for k in range(1, 4):
        chunk = stream[k * TC:(k + 1) * TC]
        prev = ts
        js, jsp = jsl.process_chunk(js, jnp.asarray(chunk))
        ts, tsp = tsl.process_chunk(ts, chunk)
        assert tsp.shape == np.asarray(jsp).shape == (TC, C_out) and tsp.dtype == torch.int8
        # the same analysis window: JAX's decision equals the port's raster
        integrated = tsl._encode(prev, torch.as_tensor(chunk)[:, None])[-1]
        window = torch.cat([prev.pending, integrated], dim=0)[:, 0]
        np.testing.assert_array_equal(np.asarray(parts["decide"](jnp.asarray(window.numpy()), TC)), tsp.numpy())
        # the same raster and LIF state: JAX's float scan gives the port's counts and state
        inp = jnp.dot(jnp.asarray(tsp.numpy(), jnp.float32), parts["w_in"])
        (isyn, vmem, spk), seq = jax.lax.scan(parts["lif_scan"], tuple(jnp.asarray(getattr(prev, f).numpy()[0])
                                                                       for f in ("isyn", "vmem", "spk")), inp)
        np.testing.assert_array_equal((ts.counts - prev.counts).numpy()[0], np.asarray(seq.sum(axis=0)))
        for got, want in ((ts.isyn, isyn), (ts.vmem, vmem), (ts.spk, spk)):
            np.testing.assert_array_equal(got.numpy()[0], np.asarray(want))
        # end to end from the shared state: within the batch tests' bounds
        assert (np.asarray(jsp) != tsp.numpy()).mean() < 1e-3
        spikes_seen += int(np.abs(tsp.numpy()).sum())
    assert spikes_seen > 0 and int((ts.counts - prev.counts).sum()) > 0
    jcounts, tcounts = np.asarray(js.counts), ts.counts.numpy()[0]
    assert np.abs(jcounts - tcounts).max() <= 2 and (jcounts != tcounts).mean() < 0.01
    assert int(np.asarray(js.steps)) == int(ts.steps[0]) == 4 * TC
