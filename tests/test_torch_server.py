"""Serving daemon of the PyTorch port on CPU tensors: the native ingestion
daemon (``native/streamd.cpp``, built with g++ at first use) in front of the
port's streaming runtime.  Every served answer must equal the DoA of the
port's ``StreamingLocalizer`` driven directly on the same chunks at the same
batch width (lanes are independent, so the daemon's batching cannot change
a lane's integers), and the streams must localize; with ``sources=2`` and
``track=True`` every K-float answer equals the direct step's counts through
the same top-K picker and trackers.  The wire codecs are held against the
JAX package's.

The design is the small one of ``tests/test_server.py`` (65-point grid, 5 ms
STHT kernel, peak estimator), built in JAX, saved and ``Demo.load``-ed."""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.ops import mulaw as jax_mulaw
from haghighatshoarmuir2024_tpu.ops import resample as jax_resample
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template
from haghighatshoarmuir2024_tpu.runtime import server as jax_server

import haghighatshoarmuir2024_tpu_torch as tpkg
from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
from haghighatshoarmuir2024_tpu_torch.ops import mulaw, resample
from haghighatshoarmuir2024_tpu_torch.ops.peaks import top_k_peaks
from haghighatshoarmuir2024_tpu_torch.parallel import make_mesh
from haghighatshoarmuir2024_tpu_torch.runtime import LocalizationServer, StreamingLocalizer
from haghighatshoarmuir2024_tpu_torch.runtime.server import (
    ShmStreamClient,
    StreamClient,
    WireEncoder,
    encode_wire,
)
from haghighatshoarmuir2024_tpu_torch.utils.tracking import DoaTracker, MultiDoaTracker

FS = 48_000
TC = 6000  # 0.125 s chunks
CHUNK_SEC = TC / FS


@pytest.fixture(autouse=True, scope="module")
def _no_jax_persistent_cache():
    """Build JAX Demos without seeding the committed XLA executables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        yield


@pytest.fixture(scope="module")
def demo(tmp_path_factory, _no_jax_persistent_cache):
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                 freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 65),
                 recording_duration=0.25, kernel_duration=5e-3, bipolar_spikes=True, fs=FS,
                 use_cache=False)
    path = tmp_path_factory.mktemp("demo") / "small.npz"
    jd.save(str(path))
    return Demo.load(str(path), device="cpu")


def stream_signal(demo, doa, n_chunks, seed):
    t = np.arange(0, n_chunks * CHUNK_SEC, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    clean = np.asarray(signal_from_template(jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                                            t, sig, doa, fs=FS))
    sigma = np.sqrt((clean**2).mean() / 10)  # 10 dB SNR
    x = clean + sigma * np.random.default_rng(seed).standard_normal(clean.shape)
    return (x / np.abs(x).max() * 0.98).astype(np.float32)


def folded_deg(a, b):
    return np.rad2deg(np.arcsin(abs(np.sin(a - b))))


def decode(wire, up, B, wire_chunks, carry):
    """What the server's ingest makes of one round of wire chunks
    ({slot: bytes}), on the host: (B, Tc, M) float32 and the new carry."""
    n = next(iter(wire_chunks.values())).shape[0] * (2 if wire == "u4" else 1)
    x = np.zeros((B, n, 7), np.float32)
    for s, w in wire_chunks.items():
        x[s] = {"f32": lambda: w, "u8": lambda: mulaw.mulaw_decode(w),
                "u4": lambda: mulaw.mulaw4_decode(mulaw.unpack4(w))}[wire]()
    x = torch.as_tensor(x)
    if up > 1:
        x, carry = resample.upsample_poly_stream(x, carry, resample.phase_table(resample.design_upsample_fir(up), up), up)
    return x, carry


def direct_doas(demo, B, rounds, wire="f32", up=1, method="peak"):
    """The streaming step driven directly: ``rounds`` is a list of
    {slot: wire chunk}; returns {slot: [DoA after each of its chunks]}."""
    sl = StreamingLocalizer(demo)
    state = sl.init_state(batch=B)
    carry = torch.zeros((B, resample.TAPS_PER_PHASE - 1, 7))
    out = {}
    for chunks in rounds:
        x, carry = decode(wire, up, B, chunks, carry)
        state = sl.process_chunk(state, x, return_spikes=False)
        doa = sl.estimate_doa(state, method).to(torch.float32).numpy()
        for s in chunks:
            out.setdefault(s, []).append(float(doa[s]))
    return out


def serve(srv, clients, rounds):
    """Send each round's chunks, collect every answer: {slot: [DoA, ...]}."""
    got = {}
    for chunks in rounds:
        for s, w in chunks.items():
            clients[s].send(w)
        for s in chunks:
            rid, doa = clients[s].recv_doa(timeout=120.0)
            assert rid == s
            got.setdefault(s, []).append(doa)
    return got


@pytest.mark.parametrize("wire,up", [("f32", 1), ("u8", 1), ("u4", 4)])
def test_torch_server_streams_localize_and_match_direct(demo, wire, up):
    doas = {0: 0.7, 2: -1.4}
    sigs = {s: stream_signal(demo, d, 3, seed=s) for s, d in doas.items()}
    encs = {s: WireEncoder(wire, up) for s in doas}
    rounds = [{s: encs[s].encode(sigs[s][k * TC:(k + 1) * TC]) for s in doas} for k in range(3)]
    with LocalizationServer(demo, max_streams=4, chunk_sec=CHUNK_SEC, wire_dtype=wire,
                            wire_upsample=up) as srv:
        assert srv.method == "peak" and srv.Tb == {"f32": TC, "u8": TC, "u4": TC // 8}[wire]
        srv.start()
        clients = {s: StreamClient(srv.port, s) for s in doas}
        got = serve(srv, clients, rounds)
        for c in clients.values():
            c.close()
    assert got == direct_doas(demo, 4, rounds, wire, up)
    for s, d in doas.items():
        assert folded_deg(got[s][-1], d) < 25.0, (s, got[s], d)


@pytest.fixture(scope="module")
def unipolar_demo():
    """The same small configuration with unipolar spikes, designed by the
    port itself."""
    return Demo(geometry=tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 65),
                recording_duration=0.25, kernel_duration=5e-3, bipolar_spikes=False, fs=FS, use_cache=False,
                device="cpu")


def test_torch_server_serves_unipolar_model(unipolar_demo):
    """A unipolar model over the f32 wire: 2 clients x 3 chunks, every
    answer equal to the direct streaming step (kernel K6's path)."""
    doas = {0: 0.7, 2: -1.4}
    sigs = {s: stream_signal(unipolar_demo, d, 3, seed=s) for s, d in doas.items()}
    rounds = [{s: sigs[s][k * TC:(k + 1) * TC] for s in doas} for k in range(3)]
    with LocalizationServer(unipolar_demo, max_streams=4, chunk_sec=CHUNK_SEC) as srv:
        srv.start()
        clients = {s: StreamClient(srv.port, s) for s in doas}
        got = serve(srv, clients, rounds)
        for c in clients.values():
            c.close()
    assert got == direct_doas(unipolar_demo, 4, rounds)
    for s, d in doas.items():
        assert folded_deg(got[s][-1], d) < 25.0, (s, got[s], d)


@pytest.fixture(scope="module")
def multiband_demo():
    """Two bands on a 17-point grid, designed and calibrated band-stacked by
    the port itself (the small model of ``tests/test_xylo.py:443-500``)."""
    d = Demo(geometry=tpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
             freq_bands=[[1600, 1900], [1900, 2200]], doa_list=np.linspace(-np.pi, np.pi, 17),
             recording_duration=0.1, kernel_duration=5e-3, bipolar_spikes=True, fs=FS, design_chunk=16,
             use_cache=False, device="cpu")
    t = np.arange(0, 0.1, 1 / FS)
    d.calibrate_profiles(template=(t, np.sin(2 * np.pi * 1750 * t) + np.sin(2 * np.pi * 2050 * t)),
                         use_cache=False, band_stacked=True)
    return d


@pytest.mark.parametrize("method,forget", [("matched_stacked", None), ("matched_auto", 0.4)])
def test_torch_server_band_stacked_matches_direct(multiband_demo, method, forget):
    """The band-stacked estimators served: each answer equals the direct
    streaming step's on the unfolded counts, or on the unfolded ``forget``
    EMA of the chunk counts (JAX ``server.py:315-351, 426-452``)."""
    demo = multiband_demo
    doas = {0: 0.7, 3: -1.4}
    sigs = {s: stream_signal(demo, d, 3, seed=s) for s, d in doas.items()}
    rounds = [{s: sigs[s][k * TC:(k + 1) * TC] for s in doas} for k in range(3)]
    with LocalizationServer(demo, max_streams=4, chunk_sec=CHUNK_SEC, method=method, forget=forget) as srv:
        srv.start()
        clients = {s: StreamClient(srv.port, s) for s in doas}
        got = serve(srv, clients, rounds)
        for c in clients.values():
            c.close()
    if forget is None:
        assert got == direct_doas(demo, 4, rounds, method=method)
    else:
        sl = StreamingLocalizer(demo)
        state, ema, want = sl.init_state(batch=4), torch.zeros((4, sl.n_hidden)), {}
        for chunks in rounds:
            x, _ = decode("f32", 1, 4, chunks, None)
            new = sl.process_chunk(state, x, return_spikes=False)
            ema = forget * ema + (new.counts - state.counts).to(torch.float32)
            state = new
            doa = demo.estimate_doa_from_rate(ema, method).to(torch.float32)
            for s_ in chunks:
                want.setdefault(s_, []).append(float(doa[s_]))
        assert got == want
    for s, d in doas.items():
        assert folded_deg(got[s][-1], d) < 25.0, (s, got[s], d)


def test_torch_server_slot_reset_on_reconnect(demo):
    """A reclaimed slot starts from zeroed carried state: the successor's
    answers equal a fresh stream's."""
    sig_a, sig_b = stream_signal(demo, 0.7, 2, seed=1), stream_signal(demo, -1.4, 2, seed=2)
    rounds_a = [{1: sig_a[k * TC:(k + 1) * TC]} for k in range(2)]
    rounds_b = [{1: sig_b[k * TC:(k + 1) * TC]} for k in range(2)]
    with LocalizationServer(demo, max_streams=2, chunk_sec=CHUNK_SEC) as srv:
        srv.start()
        c1 = StreamClient(srv.port, 1)
        serve(srv, {1: c1}, rounds_a)
        c1.close()
        time.sleep(0.5)  # let the daemon reap the closed socket
        c2 = StreamClient(srv.port, 1)
        got = serve(srv, {1: c2}, rounds_b)
        c2.close()
    assert got == direct_doas(demo, 2, rounds_b)
    assert folded_deg(got[1][-1], -1.4) < 25.0


def test_torch_server_forget_follows_a_moving_source(demo):
    """forget = 0.4: the answer follows an exponentially forgotten count
    profile, ema ← 0.4·ema + chunk counts, and re-acquires a source that
    jumps from 0.7 to -1.4 rad after 3 chunks."""
    sig = np.concatenate([stream_signal(demo, 0.7, 3, seed=1), stream_signal(demo, -1.4, 3, seed=2)])
    rounds = [{0: sig[k * TC:(k + 1) * TC]} for k in range(6)]
    with LocalizationServer(demo, max_streams=2, chunk_sec=CHUNK_SEC, forget=0.4) as srv:
        srv.start()
        c = StreamClient(srv.port, 0)
        got = serve(srv, {0: c}, rounds)[0]
        c.close()
    sl = StreamingLocalizer(demo)
    state, ema, want = sl.init_state(batch=2), torch.zeros((2, sl.n_hidden)), []
    for chunks in rounds:
        x, _ = decode("f32", 1, 2, chunks, None)
        new = sl.process_chunk(state, x, return_spikes=False)
        ema = 0.4 * ema + (new.counts - state.counts).to(torch.float32)
        state = new
        doa = demo.estimate_doa_from_rate(ema.reshape(2, -1, 65).mean(dim=1), "peak")
        want.append(float(doa.to(torch.float32)[0]))  # the wire carries float32
    assert got == want
    assert folded_deg(got[-1], -1.4) < 25.0, got


def test_torch_server_shm_stream_and_stage_times(demo, monkeypatch):
    """The shared-memory ring path serves the same answers as the direct
    step, next to a TCP stream; HM2024_SERVE_TIMING books the stage times."""
    monkeypatch.setenv("HM2024_SERVE_TIMING", "1")
    sig_shm, sig_tcp = stream_signal(demo, 0.7, 2, seed=5), stream_signal(demo, -1.4, 2, seed=6)
    rounds = [{1: sig_shm[k * TC:(k + 1) * TC], 3: sig_tcp[k * TC:(k + 1) * TC]} for k in range(2)]
    with LocalizationServer(demo, max_streams=4, chunk_sec=CHUNK_SEC) as srv:
        srv.start()
        shm = ShmStreamClient(f"hm2024_torch_test_shm_{os.getpid()}")
        srv.attach_shm(1, shm.name)
        tcp = StreamClient(srv.port, 3)
        got = {1: [], 3: []}
        for chunks in rounds:
            shm.send(chunks[1])
            tcp.send(chunks[3])
            got[1].append(shm.recv_doa(timeout=120.0))
            got[3].append(tcp.recv_doa(timeout=120.0)[1])
        srv.detach_shm(1)
        tcp.close()
        shm.close()
        time.sleep(0.2)
        stage = dict(srv.stage_times)
    assert got == direct_doas(demo, 4, rounds)
    assert stage["steps"] >= 2 and stage["device"] > 0 and stage["route"] >= 0


def two_source_signal(doas, n_chunks, seed):
    """Tones of 1700 and 1820 Hz from the two ``doas``, 10 dB white noise."""
    t = np.arange(0, n_chunks * CHUNK_SEC, 1 / FS)
    geo = jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7)
    clean = sum(np.asarray(signal_from_template(geo, t, np.sin(2 * np.pi * f * t), d, fs=FS))
                for d, f in zip(doas, (1700.0, 1820.0)))
    sigma = np.sqrt((clean**2).mean() / 10)
    x = clean + sigma * np.random.default_rng(seed).standard_normal(clean.shape)
    return (x / np.abs(x).max() * 0.98).astype(np.float32)


@pytest.mark.parametrize("sources,track", [(2, True), (2, False), (1, True)])
def test_torch_server_multi_source_and_tracks(demo, sources, track):
    """``sources=K`` answers K floats per chunk: the top-K peaks of each
    lane's scores picked on the device (minimum separation 20 deg, 0.2 of
    the maximum), NaN-padded; ``track=True`` passes them through a host
    tracker per slot (``MultiDoaTracker`` of K + 2 slots for K > 1).  Every
    answer equals the direct streaming step's counts through the same
    top-K and trackers (JAX ``server.py:455-475, 595-625``)."""
    doas = {0: (0.7, -1.4), 2: (2.2, -0.3)}
    n = 4
    sigs = {s: two_source_signal(d, n, seed=s) for s, d in doas.items()}
    rounds = [{s: sigs[s][k * TC:(k + 1) * TC] for s in doas} for k in range(n)]
    with LocalizationServer(demo, max_streams=4, chunk_sec=CHUNK_SEC, sources=sources, track=track) as srv:
        srv.start()
        clients = {s: StreamClient(srv.port, s, sources=sources) for s in doas}
        got = {}
        for chunks in rounds:
            for s, w in chunks.items():
                clients[s].send(w)
            for s in chunks:
                rid, v = clients[s].recv_doa(timeout=120.0)
                assert rid == s
                got.setdefault(s, []).append(np.atleast_1d(np.asarray(v, np.float32)))
        for c in clients.values():
            c.close()
    # the direct path: the streaming step, the scores, top-K on the device, the trackers
    sl = StreamingLocalizer(demo)
    state = sl.init_state(batch=4)
    trackers = {s: (MultiDoaTracker(sources + 2, max_misses=4) if sources > 1 else DoaTracker()) for s in doas}
    dist = int(round(20.0 / (360.0 / 64)))
    want = {}
    for chunks in rounds:
        x, _ = decode("f32", 1, 4, chunks, None)
        state = sl.process_chunk(state, x, return_spikes=False)
        scores = demo.doa_scores(sl.rate(state), "peak")
        idx, _, valid = top_k_peaks(scores, sources, distance=dist, rel_height=0.2)
        z = torch.where(valid, demo._doa_t.to(torch.float32)[idx], float("nan")).numpy()
        for s in chunks:
            row = np.full(sources, np.nan, np.float32)
            if not track:
                row[:] = z[s]
            elif sources == 1:
                row[0] = trackers[s].update(float(z[s, 0]))
            else:
                th, cf = trackers[s].update(z[s], valid=np.isfinite(z[s]))
                row[: cf.sum()] = th[cf][:sources]
            want.setdefault(s, []).append(row)
    for s in doas:
        np.testing.assert_array_equal(np.stack(got[s]), np.stack(want[s]))
    if sources == 2 and track:
        # by the last chunk two tracks are confirmed, one near a source (this
        # small model, 65 DoAs and a 5 ms kernel, does not always resolve the
        # second source; the card's smoke test holds the flagship to both)
        for s, d in doas.items():
            last = got[s][-1]
            assert np.isfinite(last).all(), got[s]
            assert min(folded_deg(e, true) for e in last for true in d) < 25.0, (s, last, d)


def test_torch_server_rejects_unported_options(demo):
    with pytest.raises(ValueError, match="mesh axis"):  # 6 slots do not split over 4 shards
        LocalizationServer(demo, max_streams=6, mesh=make_mesh(devices=["cpu"] * 4))
    for k in (0, 9):
        with pytest.raises(ValueError, match="sources"):
            LocalizationServer(demo, sources=k)
    with pytest.raises(ValueError, match="band_stacked"):  # a demo without the band-stacked table
        LocalizationServer(demo, method="matched_stacked")
    with pytest.raises(ValueError, match="method"):
        LocalizationServer(demo, method="periodic_ml")
    with pytest.raises(ValueError, match="wire_dtype"):
        LocalizationServer(demo, wire_dtype="f16")
    with pytest.raises(ValueError, match="forget"):
        LocalizationServer(demo, forget=1.0)


def test_torch_mulaw_matches_jax():
    x = np.concatenate([np.linspace(-1, 1, 70_000, dtype=np.float32),
                        np.random.default_rng(0).standard_normal(1000).astype(np.float32)]).reshape(-1, 2)
    for fn in ("mulaw_encode", "mulaw4_encode"):
        np.testing.assert_array_equal(getattr(mulaw, fn)(x), getattr(jax_mulaw, fn)(x))
    pcm = (x * 30000).astype(np.int16)
    np.testing.assert_array_equal(mulaw.mulaw_encode(pcm), jax_mulaw.mulaw_encode(pcm))
    for fn in ("mulaw_decode_table", "mulaw4_decode_table"):
        np.testing.assert_array_equal(getattr(mulaw, fn)(), getattr(jax_mulaw, fn)())
    codes = mulaw.mulaw4_encode(x)
    np.testing.assert_array_equal(mulaw.pack4(codes), jax_mulaw.pack4(codes))
    np.testing.assert_array_equal(mulaw.unpack4(mulaw.pack4(codes)), codes)
    with pytest.raises(ValueError, match="even"):
        mulaw.pack4(codes[:3])


def test_torch_upsample_poly_stream_matches_jax():
    """The grouped conv1d against JAX's conv (Precision.HIGHEST) chunk by
    chunk, and the carried chunks against the offline interpolator; float32
    sums of 16 products in another order: 1e-6 absolute on unit-scale audio."""
    rng = np.random.default_rng(1)
    h = resample.design_upsample_fir(4)
    np.testing.assert_array_equal(h, jax_resample.design_upsample_fir(4))
    hp = resample.phase_table(h, 4)
    x = rng.standard_normal((2, 3 * 500, 7)).astype(np.float32)
    carry_t = torch.zeros((2, resample.TAPS_PER_PHASE - 1, 7))
    carry_j = jnp.zeros((2, resample.TAPS_PER_PHASE - 1, 7), jnp.float32)
    parts = []
    for k in range(3):
        xk = x[:, k * 500:(k + 1) * 500]
        y_t, carry_t = resample.upsample_poly_stream(torch.as_tensor(xk), carry_t, hp, 4)
        y_j, carry_j = jax_resample.upsample_poly_stream(jnp.asarray(xk), carry_j, hp, 4)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(carry_t.numpy(), np.asarray(carry_j))
        parts.append(y_t.numpy())
    offline = np.stack([resample.upsample_poly(x[b], h, 4) for b in range(2)])
    np.testing.assert_allclose(np.concatenate(parts, axis=1), offline, rtol=0, atol=1e-6)
    # the client side: decimation and the wire encoders
    chunk = rng.uniform(-1, 1, (1200, 7)).astype(np.float32)
    np.testing.assert_array_equal(resample.decimate_fir(chunk, 4), jax_resample.decimate_fir(chunk, 4))
    for wire, up in (("i16", 1), ("u8", 1), ("u4", 4)):
        np.testing.assert_array_equal(encode_wire(chunk, wire, up), jax_server.encode_wire(chunk, wire, up))
        ours, theirs = WireEncoder(wire, up), jax_server.WireEncoder(wire, up)
        for part in np.split(chunk, 3):
            np.testing.assert_array_equal(ours.encode(part), theirs.encode(part))
