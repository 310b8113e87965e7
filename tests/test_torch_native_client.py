"""The native producer clients of the PyTorch port (``runtime.native_client``
over ``native/streamc.cpp``, built with g++ at first use), on the CPU.

The C wire encoder's codes equal the port's ``WireEncoder`` and the JAX
package's byte for byte at i16, u8 and u4, and its decimated float wire
(fs/4) within 1e-5 (JAX ``tests/test_server.py:208-236``); the C TCP and
shared-memory clients drive the port's daemon, every answer equal to the
direct streaming step on the decoded chunks (JAX ``:239-280``); and
``serving_throughput.daemon_main(native_clients=True)`` answers as the
Python clients do (``tests/test_torch_bench_harnesses.py``)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template
from haghighatshoarmuir2024_tpu.runtime import server as jax_server

from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
from haghighatshoarmuir2024_tpu_torch.ops.resample import TAPS_PER_PHASE
from haghighatshoarmuir2024_tpu_torch.runtime import LocalizationServer, StreamingLocalizer
from haghighatshoarmuir2024_tpu_torch.runtime.native_client import (NativeShmClient, NativeStreamClient,
                                                                    NativeWireEncoder)
from haghighatshoarmuir2024_tpu_torch.runtime.server import WireEncoder

FS = 48_000
TC = 6000  # 0.125 s chunks


@pytest.fixture(autouse=True, scope="module")
def _no_jax_persistent_cache():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HM2024_JAX_CACHE", "0")
        yield


@pytest.fixture(scope="module")
def demo(tmp_path_factory, _no_jax_persistent_cache):
    """The small design of ``tests/test_server.py`` (65 points, 5 ms kernel)."""
    jd = JaxDemo(geometry=jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7),
                 freq_bands=[[1600, 1900]], doa_list=np.linspace(-np.pi, np.pi, 65),
                 recording_duration=0.25, kernel_duration=5e-3, bipolar_spikes=True, fs=FS,
                 use_cache=False)
    path = tmp_path_factory.mktemp("demo") / "small.npz"
    jd.save(str(path))
    return Demo.load(str(path), device="cpu")


def chunks_to_encode():
    """Three random (6000, 7) blocks and a dense ramp across every companding
    code boundary (JAX ``tests/test_server.py:214-219``)."""
    rng = np.random.default_rng(123)
    out = [np.clip(rng.standard_normal((TC, 7)) * 0.4, -1, 1).astype(np.float32) for _ in range(3)]
    out.append(np.linspace(-1, 1, 70_000, dtype=np.float32).reshape(-1, 7))
    return out


@pytest.mark.parametrize("wire", ["i16", "u8", "u4"])
def test_torch_native_encoder_bytes_equal_wire_encoders(wire):
    nat, ours, theirs = NativeWireEncoder(wire, n_ch=7), WireEncoder(wire), jax_server.WireEncoder(wire)
    try:
        for ch in chunks_to_encode():
            got, want = nat.encode(ch), ours.encode(ch)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, theirs.encode(ch))
    finally:
        nat.close()


def test_torch_native_encoder_decimated_float_wire():
    """fs/4 on the f32 wire: the same carried history and taps, computed
    apart, within float rounding; a chunk that does not divide raises."""
    nat, ours, theirs = NativeWireEncoder("f32", 4, n_ch=7), WireEncoder("f32", 4), jax_server.WireEncoder("f32", 4)
    try:
        for ch in chunks_to_encode():
            got = nat.encode(ch)
            np.testing.assert_allclose(got, ours.encode(ch), rtol=0, atol=1e-5)
            np.testing.assert_allclose(got, theirs.encode(ch), rtol=0, atol=1e-5)
        with pytest.raises(ValueError, match="divide"):
            nat.encode(np.zeros((6001, 7), np.float32))
        with pytest.raises(ValueError, match=r"\(T, 7\)"):
            nat.encode(np.zeros((8, 3), np.float32))
    finally:
        nat.close()
    with pytest.raises(ValueError, match="wire_dtype"):
        NativeWireEncoder("f16")


def stream(doa, n_chunks, seed):
    t = np.arange(0, n_chunks * TC / FS, 1 / FS)
    clean = np.asarray(signal_from_template(jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), t,
                                            np.sin(2 * np.pi * 1750 * t), doa, fs=FS))
    x = clean + np.sqrt((clean**2).mean() / 10) * np.random.default_rng(seed).standard_normal(clean.shape)
    return (x / np.abs(x).max() * 0.98).astype(np.float32)


def test_torch_native_clients_drive_the_daemon(demo):
    """A C TCP client on slot 0 and a C shared-memory ring on slot 2, the C
    encoder at u4 and fs/4: every answer equals the direct streaming step on
    the decoded chunks, and both streams localize."""
    from test_torch_server import decode  # the server's ingest on the host

    n_chunks, doas = 3, {0: 0.7, 2: -1.4}
    sigs = {0: stream(0.7, n_chunks, 11), 2: stream(-1.4, n_chunks, 12)}
    encs = {s: NativeWireEncoder("u4", 4, n_ch=7) for s in doas}
    rounds = [{s: encs[s].encode(sigs[s][k * TC:(k + 1) * TC]) for s in doas} for k in range(n_chunks)]
    for e in encs.values():
        e.close()
    got = {0: [], 2: []}
    with LocalizationServer(demo, max_streams=4, chunk_sec=TC / FS, wire_dtype="u4", wire_upsample=4) as srv:
        srv.start()
        tcp = NativeStreamClient(srv.port, 0)
        shm = NativeShmClient(f"hm2024_test_torch_natshm_{os.getpid()}")
        srv.attach_shm(2, shm.name)
        try:
            for chunks in rounds:
                tcp.send(chunks[0])
                shm.send(chunks[2])
                rid, doa = tcp.recv_doa(timeout=120.0)
                assert rid == 0
                got[0].append(doa)
                got[2].append(shm.recv_doa(timeout=120.0))
        finally:
            srv.detach_shm(2)
            tcp.close()
            shm.close()
    assert not os.path.exists(f"/dev/shm/{shm.name}")

    sl = StreamingLocalizer(demo)
    state, carry = sl.init_state(batch=4), torch.zeros((4, TAPS_PER_PHASE - 1, 7))
    for k, chunks in enumerate(rounds):
        x, carry = decode("u4", 4, 4, chunks, carry)
        state = sl.process_chunk(state, x, return_spikes=False)
        want = sl.estimate_doa(state, "peak").to(torch.float32).numpy()
        for s in doas:
            assert np.float32(got[s][k]) == want[s], (k, s)
    for s, d in doas.items():
        assert np.rad2deg(np.arcsin(abs(np.sin(got[s][-1] - d)))) < 25.0, (s, got[s])
