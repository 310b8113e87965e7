"""Data parallelism over a device mesh in the PyTorch port, on CPU shards.

A torch mesh may name one device more than once; eight shards on the one
CPU are the counterpart of the JAX package's virtual 8-device CPU mesh
(``tests/conftest.py``).  The design is the small one of
``tests/test_streaming.py`` (65-point grid, 5 ms STHT kernel), built and
calibrated in JAX, saved and ``Demo.load``-ed into the port.

* The sharded serving step over 8 shards against JAX's ``make_sharded_step``
  (its TPU form, selected as in ``tests/test_torch_streaming.py``) on JAX's
  8-device mesh and against the port's own unsharded step, over two
  6000-sample chunks of 8 streams (JAX ``tests/test_streaming.py:238-274``):
  the port's unsharded step bit for bit (the lifted IIR rounds a column
  alike whatever the batch width), JAX's integers bit-exact and DoAs equal,
  its carried float state within ``TOL_PER_CHUNK`` a chunk of each field's
  largest value (the two encoders sum in other orders, as in
  ``tests/test_torch_streaming.py``).
* No tensor of a shard leaves its shard (the counterpart of JAX's
  no-collectives check, ``:277-293``): each shard's state lies on its
  device with its B/n lanes, and another shard's input changes none of it.
* ``LocalizationServer(mesh=)`` through sockets on the u4 wire at fs/4
  (JAX ``tests/test_server.py:370-410``), every answer the unsharded
  direct step's; 6 streams over 8 shards raise.
* The sharded Monte Carlo equals the unsharded one, 2 trials over 8 shards
  included (JAX ``tests/test_utils_parallel.py:83-140``).
* The mesh helpers, their errors, the one-thread launch order of the
  sharded step and ``replicate_demo``.
* ``experiments.multichip_scaling`` over 8 CPU shards."""
import contextlib
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as PS

import haghighatshoarmuir2024_tpu as jpkg
from haghighatshoarmuir2024_tpu.models.xylo import Demo as JaxDemo
from haghighatshoarmuir2024_tpu.ops.interp import signal_from_template
from haghighatshoarmuir2024_tpu.parallel.mesh import make_mesh as jax_make_mesh
from haghighatshoarmuir2024_tpu.runtime import StreamingLocalizer as JaxStreamingLocalizer

from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo
from haghighatshoarmuir2024_tpu_torch.ops.resample import TAPS_PER_PHASE
from haghighatshoarmuir2024_tpu_torch.parallel import (device_scope, gather, make_mesh, make_trial_fn,
                                                       monte_carlo_sweep, pad_to_multiple, replicate_demo, split)
from haghighatshoarmuir2024_tpu_torch.runtime import LocalizationServer, StreamingLocalizer, StreamState
from haghighatshoarmuir2024_tpu_torch.runtime.server import StreamClient, WireEncoder

FS, TC, B = 48_000, 6000, 8
# the carried float state (integrator total, pending window) against JAX, as a
# fraction of the field's largest value per chunk carried: the two encoders sum
# in other orders, and the integrator total keeps every chunk's rounding;
# measured 1.46e-5 after two chunks
TOL_PER_CHUNK = 2e-5
TIME_MAJOR = ("fir_tail", "delay_line", "pending")


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


def signal(duration, doa, seed, snr_db=10.0):
    """JAX ``tests/test_streaming.py``'s ``_signal``: a 1750 Hz tone from
    ``doa`` in white noise, (T, 7) float32."""
    t = np.arange(0, duration, 1 / FS)
    clean = np.asarray(signal_from_template(jpkg.CenterCircularArray(radius=4.5e-2, num_mic=7), t, np.sin(2 * np.pi * 1750 * t), doa, fs=FS))
    sigma = np.sqrt((clean**2).mean() / 10 ** (snr_db / 10))
    return (clean + sigma * np.random.default_rng(seed).standard_normal(clean.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def streams(demos):
    jd, _ = demos
    doas = np.linspace(-np.pi, np.pi, B, endpoint=False)
    return np.stack([signal(2 * TC / FS, d, seed=i) for i, d in enumerate(doas)])


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def test_torch_sharded_step_matches_jax_and_unsharded(demos, streams):
    jd, td = demos
    jsl = JaxStreamingLocalizer(jd)
    jsl._on_tpu = True  # the TPU form, which the port's runtime is (tests/test_torch_streaming.py)
    jsl.N_state = len(jsl._bp[0][1]) - 1
    jmesh = jax_make_mesh(8)
    sh = NamedSharding(jmesh, PS("data"))
    jstep = jsl.make_sharded_step(jmesh)
    js = jax.device_put(jsl.init_state(batch=B), sh)

    sl = StreamingLocalizer(td)
    step = sl.make_sharded_step(cpu_mesh(8))
    states, ref = step.init_state(B), sl.init_state(B)
    assert len(states) == 8 and all(s.batch == 1 for s in states)
    for k in range(2):  # two chunks: the seam state crosses each shard's steps
        chunk = streams[:, k * TC:(k + 1) * TC]
        js = jstep(js, jax.device_put(jnp.asarray(chunk), sh))
        states = step(states, chunk)
        ref = sl.process_chunk(ref, chunk, return_spikes=False)
    got = StreamState.cat(states)
    jn = {k: np.asarray(v) for k, v in js._asdict().items()}
    for name in StreamState.__dataclass_fields__:
        a, r = getattr(got, name).numpy(), getattr(ref, name).numpy()
        j = np.swapaxes(jn[name], 0, 1) if name in TIME_MAJOR else jn[name]
        np.testing.assert_array_equal(a, r, err_msg=name)  # the port's own step, bit for bit
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, j, err_msg=name)
        else:
            np.testing.assert_allclose(a, j, rtol=0, atol=2 * TOL_PER_CHUNK * np.abs(r).max(), err_msg=name)
    assert got.counts.sum() > 0
    for method in ("matched", "peak"):
        d = sl.estimate_doa(got, method).numpy()
        np.testing.assert_array_equal(d, sl.estimate_doa(ref, method).numpy())
        # the grid holds -pi and pi, one direction: the packages may name it either way
        np.testing.assert_array_equal(np.mod(d, 2 * np.pi).round(6),
                                      np.mod(np.asarray(jsl.estimate_doa(js, method)), 2 * np.pi).round(6))


def test_torch_sharded_step_keeps_each_shard_to_itself(demos, streams):
    _, td = demos
    sl = StreamingLocalizer(td)
    mesh = cpu_mesh(4)
    step = sl.make_sharded_step(mesh)
    seen = []
    for loc in step.localizers:  # every shard runs the one localizer of the CPU
        assert loc is sl
    real_launch = sl._step_launch
    sl._step_launch = lambda state, x: (seen.append((state.batch, x.shape[0])), real_launch(state, x))[1]
    try:
        chunk = streams[:, :TC]
        base = step(step.init_state(B), chunk)
        other = chunk.copy()
        other[2:4] = 0.0  # shard 1's streams only
        moved = step(step.init_state(B), split(other, mesh))  # per-shard pieces are taken as they are
    finally:
        del sl._step_launch
    assert seen == [(2, 2)] * 8  # each shard's step saw its own 2 lanes, never the batch
    for i, (a, b) in enumerate(zip(base, moved)):
        for name in StreamState.__dataclass_fields__:
            ta, tb = getattr(a, name), getattr(b, name)
            assert ta.device == mesh.axis_devices()[i]
            assert ta.shape[1 if name in TIME_MAJOR else 0] == 2
            if i != 1:
                assert torch.equal(ta, tb), (i, name)
    assert not torch.equal(base[1].pending, moved[1].pending)
    with pytest.raises(ValueError, match="divide"):
        step.init_state(6)
    with pytest.raises(ValueError, match="states"):
        step(step.init_state(B)[:3], chunk)
    with pytest.raises(ValueError, match="divide"):
        step(step.init_state(B), chunk[:6])


def test_torch_server_over_mesh_localizes(demos):
    """8 slots over 8 CPU shards, u4 at fs/4 through real sockets: every
    answer equals the unsharded direct step's, and the streams localize."""
    from test_torch_server import decode  # the server's ingest on the host

    _, td = demos
    chunk_sec, n_chunks = 0.125, 3
    doas = {0: 0.7, 3: -1.4, 6: 2.3}
    sigs = {}
    for sid, d in doas.items():
        s = signal(n_chunks * chunk_sec, d, seed=40 + sid)
        sigs[sid] = s / np.abs(s).max() * 0.98
    encs = {sid: WireEncoder("u4", wire_upsample=4) for sid in doas}
    rounds = [{sid: encs[sid].encode(sigs[sid][k * TC:(k + 1) * TC]) for sid in doas} for k in range(n_chunks)]
    mesh = cpu_mesh(8)
    with LocalizationServer(td, max_streams=8, chunk_sec=chunk_sec, wire_dtype="u4", wire_upsample=4,
                            method="peak", mesh=mesh) as srv:
        assert len(srv._shards) == 8 and all(sh.B == 1 for sh in srv._shards)
        srv.start()
        clients = {sid: StreamClient(srv.port, sid) for sid in doas}
        got = {}
        for chunks in rounds:
            for sid, w in chunks.items():
                clients[sid].send(w)
            for sid in chunks:
                rid, doa = clients[sid].recv_doa(timeout=120.0)
                assert rid == sid
                got.setdefault(sid, []).append(doa)
        for c in clients.values():
            c.close()

    sl = StreamingLocalizer(td)
    state = sl.init_state(batch=8)
    carry = torch.zeros((8, TAPS_PER_PHASE - 1, 7))
    for k, chunks in enumerate(rounds):
        x, carry = decode("u4", 4, 8, chunks, carry)
        state = sl.process_chunk(state, x, return_spikes=False)
        want = sl.estimate_doa(state, "peak").to(torch.float32).numpy()
        for sid in doas:
            assert np.float32(got[sid][k]) == want[sid], (k, sid)
    for sid, d in doas.items():
        assert np.rad2deg(np.arcsin(abs(np.sin(got[sid][-1] - d)))) < 25.0, (sid, got[sid])

    with pytest.raises(ValueError, match="mesh axis"):
        LocalizationServer(td, max_streams=6, mesh=mesh)


@pytest.mark.parametrize("num_sims,batch_size,n_shards", [(8, None, 8), (6, 4, 4), (2, None, 8)])
def test_torch_monte_carlo_sharded_matches_unsharded(num_sims, batch_size, n_shards):
    """Equal errors element for element: the draws on one generator in the
    unsharded order, each launch padded to the shards by a modular repeat
    (2 trials over 8 shards pad by 6, more than the trials).  As JAX's test
    of the same (``tests/test_utils_parallel.py:116-140``), the estimator
    reads each frame alone (the strongest microphone at one sample), so the
    comparison holds the sweep's plumbing: the model's own batch-width
    rounding is the card's check (``chip_smoke.py`` phase 26)."""
    from haghighatshoarmuir2024_tpu_torch.geometry import CenterCircularArray

    t = np.arange(0, 0.02, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    seen = []

    def estimate(frames):
        seen.append(frames.shape[0])
        return frames[:, 100, :].argmax(dim=-1).to(torch.float32) * (2 * np.pi / 7)

    trial = make_trial_fn(CenterCircularArray(radius=4.5e-2, num_mic=7), t, sig, estimate, FS, device="cpu")
    r1 = monte_carlo_sweep(trial, [20.0, 0.0], num_sims, seed=1, batch_size=batch_size)
    seen.clear()
    r2 = monte_carlo_sweep(trial, [20.0, 0.0], num_sims, seed=1, batch_size=batch_size, mesh=cpu_mesh(n_shards))
    assert r2["errors"].shape == (2, num_sims)
    np.testing.assert_array_equal(r2["errors"], r1["errors"])
    np.testing.assert_array_equal(r2["mae"], r1["mae"])
    assert len(np.unique(r1["errors"])) > 1
    chunk = num_sims if batch_size is None else batch_size
    launches = -(-num_sims // chunk)
    assert seen == [-(-min(chunk, num_sims) // n_shards)] * (n_shards * launches * 2)
    # the same draws handed in (JAX's, say) give the same errors sharded
    gen = torch.Generator().manual_seed(1)
    draws = trial.draw(gen, num_sims)
    r3 = monte_carlo_sweep(trial, [20.0], num_sims, draws=draws)
    r4 = monte_carlo_sweep(trial, [20.0], num_sims, draws=draws, mesh=cpu_mesh(n_shards))
    np.testing.assert_array_equal(r4["errors"], r3["errors"])
    if batch_size is None:  # one launch: the same draws as the generator's
        np.testing.assert_array_equal(r3["errors"][0], r1["errors"][0])
    with pytest.raises(ValueError, match="both"):
        trial(None, 0.0, 2, doa_true=draws[0][:2])


def test_torch_monte_carlo_sharded_model(demos):
    """The Xylo model as the estimator, the sweep over 4 shards: each shard's
    frames reach the model on its shard's device, and the sweep localizes
    as the unsharded one does (its MAE within a grid step)."""
    _, td = demos
    t = np.arange(0, 0.05, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    trial = make_trial_fn(td.geometry, t, sig, lambda f: td.forward_batch(f)[0], FS, device="cpu")
    r1 = monte_carlo_sweep(trial, [20.0], 8, seed=2)
    r2 = monte_carlo_sweep(trial, [20.0], 8, seed=2, mesh=cpu_mesh(4))
    assert r2["errors"].shape == (1, 8)
    step = np.deg2rad(360.0 / 64)
    assert abs(r2["mae"][0] - r1["mae"][0]) <= step and r2["mae"][0] < 2 * step


def test_torch_mesh_helpers_and_errors(monkeypatch):
    mesh = make_mesh(8, shape=(4, 2), devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.axis_devices("data") == [torch.device("cpu")] * 4
    assert len(mesh.axis_devices("model")) == 2
    x = torch.arange(24.0).reshape(4, 6)
    pieces = split(x, mesh, axis=0)
    assert [p.shape for p in pieces] == [(1, 6)] * 4
    assert torch.equal(gather(pieces), x)
    assert torch.equal(gather(split(x.numpy(), make_mesh(devices=["cpu"] * 3), axis=1), axis=1), x)
    padded, n = pad_to_multiple(torch.ones(5, 2), 4)
    assert n == 5 and padded.shape == (8, 2) and float(padded[5:].abs().sum()) == 0.0
    assert pad_to_multiple(x, 2)[0] is x
    with pytest.raises(ValueError, match="divide"):
        split(torch.ones(6, 2), cpu_mesh(4))
    with pytest.raises(ValueError, match="asked for 3 devices"):
        make_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(4, shape=(3, 2), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="no axis"):
        cpu_mesh(2).axis_devices("stream")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="visible CUDA cards"):
        make_mesh()


def test_torch_sharded_step_launches_every_shard_before_reading_a_flag(demos, streams):
    """One host thread drives the shards: every shard's step is launched up
    to K2's flag read before any shard's flags are read, each under its
    device's scope, so each card has its work queued while the host waits
    on one; the result is the shard-by-shard step's."""
    _, td = demos
    sl = StreamingLocalizer(td)
    step = sl.make_sharded_step(cpu_mesh(4))
    order = []
    launch, finish = sl._step_launch, sl._step_finish
    sl._step_launch = lambda st, x: (order.append(("launch", x.shape[0])), launch(st, x))[1]
    sl._step_finish = lambda pending: (order.append(("finish", pending[0].batch)), finish(pending))[1]
    try:
        chunk = streams[:, :TC]
        got = step(step.init_state(B), chunk)
    finally:
        del sl._step_launch, sl._step_finish
    assert order == [("launch", 2)] * 4 + [("finish", 2)] * 4
    for i, st in enumerate(got):
        want = sl.process_chunk(sl.init_state(2), chunk[2 * i:2 * i + 2], return_spikes=False)
        for name in StreamState.__dataclass_fields__:
            assert torch.equal(getattr(st, name), getattr(want, name)), (i, name)
    assert isinstance(device_scope("cpu"), contextlib.nullcontext)


def test_torch_replicate_demo_copies_state(demos):
    """A replica carries the demo's own arrays (design, integers, profiles)
    and answers as the demo does; on the demo's own device it is the demo."""
    _, td = demos
    assert replicate_demo(td, "cpu") is td
    elsewhere = copy.copy(td)
    elsewhere.device = torch.device("meta")  # as if the demo lay on another card
    rep = replicate_demo(elsewhere, "cpu")
    assert rep is not elsewhere and rep.device == torch.device("cpu")
    np.testing.assert_array_equal(rep.bf_mats[0], td.bf_mats[0])
    np.testing.assert_array_equal(rep._profiles, td._profiles)
    for name in ("w_in", "w_rec", "dash_syn", "dash_mem", "threshold"):
        np.testing.assert_array_equal(np.asarray(getattr(rep.xylo_config, name)),
                                      np.asarray(getattr(td.xylo_config, name)))
    frames = torch.as_tensor(np.stack([signal(0.05, d, seed=3) for d in (0.7, -1.4)]))
    for method in ("peak", "matched"):
        assert torch.equal(rep.forward_batch(frames, method)[0], td.forward_batch(frames, method)[0])


def test_torch_multichip_scaling_on_cpu_shards():
    """The scaling harness over 8 CPU shards: each shard handed 1/8 of the
    trials, 8 bytes of float64 error a trial gathered from it and nothing
    more, and the errors equal to the one-shard sweep's."""
    from haghighatshoarmuir2024_tpu_torch.experiments import multichip_scaling

    res = multichip_scaling.main(num_sims=16, device="cpu")
    assert res["errors_equal"]
    assert res["mesh1"]["per_device_key_block"] == 16 and res["mesh8"]["per_device_key_block"] == 2
    assert res["mesh1"]["bytes_leaving_shard"] == 16 * 8 and res["mesh8"]["bytes_leaving_shard"] == 2 * 8
    assert res["per_device_work_ratio"] == 8
    assert "collectives" not in res["mesh8"]
