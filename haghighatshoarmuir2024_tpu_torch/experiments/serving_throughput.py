"""Serving throughput and latency of the carried-state runtime, the port's
twin of ``experiments/serving_throughput.py``.

:func:`main`: B concurrent streams advanced by one ``StreamingLocalizer``
step a chunk (encode, K1/K2, the pack pass and K4 on the card): the
sustained batched rate (``n_steps`` steps back to back, synchronized at the
end), and one stream's chunk latency, blocking (synchronized after every
chunk, median of 10) and pipelined (50 chunks, synchronized once).
``--quick`` cuts the latency readings to 2 chunks each.

:func:`daemon_main`: the same through the serving daemon
(``runtime.server.LocalizationServer`` over ``native/streamd.cpp``):
``batch`` clients stream in lockstep over TCP, or over shared-memory rings
with ``use_shm``, on the f32, i16, u8 or u4 wire, at fs/4 with
``wire_upsample=4``; the wall time covers ingestion, the device step and
the answers.  With ``HM2024_SERVE_TIMING=1`` the server's stage times
(wait / device / route) are reported per step.  ``native_clients=True``
(``--native``) streams through the C producer clients of
``runtime.native_client`` (``native/streamc.cpp``) instead of the Python
ones, over TCP or shared memory alike.

    python -m haghighatshoarmuir2024_tpu_torch.experiments.serving_throughput \\
        [--daemon | --shm] [--native] [--wire=f32|i16|u8|u4] [--decim=4] \\
        [--sources=2] [--fs=48000] [--quick] [--device cpu]

Prints one JSON object with the JAX twin's keys.  Each stream is a tone of
the band centre from its own direction plus 0.1 white noise from
``numpy.random.default_rng(0)`` (with ``--sources=2`` a second tone 100 Hz
higher, 2 rad away), as in JAX.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..geometry import resolve_device
from ..models.xylo import Demo
from ..parallel import synthesize_batch
from ..runtime import StreamingLocalizer
from ..ops.resample import TAPS_PER_PHASE, design_upsample_fir, phase_table, upsample_poly_stream
from ..runtime.native_client import NativeShmClient, NativeStreamClient
from ..runtime.server import LocalizationServer, ShmStreamClient, StreamClient, encode_wire
from .common import FS, arg_parser, calibrated_demo, folded_deg, sinusoid_template, sync
from .wire_accuracy import decode_wire


def stream_chunks(demo: Demo, batch: int, chunk_sec: float, freq_band, sources: int = 1):
    """The streams' (B, Tc, M) float32 chunks on the demo's device, their
    directions and, with ``sources=2``, the second tone's."""
    fs, dev = demo.fs, demo.device
    f32 = dict(dtype=torch.float32, device=dev)
    t, sig = sinusoid_template(float(np.mean(freq_band)), chunk_sec, fs=fs)
    doas = np.linspace(-np.pi, np.pi, batch, endpoint=False)
    tt = torch.as_tensor(t, **f32)
    chunks = synthesize_batch(demo.geometry, tt, torch.as_tensor(sig, **f32), torch.as_tensor(doas, **f32), fs)
    doas_b = None
    if sources == 2:
        sig2 = np.sin(2 * np.pi * (float(np.mean(freq_band)) + 100.0) * np.arange(0, chunk_sec, 1 / fs))
        doas_b = np.arctan2(np.sin(doas + 2.0), np.cos(doas + 2.0))
        chunks = chunks + synthesize_batch(demo.geometry, tt, torch.as_tensor(sig2, **f32),
                                           torch.as_tensor(doas_b, **f32), fs)
    noise = 0.1 * np.random.default_rng(0).standard_normal(tuple(chunks.shape)).astype(np.float32)
    return chunks + torch.as_tensor(noise, device=dev), doas, doas_b


def main(batch: int = 96, chunk_sec: float = 0.25, n_steps: int = 100, freq_band=(1600, 1900),
         num_grid: int = 64 * 7 + 1, fs: int = FS, sources: int = 1, device=None, demo=None,
         latency_reps=(10, 50)) -> dict:
    """The batched step's serving rate and one stream's latency (module
    docstring) over ``latency_reps`` chunks, blocking and pipelined;
    ``demo`` replaces the flagship model at ``fs`` on a ``num_grid``-point
    grid with chunks as frames."""
    dev = resolve_device(device) if demo is None else demo.device
    demo = demo or calibrated_demo(num_grid, chunk_sec, fs, freq_band, dev)
    sl = StreamingLocalizer(demo)
    chunks, doas, doas_b = stream_chunks(demo, batch, chunk_sec, freq_band, sources)

    state = sl.process_chunk(sl.init_state(batch=batch), chunks, return_spikes=False)  # warm-up
    sync(dev)
    state = sl.init_state(batch=batch)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state = sl.process_chunk(state, chunks, return_spikes=False)
    sync(dev)
    step_ms = (time.perf_counter() - t0) / n_steps * 1000
    serving = batch * chunk_sec / (step_ms / 1000)
    # one estimate a stream; with two sources it is scored against the nearer one, as in JAX
    est = sl.estimate_doa(state, method="matched").cpu().numpy()
    err = folded_deg(est, doas) if sources == 1 else np.minimum(folded_deg(est, doas), folded_deg(est, doas_b))
    ok = float(np.mean(err < 5.0))

    one = chunks[0]
    state1, _ = sl.process_chunk(sl.init_state(), one)  # warm-up
    sync(dev)
    lat_block = []
    state1 = sl.init_state()
    for _ in range(latency_reps[0]):
        t0 = time.perf_counter()
        state1, _ = sl.process_chunk(state1, one)
        sync(dev)
        lat_block.append((time.perf_counter() - t0) * 1000)
    state1 = sl.init_state()
    t0 = time.perf_counter()
    for _ in range(latency_reps[1]):
        state1, _ = sl.process_chunk(state1, one)
    sync(dev)
    lat_pipe = (time.perf_counter() - t0) / latency_reps[1] * 1000

    metrics = {
        "serving-audio-sec/sec": round(serving, 1),
        "serving-step-ms": round(step_ms, 2),
        "streams": batch,
        "doa-ok-frac@5deg" if sources == 1 else "nearest-source-frac@5deg": ok,
        "sources": sources,
        "latency-ms-blocking": round(float(np.median(lat_block)), 1),
        "latency-ms-pipelined": round(lat_pipe, 1),
    }
    print(json.dumps(metrics))
    return metrics


def wire_chunks(chunks: torch.Tensor, wire: str, wire_upsample: int) -> np.ndarray:
    """Each stream's chunk, peak-normalized to 0.98, in its wire encoding
    (``encode_wire``, zero filter history), stacked (B, ...)."""
    audio = chunks.cpu().numpy()
    peak = np.abs(audio).max()
    return np.stack([encode_wire(c / peak * 0.98, wire, wire_upsample) for c in audio])


def direct_answers(demo: Demo, sent: np.ndarray, n_rounds: int, wire: str, wire_upsample: int) -> np.ndarray:
    """Each stream's matched DoA after ``n_rounds`` of its wire chunk
    ``sent[i]`` through the direct streaming step, decoded as the daemon
    decodes it: what :func:`daemon_main`'s answers must equal."""
    audio = np.moveaxis(decode_wire(np.moveaxis(sent, 1, 0), wire), 0, 1)
    x = torch.as_tensor(np.ascontiguousarray(audio, np.float32), device=demo.device)
    sl = StreamingLocalizer(demo)
    state = sl.init_state(batch=x.shape[0])
    carry = torch.zeros((x.shape[0], TAPS_PER_PHASE - 1, x.shape[-1]), device=demo.device)
    up = wire_upsample
    hp = phase_table(design_upsample_fir(up), up) if up > 1 else None
    for _ in range(n_rounds):
        chunk = x
        if up > 1:
            chunk, carry = upsample_poly_stream(x, carry, hp, up)
        state = sl.process_chunk(state, chunk, return_spikes=False)
    return sl.estimate_doa(state, "matched").to(torch.float32).cpu().numpy()


def daemon_main(batch: int = 64, chunk_sec: float = 0.25, n_steps: int = 20, freq_band=(1600, 1900),
                num_grid: int = 64 * 7 + 1, use_shm: bool = False, wire: str = "i16", wire_upsample: int = 1,
                native_clients: bool = False, sources: int = 1, fs: int = FS, device=None, demo=None,
                answers: dict | None = None) -> dict:
    """Serving throughput through the daemon (module docstring); ``demo``
    replaces :func:`main`'s model, and ``answers``, where given, receives
    each stream's last answer by stream id."""
    demo = demo or calibrated_demo(num_grid, chunk_sec, fs, freq_band, resolve_device(device))
    chunks, doas, doas_b = stream_chunks(demo, batch, chunk_sec, freq_band, sources)
    sent = wire_chunks(chunks, wire, wire_upsample)

    got = {}

    def round_trip(clients):
        for i, c in enumerate(clients):
            c.send(sent[i])
        if use_shm:
            for i, c in enumerate(clients):
                got[i] = c.recv_doa(timeout=600.0) if sources == 1 else c.recv_doa(timeout=600.0, sources=sources)
        else:
            for c in clients:
                sid, doa = c.recv_doa(timeout=600.0)
                got[sid] = doa

    clients, attached = [], []
    with LocalizationServer(demo, max_streams=batch, chunk_sec=chunk_sec, wire_dtype=wire, batch_window_ms=60,
                            wire_upsample=wire_upsample, sources=sources) as srv:
        srv.start()
        try:
            for i in range(batch):
                if use_shm:
                    shm_client = NativeShmClient if native_clients else ShmStreamClient
                    clients.append(shm_client(f"hm2024_bench_{os.getpid()}_{i}"))
                    srv.attach_shm(i, clients[-1].name)
                    attached.append(i)
                else:
                    tcp_client = NativeStreamClient if native_clients else StreamClient
                    clients.append(tcp_client(srv.port, i, sources=sources))
            round_trip(clients)  # warm-up: the first step's one-off set-up
            srv.stage_times.update({k: 0 if k == "steps" else 0.0 for k in srv.stage_times})
            t0 = time.perf_counter()
            for _ in range(n_steps):
                round_trip(clients)
            wall = time.perf_counter() - t0
            st = dict(srv.stage_times)
        finally:
            for i in attached:
                srv.detach_shm(i)
            for c in clients:
                c.close()  # a shared-memory ring's name is unlinked here
    if sources == 2:
        # each stream's K answer slots must cover both its sources
        oks = []
        for i in range(batch):
            res = np.atleast_1d(np.asarray(got[i], np.float64))
            res = res[np.isfinite(res)]
            oks.append(all(res.size > 0 and folded_deg(res, d).min() < 10.0 for d in (doas[i], doas_b[i])))
        ok = float(np.mean(oks))
    else:
        ok = float(np.mean(folded_deg([got[i] for i in range(batch)], doas) < 5.0))
    if answers is not None:
        answers.update(got)

    metrics = {
        ("shm" if use_shm else "daemon") + "-audio-sec/sec": round(batch * chunk_sec * n_steps / wall, 1),
        "daemon-step-ms": round(wall / n_steps * 1000, 2),
        "streams": batch,
        "doa-ok-frac@5deg" if sources == 1 else "both-sources-frac@10deg": ok,
        "sources": sources,
        "wire": wire + ("@12k" if wire_upsample == 4 else ""),
        "native-clients": native_clients,
    }
    if st["steps"]:
        metrics["stage-ms"] = {k: round(v / st["steps"] * 1000, 1) for k, v in st.items() if k != "steps"}
        metrics["stage-steps"] = st["steps"]
    print(json.dumps(metrics))
    return metrics


def cli(argv=None) -> dict:
    ap = arg_parser(__doc__)
    ap.add_argument("--daemon", action="store_true", help="through the serving daemon, TCP clients")
    ap.add_argument("--shm", action="store_true", help="through the serving daemon, shared-memory clients")
    ap.add_argument("--wire", choices=("f32", "i16", "u8", "u4"), default="i16")
    ap.add_argument("--decim", type=int, choices=(1, 4), default=1, help="4: the wire at fs/4")
    ap.add_argument("--native", action="store_true", help="the C producer clients (native/streamc.cpp)")
    ap.add_argument("--sources", type=int, choices=(1, 2), default=1)
    ap.add_argument("--fs", type=int, default=FS)
    args = ap.parse_args(argv)
    size = dict(chunk_sec=0.1, num_grid=17) if args.quick else {}
    if args.shm or args.daemon:
        return daemon_main(use_shm=args.shm, wire=args.wire, wire_upsample=args.decim, native_clients=args.native,
                           sources=args.sources, fs=args.fs, device=args.device,
                           **(dict(size, batch=4, n_steps=2) if args.quick else {}))
    return main(fs=args.fs, sources=args.sources, device=args.device,
                **(dict(size, batch=4, n_steps=2, latency_reps=(2, 2)) if args.quick else {}))


if __name__ == "__main__":
    cli()
