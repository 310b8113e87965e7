"""Serving daemon: N concurrent audio streams in, DoA estimates out
(counterpart of ``haghighatshoarmuir2024_tpu/runtime/server.py``; the
reference's closest analogue is its live demo loop, one capture at a time,
micloc/xylo_snn_localization.py:446-542).

The native C++ ingestion daemon (``native/streamd.cpp``, shared with the JAX
package and bound here with ctypes) accepts TCP or shared-memory audio
streams into per-stream queues on its own threads.  One Python loop takes at
most one chunk per stream, advances all B stream slots by one carried-state
step of :class:`StreamingLocalizer` on the device, and posts each served
stream's running DoA back to its client.

One serve step, in plain tensor code (``server.py:488-530`` of the JAX
package): zero the state of reclaimed slots, advance all B lanes (idle lanes
compute on stale audio), merge the active lanes back with ``torch.where``,
estimate: ``peak`` and ``matched`` on the folded rates, the band-stacked
``matched_stacked`` and ``matched_auto`` on the unfolded ones (the counts,
or the ``forget`` EMA where set), against the demo's table, block-normalized
once on the host (``server.py:315-351, 426-452``).  With ``sources=K`` > 1
the estimate is the top-K peaks of each lane's scores, picked on the device
(``ops.peaks.top_k_peaks``, ``server.py:455-475``), and every result frame
carries K floats, NaN-padded.  Per step there is one host→device upload —
the daemon's buffer and the two lane masks share one pinned staging buffer
— and one (B,) or (B, K) DoA download.  ``track=True`` runs a host tracker
per slot over its answers (``utils.tracking``: ``DoaTracker``, or
``MultiDoaTracker`` with K + 2 slots when K > 1), reset when the slot is
reclaimed (``server.py:207-240, 595-625``).

With ``mesh=`` (``parallel.make_mesh``) the B stream slots split into
B/n lanes per shard of the mesh's data axis (JAX ``server.py:235-284,
385-420, 480-530``): each shard keeps its own state, wire carry and
``forget`` EMA on its device, over its own copy of the demo
(``parallel.replicate_demo``), receives its slice of the staging buffer
and runs the serve step on it; only the DoAs come back, gathered once on
the host.  One host thread drives the shards: every shard's step is
launched up to its one host synchronization (K2's flag read) before any
shard finishes, so every card has its work queued while the host waits on
one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import socket
import struct
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..models.xylo.pipeline import STACKED
from ..ops.mulaw import mulaw4_decode_table, mulaw4_encode, mulaw_decode_table, mulaw_encode, pack4
from ..ops.peaks import top_k_peaks
from ..ops.resample import TAPS_PER_PHASE, decimate_fir, design_upsample_fir, phase_table, upsample_poly_stream
from ..parallel.mesh import canonical_device, device_scope, replicate_demo
from ..utils.tracking import DoaTracker, MultiDoaTracker
from .streaming import StreamingLocalizer

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "streamd.cpp"
_BUILD_DIR = _REPO_ROOT / "native" / "build"

_WIRE = {"f32": (np.float32, torch.float32), "i16": (np.int16, torch.int16),
         "u8": (np.uint8, torch.uint8), "u4": (np.uint8, torch.uint8)}


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    """Build ``native/streamd.cpp`` with g++ at first use into
    ``native/build/`` (git-ignored), named by a hash of the source, and bind
    its C interface (the JAX package's loader, ``server.py:47-88``)."""
    so = _BUILD_DIR / f"libstreamd_{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=_BUILD_DIR, suffix=".so", delete=False) as tmp:
            tmp_path = Path(tmp.name)
        proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp_path), str(_SRC), "-pthread"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp_path.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {_SRC.name} ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp_path, so)
    lib = ctypes.CDLL(str(so))
    u32, u32p, vp, i = ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p, ctypes.c_int
    for name, args, res in (
        ("sd_start", [ctypes.c_uint16, u32, u32, u32, u32], vp),
        ("sd_port", [vp], i),
        ("sd_next_batch_r", [vp, u32, u32, u32p, vp, u32p, i, ctypes.POINTER(i)], i),
        ("sd_post_results", [vp, u32, u32p, ctypes.POINTER(ctypes.c_float)], None),
        ("sd_set_window", [vp, u32], None),
        ("sd_set_sources", [vp, u32], None),
        ("sd_shm_attach", [vp, u32, ctypes.c_char_p], i),
        ("sd_shm_detach", [vp, u32], i),
        ("sd_stop", [vp], None),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


class _Shard:
    """One shard's stream lanes ``[lo, hi)`` of a :class:`LocalizationServer`
    on its device: its localizer over its copy of the demo, its carried
    state, wire carry and ``forget`` EMA, and the serve step on its slice of
    the staging buffer.  Without a mesh one shard holds every lane."""

    def __init__(self, srv: "LocalizationServer", index: int, demo):
        self.srv, self.demo, self.device = srv, demo, demo.device
        self.B = srv._lanes
        self.lo, self.hi = index * self.B, (index + 1) * self.B
        self.sl = StreamingLocalizer(demo)
        self._tbl8 = torch.as_tensor(mulaw_decode_table(), device=self.device)
        self._tbl4 = torch.as_tensor(mulaw4_decode_table(), device=self.device)
        self._wire_carry = None
        if srv.wire_upsample > 1:
            self._hp = torch.as_tensor(phase_table(design_upsample_fir(srv.wire_upsample), srv.wire_upsample),
                                       device=self.device)
            self._wire_carry = torch.zeros((self.B, TAPS_PER_PHASE - 1, srv.M), device=self.device)
        self._state = self.sl.init_state(batch=self.B)
        self._active = self._launched = None  # a launched step's lanes and state (launch, finish)
        self._ema = None
        if srv.forget is not None:
            self._ema = torch.zeros((self.B, self.sl.n_hidden), device=self.device)

    def _decode(self, raw_bytes: torch.Tensor) -> torch.Tensor:
        """The uploaded wire bytes → (B, Tw, M) float32 wire-rate audio."""
        srv = self.srv
        raw = raw_bytes.view(srv._torch_dt).reshape(self.B, srv.Tb, srv.M)
        if srv.wire_dtype == "i16":
            return raw.to(torch.float32) * (1.0 / 32768.0)
        if srv.wire_dtype == "u8":
            return self._tbl8[raw.long()]
        if srv.wire_dtype == "u4":
            r = raw.long()
            hi, lo = self._tbl4[(r >> 4) & 0xF], self._tbl4[r & 0xF]  # even sample in the high nibble
            return torch.stack([hi, lo], dim=2).reshape(self.B, srv.Tb * 2, srv.M)
        return raw

    def reset_lanes(self, reset: torch.Tensor) -> None:
        self._state = self._state.zero_where(reset)
        if self._wire_carry is not None:
            self._wire_carry = self._wire_carry.masked_fill(reset[:, None, None], 0.0)
        if self._ema is not None:
            self._ema = self._ema.masked_fill(reset[:, None], 0.0)

    def _estimate(self, rate: torch.Tensor) -> torch.Tensor:
        """Rates (B, H) → (B,) DoAs, or for K > 1 the (B, K) DoAs of each
        row's top-K score peaks, NaN where a row has fewer (JAX
        ``server.py:455-475``)."""
        srv = self.srv
        if srv.K == 1:
            return self.demo.estimate_doa_from_rate(rate, srv.method)
        scores = self.demo.doa_scores(rate, srv.method)
        G = len(self.demo.doa_list)
        dist = max(int(round(srv.source_min_sep_deg / (360.0 / max(G - 1, 1)))), 1)
        idx, _, valid = top_k_peaks(scores, srv.K, distance=dist, rel_height=srv.source_rel_height)
        doas = self.demo._doa_t.to(torch.float32)[idx]
        return torch.where(valid, doas, torch.full_like(doas, float("nan")))

    def launch(self, data: torch.Tensor, masks: torch.Tensor) -> None:
        """The first half of a serve step on this shard's uploaded chunk rows
        and (2, B) lane masks (active, reset): reset, decode, upsample and
        the step up to K2's flag read (``StreamingLocalizer._step_launch``)."""
        srv = self.srv
        self._active, reset = masks[:self.B].bool(), masks[self.B:].bool()
        self.reset_lanes(reset)
        chunks = self._decode(data)
        if self._wire_carry is not None:
            chunks, adv = upsample_poly_stream(chunks, self._wire_carry, self._hp, srv.wire_upsample)
            self._wire_carry = torch.where(self._active[:, None, None], adv, self._wire_carry)
        self._launched = self.sl._step_launch(self._state, chunks)

    def finish(self) -> torch.Tensor:
        """The rest of the serve step: the LIF, the merge of the active lanes
        and the estimate → (B,) or (B, K) DoAs on the device."""
        srv, active, state = self.srv, self._active, self._state
        new, _, _ = self.sl._step_finish(self._launched)
        self._launched = None
        self._state = new.where(active, state)
        if self._ema is None:
            return self._estimate(self.sl.rate(self._state, fold=srv.method not in STACKED))
        # the merged counts of idle lanes are their old counts: chunk counts 0
        chunk_counts = (self._state.counts - state.counts).to(torch.float32)
        self._ema = torch.where(active[:, None], srv.forget * self._ema + chunk_counts, self._ema)
        return self._estimate(self._ema if srv.method in STACKED else self.demo.fold(self._ema))


class LocalizationServer:
    """TCP / shared-memory serving front end around :class:`StreamingLocalizer`.

    One instance owns ``max_streams`` stream slots on ``demo.device``;
    clients claim a slot id and stream audio in the ``wire_dtype`` format
    (``f32``, PCM16 ``i16``, mu-law ``u8``, 4-bit mu-law ``u4``, see
    :func:`encode_wire`), optionally at fs/4 (``wire_upsample=4``, rebuilt to
    48 kHz on the device); the server answers with the running DoA after
    every processed chunk.  ``forget`` in [0, 1) estimates from an
    exponentially forgotten spike-count profile instead of the whole
    history.  ``sources`` in [1, 8] is the number of DoAs per answer: for
    K > 1 the top-K peaks of the scores, at least ``source_min_sep_deg``
    apart and above ``source_rel_height`` times the row's maximum.
    ``track=True`` tracks each slot's answers on the host (gate
    ``track_gate_deg``, gain ``track_alpha``); with K > 1 an answer holds
    the confirmed tracks.  ``HM2024_SERVE_TIMING=1`` accumulates seconds per
    stage in ``stage_times``.  ``mesh`` (``parallel.make_mesh``) splits the
    slots over the devices of its ``mesh_axis``, B/n a shard; ``max_streams``
    must divide that axis.
    """

    def __init__(self, demo, max_streams: int = 64, chunk_sec: float = 0.25, port: int = 0,
                 method: str | None = None, batch_window_ms: int = 10, wire_dtype: str = "f32",
                 wire_upsample: int = 1, forget: float | None = None, mesh=None,
                 track: bool = False, track_alpha: float = 0.35, track_gate_deg: float = 25.0,
                 sources: int = 1, source_min_sep_deg: float = 20.0, source_rel_height: float = 0.2,
                 mesh_axis: str = "data"):
        if not 1 <= int(sources) <= 8:
            raise ValueError("sources must be in [1, 8]")
        self.K = int(sources)
        self.source_min_sep_deg = float(source_min_sep_deg)
        self.source_rel_height = float(source_rel_height)
        self.demo = demo
        self.device = demo.device
        self.B = int(max_streams)
        self.Tc = int(round(chunk_sec * demo.fs))
        self.M = len(demo.geometry)
        self.method = method or ("matched" if getattr(demo, "_profiles", None) is not None else "peak")
        if self.method not in ("peak", "matched") + STACKED:
            raise ValueError(f"method must be 'peak', 'matched', 'matched_stacked' or 'matched_auto' "
                             f"(got {self.method!r})")
        if self.method in STACKED and getattr(demo, "_profiles_stacked", None) is None:
            raise ValueError(f"method={self.method!r} needs demo.calibrate_profiles(band_stacked=True)")
        if wire_dtype not in _WIRE:
            raise ValueError("wire_dtype must be 'f32', 'i16', 'u8' or 'u4'")
        if wire_upsample not in (1, 4):
            raise ValueError("wire_upsample must be 1 or 4")
        if wire_upsample > 1 and abs(float(demo.fs) - 48_000.0) > 1e-6:
            # the interpolator's cutoff is a fraction of the internal rate:
            # at 24 kHz it would fall inside the 2.0-2.6 kHz reference bands
            raise ValueError("wire_upsample>1 assumes the 48 kHz internal rate")
        if forget is not None and not (0.0 <= float(forget) < 1.0):
            raise ValueError("forget must be in [0, 1)")
        self.wire_dtype = wire_dtype
        self.wire_upsample = int(wire_upsample)
        if self.Tc % self.wire_upsample:
            raise ValueError("chunk samples must divide by wire_upsample")
        self.Tw = self.Tc // self.wire_upsample  # wire-rate samples per chunk
        if wire_dtype == "u4" and self.Tw % 2:
            raise ValueError("u4 wire needs an even wire-rate chunk")
        self.Tb = self.Tw // 2 if wire_dtype == "u4" else self.Tw  # wire rows per chunk
        self.forget = None if forget is None else float(forget)
        self.mesh, self.mesh_axis = mesh, mesh_axis
        devices = [canonical_device(demo.device)] if mesh is None else mesh.axis_devices(mesh_axis)
        if self.B % len(devices):
            raise ValueError("max_streams must divide the mesh axis size")

        np_dt, self._torch_dt = _WIRE[wire_dtype]
        elem = np.dtype(np_dt).itemsize
        self._lib = _load()
        self._h = self._lib.sd_start(port, self.B, self.Tb, self.M, elem)
        if not self._h:
            raise OSError("streamd: failed to bind server socket")
        self._lib.sd_set_window(self._h, batch_window_ms)
        if self.K > 1:
            self._lib.sd_set_sources(self._h, self.K)
        self.port = self._lib.sd_port(self._h)
        self._stop = threading.Event()
        self._thread = None

        self._ids_buf = (ctypes.c_uint32 * self.B)()
        self._reset_buf = (ctypes.c_uint32 * self.B)()
        self._n_resets = ctypes.c_int(0)
        # one staging buffer per step: the daemon's (B, Tb, M) chunk rows,
        # then each shard's active and reset lane masks (B/n bytes each);
        # pinned on a GPU so that each upload is a DMA
        self._nbytes = self.B * self.Tb * self.M * elem
        self._staging = torch.zeros(self._nbytes + 2 * self.B, dtype=torch.uint8,
                                    pin_memory=any(d.type == "cuda" for d in devices))
        staging_np = self._staging.numpy()
        self._data_buf = staging_np[:self._nbytes].view(np_dt).reshape(self.B, self.Tb, self.M)
        self._lanes = self.B // len(devices)
        self._masks = staging_np[self._nbytes:].reshape(len(devices), 2, self._lanes)  # (shard, active/reset, lane)
        self.stage_times = {"wait": 0.0, "device": 0.0, "route": 0.0, "steps": 0}
        self._timing = os.environ.get("HM2024_SERVE_TIMING") in ("1", "2")

        # per-slot host trackers over the answers; a reclaimed slot's is reset
        self._trackers = None
        if track:
            self._trackers = [
                MultiDoaTracker(num_tracks=self.K + 2, alpha=track_alpha, gate_deg=track_gate_deg, max_misses=4)
                if self.K > 1 else DoaTracker(alpha=track_alpha, gate_deg=track_gate_deg)
                for _ in range(self.B)]
        demos = {canonical_device(demo.device): demo}
        for d in devices:
            if d not in demos:
                demos[d] = replicate_demo(demo, d)
        self._shards = [_Shard(self, i, demos[d]) for i, d in enumerate(devices)]

    # ---- device side ------------------------------------------------------
    def _serve(self) -> np.ndarray:
        """One serve step over the shards: each uploads its slice of the
        staging buffer (its lanes' rows and masks; the whole buffer at once
        without a mesh) and launches its step, then each finishes it; the
        (B,) or (B, K) DoAs come back to the host."""
        for sh in self._shards:
            with device_scope(sh.device):
                if len(self._shards) == 1:
                    staged = self._staging.to(sh.device, non_blocking=True)
                    data, masks = staged[:self._nbytes], staged[self._nbytes:]
                else:
                    row = self._nbytes // self.B
                    data = self._staging[sh.lo * row:sh.hi * row].to(sh.device, non_blocking=True)
                    off = self._nbytes + 2 * sh.lo
                    masks = self._staging[off:off + 2 * self._lanes].to(sh.device, non_blocking=True)
                sh.launch(data, masks)
        doas = []
        for sh in self._shards:
            with device_scope(sh.device):
                doas.append(sh.finish())
        return np.concatenate([d.to("cpu", torch.float32).numpy() for d in doas])

    def _answers(self, ids: np.ndarray, all_doas: np.ndarray) -> list:
        """The served streams' result floats, n·K of them: each stream's DoA
        (its tracker's output with ``track=True``), or for K > 1 its top-K
        peaks (its confirmed tracks), NaN-padded (JAX ``server.py:595-625``)."""
        if self.K == 1:
            if self._trackers is None:
                return all_doas[ids].tolist()
            return [self._trackers[i].update(float(all_doas[i])) for i in ids]
        rows = np.full((len(ids), self.K), np.nan, np.float32)
        for j, i in enumerate(ids):
            z = all_doas[i]
            if self._trackers is None:
                rows[j] = z
            else:
                thetas, confirmed = self._trackers[i].update(z, valid=np.isfinite(z))
                conf = thetas[confirmed][: self.K]
                rows[j, : conf.size] = conf
        return rows.ravel().tolist()

    # ---- serving loop -----------------------------------------------------
    def step(self, timeout_ms: int = 100) -> int:
        """One serving step: drain at most one ready chunk per stream,
        advance those streams, answer them.  Returns the number served.

        Chunks and pending slot resets are drained atomically (one daemon
        mutex hold), so every returned chunk was ingested after the latest
        claim of its slot: reset lanes are zeroed first, then advanced."""
        t0 = time.monotonic() if self._timing else 0.0
        n = self._lib.sd_next_batch_r(
            self._h, self.B, timeout_ms, self._ids_buf,
            self._data_buf.ctypes.data_as(ctypes.c_void_p),
            self._reset_buf, self.B, ctypes.byref(self._n_resets),
        )
        t1 = time.monotonic() if self._timing else 0.0
        self._masks[:, 1] = 0
        n_reset = self._n_resets.value
        if n_reset > 0:
            reset_slots = np.ctypeslib.as_array(self._reset_buf)[:n_reset]
            self._masks[reset_slots // self._lanes, 1, reset_slots % self._lanes] = 1
            if self._trackers is not None:
                for s in reset_slots:
                    self._trackers[int(s)].reset()
        if n <= 0:
            if n_reset > 0:
                for i, sh in enumerate(self._shards):
                    with device_scope(sh.device):
                        sh.reset_lanes(torch.as_tensor(self._masks[i, 1], device=sh.device).bool())
            if self._timing:
                self.stage_times["wait"] += t1 - t0
            return 0
        ids = np.ctypeslib.as_array(self._ids_buf)[:n].copy()
        self._masks[:, 0] = 0
        self._masks[ids // self._lanes, 0, ids % self._lanes] = 1
        all_doas = self._serve()
        t2 = time.monotonic() if self._timing else 0.0
        out_ids = (ctypes.c_uint32 * n)(*ids.tolist())
        out_doas = (ctypes.c_float * (n * self.K))(*self._answers(ids, all_doas))
        self._lib.sd_post_results(self._h, n, out_ids, out_doas)
        if self._timing:
            t3 = time.monotonic()
            self.stage_times["wait"] += t1 - t0
            self.stage_times["device"] += t2 - t1
            self.stage_times["route"] += t3 - t2
            self.stage_times["steps"] += 1
        return n

    def attach_shm(self, stream_id: int, name: str) -> None:
        """Attach a co-located producer's shared-memory ring (made by
        :class:`ShmStreamClient`) to a stream slot."""
        if self._lib.sd_shm_attach(self._h, stream_id, name.encode()) != 0:
            raise OSError(f"streamd: shm attach failed for slot {stream_id} ({name})")

    def detach_shm(self, stream_id: int) -> None:
        self._lib.sd_shm_detach(self._h, stream_id)

    def serve_forever(self):
        while not self._stop.is_set():
            self.step()

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._h:
            self._lib.sd_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------- clients
def _compress(x: np.ndarray, wire_dtype: str) -> np.ndarray:
    if wire_dtype == "i16":
        return np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
    if wire_dtype == "u8":
        return mulaw_encode(x)
    if wire_dtype == "u4":
        return pack4(mulaw4_encode(x))
    return x


def encode_wire(chunk: np.ndarray, wire_dtype: str = "f32", wire_upsample: int = 1) -> np.ndarray:
    """Client-side wire encode matching a server's (wire_dtype,
    wire_upsample): (T, M) float audio in [-1, 1] → wire buffer.
    ``wire_upsample=4`` decimates to fs/4 first (anti-aliased, zero
    history); u8/u4 are mu-law companded, u4 packed two codes per byte."""
    x = np.asarray(chunk, np.float32)
    if wire_upsample > 1:
        x = decimate_fir(x, wire_upsample)
    return _compress(x, wire_dtype)


class WireEncoder:
    """Stateful client-side encoder for streaming chunks: it carries the
    anti-alias filter history, so chunked encoding equals encoding the
    concatenated stream (the mirror of the server's carried-state
    interpolator)."""

    def __init__(self, wire_dtype: str = "f32", wire_upsample: int = 1):
        self.wire_dtype = wire_dtype
        self.up = int(wire_upsample)
        if self.up > 1:
            self._h = design_upsample_fir(self.up) / np.float32(self.up)
            self._carry = None  # (L-1, M), shaped on the first chunk

    def encode(self, chunk: np.ndarray) -> np.ndarray:
        x = np.asarray(chunk, np.float32)
        if self.up > 1:
            L = self._h.size
            if self._carry is None:
                self._carry = np.zeros((L - 1,) + x.shape[1:], np.float32)
            ext = np.concatenate([self._carry, x], axis=0)
            self._carry = ext[-(L - 1):].copy()
            flat = ext.reshape(ext.shape[0], -1)
            out = np.empty((x.shape[0], flat.shape[1]), np.float32)
            for c in range(flat.shape[1]):
                out[:, c] = np.convolve(flat[:, c], self._h, mode="valid")
            x = out.reshape((x.shape[0],) + x.shape[1:])[:: self.up]
        return _compress(x, self.wire_dtype)


class StreamClient:
    """Minimal TCP client of :class:`LocalizationServer` (the JAX package's
    ``StreamClient``, copied: its module imports JAX).  ``sources`` must be
    the server's: a result frame is ``u32 id + f32[K]``."""

    def __init__(self, port: int, stream_id: int, host: str = "127.0.0.1", sources: int = 1):
        self.K = int(sources)
        self.sock = socket.create_connection((host, port))
        self.sock.sendall(struct.pack("<II", 0x484D3234, stream_id))

    def send(self, chunk: np.ndarray):
        """Send a (T, M) block (any T; the daemon re-chunks) in the server's
        wire dtype: float32, int16 PCM or mu-law uint8 codes."""
        data = np.ascontiguousarray(chunk)
        if data.dtype not in (np.float32, np.int16, np.uint8):
            data = data.astype(np.float32)
        self.sock.sendall(struct.pack("<I", data.size) + data.tobytes())

    def recv_doa(self, timeout: float = 30.0):
        """The next result: ``(stream_id, doa)``, or for K > 1
        ``(stream_id, (K,) float32 array)``, NaN-padded."""
        self.sock.settimeout(timeout)
        want = 4 + 4 * self.K
        buf = b""
        while len(buf) < want:
            part = self.sock.recv(want - len(buf))
            if not part:
                raise ConnectionError("server closed")
            buf += part
        sid = struct.unpack_from("<I", buf)[0]
        doas = np.frombuffer(buf, np.float32, count=self.K, offset=4)
        return (sid, float(doas[0])) if self.K == 1 else (sid, doas.copy())

    def close(self):
        self.sock.close()


class ShmStreamClient:
    """Shared-memory producer for a co-located :class:`LocalizationServer`:
    a single-producer/single-consumer byte ring under ``/dev/shm`` (layout
    in ``native/streamd.cpp``), written with plain memcpy.  Attach it with
    ``server.attach_shm(stream_id, client.name)``.  Publication of the write
    position relies on the host's total store order (x86)."""

    MAGIC = 0x484D5348  # "HMSH"
    HDR = 64

    def __init__(self, name: str, capacity_bytes: int = 1 << 22):
        import mmap

        self.name = name
        self.path = "/dev/shm/" + name
        self.cap = int(capacity_bytes)
        self._f = open(self.path, "w+b")
        self._f.truncate(self.HDR + self.cap)
        self.mm = mmap.mmap(self._f.fileno(), self.HDR + self.cap)
        self.mm[: self.HDR] = b"\x00" * self.HDR
        struct.pack_into("<I", self.mm, 4, self.cap)
        struct.pack_into("<I", self.mm, 0, self.MAGIC)  # magic last: the ring is valid
        self._last_seq = 0

    def _write_pos(self):
        return struct.unpack_from("<Q", self.mm, 8)[0]

    def _read_pos(self):
        return struct.unpack_from("<Q", self.mm, 16)[0]

    def send(self, chunk: np.ndarray, timeout: float = 30.0):
        """Append a (T, M) block in the server's wire dtype; waits while the
        ring is full."""
        data = np.ascontiguousarray(chunk).tobytes()
        n, off = len(data), 0
        deadline = time.monotonic() + timeout
        while off < n:
            wp = self._write_pos()
            free = self.cap - (wp - self._read_pos())
            if free == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError("shm ring full: consumer not draining")
                time.sleep(0.0002)
                continue
            take = min(free, n - off)
            idx = int(wp % self.cap)
            first = min(take, self.cap - idx)
            self.mm[self.HDR + idx: self.HDR + idx + first] = data[off: off + first]
            if first < take:
                self.mm[self.HDR: self.HDR + take - first] = data[off + first: off + take]
            struct.pack_into("<Q", self.mm, 8, wp + take)
            off += take

    def recv_doa(self, timeout: float = 30.0, sources: int = 1):
        """The newest DoA once a new result is posted (each result supersedes
        the last); with ``sources=K`` > 1 a (K,) NaN-padded array (slot 0 at
        byte 28, slots 1..K-1 at 36 + 4(k-1), ``native/streamd.cpp``)."""
        deadline = time.monotonic() + timeout
        while True:
            seq = struct.unpack_from("<I", self.mm, 24)[0]
            if seq != self._last_seq:
                self._last_seq = seq
                if sources == 1:
                    return struct.unpack_from("<f", self.mm, 28)[0]
                out = np.empty(sources, np.float32)
                out[0] = struct.unpack_from("<f", self.mm, 28)[0]
                for k in range(1, sources):
                    out[k] = struct.unpack_from("<f", self.mm, 36 + 4 * (k - 1))[0]
                return out
            if time.monotonic() > deadline:
                raise TimeoutError("no shm result")
            time.sleep(0.0002)

    def close(self, unlink: bool = True):
        self.mm.close()
        self._f.close()
        if unlink:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
