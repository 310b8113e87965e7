"""Wrapped-angle DoA tracking (counterpart of
``haghighatshoarmuir2024_tpu/utils/tracking.py``).

The reference scores raw per-frame estimates (micloc/tests/
test_snn_hilbert_localization.py:224-334); the JAX package adds trackers on
the circle, and the port keeps them in two forms:

* batched tensor functions: :func:`track_step` / :func:`track_angles` (the
  alpha-beta tracker) and :func:`multi_track_step` /
  :func:`track_multi_angles` (gated greedy global-nearest-neighbour
  association into M track slots), pure selects over any leading batch
  dims, float32 and int32 state; the scans and the initial states run on
  ``device``, the card unless the caller passes ``device="cpu"``, and a
  step runs on its state's device.  On the CPU a scan is a loop of steps
  (:func:`track_angles_plain`, :func:`track_multi_angles_plain`); on the
  card it is one launch of a hand kernel (``csrc/tracking.cu``) that
  equals that loop bit for bit;
* :class:`DoaTracker` and :class:`MultiDoaTracker`, the host-side numpy
  trackers of the CLI and the server, copies of the JAX package's (its
  module imports JAX).

The innovation is the wrapped difference ``atan2(sin, cos)``, so a target
crossing ±π tracks through the seam.  A measurement beyond the gate is an
outlier: the track coasts on its prediction and counts the miss; after
``max_misses`` consecutive misses it re-acquires.  The second measurement
sets the rate directly (two-point bootstrap, ungated).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import resolve_device

__all__ = ["TrackState", "track_step", "track_angles", "DoaTracker", "MultiTrackState", "multi_track_init",
           "multi_track_step", "track_multi_angles", "MultiDoaTracker"]


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(x), torch.cos(x))


def _beta(alpha: float, beta: Optional[float]) -> float:
    """The critically damped alpha-beta relation ``beta = alpha² / (2 − alpha)``."""
    return alpha * alpha / (2.0 - alpha) if beta is None else beta


class TrackState(NamedTuple):
    """Tracker carry: wrapped angle, rate [rad/frame], consecutive gated-out
    measurements, and 0 = empty, 1 = have theta, 2 = tracking."""

    theta: torch.Tensor
    omega: torch.Tensor
    misses: torch.Tensor
    initialized: torch.Tensor


def track_init(batch_shape=(), device=None) -> TrackState:
    device = resolve_device(device)
    z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
    zi = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    return TrackState(theta=z, omega=z, misses=zi, initialized=zi)


def track_step(state: TrackState, z, alpha: float = 0.35, beta: Optional[float] = None,
               gate_rad: float = float(np.deg2rad(25.0)), max_misses: int = 3):
    """One predict/gate/update on the circle for every lane of ``state``
    (JAX ``tracking.py:65-136``).  Returns ``(next_state, theta_filtered)``."""
    beta = _beta(alpha, beta)
    z = torch.as_tensor(z, dtype=torch.float32, device=state.theta.device)
    theta_pred = _wrap(state.theta + state.omega)
    delta = _wrap(z - theta_pred)
    inlier = delta.abs() <= gate_rad
    theta_upd = _wrap(theta_pred + alpha * delta)
    omega_upd = state.omega + beta * delta

    misses = torch.where(inlier, 0, state.misses + 1)
    reacquire = misses > max_misses
    theta = torch.where(reacquire, z, torch.where(inlier, theta_upd, theta_pred))
    omega = torch.where(reacquire, 0.0, torch.where(inlier, omega_upd, state.omega))
    misses = torch.where(reacquire, 0, misses)
    init = torch.where(reacquire, 1, state.initialized)
    # bootstrap step 2: the second measurement sets omega, ungated
    boot = state.initialized == 1
    theta = torch.where(boot, z, theta)
    omega = torch.where(boot, _wrap(z - state.theta), omega)
    init = torch.where(boot, 2, init)
    # bootstrap step 1: the first measurement sets theta
    fresh = state.initialized == 0
    theta = torch.where(fresh, z, theta)
    omega = torch.where(fresh, 0.0, omega)
    misses = torch.where(fresh | boot, 0, misses)
    init = torch.where(fresh, 1, init)
    nxt = TrackState(theta=theta.to(torch.float32), omega=omega.to(torch.float32),
                     misses=misses.to(torch.int32), initialized=init.to(torch.int32))
    return nxt, nxt.theta


def track_angles(angles, alpha: float = 0.35, beta: Optional[float] = None, gate_deg: float = 25.0,
                 max_misses: int = 3, device=None) -> torch.Tensor:
    """Filtered angles of a (T,) or (T, B) sequence of per-frame DoAs, on
    ``device`` (JAX ``tracking.py:150-181``).  On the CPU this is
    :func:`track_angles_plain`; on the card the hand kernel
    ``csrc/tracking.cu`` (``ops/cuda/track_kernel.track_angles``: one launch
    for all T frames, the same angles bit for bit)."""
    from ..ops.cuda import track_kernel

    angles = torch.as_tensor(angles, dtype=torch.float32, device=resolve_device(device))
    return track_kernel.track_angles(angles, alpha=alpha, beta=beta, gate_deg=gate_deg, max_misses=max_misses)


def track_angles_plain(angles, alpha: float = 0.35, beta: Optional[float] = None, gate_deg: float = 25.0,
                       max_misses: int = 3, device=None) -> torch.Tensor:
    """:func:`track_angles` as a loop of :func:`track_step` over the frames:
    the CPU's route, and the plain version the kernel is held to on the
    card."""
    angles = torch.as_tensor(angles, dtype=torch.float32, device=resolve_device(device))
    gate = float(np.deg2rad(gate_deg))
    state = track_init(angles.shape[1:], angles.device)
    out = []
    for z in angles:
        state, theta = track_step(state, z, alpha=alpha, beta=beta, gate_rad=gate, max_misses=max_misses)
        out.append(theta)
    return torch.stack(out) if out else angles.clone()


class DoaTracker:
    """Host-side streaming tracker: one estimate per frame in, the filtered
    DoA out (numpy; the JAX package's ``DoaTracker``, ``tracking.py:184-241``)."""

    def __init__(self, alpha: float = 0.35, beta: Optional[float] = None, gate_deg: float = 25.0,
                 max_misses: int = 3):
        self.alpha = float(alpha)
        self.beta = float(_beta(self.alpha, beta))
        self.gate_rad = float(np.deg2rad(gate_deg))
        self.max_misses = int(max_misses)
        self.reset()

    def reset(self):
        self.theta = 0.0
        self.omega = 0.0
        self.misses = 0
        self.initialized = 0  # 0 = empty, 1 = have theta, 2 = tracking

    @staticmethod
    def _wrap(x: float) -> float:
        return float(np.arctan2(np.sin(x), np.cos(x)))

    def update(self, z: float) -> float:
        z = float(z)
        if self.initialized == 0:
            self.theta, self.omega, self.misses = z, 0.0, 0
            self.initialized = 1
            return self.theta
        if self.initialized == 1:
            self.omega = self._wrap(z - self.theta)
            self.theta, self.misses = z, 0
            self.initialized = 2
            return self.theta
        theta_pred = self._wrap(self.theta + self.omega)
        delta = self._wrap(z - theta_pred)
        if abs(delta) <= self.gate_rad:
            self.theta = self._wrap(theta_pred + self.alpha * delta)
            self.omega = self.omega + self.beta * delta
            self.misses = 0
        else:
            self.misses += 1
            if self.misses > self.max_misses:
                self.theta, self.omega, self.misses = z, 0.0, 0
                self.initialized = 1
            else:
                self.theta = theta_pred
        return self.theta


# ---------------------------------------------------------------- multi-target
class MultiTrackState(NamedTuple):
    """Carry of M track slots per lane, (..., M): the single-target state
    per slot plus ``hits``, the inlier updates since birth."""

    theta: torch.Tensor
    omega: torch.Tensor
    misses: torch.Tensor
    initialized: torch.Tensor
    hits: torch.Tensor


def multi_track_init(num_tracks: int, batch_shape=(), device=None) -> MultiTrackState:
    device = resolve_device(device)
    shape = tuple(batch_shape) + (num_tracks,)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    zi = torch.zeros(shape, dtype=torch.int32, device=device)
    return MultiTrackState(theta=z, omega=z, misses=zi, initialized=zi, hits=zi)


def greedy_assignment(cost: torch.Tensor):
    """The greedy global-minimum assignment of a (..., M, K) cost, unrolled
    min(M, K) rounds of masked selects: each round takes the first minimum in
    row-major order (as ``jnp.argmin``) and, where it is finite, assigns its
    column to its row and closes both.  Returns ``(assign (..., M) int64, -1
    where unassigned, taken (..., K) bool)``."""
    M, K = cost.shape[-2:]
    dev = cost.device
    arange_m = torch.arange(M, device=dev)
    arange_k = torch.arange(K, device=dev)
    assign = torch.full(cost.shape[:-1], -1, dtype=torch.int64, device=dev)
    taken = torch.zeros(cost.shape[:-2] + (K,), dtype=torch.bool, device=dev)
    for _ in range(min(M, K)):
        flat = torch.argmin(cost.flatten(-2), dim=-1)  # first minimum, row-major, as jnp.argmin
        m, k = flat // K, flat % K
        ok = torch.isfinite(torch.gather(cost.flatten(-2), -1, flat[..., None])[..., 0])
        row = arange_m == m[..., None]
        col = arange_k == k[..., None]
        assign = torch.where(ok[..., None] & row, k[..., None], assign)
        taken = taken | (ok[..., None] & col)
        cost = torch.where(ok[..., None, None] & (row[..., :, None] | col[..., None, :]), float("inf"), cost)
    return assign, taken


def multi_track_step(state: MultiTrackState, z, valid, alpha: float = 0.35, beta: Optional[float] = None,
                     gate_rad: float = float(np.deg2rad(25.0)), max_misses: int = 3, confirm_hits: int = 2):
    """One gated-GNN predict/assign/update of M slots against K measurements
    ``z`` (..., K) with ``valid`` (..., K) (JAX ``tracking.py:276-403``):
    the greedy global-minimum assignment unrolled min(M, K) rounds over the
    wrapped-distance cost, alpha-beta updates of assigned tracking slots,
    the two-point bootstrap of booting ones, deaths (a tentative slot on its
    first miss, a tracking one after ``max_misses`` coasts), and each
    leftover valid measurement spawning in the first free slot.

    Returns ``(next_state, (theta (..., M), confirmed (..., M)))``."""
    beta = _beta(alpha, beta)
    dev = state.theta.device
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    M, K = state.theta.shape[-1], z.shape[-1]
    tracking = state.initialized == 2
    booting = state.initialized == 1
    theta_pred = _wrap(state.theta + state.omega)

    dist = _wrap(z[..., None, :] - theta_pred[..., :, None]).abs()  # (..., M, K)
    slot_gate = torch.where(tracking, gate_rad, float(np.pi))[..., None]
    feasible = (tracking | booting)[..., :, None] & valid[..., None, :] & (dist <= slot_gate)
    cost = torch.where(feasible, dist, torch.full_like(dist, float("inf")))
    assign, taken = greedy_assignment(cost)

    arange_m = torch.arange(M, device=dev)
    has_meas = assign >= 0
    z_m = torch.gather(z, -1, assign.clamp(min=0))
    delta = _wrap(z_m - theta_pred)
    theta_upd = _wrap(theta_pred + alpha * delta)
    omega_upd = state.omega + beta * delta
    upd = tracking & has_meas
    coast = tracking & ~has_meas
    theta = torch.where(upd, theta_upd, torch.where(coast, theta_pred, state.theta))
    omega = torch.where(upd, omega_upd, state.omega)
    misses = torch.where(upd, 0, torch.where(coast, state.misses + 1, state.misses))
    hits = torch.where(upd, state.hits + 1, state.hits)
    init = state.initialized

    boot = booting & has_meas
    omega = torch.where(boot, _wrap(z_m - state.theta), omega)
    theta = torch.where(boot, z_m, theta)
    hits = torch.where(boot, state.hits + 1, hits)
    misses = torch.where(boot, 0, misses)
    init = torch.where(boot, 2, init)

    die = (booting & ~has_meas) | (coast & (misses > max_misses))
    init = torch.where(die, 0, init)
    hits = torch.where(die, 0, hits)
    misses = torch.where(die, 0, misses)

    for k in range(K):  # leftover measurements claim the first free slot, in order
        free = init == 0
        spawn = valid[..., k] & ~taken[..., k] & free.any(dim=-1)
        sel = spawn[..., None] & (arange_m == torch.argmax(free.to(torch.int32), dim=-1)[..., None])
        theta = torch.where(sel, z[..., k:k + 1], theta)
        omega = torch.where(sel, 0.0, omega)
        misses = torch.where(sel, 0, misses)
        hits = torch.where(sel, 0, hits)
        init = torch.where(sel, 1, init)

    nxt = MultiTrackState(theta=theta.to(torch.float32), omega=omega.to(torch.float32),
                          misses=misses.to(torch.int32), initialized=init.to(torch.int32),
                          hits=hits.to(torch.int32))
    confirmed = (nxt.initialized == 2) & (nxt.hits >= confirm_hits)
    return nxt, (nxt.theta, confirmed)


def track_multi_angles(z_seq, valid_seq, num_tracks: int, alpha: float = 0.35, beta: Optional[float] = None,
                       gate_deg: float = 25.0, max_misses: int = 3, confirm_hits: int = 2, device=None):
    """Track a (T, ..., K) sequence of per-frame peak measurements into
    ``num_tracks`` slots on ``device`` (JAX ``tracking.py:406-437``).
    Returns ``(thetas (T, ..., M), confirmed (T, ..., M))``.  On the CPU
    this is :func:`track_multi_angles_plain`; on the card the hand kernel
    ``csrc/tracking.cu`` (``ops/cuda/track_kernel.track_multi``: one launch
    for all T frames, M and K at most 16, the same outputs bit for bit)."""
    from ..ops.cuda import track_kernel

    z_seq = torch.as_tensor(z_seq, dtype=torch.float32, device=resolve_device(device))
    valid_seq = torch.as_tensor(valid_seq, dtype=torch.bool, device=z_seq.device)
    return track_kernel.track_multi(z_seq, valid_seq, num_tracks, alpha=alpha, beta=beta, gate_deg=gate_deg,
                                    max_misses=max_misses, confirm_hits=confirm_hits)


def track_multi_angles_plain(z_seq, valid_seq, num_tracks: int, alpha: float = 0.35, beta: Optional[float] = None,
                             gate_deg: float = 25.0, max_misses: int = 3, confirm_hits: int = 2, device=None):
    """:func:`track_multi_angles` as a loop of :func:`multi_track_step` over
    the frames: the CPU's route, and the plain version the kernel is held to
    on the card."""
    z_seq = torch.as_tensor(z_seq, dtype=torch.float32, device=resolve_device(device))
    valid_seq = torch.as_tensor(valid_seq, dtype=torch.bool, device=z_seq.device)
    gate = float(np.deg2rad(gate_deg))
    state = multi_track_init(num_tracks, z_seq.shape[1:-1], z_seq.device)
    thetas, confirmed = [], []
    for z, v in zip(z_seq, valid_seq):
        state, (th, cf) = multi_track_step(state, z, v, alpha=alpha, beta=beta, gate_rad=gate,
                                           max_misses=max_misses, confirm_hits=confirm_hits)
        thetas.append(th)
        confirmed.append(cf)
    return torch.stack(thetas), torch.stack(confirmed)


class MultiDoaTracker:
    """Host-side streaming GNN tracker (numpy; the JAX package's
    ``MultiDoaTracker``, ``tracking.py:440-511``): K candidate
    (angle, valid) pairs per frame in, (thetas, confirmed) per slot out."""

    def __init__(self, num_tracks: int, alpha: float = 0.35, beta: Optional[float] = None,
                 gate_deg: float = 25.0, max_misses: int = 3, confirm_hits: int = 2):
        self.M = int(num_tracks)
        self.alpha = float(alpha)
        self.beta = float(_beta(self.alpha, beta))
        self.gate_rad = float(np.deg2rad(gate_deg))
        self.max_misses = int(max_misses)
        self.confirm_hits = int(confirm_hits)
        self.reset()

    def reset(self):
        self.theta = np.zeros(self.M, np.float32)
        self.omega = np.zeros(self.M, np.float32)
        self.misses = np.zeros(self.M, np.int32)
        self.initialized = np.zeros(self.M, np.int32)
        self.hits = np.zeros(self.M, np.int32)

    @staticmethod
    def _wrap(x):
        return np.arctan2(np.sin(x), np.cos(x))

    def update(self, z, valid=None):
        z = np.asarray(z, np.float32)
        K = z.shape[0]
        valid = np.ones(K, bool) if valid is None else np.asarray(valid, bool)
        M = self.M
        tracking = self.initialized == 2
        booting = self.initialized == 1
        theta_pred = self._wrap(self.theta + self.omega)

        dist = np.abs(self._wrap(z[None, :] - theta_pred[:, None]))
        slot_gate = np.where(tracking, self.gate_rad, np.pi)[:, None]
        feasible = (tracking | booting)[:, None] & valid[None, :] & (dist <= slot_gate)
        cost = np.where(feasible, dist, np.inf)

        assign = np.full(M, -1, np.int32)
        taken = np.zeros(K, bool)
        for _ in range(min(M, K)):
            flat = int(np.argmin(cost))
            m, k = flat // K, flat % K
            if not np.isfinite(cost[m, k]):
                break
            assign[m] = k
            taken[k] = True
            cost[m, :] = np.inf
            cost[:, k] = np.inf

        has_meas = assign >= 0
        z_m = z[np.clip(assign, 0, None)]
        delta = self._wrap(z_m - theta_pred)
        theta_upd = self._wrap(theta_pred + self.alpha * delta)
        omega_upd = self.omega + self.beta * delta

        upd = tracking & has_meas
        coast = tracking & ~has_meas
        theta = np.where(upd, theta_upd, np.where(coast, theta_pred, self.theta))
        omega = np.where(upd, omega_upd, self.omega)
        misses = np.where(upd, 0, np.where(coast, self.misses + 1, self.misses))
        hits = np.where(upd, self.hits + 1, self.hits)
        init = self.initialized.copy()

        boot = booting & has_meas
        omega = np.where(boot, self._wrap(z_m - self.theta), omega)
        theta = np.where(boot, z_m, theta)
        hits = np.where(boot, self.hits + 1, hits)
        misses = np.where(boot, 0, misses)
        init = np.where(boot, 2, init)

        die = (booting & ~has_meas) | (coast & (misses > self.max_misses))
        init = np.where(die, 0, init)
        hits = np.where(die, 0, hits)
        misses = np.where(die, 0, misses)

        for k in range(K):
            free = init == 0
            if valid[k] and not taken[k] and free.any():
                slot = int(np.argmax(free))
                theta[slot], omega[slot] = z[k], 0.0
                misses[slot], hits[slot], init[slot] = 0, 0, 1

        self.theta = theta.astype(np.float32)
        self.omega = omega.astype(np.float32)
        self.misses = misses.astype(np.int32)
        self.hits = hits.astype(np.int32)
        self.initialized = init.astype(np.int32)
        confirmed = (init == 2) & (hits >= self.confirm_hits)
        return self.theta.copy(), confirmed
