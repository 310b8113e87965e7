"""A numpy model of kernels K5/K6's body (``csrc/lif_raster.cu``,
``lif_raster_body``) on the CPU, held against the plain simulator
(``project_input`` + ``sim_hidden`` behind ``lif_count_stateful_plain``).

The model walks what the CUDA source does, thread by thread of a warp: the
raster pack pass's (B, Tp, Cpad) int8 rows read as 32-bit words, the
weights as ``weight_fragments`` lays them out, ``mma.sync.m16n8k16``
(int8, or uint8 weights for the lower byte planes) by its fragment layouts
(lane ``4g + q`` holds A's bytes ``[g][4q..4q+3]`` and ``[g+8][4q..4q+3]``,
B's ``[4q..4q+3][g]`` and D's ``[g][2q..2q+1]``, ``[g+8][2q..2q+1]``), the
byte planes summed by Horner's rule in the accumulator, the warp's tile of
(32 neurons, 20 words) in shared memory, the groups of 16 steps with the
ragged last one, and the chain.  All integers: bit-exact.  A wrong lane
mapping, a stale tile word or a padded channel that is not zero shows here
as wrong counts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from haghighatshoarmuir2024_tpu_torch.experiments import roofline
from haghighatshoarmuir2024_tpu_torch.models.xylo import XyloConfig
from haghighatshoarmuir2024_tpu_torch.ops.cuda import lif_kernel as lk

GROUP, TILE_S = 16, 20  # csrc/lif_raster.cu: steps a fill, words a tile row
STATE_MIN, STATE_MAX = -(1 << 15), (1 << 15) - 1
LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3


def make_config(seed, C, N=40, rec=0, w_scale=20):
    r = np.random.default_rng(seed)
    return XyloConfig(
        w_in=r.integers(-w_scale, w_scale + 1, size=(C, N)).astype(np.int32),
        w_rec=np.full((N, N), rec, np.int32), w_out=np.ones((N, 1), np.int32),
        dash_syn=r.integers(1, 7, size=N).astype(np.int32), dash_mem=r.integers(1, 7, size=N).astype(np.int32),
        dash_syn_out=np.ones(1, np.int32), dash_mem_out=np.ones(1, np.int32),
        threshold=r.integers(30, 200, size=N).astype(np.int32), threshold_out=np.ones(1, np.int32),
        dt=1e-3, weight_scale=1.0)


def make_raster(seed, T, B, C, p, lo=-128, hi=128):
    r = np.random.default_rng(seed + 3000)
    return np.where(r.random((T, B, C)) < p, r.integers(lo, hi, size=(T, B, C)), 0).astype(np.int8)


def word_bytes(words, signed):
    """(32,) fragment words -> (32, 4) byte values, from the low byte."""
    b = (words.astype(np.uint32)[:, None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF
    return np.where(signed & (b >= 128), b.astype(np.int64) - 256, b.astype(np.int64))


def mma_m16n8k16(d, w0, w1, x, w_signed):
    """``d += A @ B`` by the fragment layouts of ``mma.m16n8k16``; ``d`` (32, 4)
    int64 holding wrapped int32 values, one row a lane."""
    A = np.zeros((16, 16), np.int64)
    Bm = np.zeros((16, 8), np.int64)
    A[G[:, None], 4 * Q[:, None] + np.arange(4)] = word_bytes(w0, w_signed)
    A[G[:, None] + 8, 4 * Q[:, None] + np.arange(4)] = word_bytes(w1, w_signed)
    Bm[4 * Q[:, None] + np.arange(4), G[:, None]] = word_bytes(x, True)
    D = A @ Bm
    out = d + np.stack([D[G, 2 * Q], D[G, 2 * Q + 1], D[G + 8, 2 * Q], D[G + 8, 2 * Q + 1]], axis=1)
    return ((out + 2**31) % 2**32) - 2**31  # int32 wrap


def model_counts(cfg, spikes_tbc, state=None, clip=True):
    """K5 (``state`` None) / K6 as the CUDA body computes them."""
    T, B, C = spikes_tbc.shape
    w_in = np.asarray(cfg.w_in)
    N = w_in.shape[1]
    rec = int(np.asarray(cfg.w_rec).flat[0])
    frag = lk.weight_fragments(w_in).view(np.uint32)  # (NW, P, KT, 4, 32)
    NW, P, KT = frag.shape[:3]
    packed = lk.pack_raster_plain(torch.as_tensor(spikes_tbc)).numpy()
    Tp = packed.shape[1]
    assert packed.shape == (B, Tp, 16 * KT) and Tp % 32 == 0
    words = np.ascontiguousarray(packed).view("<u4")  # (B, Tp, 4 KT)
    ds = np.zeros(NW * 32, np.int64)
    dm, th = ds.copy(), ds.copy()
    ds[:N], dm[:N], th[:N] = cfg.dash_syn, cfg.dash_mem, cfg.threshold
    live = np.arange(NW * 32) < N
    out = np.zeros((4, B, NW * 32), np.int64)
    for b in range(B):
        isyn, vmem, spk, cnt = (np.zeros(NW * 32, np.int64) for _ in range(4))
        if state is not None:
            isyn[:N], vmem[:N], spk[:N] = (np.asarray(s)[b] for s in state)
        tiles = np.full((NW, 32 * TILE_S), 0x5A5A5A5A, np.int64)  # stale words, not zeros
        for t0 in range(0, T, GROUP):
            cur = np.zeros((NW * 32, GROUP), np.int64)
            for w in range(NW):
                ts = min(t0, Tp - GROUP)
                x = [[words[b, ts + 8 * s + G, 4 * kt + Q] for s in range(2)] for kt in range(KT)]
                for m in range(2):
                    d = [np.zeros((32, 4), np.int64) for _ in range(2)]
                    for p in range(P - 1, -1, -1):
                        top = p == P - 1
                        for kt in range(KT):
                            w0, w1 = frag[w, p, kt, 2 * m], frag[w, p, kt, 2 * m + 1]
                            for s in range(2):
                                if not top and kt == 0:
                                    d[s] = (((d[s] << 8) + 2**31) % 2**32) - 2**31
                                d[s] = mma_m16n8k16(d[s], w0, w1, x[kt][s], top)
                    at = (16 * m + G) * TILE_S + 2 * Q
                    for s in range(2):
                        tiles[w, at + 8 * s], tiles[w, at + 8 * s + 1] = d[s][:, 0], d[s][:, 1]
                        tiles[w, at + 8 * TILE_S + 8 * s], tiles[w, at + 8 * TILE_S + 8 * s + 1] = d[s][:, 2], d[s][:, 3]
                cur[32 * w:32 * w + 32] = tiles[w, LANE[:, None] * TILE_S + np.arange(GROUP)]
            for j in range(min(GROUP, T - t0)):
                c = cur[:, j] + rec * int(spk[live].sum())
                isyn = isyn - (isyn >> ds) + c
                if clip:
                    isyn = np.clip(isyn, STATE_MIN, STATE_MAX)
                vmem = vmem - (vmem >> dm) + isyn
                if clip:
                    vmem = np.clip(vmem, STATE_MIN, STATE_MAX)
                fired = live & (vmem >= th)
                vmem = vmem - fired * th
                cnt += fired
                spk = fired.astype(np.int64)
        out[:, b] = cnt, isyn, vmem, spk
    return out[:, :, :N]


def plain(cfg, spikes_tbc, state=None):
    st = (None, None, None) if state is None else tuple(torch.as_tensor(np.asarray(s)) for s in state)
    return [a.numpy() for a in lk.lif_count_stateful_plain(cfg, torch.as_tensor(spikes_tbc), *st)]


@pytest.mark.parametrize("T", [1, 15, 16, 17, 777])
@pytest.mark.parametrize("C", [1, 14, 31, 32, 33, 64, 65, 128])
def test_torch_k5_body_model_matches_plain(C, T):
    """k-tile edges (zero padding past C), the groups of 16 steps and the
    ragged last one, any int8 values (−128 and 127 among them)."""
    cfg = make_config(1000 * C + T, C, N=40, w_scale=20 if C < 40 else 6)
    p = 0.3 if C < 40 else 0.1
    spikes = make_raster(C + T, T, 2, C, p)
    spikes[0, 0, 0], spikes[-1, -1, -1] = -128, 127
    ref = plain(cfg, spikes)
    got = model_counts(cfg, spikes)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[3], ref[3])  # whether the step at T fired: K6 stores state at exactly T


# (label, |w| set into the config, byte planes the route takes)
ROUTES = [("127", 127, 1), ("-128", -128, 1), ("128", 128, 2), ("32767", 32767, 2), ("-32768", -32768, 2),
          ("32768", 32768, 3), ("-8388609", -8_388_609, 4), ("100000000", 100_000_000, 4)]


@pytest.mark.parametrize("label,w,planes", ROUTES, ids=[r[0] for r in ROUTES])
def test_torch_k5_body_model_weight_routes(label, w, planes):
    """The route switch: one signed int8 plane up to [−128, 127], else the
    fewest byte planes (top signed, lower unsigned) of the same product."""
    cfg = make_config(abs(w) % 1000, 14, N=40)
    r = np.random.default_rng(abs(w))
    cfg.w_in[:] = r.choice([w, -w if w > 0 else -w - 1, 0, 1, -1, w // 3], size=cfg.w_in.shape)
    cfg.w_in[3, 5] = w
    if abs(w) > 40_000:
        cfg.threshold[:] = 30_000
    assert lk.weight_planes(cfg.w_in) == planes
    assert lk.weight_fragments(cfg.w_in).shape == (2, planes, 1, 4, 32)
    spikes = make_raster(abs(w) % 977, 50, 2, 14, 0.4, 0, 2 if abs(w) > 40_000 else 4)
    ref = plain(cfg, spikes)
    got = model_counts(cfg, spikes)
    for g, r_ in zip(got, ref):
        np.testing.assert_array_equal(g, r_)
    assert ref[0].sum() > 0


@pytest.mark.parametrize("C,N,rec,T", [(14, 70, -1, 45), (128, 100, -1, 37), (33, 33, -2, 50), (14, 40, 0, 77)])
def test_torch_k6_body_model_carried_state(C, N, rec, T):
    """K6: the (B, N) state loaded first and stored at exactly T, with and
    without the uniform recurrence (a row's spikes summed every step, dead
    lanes never counted)."""
    cfg = make_config(C + N, C, N=N, rec=rec, w_scale=20 if C < 40 else 6)
    mid = plain(cfg, make_raster(N, 30, 2, C, 0.1, -3, 4))
    spikes = make_raster(C, T, 2, C, 0.1, -3, 4)
    ref = plain(cfg, spikes, mid[1:])
    got = model_counts(cfg, spikes, mid[1:])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert ref[0].sum() > 0


def test_torch_k5_body_model_without_clips_where_proven_dead():
    cfg = make_config(30, 14, N=70, w_scale=3)
    cfg.dash_syn[:], cfg.dash_mem[:], cfg.threshold[:] = 2, 2, 40
    assert lk._no_saturation_possible(cfg, 1, 0)
    spikes = make_raster(30, 100, 3, 14, 0.3, 1, 2)
    np.testing.assert_array_equal(model_counts(cfg, spikes, clip=False)[0], plain(cfg, spikes)[0])


@pytest.mark.parametrize("C", [1, 14, 16, 17, 33, 128])
def test_torch_weight_fragments_hold_every_weight_once(C):
    """Decoding the fragments by the layout the kernel reads gives ``w_in``
    back, zeros past C and N; int16-range weights as two planes."""
    r = np.random.default_rng(C)
    for scale in (127, 20_000):
        w_in = r.integers(-scale, scale + 1, size=(C, 45)).astype(np.int32)
        frag = lk.weight_fragments(w_in).view(np.uint32)
        NW, P, KT = frag.shape[:3]
        assert (NW, P, KT) == (2, 1 if scale == 127 else 2, -(-C // 16))
        back = np.zeros((16 * KT, 32 * NW), np.int64)
        for p in range(P):
            for i in range(4):
                b = np.stack([word_bytes(frag[w, p, kt, i], p == P - 1) for w in range(NW) for kt in range(KT)])
                b = b.reshape(NW, KT, 32, 4)
                for w in range(NW):
                    for kt in range(KT):
                        back[16 * kt + 4 * Q[:, None] + np.arange(4), 32 * w + 8 * i + G[:, None]] += b[w, kt] << (8 * p)
        np.testing.assert_array_equal(back[:C, :45], w_in)
        assert not back[C:].any() and not back[:, 45:].any()


@pytest.mark.parametrize("T,B,C,dtype", [(1, 1, 1, np.int8), (33, 3, 14, np.int8), (64, 9, 16, np.int8),
                                         (50, 2, 17, bool), (40, 2, 128, np.int8)])
def test_torch_pack_raster_plain_matches_numpy(T, B, C, dtype):
    """The raster pack pass's plain version: (T, B, C) -> (B, Tp, Cpad),
    Tp a multiple of 32 and Cpad of 16, zeros past T and C; bool is 0/1."""
    v = make_raster(T + C, T, B, C, 0.4)
    v = (v != 0) if dtype is bool else v
    got = lk.pack_raster(torch.as_tensor(v))  # a CPU tensor: the plain version
    Tp, Cp = -(-T // 32) * 32, -(-C // 16) * 16
    want = np.zeros((B, Tp, Cp), np.int8)
    want[:, :T, :C] = np.transpose(v.astype(np.int8), (1, 0, 2))
    assert got.dtype == torch.int8 and tuple(got.shape) == (B, Tp, Cp)
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_raster_pack_work_and_fill_bound():
    """The harness's counts for the raster pack pass and the tensor-core
    fill at the unipolar flagship's shapes."""
    ops, nbytes = roofline.pack_raster_work(12_000, 96, 14)
    assert nbytes == 12_000 * 96 * (14 + 16) and ops == 12_000 * 96 * 4
    assert roofline.bound(ops, 31e12, nbytes)[1] == "bytes"
    assert roofline.raster_fill_ms(12_000, 96, 14, 449) == pytest.approx(2 * 96 * 12_000 * 449 * 16 / 1.979e15 * 1e3)
    assert roofline.UNIT["lif_pack_raster"] == "int32"


def test_torch_k5_bool_and_int8_rasters_give_identical_counts():
    """The wrappers take bool masks as they are: the entry points pass them
    uncast."""
    cfg = make_config(77, 14, N=50)
    spikes = make_raster(77, 120, 3, 14, 0.2, 1, 2)
    as_bool, as_int8 = torch.as_tensor(spikes != 0), torch.as_tensor(spikes)
    np.testing.assert_array_equal(lk.lif_count_rates(cfg, as_bool, time_major=True).numpy(),
                                  lk.lif_count_rates(cfg, as_int8, time_major=True).numpy())
    z = [torch.zeros((3, 50), dtype=torch.int32)] * 3
    for a, b in zip(lk.lif_count_stateful(cfg, as_bool, *z, time_major=True),
                    lk.lif_count_stateful(cfg, as_int8, *z, time_major=True)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(model_counts(cfg, spikes != 0)[0], plain(cfg, spikes)[0])
