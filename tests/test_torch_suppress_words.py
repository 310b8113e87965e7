"""The word algorithm of the suppression kernels K1, K2 and K7
(``haghighatshoarmuir2024_tpu_torch/csrc/suppress.cu``), emulated on the CPU
and held bit-exact against the plain versions in ``ops/peaks.py``.

A CUDA kernel cannot run without a card, so this file keeps a small Python
model of exactly what a block does per row: every flag a bit, 32 consecutive
samples to a 32-bit word; the rise and fall words of a tile and the extrema
from them (two boundaries side by side by a shift and an and, a plateau by a
find-first-set over at most 2W - 1 bits, its midpoint ``(j + 1 + k) >> 1``);
pass 1 of a round over the set bits of a candidate word, heights read only
at set bits inside ``[t - w, t + w]`` and only for candidates that have
another candidate there; passes 2 and 3 on the window-max and winner words,
by log-step smears of a word and its neighbour as one 64-bit string where
the window is at most a word (1 <= w <= 32), by range tests per set bit
otherwise; tiles of ``TB`` samples with the wrapper's halo
``_margin`` on both sides, rounded up to whole words on the right; the
centre's bits written out, kept or-ed in place, one flag per tile.  The
model lives here and on no path of the package.

Compared with ``ops.peaks.local_extrema_mask_bounded``, ``suppression_round``
and ``select_by_distance``: random cumsums, exact ties (rightmost wins),
dense chains, plateaus longer and shorter than W, candidates in the first
and last w samples, windows across a word and a tile boundary, w at and
beyond the word length, T = 1, and a ``hypothesis`` case over
(T, w, W, density).  Tolerance: none, every mask bit-exact.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from haghighatshoarmuir2024_tpu_torch.ops import peaks  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.ops.cuda import suppress_kernel as sk  # noqa: E402

FULL = 0xFFFFFFFF


# ------------------------------------------------------------ the word model
def ffs(word: int) -> int:
    """Index of the lowest set bit (CUDA's ``__ffs`` less one)."""
    return (word & -word).bit_length() - 1


def set_bits(word: int):
    while word:
        yield ffs(word)
        word &= word - 1


def range_mask(wj: int, lo: int, hi: int) -> int:
    """Bits of word ``wj`` that lie in the sample range [lo, hi]."""
    m = FULL
    if wj == lo >> 5:
        m &= (FULL << (lo & 31)) & FULL
    if wj == hi >> 5:
        m &= FULL >> (31 - (hi & 31))
    return m


def any_in(plane, tbe: int, lo: int, hi: int) -> bool:
    lo, hi = max(lo, 0), min(hi, tbe - 1)
    if lo > hi:
        return False
    return any(plane[wj] & range_mask(wj, lo, hi) for wj in range(lo >> 5, (hi >> 5) + 1))


MASK64 = (1 << 64) - 1


def smear_up(x: int, n: int) -> int:
    """Every set bit of the 64-bit string smeared over the n places above it."""
    reach = 0
    while reach < n:
        step = min(reach + 1, n - reach)
        x = (x | (x << step)) & MASK64
        reach += step
    return x


def smear_down(x: int, n: int) -> int:
    reach = 0
    while reach < n:
        step = min(reach + 1, n - reach)
        x |= x >> step
        reach += step
    return x


def narrow(w: int) -> bool:
    """Whether a window of w samples either side is done by smears."""
    return 1 <= w <= 32


def around(plane, wi: int):
    """(below, above): words (wi - 1, wi) and (wi, wi + 1) as 64-bit strings;
    words off the tile are 0."""
    lo = plane[wi - 1] if wi else 0
    hi = plane[wi + 1] if wi + 1 < len(plane) else 0
    return (plane[wi] << 32) | lo, (hi << 32) | plane[wi]


def others_within(plane, wi: int, w: int) -> int:
    below, above = around(plane, wi)
    return (smear_up((below << 1) & MASK64, w - 1) >> 32) | (smear_down(above >> 1, w - 1) & FULL)


def window_maxima(h, act, wi: int, w: int, sign: float, tbe: int) -> int:
    """Pass 1 for one word: the candidates that no other candidate within w
    exceeds; heights are read at set bits only, a neighbour's only for a
    candidate that has one."""
    crowded = others_within(act, wi, w) if narrow(w) else FULL
    top = 0
    for i in set_bits(act[wi]):
        t = wi * 32 + i
        ht = np.float32(sign) * h[t]
        is_top = bool(np.isfinite(ht))
        if (crowded >> i) & 1:
            lo, hi = max(t - w, 0), min(t + w, tbe - 1)
            for wj in range(lo >> 5, (hi >> 5) + 1):
                if not is_top:
                    break
                m = act[wj] & range_mask(wj, lo, hi)
                if wj == wi:
                    m &= ~(1 << i)
                for j in set_bits(m):
                    if np.float32(sign) * h[wj * 32 + j] > ht:
                        is_top = False
                        break
        if is_top:
            top |= 1 << i
    return top


def winners(top, wi: int, w: int, tbe: int) -> int:
    """Pass 2: window-maxima with no window-max to the right within w."""
    if narrow(w):
        above = around(top, wi)[1]
        return top[wi] & ~smear_down(above >> 1, w - 1) & FULL
    return sum(1 << i for i in set_bits(top[wi]) if not any_in(top, tbe, wi * 32 + i + 1, wi * 32 + i + w))


def survivors(act, win, wi: int, w: int, tbe: int) -> int:
    """Pass 3: candidates with no winner within w."""
    if narrow(w):
        below, above = around(win, wi)
        return act[wi] & ~((smear_up(below, w) >> 32) | smear_down(above, w)) & FULL
    return sum(1 << i for i in set_bits(act[wi]) if not any_in(win, tbe, wi * 32 + i - w, wi * 32 + i + w))


def round_words(h, acts, w: int, signs, tbe: int):
    """One round on a tile's candidate planes (one list of words per
    polarity): returns (survivors, winners) per polarity."""
    nw = tbe // 32
    out = []
    for act, sign in zip(acts, signs):
        top = [window_maxima(h, act, wi, w, sign, tbe) for wi in range(nw)]
        win = [winners(top, wi, w, tbe) for wi in range(nw)]
        out.append(([survivors(act, win, wi, w, tbe) for wi in range(nw)], win))
    return out


def stage(x_row, T: int, base: int, tbe: int):
    """The tile's samples, 0 outside [0, T)."""
    h = np.zeros(tbe + 1, np.float32)
    lo, hi = max(base, 0), min(base + tbe + 1, T)
    if lo < hi:
        h[lo - base:hi - base] = x_row[lo:hi]
    return h


def extrema_words(h, T: int, base: int, tbe: int, W: int):
    """K1's rise and fall words and the extrema planes (maxima, minima) of a
    tile from them."""
    nw = tbe // 32
    rise, fall = [0] * nw, [0] * nw
    for t in range(tbe):
        g = base + t
        if 0 <= g < T - 1 and t + 1 < tbe:
            d = h[t + 1] - h[t]
            rise[t >> 5] |= int(d > 0) << (t & 31)
            fall[t >> 5] |= int(d < 0) << (t & 31)
    act = [[0] * nw, [0] * nw]
    for wi in range(nw):
        bnd = rise[wi] | fall[wi]
        prev_rise = rise[wi - 1] >> 31 if wi else 0
        prev_fall = fall[wi - 1] >> 31 if wi else 0
        next_bnd = (rise[wi + 1] | fall[wi + 1]) & 1 if wi + 1 < nw else 0
        act[0][wi] |= (((rise[wi] << 1) & FULL) | prev_rise) & fall[wi]
        act[1][wi] |= (((fall[wi] << 1) & FULL) | prev_fall) & rise[wi]
        for i in set_bits(bnd & ~((bnd >> 1) | (next_bnd << 31)) & FULL):
            j = wi * 32 + i
            lo, hi = j + 1, min(j + 2 * W - 1, tbe - 1)
            k = -1
            for wj in range(lo >> 5, (hi >> 5) + 1):
                if lo > hi or k >= 0:
                    break
                m = (rise[wj] | fall[wj]) & range_mask(wj, lo, hi)
                if m:
                    k = wj * 32 + ffs(m)
            if k < 0:
                continue
            j_rises, k_rises = (rise[wi] >> i) & 1, (rise[k >> 5] >> (k & 31)) & 1
            if j_rises == k_rises:
                continue
            mid = (j + 1 + k) >> 1
            act[0 if j_rises else 1][mid >> 5] |= 1 << (mid & 31)
    return act


def tiles(T: int, tb: int, M: int):
    """(global time of the centre, global time of local 0, samples staged)."""
    tbe = 32 * ((tb + 2 * M + 31) // 32)
    return [(g0, g0 - M, tbe) for g0 in range(0, T, tb)]


def words_of(mask_row, T: int, base: int, tbe: int):
    words = [0] * (tbe // 32)
    for t in range(tbe):
        if 0 <= base + t < T and mask_row[base + t]:
            words[t >> 5] |= 1 << (t & 31)
    return words


def write_centre(out_row, words, g0: int, M: int, tb: int, T: int, only_set=False):
    for c in range(min(tb, T - g0)):
        bit = (words[(M + c) >> 5] >> ((M + c) & 31)) & 1
        if bit or not only_set:
            out_row[g0 + c] = bit


def model_k1(cs, w: int, W: int, tb: int):
    """K1 on (rows, T) ``cs``: (act_p, act_n, kept_p, kept_n) after the
    extrema and round 1."""
    rows, T = cs.shape
    M = sk._margin(w, W)
    outs = [np.zeros((rows, T), bool) for _ in range(4)]
    for r in range(rows):
        for g0, base, tbe in tiles(T, tb, M):
            h = stage(cs[r], T, base, tbe)
            acts = extrema_words(h, T, base, tbe, W)
            (ap, kp), (an, kn) = round_words(h, acts, w, (1.0, -1.0), tbe)
            for out, words in zip(outs, (ap, an, kp, kn)):
                write_centre(out[r], words, g0, M, tb, T)
    return outs


def model_round(h, acts, kepts, w: int, signs, tb: int):
    """One K2/K7 launch: new candidate masks, kept or-ed in place, whether
    any tile's flag is up."""
    rows, T = h.shape
    M = sk._margin(w)
    new = [np.zeros((rows, T), bool) for _ in acts]
    flag = False
    for r in range(rows):
        for g0, base, tbe in tiles(T, tb, M):
            planes = [words_of(a[r], T, base, tbe) for a in acts]
            if not any(any(p) for p in planes):
                continue  # the early exit: nothing can reach this tile
            hs = stage(h[r], T, base, tbe)
            for pol, (keep, win) in enumerate(round_words(hs, planes, w, signs, tbe)):
                write_centre(new[pol][r], keep, g0, M, tb, T)
                write_centre(kepts[pol][r], win, g0, M, tb, T, only_set=True)
                flag |= bool(new[pol][r, g0:g0 + tb].any())
    return new, flag


def model_select(cand, h, d, tb: int, signs=(1.0,)):
    """The fixed point of rounds from given candidates, one plane per sign."""
    w = int(math.ceil(d)) - 1
    acts = [c.copy() for c in cand]
    kepts = [np.zeros_like(c) for c in cand]
    for _ in range(h.shape[1] + 1):
        acts, flag = model_round(h, acts, kepts, w, signs, tb)
        if not flag:
            return kepts
    raise AssertionError("no fixed point")


# ------------------------------------------------------------------ helpers
def plain_select(cand, h, d):
    return peaks.select_by_distance(torch.as_tensor(cand), torch.as_tensor(h), d).numpy()


def walk(seed: int, rows: int, T: int, quantum: float = 0.0):
    x = np.cumsum(np.random.default_rng(seed).standard_normal((rows, T)), axis=-1)
    if quantum:
        x = np.round(x / quantum) * quantum
    return x.astype(np.float32)


def check_k1(cs, d, W, tb):
    w, W = sk._windows(d, W)
    ref = [m.numpy().T for m in sk._k1_plain(torch.as_tensor(np.ascontiguousarray(cs.T)), w, W)]
    for name, got, want in zip(("act_p", "act_n", "kept_p", "kept_n"), model_k1(cs, w, W, tb), ref):
        np.testing.assert_array_equal(got, want, err_msg=name)


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("wj,lo,hi,want", [
    (0, 0, 31, FULL), (0, 3, 5, 0b111000), (1, 40, 100, (FULL << 8) & FULL), (3, 40, 100, 0b11111),
    (2, 40, 100, FULL), (0, 31, 32, 1 << 31), (1, 31, 32, 1),
])
def test_range_mask(wj, lo, hi, want):
    assert range_mask(wj, lo, hi) == want


@pytest.mark.parametrize("n", [0, 1, 2, 3, 10, 11, 16, 31, 32])
def test_smears_cover_exactly_n_places(n):
    x = (1 << 40) | (1 << 3)
    up = sum(1 << (b + k) for b in (40, 3) for k in range(n + 1)) & MASK64
    down = sum(1 << (b - k) for b in (40, 3) for k in range(n + 1) if b - k >= 0)
    assert smear_up(x, n) == up and smear_down(x, n) == down


@pytest.mark.parametrize("rows,T,d,W,tb", [
    (3, 500, 12, 24, 512),   # the flagship's windows, one tile
    (2, 700, 12, 24, 64),    # many tiles, tile ends on word ends
    (2, 333, 7, 14, 96),     # tile ends mid-word (margins of 40: centre starts at bit 8)
    (2, 300, 3, 6, 160),
    (4, 1, 12, 24, 512),     # T = 1
    (3, 31, 12, 24, 32),     # T shorter than a word
    (2, 257, 2, 1, 64),      # w = 1, W = 1
    (2, 400, 32, 24, 128),   # w = 31, 32, 33: the last windows done by smears, the first by range tests
    (2, 400, 33, 24, 128),
    (2, 400, 34, 24, 128),
    (2, 300, 1, 3, 64),      # w = 0: every finite candidate wins
    (2, 400, 40, 24, 128),   # w beyond the word length
    (1, 500, 80, 24, 512),   # w beyond two words
])
def test_k1_words_random_cumsum(rows, T, d, W, tb):
    cs = walk(rows * T + d, rows, T)
    if T > 110:
        cs[:, 40:44] = cs[:, 40:41]    # short plateaus
        cs[:, 100:103] = cs[:, 100:101]
        cs[0, 60:93] = cs[0, 60]       # a plateau over a whole word
    check_k1(cs, d, W, tb)


@pytest.mark.parametrize("quantum,d,W,tb", [
    (0.5, 3, 6, 128), (0.5, 12, 24, 256), (0.5, 24, 48, 512), (0.5, 5, 2, 64),
    (6.0, 12, 24, 64),    # plateaus longer than W: the bound decides
    (6.0, 12, 100, 512),  # the same plateaus inside the bound, across words
    (6.0, 40, 70, 96),
])
def test_k1_words_plateaus(quantum, d, W, tb):
    check_k1(walk(int(quantum * 10) + d, 2, 600, quantum), d, W, tb)


@pytest.mark.parametrize("kind", ["flat", "monotone", "sawtooth"])
def test_k1_words_degenerate(kind):
    t = np.arange(300, dtype=np.float32)
    cs = {"flat": np.zeros(300, np.float32), "monotone": t, "sawtooth": (t % 2)}[kind][None, :].repeat(2, 0)
    check_k1(np.ascontiguousarray(cs), 12, 24, 64)
    check_k1(np.ascontiguousarray(cs), 3, 6, 96)


@pytest.mark.parametrize("rows,T,d,W,tb", [(2, 300, 12, 24, 64), (2, 200, 7, 14, 96), (1, 400, 40, 24, 128)])
def test_k1_then_rounds_reach_select_by_distance(rows, T, d, W, tb):
    """K1's masks carried through the K2 rounds give the wrapper's answer."""
    cs = walk(T + d, rows, T, 0.25)
    w, W = sk._windows(d, W)
    ap, an, kp, kn = model_k1(cs, w, W, tb)
    acts, kepts = [ap, an], [kp, kn]
    for _ in range(T + 1):
        acts, flag = model_round(cs, acts, kepts, w, (1.0, -1.0), tb)
        if not flag:
            break
    ref = sk.rzcc_encode_bipolar_tm_plain(torch.as_tensor(np.ascontiguousarray(cs.T)), d, W)
    np.testing.assert_array_equal(kepts[0], ref[0].numpy().T)
    np.testing.assert_array_equal(kepts[1], ref[1].numpy().T)


@pytest.mark.parametrize("d,tb", [(6, 32), (11, 32), (40, 32), (6, 512), (11, 512), (40, 512), (80, 64)])
def test_round_words_exact_ties_rightmost_wins(d, tb):
    h = np.zeros((1, 64), np.float32)
    cand = np.zeros((1, 64), bool)
    h[0, [10, 15, 40, 45, 50]] = 1.0
    cand[0, [10, 15, 40, 45, 50]] = True
    np.testing.assert_array_equal(model_select([cand], h, d, tb)[0], plain_select(cand, h, d))


@pytest.mark.parametrize("d,tb", [(12, 64), (40, 96)])
def test_round_words_all_ties(d, tb):
    h = np.zeros((2, 200), np.float32)
    cand = np.ones((2, 200), bool)
    np.testing.assert_array_equal(model_select([cand], h, d, tb)[0], plain_select(cand, h, d))


@pytest.mark.parametrize("T,d,tb", [(257, 2, 64), (257, 5, 64), (257, 11, 64), (257, 40, 64), (600, 11, 128),
                                    (600, 40, 128), (400, 80, 96)])
def test_round_words_dense_chains(T, d, tb):
    h = np.random.default_rng(T + d).standard_normal((2, T)).astype(np.float32)
    cand = np.ones_like(h, bool)
    cand[1, ::3] = False
    np.testing.assert_array_equal(model_select([cand], h, d, tb)[0], plain_select(cand, h, d))


@pytest.mark.parametrize("d", [1.5, 3, 7, 12, 32, 33, 34, 65])
def test_round_words_candidates_at_both_ends(d):
    """Candidates at t = 0 and T - 1 and within w of both ends, T not a
    multiple of the word."""
    x = walk(int(d * 2), 3, 203)
    cand = peaks.local_maxima_mask(torch.as_tensor(x)).numpy()
    cand[:, [0, 1, 5, -6, -2, -1]] = True
    np.testing.assert_array_equal(model_select([cand], x, d, 64)[0], plain_select(cand, x, d))


@pytest.mark.parametrize("gap,d,tb", [(5, 12, 32), (11, 12, 32), (12, 12, 32), (31, 33, 64), (32, 33, 64),
                                      (33, 33, 64), (31, 40, 64), (39, 40, 64), (40, 40, 64), (79, 80, 64),
                                      (80, 80, 64)])
def test_round_words_window_across_word_and_tile_boundary(gap, d, tb):
    """Two candidates ``gap`` apart on either side of every word and tile
    boundary: the lower goes exactly when gap < d."""
    T = 4 * tb + 130
    for edge in range(32, T - gap, 32):
        h = np.zeros((2, T), np.float32)
        cand = np.zeros((2, T), bool)
        a, b = edge - gap // 2 - 1, edge - gap // 2 - 1 + gap
        if a < 0 or b >= T:
            continue
        cand[:, [a, b]] = True
        h[0, a], h[0, b] = 2.0, 1.0
        h[1, a], h[1, b] = 1.0, 2.0
        got = model_select([cand], h, d, tb)[0]
        np.testing.assert_array_equal(got, plain_select(cand, h, d), err_msg=f"edge {edge}")
        assert got[0, b] == (gap >= d) and got[1, a] == (gap >= d)


@pytest.mark.parametrize("d,tb", [(3, 64), (12, 64), (40, 128)])
def test_round_words_one_launch_is_one_plain_round(d, tb):
    """A single K2 launch (both polarities, heights ±cs) against one plain
    round: survivors, kept in place, and the flag."""
    cs = walk(d, 3, 300)
    w = d - 1
    maxima, minima = (m.numpy() for m in peaks.local_extrema_mask_bounded(torch.as_tensor(cs), 24))
    kepts = [np.zeros_like(maxima), np.zeros_like(minima)]
    kepts[0][:, 7] = True  # kept bits from an earlier round stay
    (ap, an), flag = model_round(cs, [maxima, minima], kepts, w, (1.0, -1.0), tb)
    t = torch.as_tensor
    ref_kept = np.zeros_like(maxima)
    ref_kept[:, 7] = True
    rap, rkp = peaks.suppression_round(t(maxima), t(ref_kept), t(cs), w)
    ran, rkn = peaks.suppression_round(t(minima), t(np.zeros_like(minima)), t(-cs), w)
    for got, want in ((ap, rap), (an, ran), (kepts[0], rkp), (kepts[1], rkn)):
        np.testing.assert_array_equal(got, want.numpy())
    assert flag == bool(rap.any() or ran.any())


def test_round_words_empty_tiles_exit_early():
    h = walk(3, 2, 500)
    cand = np.zeros((2, 500), bool)
    cand[0, 470] = True  # one candidate: only the tiles whose halo holds it do a round
    kept = model_select([cand], h, 12, 64)[0]
    np.testing.assert_array_equal(kept, cand)
    assert not model_round(h, [np.zeros_like(cand)], [np.zeros_like(cand)], 11, (1.0,), 64)[1]


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(T=st.integers(1, 260), w=st.integers(1, 70), W=st.integers(1, 40), density=st.floats(0.02, 1.0),
       tb=st.sampled_from([32, 64, 96, 512]), seed=st.integers(0, 2**16))
def test_words_hypothesis(T, w, W, density, tb, seed):
    """Random (T, w, W, density): a quantized walk through the K1 model, and
    random candidates with tied heights through the fixed point of rounds."""
    rng = np.random.default_rng(seed)
    cs = (np.round(np.cumsum(rng.standard_normal((1, T))) * 2) / 2).astype(np.float32).reshape(1, T)
    check_k1(cs, w + 1, W, tb)
    h = rng.integers(0, 6, size=(1, T)).astype(np.float32)
    cand = rng.random((1, T)) < density
    np.testing.assert_array_equal(model_select([cand], h, w + 1, tb)[0], plain_select(cand, h, w + 1))
