"""The two scan kernels on the card, ``iir_scan`` (``csrc/iir_scan.cu``) and
``xylo_sim`` (``csrc/xylo_sim.cu``), against their plain loops with
``torch.equal`` at the shapes of the paths that run them:

  * the IIR scan at the Hilbert apply's (T, B, 7) complex64 analytic signal
    of 1 and 96 frames, MUSIC's order-1 band over a (96, T, 7) batch along
    dim 1, the SNN beamformer's 14 real columns, and a streaming-fallback
    chunk with its state carried over two chunks; each within twice JAX's
    error from scipy's float64 ``lfilter``;
  * the simulator on the flagship's rasters of bench.py's 96 frames, in the
    four step conventions with the flagship's uniform ``w_rec`` and the
    dense push-to-hidden block, a uniform ``w_rec`` of -1, two carried
    halves, and wider layers (N = 700, 1347, 4096);
  * the redesign's edges (``chip_smoke.IIR_EDGES``, ``SIM_EDGES``): the
    scan at N = 0-8, T below and across its 64-step tiles, one lane, lanes
    no multiple of 32, complex lanes, 16-byte rows, MUSIC's strided view
    and a carried zi; the simulator's flat grid with a partial last block,
    B = 1 (B·N·4 no whole line), N = 4096, records on and off, all four
    conventions, uniform and dense ``w_rec``, two halves carried;
  * the simulator's recurrent rows: the dense push-to-hidden block
    in the four conventions, also through the on-chip kernel at 1, 2 and 4
    CTAs a row (``chip_smoke.ONCHIP_CLUSTERS``), the uniform ``w_rec =
    -1``, and the edges in ``SIM_EDGES`` (each width at its boundaries and
    on the cluster sizes its N plans, N = 1000 in int8 on eight CTAs, N no
    multiple of S·c with B = 1, ``spk0`` above 1, a spiking neuron whose row
    is zero, two halves carried, the global-memory row kernel at N = 700 in
    int32 and N = 4096), each launching the kernel its plan names; the
    cluster barrier's probe;
  * the routes: ``iir_filter(method="scan")`` and ``XyloSim`` launch their
    kernels (the dense block's hidden layer the on-chip kernel, an N = 4096
    dense layer the global-memory row kernel), the plain twins of K3-K6 launch none,
    and an unsupported dtype, a cluster that does not fit or a plan the
    library does not hold raises on the card;
  * the wrappers' mirrors of the kernels' constants equal the library's,
    and ``hm_iir_scan`` refuses 16-byte copies off an aligned flat layout.

The cases are ``experiments/scan_kernels.py``'s and ``chip_smoke.py`` phase
28's, so every run of that script makes them too.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.cuda
B = 96
IIR_CASES = ("hilbert 1 frame", f"hilbert {B} frames", f"music {B} frames", "snn 14 columns")
STREAM_CASE = f"stream {B} x 14, two chunks"
CONVENTIONS = [(o, r) for o in ("decay_first", "integrate_first") for r in ("subtract", "zero")]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("tests_gpu needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def iir_inputs():
    _card()
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    return scan_kernels.iir_inputs(B)


@pytest.fixture(scope="module")
def flagship_rasters():
    """The flagship demo, its (T, 96, 28) rasters of bench.py's frames and
    the dense push-to-hidden block config."""
    dev = _card()
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels
    from haghighatshoarmuir2024_tpu_torch.models.xylo import Demo, DemoPushToHidden
    from haghighatshoarmuir2024_tpu_torch.models.xylo.flagship import flagship_config, flagship_frames

    demo = Demo(**flagship_config(dev))
    frames, _ = flagship_frames(demo, B, seed=cs.SEED)
    spk = demo.spike_encoding(frames).transpose(0, 1).contiguous()
    _, block = scan_kernels.push_to_hidden_block(DemoPushToHidden(**flagship_config(dev)))
    return demo, spk, block


@pytest.mark.parametrize("case", IIR_CASES)
def test_iir_scan_against_plain(iir_inputs, case):
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    b, a, x, axis, _ = iir_inputs[case]
    r = scan_kernels.iir_against_plain(b, a, x.to(_card()), axis)
    assert r["equal"] and r["launches"] == 1, r
    assert r["rel64"] <= 2 * cs.JAX_SCAN_REL64[case] + 1e-6, r


def test_iir_scan_stream_chunks_carried(iir_inputs):
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    b, a, x, _, zi = iir_inputs[STREAM_CASE]
    r = scan_kernels.stream_chunks(b, a, x.to(_card()), zi)
    assert r["chunks_equal"] and r["one_pass_equal"], r
    assert r["rel64"] <= 2 * cs.JAX_SCAN_REL64[STREAM_CASE] + 1e-6, r


@pytest.mark.parametrize("rec", ["uniform", "dense"])
@pytest.mark.parametrize("ordering,reset", CONVENTIONS)
def test_xylo_sim_against_plain(flagship_rasters, ordering, reset, rec):
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    demo, spk, block = flagship_rasters
    cfg = demo.xylo_config if rec == "uniform" else block
    split = (ordering, reset, rec) == ("decay_first", "subtract", "uniform")
    clusters = (None,) + (cs.ONCHIP_CLUSTERS if rec == "dense" else ())
    r = scan_kernels.sim_against_plain(cfg, spk, ordering, reset, split=split, clusters=clusters)
    assert r["equal"] and r["launches"] == 2 and r.get("halves_equal", True) and r["spikes"] > 0, r
    assert all(r[f"launches@{c}"] == 2 and r[f"kernels@{c}"].get("xylo_sim_onchip") == 1 for c in clusters[1:]), r


def test_xylo_sim_uniform_recurrence(flagship_rasters):
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels

    demo, spk, _ = flagship_rasters
    r = scan_kernels.sim_against_plain(cs.with_rec(demo.xylo_config, -1), spk, "decay_first", "subtract")
    assert r["equal"] and r["spikes"] > 0, r
    assert r["kernels"].get("xylo_sim_onchip") == 1, r


@pytest.mark.parametrize("i", range(len(cs.WIDE_SIMS)))
def test_xylo_sim_wide_layers(i):
    from haghighatshoarmuir2024_tpu_torch.experiments import scan_kernels
    from haghighatshoarmuir2024_tpu_torch.models.xylo import XyloConfig

    N, ordering, reset, rec = cs.WIDE_SIMS[i]
    cfg, spikes = cs.wide_sim_config(torch, XyloConfig, N, rec, cs.SEED + i)
    r = scan_kernels.sim_against_plain(cfg, spikes.to(_card()), ordering, reset)
    assert r["equal"] and r["spikes"] > 0, r


@pytest.mark.parametrize("i", range(len(cs.IIR_EDGES)))
def test_iir_scan_edges(i):
    r = cs.iir_edge(torch, _card(), cs.IIR_EDGES[i], cs.SEED + i)
    assert r["equal"] and r["launches"] == 1 and r.get("halves_equal", True), r


@pytest.mark.parametrize("i", range(len(cs.SIM_EDGES)))
def test_xylo_sim_edges(i):
    r = cs.sim_edge(torch, _card(), cs.SIM_EDGES[i], cs.SEED + i)
    assert r["equal"] and r["launches"] == 1 and r.get("halves_equal", True) and r["spikes"] > 0, r
    assert r["kernel_launches"] == 1, r


def test_routes_launch_their_kernels(flagship_rasters):
    """``iir_filter(method="scan")`` and ``XyloSim`` launch their kernels
    (once, and twice: hidden layer and readout); the K3-K6 twin launches
    none; float64 and int64 raise on the card."""
    from haghighatshoarmuir2024_tpu_torch.models.xylo import XyloSim, sim
    from haghighatshoarmuir2024_tpu_torch.ops import iir
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build, lif_kernel

    demo, spk, _ = flagship_rasters
    dev = spk.device
    b, a = iir.butter_bandpass(2, (1600.0, 1900.0), 48_000)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((4000, 7)).astype(np.float32), device=dev)
    _build.launch_counts.clear()
    iir.iir_filter(b, a, x, method="scan")
    XyloSim(demo.xylo_config, device=dev)(spk[:, :4].transpose(0, 1), record=True)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"iir_scan": 1, "xylo_sim": 2}
    _build.launch_counts.clear()
    lif_kernel.lif_count_stateful_plain(demo.xylo_config, spk[:2000, :4].to(torch.int8))
    assert not _build.launch_counts
    block = flagship_rasters[2]
    XyloSim(block, device=dev)(spk[:, :4].transpose(0, 1), record=True)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"xylo_sim_onchip": 1, "xylo_sim": 1}
    _build.launch_counts.clear()
    from haghighatshoarmuir2024_tpu_torch.models.xylo import XyloConfig

    row_cfg, row_spk = cs.wide_sim_config(torch, XyloConfig, 4096, "dense", cs.SEED)
    XyloSim(row_cfg, device=dev)(row_spk[:200].transpose(0, 1).to(dev))
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"xylo_sim_row": 1, "xylo_sim": 1}
    with pytest.raises(TypeError):
        iir.iir_filter(b, a, x.double(), method="scan")
    with pytest.raises(TypeError):
        sim.scan_hidden(torch.zeros((10, 5), dtype=torch.int64, device=dev), 1, 1, 30)


def test_held_w_rec_builds_its_image_once(flagship_rasters):
    """``XyloSim`` holds a dense ``w_rec`` as a ``sim_kernel.DenseRec``:
    its on-chip image is built at the first call on the card and the same
    device tensor serves the next, both calls equal to the plain loop."""
    dev = _card()
    from haghighatshoarmuir2024_tpu_torch.models.xylo import XyloSim
    from haghighatshoarmuir2024_tpu_torch.models.xylo import sim
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import sim_kernel

    _, spk, block = flagship_rasters
    xs = XyloSim(block, device=dev)
    held = xs._w_rec
    assert isinstance(held, sim_kernel.DenseRec)
    x = spk[:3000, :4].transpose(0, 1)
    inp = sim.project_input(block, x.transpose(0, 1))
    want = sim.scan_hidden_plain(inp, block.dash_syn, block.dash_mem, block.threshold, w_rec=block.w_rec)[0]
    for _ in range(2):
        xs.reset_state()
        got = xs(x)[2]["Spikes"].transpose(0, 1)
        assert torch.equal(got, want)
    assert len(held._operands) == 1


def test_onchip_refusals():
    """A forced cluster that cannot hold the matrix raises before any
    launch; ``hm_xylo_sim_onchip`` refuses a plan it does not hold itself
    (threads, image bytes, cluster, a form it is not built in:
    cudaErrorInvalidConfiguration, 9) and a misaligned image
    (cudaErrorMisalignedAddress, 716)."""
    dev = _card()
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build, sim_kernel

    T, B, N = 20, 2, 477
    inp = torch.zeros((T, B, N), dtype=torch.int32, device=dev)
    w = np.ones((N, N), np.int64)
    w[0, 0] = 2
    with pytest.raises(ValueError, match="does not fit"):
        sim_kernel.scan_hidden(inp, 1, 1, 30, w_rec=w * 40_000, cluster=1)
    lib = sim_kernel.checked_library()
    plan = sim_kernel.sim_launch(B, N, "dense", 1)
    image = torch.as_tensor(sim_kernel.onchip_image(w, plan), device=dev)
    per = torch.zeros(N, dtype=torch.int32, device=dev)
    outs = [torch.empty((B, N), dtype=torch.int32, device=dev) for _ in range(3)]
    stream = _build.stream_handle(dev)

    def call(img_ptr, slots=plan.slots, width=plan.width, cluster=plan.cluster, threads=plan.threads,
             nbytes=image.shape[1]):
        return lib.hm_xylo_sim_onchip(inp.data_ptr(), per.data_ptr(), per.data_ptr(), per.data_ptr(), None, None, None,
                                      img_ptr, None, None, None, None, *(o.data_ptr() for o in outs), T, B, N, 0, 1,
                                      0, 0, slots, width, cluster, threads, nbytes, stream)

    assert call(image.data_ptr()) == 0
    torch.cuda.synchronize()
    assert call(image.data_ptr(), threads=plan.threads + 1) == 9
    assert call(image.data_ptr(), nbytes=image.shape[1] + 16) == 9
    assert call(image.data_ptr(), cluster=3) == 9
    assert call(image.data_ptr(), slots=4, width=2) == 9
    assert call(image.data_ptr(), slots=1) == 9  # int8 entries are built two a thread only
    assert call(image.data_ptr() + 4) == 716
    torch.cuda.synchronize()


def test_cluster_barrier_probe():
    """The barrier probe runs on one block and on clusters of 1-8 CTAs, each
    CTA's cycles a barrier positive and below 10 000."""
    _card()
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import sim_kernel

    for c in sim_kernel.CLUSTERS:
        got = sim_kernel.barrier_cycles(c, 128, 256)
        assert len(got) == c and all(0 < v < 10_000 for v in got), got
    got = sim_kernel.barrier_cycles(1, 256, 256, on_cluster=False)
    assert len(got) == 1 and 0 < got[0] < 10_000, got


def test_wrappers_constants_equal_the_library():
    """The wrappers' mirrors of the kernels' constants (``SCAN_*``,
    ``SIM_*``) equal what the built library exports."""
    _card()
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build, iir_kernel, sim_kernel

    assert iir_kernel.checked_scan_library() is _build.library()
    assert sim_kernel.checked_library() is _build.library()


def test_iir_scan_refuses_16_byte_copies_off_their_layout():
    """``hm_iir_scan`` checks a 16-byte copy path's layout itself: an
    aligned flat layout launches; a base 4 bytes off a 16-byte boundary
    (cudaErrorMisalignedAddress, 716) or lanes that are not flat
    (cudaErrorInvalidValue, 1) are refused before any launch."""
    dev = _card()
    from haghighatshoarmuir2024_tpu_torch.ops.cuda import _build, iir_kernel

    lib = iir_kernel.checked_scan_library()
    T, L, N = 100, 8, 2
    buf = torch.zeros((T, 16), device=dev)
    out = torch.zeros((T, 16), device=dev)
    zf = torch.empty((L, N, 1), device=dev)
    coef = np.array([0.5, 0.1, 0.2, -0.3, 0.1], np.float32)
    stream = _build.stream_handle(dev)

    def call(x, y, s1, vec):
        return lib.hm_iir_scan(x.data_ptr(), None, y.data_ptr(), zf.data_ptr(), coef.ctypes.data, N, T, L, 1, 1,
                               16, s1, 1, 16, s1, 1, vec, vec, stream)

    assert call(buf[:, :8], out[:, :8], 1, 1) == 0
    torch.cuda.synchronize()
    assert call(buf[:, 1:9], out[:, 1:9], 1, 1) == 716
    assert call(buf[:, :8], out[:, :8], 1, 0) == 0  # the float-a-lane path takes any base
    assert call(buf[:, ::2], out[:, ::2], 2, 1) == 1  # lanes 8 bytes apart: not flat
    torch.cuda.synchronize()
