"""The plain reference agrees with the port's CPU path (its kernels' plain
versions) at a small size: the quantized integers exactly, the offline rates
and the streams' carried counts within float32's rounding of the encode."""
import numpy as np
import pytest
import torch

from hmbench import check
from hmbench.control import inputs
from hmbench.reference import localizer as ref
from hmbench.system import build_demo


@pytest.mark.parametrize("workload", ["flagship.offline-b96", "threeband.offline-b96"])
def test_quantized_integers(cpu_context, workload):
    ctx = cpu_context(workload)
    model = ref.build(ctx.cfg.spec, ctx.cfg.arrays)
    demo = build_demo(ctx.cfg, "cpu")
    q = demo.xylo_config
    assert np.array_equal(model.w_in, q.w_in)
    assert np.array_equal(model.dash_syn, q.dash_syn) and np.array_equal(model.dash_mem, q.dash_mem)
    assert np.array_equal(model.threshold, q.threshold)
    assert np.all(np.asarray(q.w_rec) == model.rec_coef)
    assert np.array_equal(model.kernel, demo.kernel)
    assert model.rw == demo.robust_width
    for (b, a), (pb, pa) in zip(model.ba, demo.filterbank.ba_list):
        assert np.array_equal(b, pb) and np.array_equal(a, pa)


@pytest.mark.parametrize("workload", ["flagship.offline-b96", "threeband.offline-b96"])
def test_offline_rates(cpu_context, small, workload):
    ctx = cpu_context(workload, **small[workload])
    dev = torch.device("cpu")
    x = inputs(ctx, dev)
    model = ref.build(ctx.cfg.spec, ctx.cfg.arrays)
    doa, folded = build_demo(ctx.cfg, dev).forward_batch(x, "matched")
    want, nnz = ref.offline_rates(model, x, dev)
    got = check.offline(model, folded.numpy(), doa.numpy(), want)
    assert got["rate_gap"] < 1e-4 and got["score_gap"] < 1e-6
    assert nnz > 0


def test_stream_counts(cpu_context, small):
    from haghighatshoarmuir2024_tpu_torch.runtime.streaming import StreamingLocalizer

    ctx = cpu_context("flagship.stream-open", **small["flagship.stream-open"])
    dev = torch.device("cpu")
    x = inputs(ctx, dev)
    sl = StreamingLocalizer(build_demo(ctx.cfg, dev))
    state, counts = sl.init_state(x.shape[0]), []
    for _ in range(3):
        state = sl.process_chunk(state, x, return_spikes=False)
        counts.append(state.counts.numpy())
    model = ref.build(ctx.cfg.spec, ctx.cfg.arrays)
    want, _ = ref.stream_counts(model, x, 3, dev)
    assert want.shape == (3, x.shape[0], model.neurons)
    assert check.relative_gap(np.stack(counts), want) < 1e-4
    assert np.all(np.diff(want.sum(axis=(1, 2))) > 0)  # the counts carry across the seams
