"""The traffic generator gives the same inputs for the same seed and other
inputs for another seed."""
import pytest
import torch

from hmbench.control import inputs


@pytest.mark.parametrize("workload", ["flagship.offline-b96", "threeband.offline-b96", "flagship.stream-open"])
def test_same_seed_same_inputs(cpu_context, small, workload):
    a = inputs(cpu_context(workload, seed=2**31 + 17, **small[workload]), torch.device("cpu"))
    b = inputs(cpu_context(workload, seed=2**31 + 17, **small[workload]), torch.device("cpu"))
    c = inputs(cpu_context(workload, seed=2**31 + 18, **small[workload]), torch.device("cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all() and a.dtype == torch.float32


def test_snr_sets_the_noise(cpu_context):
    """At 20 dB the noise is a tenth of the tone's amplitude, at 0 dB equal."""
    from hmbench import signals

    ctx = cpu_context("flagship.offline-b96")
    dev = torch.device("cpu")
    gen = signals.generator(3, dev)
    arr = signals.ArraySpec(ctx.cfg.model["array"])
    doa = torch.zeros(2, dtype=torch.float64)
    x = signals.array_audio(arr, {"kind": "tone", "freq_hz": 1750.0}, doa, torch.tensor([0.0, 20.0]), 48000, 48000.0,
                            gen)
    clean = signals.array_audio(arr, {"kind": "tone", "freq_hz": 1750.0}, doa, torch.tensor([300.0, 300.0]), 48000,
                                48000.0, gen)
    snr = 10 * torch.log10(clean.pow(2).mean(dim=(1, 2)) / (x - clean).pow(2).mean(dim=(1, 2)))
    assert torch.allclose(snr, torch.tensor([0.0, 20.0]), atol=0.1)


def test_checked_batches_follow_the_seed(cpu_context):
    """The reference recomputes ``check_batches`` of the pool, drawn from the
    seed, and every batch in a traced run (whose set bits K3's roofline
    counts)."""
    from hmbench.drivers.offline import checked

    ctx = cpu_context("flagship.offline-b96", seed=2**31 + 17)
    k = int(ctx.traffic["check_batches"])
    a = checked(ctx)
    assert a == checked(cpu_context("flagship.offline-b96", seed=2**31 + 17))
    assert len(a) == k and len(set(a)) == k and all(0 <= b < 8 for b in a)
    assert any(checked(cpu_context("flagship.offline-b96", seed=s)) != a for s in range(5))
    assert checked(cpu_context("flagship.offline-b96", seed=2**31 + 17, trace=True)) == list(range(8))
