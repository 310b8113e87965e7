"""The port's figure helpers (``experiments/common.py``) and the figure calls
of its harnesses, against the JAX package's on the CPU.

- Each helper draws JAX's figure on the same inputs: every axes' lines
  (x and y data equal exactly: both draw the same numpy arrays), title, axis
  labels and y scale, captured by replacing ``maybe_savefig`` in both
  modules.
- With ``HM2024_FIG_DIR`` unset nothing imports matplotlib: every module of
  the port imported, every helper called, in a fresh interpreter, which also
  holds JAX and the JAX package out.
- Each harness writes its JAX twin's file names into ``HM2024_FIG_DIR``:
  ``main(["--quick", "--device", "cpu"])`` where that takes seconds, its
  figure function fed a canned result elsewhere (the speech and Xylo
  harnesses take 10-30 s at ``--quick``).  Each expected name is checked
  against the JAX twin's source, where it is written literally or as the
  same f-string.
"""
import contextlib
import io
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "experiments"))
import common as jax_common  # noqa: E402

from haghighatshoarmuir2024_tpu_torch.experiments import common  # noqa: E402
from haghighatshoarmuir2024_tpu_torch.experiments import (  # noqa: E402
    array_resolution, array_resolution_music, array_resolution_snn, mismatch_robustness, moving_target,
    multi_target_tracking, multiband_speech, multiple_targets, phase_analysis, reverb_robustness,
    short_hilbert_transform, srp_phat_baseline, target_localization, target_localization_music,
    target_snn_localization, target_xylo_localization)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def capture(module, monkeypatch):
    figs = []
    monkeypatch.setattr(module, "maybe_savefig", lambda fig, name: figs.append((name, fig)))
    return figs


def drawn(fig):
    """What a figure shows: per axes its lines' data, title, labels, scale."""
    out = []
    for ax in fig.axes:
        out.append({
            "lines": [(np.asarray(ln.get_xdata(), np.float64), np.asarray(ln.get_ydata(), np.float64),
                       ln.get_label(), ln.get_marker()) for ln in ax.get_lines()],
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "yscale": ax.get_yscale(), "name": ax.name,
            "legend": None if ax.get_legend() is None else [t.get_text() for t in ax.get_legend().get_texts()],
        })
    return out


def assert_same_figure(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert {k: v for k, v in x.items() if k != "lines"} == {k: v for k, v in y.items() if k != "lines"}
        assert len(x["lines"]) == len(y["lines"])
        for (xa, ya, la, ma), (xb, yb, lb, mb) in zip(x["lines"], y["lines"]):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
            assert (la, ma) == (lb, mb)


DOA = np.linspace(-np.pi, np.pi, 32)
HELPER_CALLS = {
    "polar_one": ("fig_polar_patterns", ({"1 kHz": np.abs(np.cos(DOA))}, DOA, "pat.pdf"), {}),
    "polar_three": ("fig_polar_patterns", ({"a": np.abs(np.cos(DOA)), "b": np.zeros(32), "c": np.sin(DOA) ** 2},
                                           DOA, "pats.pdf"), {}),
    "mae": ("fig_mae_vs_snr", ({"tone": ([0, 10, 20], [5.0, 2.0, 1.0]), "speech": ([0, 10], [9.0, 3.0])},
                               "mae.pdf"), {"ylabel": "median [deg]"}),
    "lines_one": ("fig_lines", ([0, 1, 2], {"a": [1, 2, 3]}, "lines.pdf"), {"xlabel": "t"}),
    "lines_logy": ("fig_lines", (np.arange(4.0), {"a": [1, 2, 3, 4], "b": np.array([4.0, 3, 2, 1])}, "logy.pdf"),
                   {"xlabel": "x", "ylabel": "y", "logy": True}),
}


@pytest.mark.parametrize("case", list(HELPER_CALLS), ids=list(HELPER_CALLS))
def test_torch_figure_helper_matches_jax(case, monkeypatch, tmp_path):
    helper, args, kwargs = HELPER_CALLS[case]
    monkeypatch.setenv("HM2024_FIG_DIR", str(tmp_path))
    jfigs, pfigs = capture(jax_common, monkeypatch), capture(common, monkeypatch)
    getattr(jax_common, helper)(*args, **kwargs)
    getattr(common, helper)(*args, **kwargs)
    assert [n for n, _ in pfigs] == [n for n, _ in jfigs] == [args[-1]]
    assert_same_figure(drawn(pfigs[0][1]), drawn(jfigs[0][1]))


def test_torch_maybe_savefig_writes_where_asked(monkeypatch, tmp_path):
    """``maybe_savefig`` writes the file into ``HM2024_FIG_DIR`` (made if
    missing), and nothing without it."""
    plt = common._plt()
    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    monkeypatch.delenv("HM2024_FIG_DIR", raising=False)
    common.maybe_savefig(fig, "none.pdf")
    out = tmp_path / "figs" / "deeper"
    monkeypatch.setenv("HM2024_FIG_DIR", str(out))
    common.maybe_savefig(fig, "x.pdf")
    plt.close(fig)
    assert [p.name for p in out.iterdir()] == ["x.pdf"] and (out / "x.pdf").stat().st_size > 0
    assert not (tmp_path / "none.pdf").exists()


def test_torch_no_matplotlib_without_fig_dir(tmp_path):
    """Every module of the port imported and every helper called with
    ``HM2024_FIG_DIR`` unset: matplotlib, JAX and the JAX package stay out of
    ``sys.modules``."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        import haghighatshoarmuir2024_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from haghighatshoarmuir2024_tpu_torch.experiments import common
        doa = np.linspace(-np.pi, np.pi, 8)
        common.fig_polar_patterns({{"a": np.ones(8)}}, doa, "a.pdf")
        common.fig_mae_vs_snr({{"a": ([0, 1], [1, 2])}}, "b.pdf")
        common.fig_lines([0, 1], {{"a": [1, 2]}}, "c.pdf")
        common.maybe_savefig(None, "d.pdf")
        from haghighatshoarmuir2024_tpu_torch.experiments import short_hilbert_transform
        short_hilbert_transform.kernel_response_figure()
        bad = [m for m in sys.modules if m.split(".")[0] in ("matplotlib", "jax", "haghighatshoarmuir2024_tpu")]
        assert not bad, bad
        print("clean")
    """)
    env = {k: v for k, v in os.environ.items() if k != "HM2024_FIG_DIR"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env=env)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "clean", proc.stderr[-3000:]
    assert list(tmp_path.iterdir()) == []


# harness: (the port's module, its --quick arguments, the names JAX writes, JAX's template of each)
QUICK = {
    "array_resolution": (array_resolution, [], ["array_resolution_sin.pdf"],
                         ['f"array_resolution_{template_kind}.pdf"']),
    "array_resolution_music": (array_resolution_music, [], ["array_resolution_music_circular.pdf"],
                               ['f"array_resolution_music_{kind}.pdf"']),
    "array_resolution_snn": (array_resolution_snn, ["--geometry", "linear"], ["array_resolution_snn_linear.pdf"],
                             ['f"array_resolution_snn_{kind}.pdf"']),
    "mismatch_robustness": (mismatch_robustness, ["--trials", "2"], ["mismatch_gain_mae.pdf", "mismatch_pos_mae.pdf"],
                            ['"mismatch_gain_mae.pdf"', '"mismatch_pos_mae.pdf"']),
    "moving_target": (moving_target, [], ["moving_target_track.pdf"], ['"moving_target_track.pdf"']),
    "multi_target_tracking": (multi_target_tracking, [], ["multi_target_tracking.pdf"],
                              ['"multi_target_tracking.pdf"']),
    "multiple_targets": (multiple_targets, [], ["multiple_targets.pdf"], ['"multiple_targets.pdf"']),
    "phase_analysis": (phase_analysis, [], ["phase_plot.pdf", "random_phase.pdf", "chirp_phase_plot.pdf"],
                       ['"phase_plot.pdf"', '"random_phase.pdf"', '"chirp_phase_plot.pdf"']),
    "reverb_robustness": (reverb_robustness, ["--trials", "2"], ["reverb_robustness_mae.pdf"],
                          ['"reverb_robustness_mae.pdf"']),
    "short_hilbert_transform": (short_hilbert_transform, [], ["short_hilbert_transform.pdf", "rzcc_plots.pdf"],
                                ['"short_hilbert_transform.pdf"', '"rzcc_plots.pdf"']),
    "srp_phat_baseline": (srp_phat_baseline, [], ["srp_phat_baseline_mae.pdf"], ['"srp_phat_baseline_mae.pdf"']),
    "target_localization": (target_localization, [], ["target_localization_mae.pdf"],
                            ['"target_localization_mae.pdf"']),
    "target_localization_music": (target_localization_music, [], ["target_localization_music_mae.pdf"],
                                  ['"target_localization_music_mae.pdf"']),
    "target_snn_localization": (target_snn_localization, [], ["target_snn_localization_mae.pdf"],
                                ['"target_snn_localization_mae.pdf"']),
}


def in_jax_source(name: str, templates) -> None:
    src = (REPO / "experiments" / f"{name}.py").read_text()
    for t in templates:
        assert t in src, (name, t)


def written(tmp_path) -> list:
    return sorted(p.name for p in tmp_path.iterdir() if p.stat().st_size > 0)


@pytest.mark.parametrize("name", list(QUICK), ids=list(QUICK))
def test_torch_harness_writes_jax_figure_names(name, monkeypatch, tmp_path):
    module, extra, names, templates = QUICK[name]
    in_jax_source(name, templates)
    monkeypatch.setenv("HM2024_FIG_DIR", str(tmp_path / "figs"))
    monkeypatch.setenv("HM2024_TORCH_CACHE", str(tmp_path / "cache"))
    with contextlib.redirect_stdout(io.StringIO()):
        module.main(["--quick", "--device", "cpu", *extra])
    assert written(tmp_path / "figs") == sorted(names)


def canned_curve(n=11):
    snr = np.linspace(-10, 20, n).tolist()
    return snr, {"mae_deg": np.linspace(20, 1, n).tolist(), "median_deg": np.linspace(15, 1, n).tolist()}


def test_torch_multiband_speech_figure_names(monkeypatch, tmp_path):
    """``multiband_speech.figures`` on a canned ``run`` result: JAX's file,
    its four curves."""
    in_jax_source("multiband_speech", ['"multiband_speech_mae.pdf"'])
    monkeypatch.setenv("HM2024_FIG_DIR", str(tmp_path))
    snr = [-10.0, 0.0, 10.0, 20.0]
    cols = lambda *names: {f"{c}_mae_deg": [9.0, 5.0, 2.0, 1.0] for c in names}  # noqa: E731
    res = {"snr_db": snr, "single_band_1000_2000": cols("reference_peak", "matched_speech_cal"),
           "three_band_500_3000": cols(*multiband_speech.THREE_BAND_COLUMNS)}
    figs = capture(common, monkeypatch)
    multiband_speech.figures(res)
    assert [n for n, _ in figs] == ["multiband_speech_mae.pdf"]
    assert [t.get_text() for t in figs[0][1].axes[0].get_legend().get_texts()] == [
        "single band, matched", "3 bands, matched (folded)", "3 bands, matched_stacked (cos)",
        "single band, reference peak"]


@pytest.mark.parametrize("bipolar", [True, False], ids=["bipolar", "unipolar"])
def test_torch_xylo_harness_figure_names(bipolar, monkeypatch, tmp_path):
    """``target_xylo_localization.figures`` (the tone sweeps, summarized) and
    ``speech_figures`` (``run_speech``'s result) on canned results write
    JAX's three names; the convention envelope is not drawn."""
    kind = "bipolar" if bipolar else "unipolar"
    in_jax_source("target_xylo_localization", ["f\"target_xylo_{'bipolar' if bipolar else 'unipolar'}_mae.pdf\"",
                                               "f\"target_xylo_speech_{'bipolar' if bipolar else 'unipolar'}"
                                               "_mae.pdf\"", '"xylo_fixed_speech_beam.pdf"'])
    monkeypatch.setenv("HM2024_FIG_DIR", str(tmp_path))
    snr, curve = canned_curve()
    sm = {"reference": {"snr_db": snr, **curve}, "matched": {"snr_db": snr, **curve},
          "reference_estimator_convention_envelope": {"mae_deg_min": [1.0] * 11}}
    target_xylo_localization.figures(sm, bipolar)
    mc = {"snr_db": snr, **{lab: curve for lab in target_xylo_localization.SPEECH_LABELS}}
    beam = {f"{s:+.0f}dB": {"profile": np.linspace(0, 1, 17).tolist()} for s in (-10, 0, 10)}
    target_xylo_localization.speech_figures({"speech_mc": mc, "beam_profiles": beam}, bipolar)
    assert written(tmp_path) == sorted([f"target_xylo_{kind}_mae.pdf", f"target_xylo_speech_{kind}_mae.pdf",
                                        "xylo_fixed_speech_beam.pdf"])
