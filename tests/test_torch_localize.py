"""The port's offline localizer CLI (``tools/localize.py``) against the JAX
package's on the same files, on the CPU (``--device cpu``).

Every JSON line must equal the JAX CLI's: per-frame DoAs (grid values, so
equal lines mean equal DoA indices), the tracked DoAs of ``--track``, the
confirmed tracks of ``--sources 2`` and the summary.  For ``--model xylo``
both CLIs use one design and calibration: the JAX CLI designs and saves it,
and the file is copied into the port's cache directory (the two packages
share the cache key), so the comparison is of the CLI and the spike
pipeline, not of two float32 designs.  The validation exits (code 2) are
those of the JAX CLI."""
import json
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scipy.io import wavfile

import haghighatshoarmuir2024_tpu as jpkg
import haghighatshoarmuir2024_tpu.utils.cache as jax_cache
from haghighatshoarmuir2024_tpu.tools import localize as jax_localize

from haghighatshoarmuir2024_tpu_torch.tools import localize

FS = 48_000


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """A mono 1750 Hz tone (0.6 s), and a 7-channel recording of a 1750 Hz
    tone from 1.1 rad (minus convention) plus 0.05 white noise, from seeds."""
    from haghighatshoarmuir2024_tpu_torch import CenterCircularArray
    from haghighatshoarmuir2024_tpu_torch.ops.interp import signal_from_template

    d = tmp_path_factory.mktemp("audio")
    t = np.arange(0, 0.6, 1 / FS)
    wavfile.write(d / "tone.wav", FS, (0.7 * np.sin(2 * np.pi * 1750 * t) * 32767).astype(np.int16))
    x = signal_from_template(CenterCircularArray(4.5e-2, 7), torch.as_tensor(t),
                             torch.as_tensor(np.sin(2 * np.pi * 1750 * t)), 1.1, fs=FS, delay_sign=-1).numpy()
    x = 0.5 * x + 0.05 * np.random.default_rng(0).standard_normal(x.shape)
    wavfile.write(d / "array.wav", FS, (x * 32767).astype(np.int16))
    return {"tone": str(d / "tone.wav"), "array": str(d / "array.wav")}


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' design caches in tmp directories; the JAX Demos built
    without seeding the committed XLA executables."""
    monkeypatch.setenv("HM2024_JAX_CACHE", "0")
    monkeypatch.setattr(jax_cache, "_DEFAULT_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("HM2024_TORCH_CACHE", str(tmp_path / "torch"))
    return tmp_path


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in out]


SIM = ["--simulate-doa", "0.7", "--snr-db", "10", "--frame", "0.125"]
CASES = {
    "srp-track": ["--model", "srp", "--band", "1400", "2100", *SIM, "--grid", "129", "--max-frames", "3", "--track"],
    "music-track": ["--model", "music", "--band", "1400", "2100", *SIM, "--grid", "129", "--max-frames", "3",
                    "--track"],
    "music-sources": ["--model", "music", "--band", "1400", "2100", *SIM, "--grid", "129", "--max-frames", "4",
                      "--sources", "2"],
    "hilbert-track": ["--model", "hilbert", *SIM, "--grid", "65", "--max-frames", "3", "--track"],
    "xylo-track": ["--model", "xylo", *SIM, "--grid", "33", "--max-frames", "3", "--track"],
    "xylo-sources": ["--model", "xylo", *SIM, "--grid", "33", "--max-frames", "4", "--sources", "2"],
    "xylo-stacked": ["--model", "xylo", "--band", "1600", "1900", "--band", "1900", "2200", "--stacked", *SIM,
                     "--grid", "17", "--max-frames", "2"],
    "srp-array": ["--model", "srp", "--band", "1400", "2100", "--frame", "0.125", "--grid", "129", "--track"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_localize_matches_jax_cli(case, wavs, caches, capsys):
    argv = [wavs["array" if case.endswith("array") else "tone"], *CASES[case]]
    rc, want = run(jax_localize.main, argv, capsys)
    assert rc == 0
    for f in (caches / "jax").glob("*.npz"):  # one xylo design for both CLIs
        (caches / "torch").mkdir(exist_ok=True)
        shutil.copy(f, caches / "torch" / f.name)
    rc, got = run(localize.main, argv + ["--device", "cpu"], capsys)
    assert rc == 0
    assert got == want
    frames = [r for r in got if "frame" in r]
    assert len(frames) == (4 if case.endswith("array") else int(argv[argv.index("--max-frames") + 1]))
    true = 1.1 if case.endswith("array") else 0.7
    last = frames[-1]
    if "sources" in last:  # the nearest confirmed track; MUSIC's pseudospectrum has one peak here
        assert len(last["sources"]) == 1 or "xylo" in case
        ests = [s["doa_rad"] for s in last["sources"]]
    else:
        ests = [last.get("doa_tracked_rad", last["doa_rad"])]
    err = min(np.rad2deg(np.arcsin(abs(np.sin(e - true)))) for e in ests)
    assert err < (25.0 if "xylo" in case else 6.0), frames


@pytest.mark.parametrize("argv", [
    ["--model", "music", "--band", "1400", "2100", "--band", "2100", "2400", *SIM],  # bands: xylo only
    ["--model", "xylo", "--stacked", *SIM, "--grid", "17"],  # stacked needs two bands
    ["--model", "xylo", "--band", "1600", "1900", "--band", "1900", "2200", "--stacked", "--no-calibrate", *SIM],
    ["--model", "music", *SIM, "--sources", "0"],
    ["--model", "srp", "--band", "1400", "2100", "--frame", "0.125"],  # mono file, no --simulate-doa
], ids=["bands", "stacked-one-band", "stacked-uncalibrated", "sources-0", "mono"])
def test_torch_localize_validation_exits(argv, wavs, caches, capsys):
    assert jax_localize.main([wavs["tone"], *argv]) == 2
    assert localize.main([wavs["tone"], *argv, "--device", "cpu"]) == 2
    capsys.readouterr()


def test_torch_localize_simulate_needs_mono(wavs, caches, capsys):
    argv = [wavs["array"], "--model", "srp", "--band", "1400", "2100", *SIM]
    assert jax_localize.main(argv) == 2
    assert localize.main(argv + ["--device", "cpu"]) == 2
    capsys.readouterr()


def write_verbatim_flac(path, pcm: np.ndarray, fs: int) -> None:
    """A FLAC file of (n, channels) int16 ``pcm`` in VERBATIM subframes,
    4096 samples a frame (CRCs zero: the decoder parses past them)."""
    bits = []

    def put(v, n):
        bits.extend((int(v) >> (n - 1 - i)) & 1 for i in range(n))

    n, ch = pcm.shape
    put(1, 1), put(0, 7), put(34, 24)  # the last metadata block: STREAMINFO
    put(4096, 16), put(4096, 16), put(0, 24), put(0, 24)
    put(fs, 20), put(ch - 1, 3), put(15, 5), put(n, 36), put(0, 128)
    for f, s in enumerate(range(0, n, 4096)):
        blk = pcm[s:s + 4096]
        put(0x3FFE, 14), put(0, 2), put(7, 4), put(0, 4), put(ch - 1, 4), put(4, 3), put(0, 1)
        put(f, 8), put(len(blk) - 1, 16), put(0, 8)  # frame number (< 128), block size, CRC-8
        for c in range(ch):
            put(0, 1), put(1, 6), put(0, 1)  # VERBATIM, no wasted bits
            for v in blk[:, c]:
                put(int(v) & 0xFFFF, 16)
        bits.extend([0] * (-len(bits) % 8))
        put(0, 16)  # CRC-16
    data = np.packbits(np.asarray(bits, np.uint8)).tobytes()
    with open(path, "wb") as fh:
        fh.write(b"fLaC" + data)


def test_torch_audio_io_matches_jax(wavs, caches, tmp_path, capsys, monkeypatch):
    """The bundled FLAC decoder through the port's own loader, the file and
    synthetic sources, and the localizer on a FLAC recording, against the
    JAX package's."""
    from haghighatshoarmuir2024_tpu.io import audio as jax_audio
    from haghighatshoarmuir2024_tpu.io.flac import read_flac as jax_read_flac

    from haghighatshoarmuir2024_tpu_torch import CenterCircularArray
    from haghighatshoarmuir2024_tpu_torch.io import audio
    from haghighatshoarmuir2024_tpu_torch.io.flac import read_flac

    fs, pcm = wavfile.read(wavs["array"])
    path = str(tmp_path / "array.flac")
    write_verbatim_flac(path, pcm, fs)
    data, rate = read_flac(path)
    jdata, jrate = jax_read_flac(path)
    assert rate == jrate == FS and data.shape == pcm.shape
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(read_flac(path, normalize=False)[0], pcm)
    for p in (path, wavs["array"]):
        got = list(audio.FileAudioSource(p, fs=FS).frames(0.125))
        want = list(jax_audio.FileAudioSource(p, fs=FS).frames(0.125))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    argv = [path, "--model", "srp", "--band", "1400", "2100", "--frame", "0.125", "--grid", "129"]
    want = run(jax_localize.main, argv, capsys)
    assert run(localize.main, argv + ["--device", "cpu"], capsys) == want

    t = np.arange(0, 0.05, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    syn = audio.SyntheticAudioSource(CenterCircularArray(4.5e-2, 7), t, sig, 0.4, snr_db=10.0, delay_sign=-1)
    jsyn = jax_audio.SyntheticAudioSource(jpkg.CenterCircularArray(4.5e-2, 7), t, sig, 0.4, snr_db=10.0,
                                          delay_sign=-1)
    got, want = list(syn.frames(0.01)), list(jsyn.frames(0.01))
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0, atol=1e-6)

    monkeypatch.setitem(sys.modules, "soundfile", None)  # other formats need the optional package
    with pytest.raises(RuntimeError, match="soundfile"):
        audio.FileAudioSource(str(tmp_path / "clip.ogg"))
    with pytest.raises(audio.MultiMicDevKitNotFound):
        audio.AudioRecorder().record_file(0.01)

