"""Audio sources: synthetic, file (wav, flac by the bundled decoder) and the
dev-board recorder, and the live visualizer (counterpart of
``haghighatshoarmuir2024_tpu/io``)."""

from .audio import AudioRecorder, AudioSource, FileAudioSource, MultiMicDevKitNotFound, SyntheticAudioSource
from .visualizer import Visualizer

__all__ = ["AudioSource", "SyntheticAudioSource", "FileAudioSource", "AudioRecorder", "MultiMicDevKitNotFound",
           "Visualizer"]
