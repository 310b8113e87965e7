"""Streaming runtime and serving daemon (counterpart of
haghighatshoarmuir2024_tpu/runtime): carried-state chunked execution of the
quantized pipeline, and the native-ingestion serving loop built on it."""
from .server import LocalizationServer
from .streaming import StreamingLocalizer, StreamState

__all__ = ["LocalizationServer", "StreamingLocalizer", "StreamState"]
