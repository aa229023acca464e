"""Carried over from termdaw_tpu/engine/sink.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

Audio sinks: where realtime playback goes.

The reference queues interleaved f32 into an SDL2 AudioQueue
(main.rs:101-129, ui_workflow.rs:195-210). This environment is headless (no
/dev/snd), so the sink is an abstraction with the same contract —
queue_audio / clear / pause / resume / queued_seconds — and three backends:

* NullSink  — discards audio (default in headless runs; pacing still works),
* FileSink  — streams the played audio into a WAV file (listen later),
* AlsaSink  — plays through libasound via ctypes when present (optional).

`make_sink` picks via the TERMDAW_SINK env var ("null", "file[:path]",
"alsa", "auto"); auto tries ALSA then falls back to null.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

import numpy as np

from ..fileio.wav import WavWriter


class Sink:
    """Interface. Audio is interleaved float32 stereo at the project rate."""

    def queue_audio(self, interleaved: np.ndarray) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        pass

    def pause(self) -> None:
        pass

    def resume(self) -> None:
        pass

    def close(self) -> None:
        pass


class NullSink(Sink):
    def __init__(self, sr: int) -> None:
        self.sr = sr
        self.frames_queued = 0

    def queue_audio(self, interleaved: np.ndarray) -> None:
        self.frames_queued += len(interleaved) // 2

    def clear(self) -> None:
        self.frames_queued = 0


class FileSink(Sink):
    """Streams playback into a 32-bit WAV (peak-safe)."""

    def __init__(self, sr: int, path: str = "playback.wav") -> None:
        self.sr = sr
        self.writer = WavWriter(path, 2, sr, 32)

    def queue_audio(self, interleaved: np.ndarray) -> None:
        amp = float(2**31 - 1)
        self.writer.write_scaled(
            np.clip(np.asarray(interleaved, np.float32), -1.0, 1.0) * amp
        )

    def close(self) -> None:
        self.writer.close()


class AlsaSink(Sink):
    """Minimal libasound playback via ctypes (best-effort; optional)."""

    def __init__(self, sr: int, device: str = "default") -> None:
        name = ctypes.util.find_library("asound")
        if not name:
            raise OSError("libasound not found")
        self.lib = ctypes.CDLL(name)
        self.handle = ctypes.c_void_p()
        rc = self.lib.snd_pcm_open(
            ctypes.byref(self.handle), device.encode(), 0, 0
        )
        if rc < 0:
            raise OSError(f"snd_pcm_open failed ({rc})")
        # SND_PCM_FORMAT_FLOAT_LE = 14, interleaved access
        rc = self.lib.snd_pcm_set_params(
            self.handle, 14, 3, 2, sr, 1, 100000
        )
        if rc < 0:
            raise OSError(f"snd_pcm_set_params failed ({rc})")
        self.sr = sr

    def queue_audio(self, interleaved: np.ndarray) -> None:
        data = np.asarray(interleaved, np.float32)
        frames = len(data) // 2
        rc = self.lib.snd_pcm_writei(
            self.handle, data.ctypes.data_as(ctypes.c_void_p), frames
        )
        if rc < 0:
            # -EPIPE (underrun) / -EBADFD (dropped PCM): recover the
            # stream and retry once; silently discarding the return code
            # left playback permanently mute after any underrun
            self.lib.snd_pcm_recover(self.handle, rc, 1)
            self.lib.snd_pcm_writei(
                self.handle, data.ctypes.data_as(ctypes.c_void_p), frames
            )

    def pause(self) -> None:
        self.lib.snd_pcm_drop(self.handle)

    def resume(self) -> None:
        # pause()/clear() drop the PCM into SETUP state; without a
        # prepare here every later writei fails -EBADFD and playback
        # stays silent for the rest of the session
        self.lib.snd_pcm_prepare(self.handle)

    def clear(self) -> None:
        self.lib.snd_pcm_drop(self.handle)
        self.lib.snd_pcm_prepare(self.handle)

    def close(self) -> None:
        self.lib.snd_pcm_close(self.handle)


def make_sink(sr: int, spec: str | None = None) -> Sink:
    spec = spec if spec is not None else os.environ.get("TERMDAW_SINK", "auto")
    if spec.startswith("file"):
        path = spec.split(":", 1)[1] if ":" in spec else "playback.wav"
        return FileSink(sr, path)
    if spec == "alsa":
        return AlsaSink(sr)
    if spec == "auto":
        try:
            return AlsaSink(sr)
        except OSError:
            return NullSink(sr)
    return NullSink(sr)
