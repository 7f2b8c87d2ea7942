"""AudioPlayer — file playback with linear-interpolation resampling.

Port of the reference player (ref src/generators/player.rs:1-233): decode the
whole file upfront to interleaved f32, then resample by rate ratio with
linear interpolation, controlled by Play/Pause/Stop/Seek commands.  The
symphonia decoder becomes the stdlib WAV loader (utils/wav.py) plus the
native FFmpeg decode module for every other container/codec (mp3, flac,
ogg, ... — runtime/audio_decode.cpp); resampling is a vectorized gather
per buffer instead of a per-sample loop.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils import wav


class AudioPlayer:
    def __init__(self, system_sample_rate: float):
        self.playing = False
        self.finished = False
        self.position_frames = 0.0
        self.samples = np.zeros(0, dtype=np.float32)
        self.sample_rate = 44100
        self.source_channels = 2
        self.system_sample_rate = float(system_sample_rate)
        self.playback_rate_ratio = 1.0
        self._commands: List[tuple] = []

    # ── controller ops (ref player.rs:145-232) ──────────────────────────

    def load_file(self, path: str) -> None:
        try:
            data, sr, channels = wav.read_wav_float(path)
        except (ValueError, OSError):
            # Not a (PCM) WAV — decode through the native FFmpeg module,
            # which covers every format the reference's symphonia build does
            # (ref player.rs:170-260).  Decodes to mono at native rate.
            from .. import runtime
            data, sr = runtime.decode_file(path)
            channels = 1
        self.send("LoadTrack", data, sr, channels)

    def send(self, cmd: str, *args) -> bool:
        self._commands.append((cmd, *args))
        return True

    def _handle_commands(self):
        for cmd in self._commands:
            name = cmd[0]
            if name == "LoadTrack":
                self.samples, self.sample_rate, self.source_channels = (
                    cmd[1].astype(np.float32), cmd[2], cmd[3])
                self.position_frames = 0.0
                self.playing = False
                self.playback_rate_ratio = self.sample_rate / self.system_sample_rate
            elif name == "Play":
                self.playing = True
            elif name == "Pause":
                self.playing = False
            elif name == "Stop":
                self.playing = False
                self.position_frames = 0.0
            elif name == "Seek":
                target = cmd[1] * self.sample_rate
                max_frame = len(self.samples) / max(self.source_channels, 1)
                self.position_frames = float(np.clip(target, 0.0, max_frame))
        self._commands.clear()

    def is_finished(self) -> bool:
        return self.finished

    def process(self, buffer: np.ndarray, channels: int) -> None:
        self._handle_commands()
        if not self.playing or len(self.samples) == 0:
            return
        num_frames = len(buffer) // channels
        total_source = len(self.samples) // self.source_channels
        pos = self.position_frames + self.playback_rate_ratio * np.arange(num_frames)
        valid = pos < total_source - 1
        n_valid = int(valid.sum())
        if n_valid == 0:
            self.playing = False
            self.position_frames = 0.0
            return
        idx = np.floor(pos[:n_valid]).astype(np.int64)
        frac = (pos[:n_valid] - idx).astype(np.float32)
        src = self.samples.reshape(total_source, self.source_channels)
        out = buffer.reshape(num_frames, channels)
        for ch in range(channels):
            src_ch = ch if ch < self.source_channels else 0
            cur = src[idx, src_ch]
            nxt = src[idx + 1, src_ch]
            out[:n_valid, ch] += cur + frac * (nxt - cur)
        if n_valid < num_frames:
            self.playing = False
            self.position_frames = 0.0
        else:
            self.position_frames = float(pos[-1] + self.playback_rate_ratio)


class PlayerController:
    """ref player.rs:145-168."""

    def __init__(self, player: AudioPlayer):
        self._player = player

    def play(self):
        self._player.send("Play")

    def pause(self):
        self._player.send("Pause")

    def stop(self):
        self._player.send("Stop")

    def seek(self, time_in_seconds: float):
        self._player.send("Seek", time_in_seconds)

    def load_file(self, path: str):
        self._player.load_file(path)

    def is_playing(self) -> bool:
        """True while the cursor is inside the decoded track and not paused
        (drops automatically when playback passes the track end)."""
        return self._player.playing

    def is_finished(self) -> bool:
        return self._player.is_finished()
