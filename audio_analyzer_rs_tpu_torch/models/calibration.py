"""CalibrationClick — one-shot latency-measurement click.

Port of ref src/generators/calibration.rs:1-134: a 2500 Hz sine (50 ms decay)
plus a 15 ms LCG noise burst scheduled `delay_samples` ahead; publishes the
actual output frame so the onset detector can measure the round-trip
residual.  Deliberately does NOT notify the transport's tick history — the
click must be *detected*, not echo-suppressed.
"""

from __future__ import annotations

import numpy as np

from ..transport import MusicalTransport
from .generators import MIN_ENVELOPE, TWO_PI
from .sources import LcgNoise


class CalibrationClick:
    FREQ = 2500.0

    def __init__(self, transport: MusicalTransport, sample_rate: float,
                 delay_samples: int, volume: float = 0.8):
        self.transport = transport
        self.sample_rate = float(sample_rate)
        self.target_frame = transport.get_output_frames() + delay_samples
        self.actual_frame: int = 0      # shared cell (read by the engine)
        self.fired = False
        self.finished = False
        self.phase = 0.0
        self.envelope = 1.0
        self.decay_rate = MIN_ENVELOPE ** (1.0 / (self.sample_rate * 0.05))
        self.volume = volume
        self.noise_envelope = 1.0
        self.noise_decay_rate = MIN_ENVELOPE ** (1.0 / (self.sample_rate * 0.015))
        self.noise = LcgNoise(12345)

    def is_finished(self) -> bool:
        return self.finished

    def process(self, buffer: np.ndarray, channels: int) -> None:
        if self.finished:
            return
        total_frames = len(buffer) // channels
        buffer_start_frame = self.transport.get_output_frames() - total_frames

        if not self.fired:
            off = self.target_frame - buffer_start_frame
            if off < 0:
                self.actual_frame = buffer_start_frame
                self.fired = True
                start_offset = 0
            elif off < total_frames:
                self.actual_frame = self.target_frame
                self.fired = True
                start_offset = int(off)
            else:
                return
        else:
            start_offset = 0

        m = total_frames - start_offset
        t = np.arange(m, dtype=np.float64)
        phase_inc = self.FREQ * TWO_PI / self.sample_rate
        env = self.envelope * np.power(self.decay_rate, t)
        sine = (np.sin((self.phase + t) * phase_inc) * self.volume * env)
        self.phase += m
        nenv = self.noise_envelope * np.power(self.noise_decay_rate, t)
        noise = self.noise.next_block(m) * np.float32(self.volume * 0.5) * \
            nenv.astype(np.float32)
        sig = (sine + noise).astype(np.float32)

        # Stop at the sample where the sine envelope decays out
        # (ref calibration.rs:128-131).
        done = env * self.decay_rate <= MIN_ENVELOPE
        if done.any():
            cut = int(np.argmax(done)) + 1
            sig[cut:] = 0.0
            self.finished = True
        self.envelope = float(env[-1] * self.decay_rate)
        self.noise_envelope = float(nenv[-1] * self.noise_decay_rate)

        frames = buffer.reshape(total_frames, channels)
        frames[start_offset:] += sig[:, None]
