"""Audio preprocessing: WAV ingestion and the log-mel spectrogram front-end
— the port's copy of ``smg_tpu/multimodal/audio.py``.

The Whisper and Qwen2-Audio recipes: 16 kHz mono, 25 ms Hann windows with a
10 ms hop, 80 or 128 mel bins, log10 with a dynamic-range clamp.  Computed
in numpy on the host, as the reference computes it: the front-end is host
work, and the encoder that would take its features runs on the device.
"""

from __future__ import annotations

import abc
import io
import math

import numpy as np


def decode_wav(raw: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (mono float32 samples in [-1, 1], sample_rate).
    Stdlib ``wave`` only (PCM 16/24/32-bit and 8-bit unsigned)."""
    import wave

    with wave.open(io.BytesIO(raw)) as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        data = w.readframes(n)
    if width == 1:
        x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    elif width == 3:
        b = np.frombuffer(data, np.uint8).reshape(-1, 3)
        as32 = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
        x = as32.astype(np.float32) / float(1 << 23)
    elif width == 4:
        x = np.frombuffer(data, "<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


def resample(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear-interpolation resample (the front-end tolerance; the
    reference uses soxr/ffmpeg)."""
    if src_rate == dst_rate:
        return x
    n_out = int(round(len(x) * dst_rate / src_rate))
    src_t = np.arange(len(x)) / src_rate
    dst_t = np.arange(n_out) / dst_rate
    return np.interp(dst_t, src_t, x).astype(np.float32)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft//2 + 1] (the Whisper
    convention: Slaney scale + area normalization)."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log_region = f >= 1000.0
        mel = np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
            lin,
        )
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        lin = m * (200.0 / 3)
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), lin)

    fmax = sample_rate / 2
    mels = np.linspace(0, float(hz_to_mel(fmax)), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, fmax, n_fft // 2 + 1)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, ctr, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        # Slaney area normalization
        fb[i] *= 2.0 / (hi - lo)
    return fb.astype(np.float32)


def log_mel_spectrogram(
    audio: np.ndarray,
    sample_rate: int = 16000,
    n_fft: int = 400,
    hop: int = 160,
    n_mels: int = 80,
) -> np.ndarray:
    """Whisper-recipe log-mel: [n_mels, frames] float32.

    Hann window, reflect padding, magnitude^2, mel projection, log10 with
    an 8-dB dynamic-range floor, scaled to ~[-1, 1]."""
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    pad = n_fft // 2
    x = np.pad(audio.astype(np.float32), pad, mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(n_frames, n_fft),
        strides=(x.strides[0] * hop, x.strides[0]),
    )
    spec = np.fft.rfft(frames * window, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2).T  # [n_fft//2+1, frames]
    # whisper drops the final frame (it covers padding only)
    power = power[:, :-1] if power.shape[1] > 1 else power
    mel = mel_filterbank(n_mels, n_fft, sample_rate) @ power
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


class AudioProcessor(abc.ABC):
    """Base: raw bytes/array -> features + placeholder count."""

    name = "base"
    sample_rate = 16000

    def process_bytes(self, raw: bytes):
        x, rate = decode_wav(raw)
        return self.process(resample(x, rate, self.sample_rate))

    @abc.abstractmethod
    def process(self, audio: np.ndarray):
        """Mono samples at ``sample_rate`` -> (features, placeholder count)."""


class WhisperAudioProcessor(AudioProcessor):
    """Whisper front-end: 80 mel bins, 30 s window padding, 2x conv stride
    on the encoder side -> frames//2 placeholder tokens."""

    name = "whisper"

    def __init__(self, n_mels: int = 80, chunk_seconds: int = 30):
        self.n_mels = n_mels
        self.chunk_samples = chunk_seconds * self.sample_rate

    def process(self, audio: np.ndarray):
        audio = audio[: self.chunk_samples]
        if len(audio) < self.chunk_samples:
            audio = np.pad(audio, (0, self.chunk_samples - len(audio)))
        feats = log_mel_spectrogram(audio, n_mels=self.n_mels)
        return feats, feats.shape[1] // 2  # encoder conv2 stride-2


class Qwen2AudioProcessor(AudioProcessor):
    """Qwen2-Audio front-end: 128 mel bins, variable length (no 30 s pad),
    pooled 2x at the adapter."""

    name = "qwen2_audio"

    def __init__(self, n_mels: int = 128, max_seconds: int = 30):
        self.n_mels = n_mels
        self.max_samples = max_seconds * self.sample_rate

    def process(self, audio: np.ndarray):
        audio = audio[: self.max_samples]
        feats = log_mel_spectrogram(audio, n_mels=self.n_mels)
        return feats, max(1, feats.shape[1] // 2)


_AUDIO = {"whisper": WhisperAudioProcessor, "qwen2_audio": Qwen2AudioProcessor}


def get_audio_processor(name_or_model: str) -> AudioProcessor:
    key = (name_or_model or "").lower()
    if key in _AUDIO:
        return _AUDIO[key]()
    if "qwen2-audio" in key or "qwen2_audio" in key:
        return Qwen2AudioProcessor()
    return WhisperAudioProcessor()
