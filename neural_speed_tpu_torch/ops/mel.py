"""Log-mel spectrogram front-end for whisper (port of
`neural_speed_tpu/ops/mel.py`: the port's own copy, so that it imports
nothing of the JAX package).  The OpenAI whisper / HF
WhisperFeatureExtractor algorithm: hann window, n_fft=400, hop=160, 80
slaney-scale mel bins, log10 with a dynamic-range clamp.  Pure numpy on
the host, as in the JAX package, and bit-equal to it
(`tests/test_torch_whisper.py`).
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE


def hertz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    m = 3.0 * f / 200.0
    log_region = f >= 1000.0
    m = np.where(log_region, 15.0 + 27.0 * np.log(np.maximum(f, 1e-10) /
                                                  1000.0) / np.log(6.4), m)
    return m


def mel_to_hertz(m):
    m = np.asarray(m, np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0),
                 f)
    return f


def mel_filter_bank(n_freqs: int = N_FFT // 2 + 1, n_mels: int = 80,
                    f_min: float = 0.0, f_max: float = 8000.0,
                    sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """[n_mels, n_freqs] triangular slaney-normalized filterbank."""
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hertz_to_mel(f_min), hertz_to_mel(f_max),
                          n_mels + 2)
    f_pts = mel_to_hertz(mel_pts)

    fdiff = np.diff(f_pts)
    slopes = f_pts[None, :] - fft_freqs[:, None]  # [F, M+2]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up)).T  # [M, F]
    # slaney normalization: equal energy per band
    enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = 80,
                        pad_to_chunk: bool = True) -> np.ndarray:
    """float PCM [T] @16kHz -> log-mel [n_mels, frames] (HF-compatible)."""
    audio = np.asarray(audio, np.float32)
    if pad_to_chunk:
        if len(audio) > N_SAMPLES:
            audio = audio[:N_SAMPLES]
        audio = np.pad(audio, (0, N_SAMPLES - len(audio)))
    # center-pad (reflect) like torch.stft(center=True)
    audio = np.pad(audio, (N_FFT // 2, N_FFT // 2), mode="reflect")
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float64)

    n_frames = 1 + (len(audio) - N_FFT) // HOP_LENGTH
    idx = (np.arange(N_FFT)[None, :]
           + HOP_LENGTH * np.arange(n_frames)[:, None])
    frames = audio[idx].astype(np.float64) * window[None, :]
    stft = np.fft.rfft(frames, n=N_FFT, axis=1)  # [frames, F]
    magnitudes = (np.abs(stft) ** 2)[:-1]  # drop the last frame (HF parity)

    fb = mel_filter_bank(n_mels=n_mels).astype(np.float64)
    mel = magnitudes @ fb.T  # [frames, M]
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.T.astype(np.float32)  # [M, frames]
