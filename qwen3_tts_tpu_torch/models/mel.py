"""Librosa-aligned log-mel frontend. Port of `qwen3_tts_tpu/models/mel.py`.

Numerically mirrors the reference's hand-rolled mel pipeline
(`src/models/onnx.rs:167-320`): 24 kHz, n_fft=1024, hop=256, n_mels=128,
fmin=0, fmax=12000, Slaney hz<->mel with 2/(f_right-f_left) filter
normalisation, reflect padding of (n_fft-hop)/2 (with the reference's own
edge rule: zeros where a short signal has no sample to reflect), periodic
Hann window, magnitude `sqrt(|X|^2 + 1e-9)`, then `ln(max(mel, 1e-5))`.

The filterbank, the window and the padding are numpy (a copy of the JAX
module's host half); the frames are an `unfold` of the padded signal, then
`torch.fft.rfft` and the filterbank product on the device. `torch.stft`
is not used: its `center=True` reflect padding is not the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import MelConfig
from ..core.precision import f32_exact


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freq = np.asarray(freq, np.float64)
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        freq / f_sp,
    )


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = np.asarray(mel, np.float64)
    return np.where(
        mel >= min_log_mel,
        min_log_hz * np.exp(logstep * (mel - min_log_mel)),
        f_sp * mel,
    )


@functools.lru_cache(maxsize=4)
def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """[n_mels, n_fft//2+1] Slaney-normalised triangular filters."""
    n_bins = cfg.n_fft // 2 + 1
    mel_min = _hz_to_mel(cfg.fmin)
    mel_max = _hz_to_mel(cfg.fmax)
    edges = _mel_to_hz(
        mel_min + (mel_max - mel_min)
        * np.arange(cfg.n_mels + 2) / (cfg.n_mels + 1)
    )
    fft_freqs = np.arange(n_bins) * cfg.sample_rate / cfg.n_fft
    fb = np.zeros((cfg.n_mels, n_bins), np.float64)
    for m in range(cfg.n_mels):
        f_left, f_center, f_right = edges[m], edges[m + 1], edges[m + 2]
        norm = 2.0 / (f_right - f_left)
        up = (fft_freqs - f_left) / (f_center - f_left)
        down = (f_right - fft_freqs) / (f_right - f_center)
        w = np.where(
            (fft_freqs >= f_left) & (fft_freqs <= f_center), up,
            np.where((fft_freqs > f_center) & (fft_freqs <= f_right), down, 0.0),
        )
        fb[m] = w * norm
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def hann_window(n_fft: int) -> np.ndarray:
    i = np.arange(n_fft)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n_fft))).astype(np.float32)


def reflect_pad(audio: np.ndarray, padding: int) -> np.ndarray:
    """The reference's exact reflect padding (src/models/onnx.rs:251-271),
    including its zero-fill edge behavior for short signals."""
    n = len(audio)
    head = [audio[i] if i < n else 0.0 for i in range(padding, 0, -1)]
    tail = []
    for i in range(1, padding + 1):
        idx = n - 1 - i
        tail.append(audio[idx] if 0 <= idx < n else 0.0)
    return np.concatenate([
        np.asarray(head, np.float32), np.asarray(audio, np.float32),
        np.asarray(tail, np.float32),
    ])


@functools.lru_cache(maxsize=8)
def _constants(cfg: MelConfig, device: torch.device):
    """(Hann window [n_fft], filterbank transposed [n_bins, n_mels]) on
    `device`, made once per config and device."""
    return (torch.from_numpy(hann_window(cfg.n_fft)).to(device),
            torch.from_numpy(np.ascontiguousarray(mel_filterbank(cfg).T))
            .to(device))


def compute_mel(audio: np.ndarray, cfg: MelConfig = MelConfig(),
                device="cpu") -> torch.Tensor:
    """audio [N] float32 -> log-mel [n_frames, n_mels] f32 on `device`."""
    device = torch.device(device)
    padding = (cfg.n_fft - cfg.hop) // 2
    padded = reflect_pad(np.asarray(audio, np.float32), padding)
    if len(padded) < cfg.n_fft:
        return torch.zeros(0, cfg.n_mels, device=device)
    n_frames = (len(padded) - cfg.n_fft) // cfg.hop + 1
    return _mel(torch.from_numpy(padded).to(device), n_frames, cfg)


def _mel(padded: torch.Tensor, n_frames: int, cfg: MelConfig
         ) -> torch.Tensor:
    window, fb_t = _constants(cfg, padded.device)
    frames = padded.unfold(0, cfg.n_fft, cfg.hop)[:n_frames] * window[None]
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    with f32_exact(padded.device):
        mel = mag @ fb_t
    return torch.log(torch.clamp_min(mel, 1e-5))
