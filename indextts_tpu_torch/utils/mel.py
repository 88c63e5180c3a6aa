"""Mel-spectrogram prompt featurizer.

Matches torchaudio.transforms.MelSpectrogram semantics as configured by the
reference (indextts/utils/feature_extractors.py:24-50): 24 kHz, n_fft=1024,
hop=256, win=n_fft, power=1 (magnitude), normalized=False, f_min=0,
f_max=sr/2, n_mels=100, center padding (reflect), HTK mel scale, no filterbank
norm — followed by safe_log with 1e-7 clip (common.py:110-121).

Implemented host-side in numpy: prompt audio is short and featurization is a
one-time cost per voice, so there is nothing to win by putting it on the TPU;
keeping it on host also lets the web server cache features as .npy exactly like
the reference (webui.py voice feature cache).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

from indextts_tpu_torch.utils.common import safe_log


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float64)


_STFT_FRAME_CHUNK = 8192  # frames per STFT transient (tests shrink this)


def stft_magnitude(
    audio: np.ndarray,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    center: bool = True,
    power: float = 1.0,
) -> np.ndarray:
    """|STFT|^power of [..., T] -> [..., n_fft//2+1, frames].

    Mirrors torch.stft(center=True, pad_mode="reflect", onesided=True,
    normalized=False) numerics.
    """
    win_length = win_length or n_fft
    window = hann_window(win_length)
    if win_length < n_fft:  # center-pad window to n_fft like torch.stft
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))

    x = np.asarray(audio, dtype=np.float64)
    squeeze = x.ndim == 1
    x = np.atleast_2d(x)
    if x.ndim != 2:
        # 3D+ would either crash in the center pad or, worse, silently
        # fancy-index the channel axis with time indices below
        raise ValueError(f"stft_magnitude takes [T] or [B, T] audio, got shape {x.shape}")
    if center:
        pad = n_fft // 2
        x = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = 1 + (x.shape[-1] - n_fft) // hop_length
    # chunk over frames: the materialized [B, chunk, n_fft] float64 windows
    # + complex128 rfft are the peak transient — unchunked, a long upload
    # (the server caps bodies at 64 MB ≈ an hour of 8 kHz audio) allocates
    # multiple GB at once and can OOM the serving process. 8192 frames
    # ≈ 67 MB per transient; numerics are identical (same float64 math).
    chunk = _STFT_FRAME_CHUNK
    out = np.empty((x.shape[0], n_fft // 2 + 1, n_frames), dtype=np.float32)
    for f0 in range(0, n_frames, chunk):
        f1 = min(f0 + chunk, n_frames)
        idx = np.arange(n_fft)[None, :] + hop_length * np.arange(f0, f1)[:, None]
        frames = x[:, idx] * window[None, None, :]  # [B, f1-f0, n_fft]
        spec = np.fft.rfft(frames, axis=-1)  # [B, f1-f0, n_fft//2+1]
        mag = np.abs(spec).transpose(0, 2, 1)  # [B, freq, f1-f0]
        if power != 1.0:
            mag = mag**power
        out[:, :, f0:f1] = mag
    return out[0] if squeeze else out


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: Optional[str] = None,
) -> np.ndarray:
    """Triangular HTK-scale mel filterbank [n_freqs, n_mels], matching
    torchaudio.functional.melscale_fbanks(norm=None, mel_scale="htk")."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # [n_mels+1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / f_diff[:-1][None, :]
    up = slopes[:, 2:] / f_diff[1:][None, :]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


class MelSpectrogramFeatures:
    """Prompt-audio featurizer (reference: feature_extractors.py:24-50)."""

    def __init__(
        self,
        sample_rate: int = 24000,
        n_fft: int = 1024,
        hop_length: int = 256,
        win_length: Optional[int] = None,
        n_mels: int = 100,
        mel_fmin: float = 0.0,
        mel_fmax: Optional[float] = None,
        normalize: bool = False,
        padding: str = "center",
        power: float = 1.0,
        norm: Optional[str] = None,
        log_clip: float = 1e-7,
    ):
        if padding not in ("center", "same"):
            raise ValueError("Padding must be 'center' or 'same'.")
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length or n_fft
        self.n_mels = n_mels
        self.f_min = mel_fmin
        self.f_max = mel_fmax if mel_fmax is not None else sample_rate / 2.0
        self.padding = padding
        self.power = power
        self.norm = norm
        self.log_clip = log_clip
        if normalize:
            raise NotImplementedError("normalized spectrogram not used by the reference")

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        """[..., T] float audio -> log-mel [..., n_mels, frames] (a 1-D
        input returns [n_mels, frames] — no spurious batch axis)."""
        unbatched = np.ndim(audio) == 1
        if self.padding == "same":
            pad = self.win_length - self.hop_length
            audio = np.pad(
                np.atleast_2d(audio), ((0, 0), (pad // 2, pad // 2)), mode="reflect"
            )
            center = False
        else:
            center = True
        spec = stft_magnitude(
            audio,
            n_fft=self.n_fft,
            hop_length=self.hop_length,
            win_length=self.win_length,
            center=center,
            power=self.power,
        )
        if spec.ndim == 2:  # unbatched input
            spec = spec[None]
        fb = mel_filterbank(
            self.n_fft // 2 + 1, self.f_min, self.f_max, self.n_mels, self.sample_rate, self.norm
        )
        mel = np.einsum("fm,bft->bmt", fb, spec)
        if unbatched:
            mel = mel[0]
        return safe_log(mel, self.log_clip).astype(np.float32)


def dvae_wav_to_mel(wav: np.ndarray, mel_norms: Optional[np.ndarray] = None) -> np.ndarray:
    """80-bin 22.05 kHz power-2 slaney-normed mel for the DVAE codebook
    (reference: vqvae/xtts_dvae.py:27-48), log-clipped at 1e-5 and divided by
    per-bin norms when provided."""
    spec = stft_magnitude(wav, n_fft=1024, hop_length=256, win_length=1024, center=True, power=2.0)
    if spec.ndim == 2:
        spec = spec[None]
    fb = mel_filterbank(513, 0.0, 8000.0, 80, 22050, norm="slaney")
    mel = np.einsum("fm,bft->bmt", fb, spec)
    mel = np.log(np.clip(mel, 1e-5, None))
    if mel_norms is not None:
        mel = mel / np.asarray(mel_norms)[None, :, None]
    return mel.astype(np.float32)
