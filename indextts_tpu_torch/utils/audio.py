"""Host-side audio I/O for the TPU stack.

The reference uses torchaudio for load/resample/save
(reference: indextts/utils/common.py:11-26, indextts/infer.py:85-93,234).
torchaudio is not a dependency here; WAV I/O is implemented on the stdlib
`wave` module + numpy, and resampling uses a polyphase kaiser-windowed sinc
(scipy.signal.resample_poly), which matches torchaudio's default
`sinc_interp_hann`-family resampler to audible transparency.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import tempfile
import wave
from typing import Optional, Tuple

import numpy as np


class UnsupportedAudioFormat(ValueError):
    """Raised when an uploaded audio file can't be decoded on this host."""


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 array [channels, samples] in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:  # packed 24-bit
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width: {sampwidth}")
    data = data.reshape(-1, n_channels).T  # [C, T]
    return np.ascontiguousarray(data), sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write int16 PCM WAV. `audio` is [channels, samples]; float input is
    interpreted as already scaled to int16 range (reference clamps to ±32767
    before saving — infer.py:208)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    if audio.dtype != np.int16:
        # np.clip passes NaN through, and NaN->int16 is undefined (emits a
        # RuntimeWarning and garbage PCM); degrade non-finite samples to
        # silence instead
        audio = np.nan_to_num(audio, nan=0.0, posinf=32767.0, neginf=-32767.0)
        audio = np.clip(audio, -32767.0, 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(audio.T.tobytes())


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis."""
    if orig_sr == target_sr:
        return audio
    g = math.gcd(int(orig_sr), int(target_sr))
    from scipy.signal import resample_poly  # imported here: scipy.signal takes seconds to import

    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def decode_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode any audio file -> (float32 [channels, samples], sample_rate).

    WAV decodes natively; other containers (mp3/ogg/flac/m4a — the reference
    accepts these via torchaudio, webui.py:307-389) are transcoded through
    ffmpeg when present on the host. Raises UnsupportedAudioFormat with a
    clear message otherwise so the server can answer 415 instead of a parse
    traceback.
    """
    try:
        return read_wav(path)
    except (wave.Error, EOFError, ValueError):
        pass
    if not ffmpeg_available():
        ext = os.path.splitext(path)[1] or "<unknown>"
        raise UnsupportedAudioFormat(
            f"cannot decode {ext} audio: not a PCM WAV and no ffmpeg on this "
            f"host — upload WAV, or install ffmpeg for mp3/ogg/flac support"
        )
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        try:
            proc = subprocess.run(
                ["ffmpeg", "-y", "-v", "error", "-i", path,
                 "-f", "wav", "-acodec", "pcm_s16le", tmp_path],
                capture_output=True, timeout=60,
            )
        except subprocess.TimeoutExpired:
            raise UnsupportedAudioFormat("ffmpeg timed out decoding the upload")
        if proc.returncode != 0:
            raise UnsupportedAudioFormat(
                f"ffmpeg failed to decode the upload: {proc.stderr.decode(errors='replace')[:300]}"
            )
        try:
            return read_wav(tmp_path)
        except Exception as e:
            # ffmpeg exit 0 with an unreadable/truncated wav (disk full,
            # killed mid-write): keep the documented contract — the server
            # answers 415, never a parse traceback
            raise UnsupportedAudioFormat(f"transcoded wav unreadable: {e}")
    finally:
        try:
            os.remove(tmp_path)
        except OSError:
            pass


def load_audio(path: str, sampling_rate: int) -> np.ndarray:
    """Load -> mono [1, T] float32 at `sampling_rate`, clipped to [-1, 1]
    (reference: indextts/utils/common.py:11-26 — takes channel 0, resamples,
    clips). NOTE the channel policy deliberately differs from
    engine.extract_features (mean-mix, mirroring ref infer.py:82-93): the
    reference itself uses channel-0 for eval-side loading and mean for
    prompt conditioning, and this helper serves the eval path
    (tools/eval_fidelity.py). Raises on undecodable input (never None)."""
    audio, sr = decode_audio(path)
    if audio.shape[0] > 1:
        audio = audio[:1]
    if sr != sampling_rate:
        audio = resample(audio, sr, sampling_rate)
    return np.clip(audio, -1.0, 1.0).astype(np.float32)
