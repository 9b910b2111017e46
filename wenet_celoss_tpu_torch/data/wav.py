"""Audio reading (``read_wav`` and ``read_audio``, copied from
``wenet_celoss_tpu/data/wav.py``).

``read_wav``: RIFF WAV in pure numpy, PCM16/PCM32/float chunks, a header
scan that skips non-data chunks, and int16-range float output (kaldi
convention). ``read_audio`` sniffs the format: FLAC (LibriSpeech ships
.flac) goes to ``data/flac.py``, anything else to ``read_wav``.
"""

from __future__ import annotations

import io
import struct
from typing import Tuple

import numpy as np


def read_wav(source) -> Tuple[np.ndarray, int]:
    """Read a WAV file.

    Args:
      source: path or file-like object or bytes.
    Returns: (samples [num_samples] or [num_samples, channels] float32 in
      int16 range, sample_rate)
    """
    if isinstance(source, (bytes, bytearray)):
        f = io.BytesIO(source)
    elif hasattr(source, "read"):
        f = source
    else:
        f = open(source, "rb")
    try:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", hdr)
            if chunk_id == b"fmt ":
                fmt = f.read(chunk_size)
            elif chunk_id == b"data":
                data = f.read(chunk_size)
                break
            else:
                f.seek(chunk_size + (chunk_size & 1), 1)
        if fmt is None or data is None:
            raise ValueError("missing fmt or data chunk")
        (audio_format, channels, sample_rate, _br, _ba,
         bits) = struct.unpack("<HHIIHH", fmt[:16])
        if audio_format == 1:  # PCM
            if bits == 16:
                x = np.frombuffer(data, "<i2").astype(np.float32)
            elif bits == 32:
                x = np.frombuffer(data, "<i4").astype(np.float32) / 65536.0
            elif bits == 8:
                x = (np.frombuffer(data, "u1").astype(np.float32)
                     - 128.0) * 256.0
            else:
                raise ValueError(f"unsupported PCM bits: {bits}")
        elif audio_format == 3:  # IEEE float
            x = np.frombuffer(data, "<f4").astype(np.float32) * 32768.0
        else:
            raise ValueError(f"unsupported format code: {audio_format}")
        if channels > 1:
            x = x.reshape(-1, channels)
        return x, sample_rate
    finally:
        if f is not source and not isinstance(source, (bytes, bytearray)):
            f.close()
        elif isinstance(source, (bytes, bytearray)):
            f.close()


def read_audio(source) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE or FLAC, told apart by the ``fLaC`` magic; the return
    contract of :func:`read_wav`. ``source``: path, file object or
    bytes."""
    if isinstance(source, (bytes, bytearray)):
        data = source
    elif hasattr(source, "read"):
        data = source.read()
    else:
        with open(source, "rb") as f:
            data = f.read()
    if bytes(data[:4]) == b"fLaC":
        from wenet_celoss_tpu_torch.data.flac import read_flac
        return read_flac(data)
    return read_wav(data)
