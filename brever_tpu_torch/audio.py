"""Audio files over numpy (counterpart of ``brever_tpu/audio.py``): what
the HTTP service reads and writes and the datasets are read from.

WAV: reads PCM16/PCM24/PCM32 and 32-bit float WAV (also
WAVE_FORMAT_EXTENSIBLE) as float32; writes 32-bit float WAV, lossless for
float32 pipelines. FLAC (``scripts/create_dataset.py``'s default): the
port's own codec, :mod:`.flac`, read as float32 in [-1, 1) and written as
16-bit. :func:`read_audio`, :func:`write_audio` and :func:`audio_frames`
pick the codec from the file name's extension, as the JAX package's
``read_audio``/``write_audio``/``audio_info`` do without ``soundfile``.
"""

import io
import os
import struct

import numpy as np

from . import flac

_PCM = 0x0001
_IEEE_FLOAT = 0x0003
_EXTENSIBLE = 0xFFFE


def _parse_header(f):
    """RIFF chunks up to 'data' -> (fmt dict, data size); ``f`` is then
    at the first sample."""
    head = f.read(12)
    if len(head) < 12:
        raise ValueError('truncated WAV header')
    riff, _, wave = struct.unpack('<4sI4s', head)
    if riff != b'RIFF' or wave != b'WAVE':
        raise ValueError('not a RIFF/WAVE file')
    fmt = None
    while True:
        header = f.read(8)
        if len(header) < 8:
            raise ValueError('no data chunk found in WAV file')
        chunk_id, size = struct.unpack('<4sI', header)
        if chunk_id == b'fmt ':
            payload = f.read(size)
            if len(payload) < 16:
                raise ValueError('truncated WAV fmt chunk')
            tag, channels, samplerate, _, block_align, bits = \
                struct.unpack('<HHIIHH', payload[:16])
            if tag == _EXTENSIBLE and len(payload) >= 26:
                tag = struct.unpack('<H', payload[24:26])[0]
            if channels == 0 or block_align == 0:
                raise ValueError('WAV fmt chunk has no channels')
            fmt = dict(tag=tag, channels=channels, samplerate=samplerate,
                       block_align=block_align, bits=bits)
            if size % 2:
                f.read(1)
        elif chunk_id == b'data':
            if fmt is None:
                raise ValueError('data chunk before fmt chunk')
            return fmt, size
        else:
            f.seek(size + (size % 2), io.SEEK_CUR)


def _decode(raw, fmt):
    bits, tag = fmt['bits'], fmt['tag']
    if tag == _IEEE_FLOAT and bits == 32:
        data = np.frombuffer(raw, '<f4').astype(np.float32)
    elif tag == _PCM and bits == 16:
        data = np.frombuffer(raw, '<i2').astype(np.float32) / 32768.0
    elif tag == _PCM and bits == 32:
        data = np.frombuffer(raw, '<i4').astype(np.float32) / 2147483648.0
    elif tag == _PCM and bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        vals = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f'unsupported WAV format: tag={tag} bits={bits}')
    return data.reshape(-1, fmt['channels'])


def wav_frames(f):
    """Number of frames of a WAV file object, read from its header."""
    fmt, size = _parse_header(f)
    return size // fmt['block_align']


def read_wav(f, always_2d=False):
    """A WAV file object -> ``(data, samplerate)``, float32 data of shape
    ``(n, channels)``, or ``(n,)`` for mono unless ``always_2d``."""
    fmt, size = _parse_header(f)
    frames = size // fmt['block_align']
    data = _decode(f.read(frames * fmt['block_align']), fmt)
    if fmt['channels'] == 1 and not always_2d:
        data = data[:, 0]
    return data, fmt['samplerate']


def write_wav(f, data, samplerate):
    """Write ``(n,)`` or ``(n, channels)`` data to a binary file object
    as 32-bit float WAV."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    channels = data.shape[1]
    payload = data.astype('<f4').tobytes()
    block_align = 4 * channels
    f.write(struct.pack(
        '<4sI4s4sIHHIIHH4sI', b'RIFF', 36 + len(payload), b'WAVE', b'fmt ',
        16, _IEEE_FLOAT, channels, int(samplerate),
        int(samplerate) * block_align, block_align, 32, b'data',
        len(payload)))
    f.write(payload)


def read_flac(f, always_2d=False):
    """A FLAC file object -> ``(data, samplerate)``: float32 in [-1, 1),
    the samples over ``2 ** (bps - 1)``, shaped as :func:`read_wav`'s."""
    samples, info = flac.decode(f.read())
    data = samples.astype(np.float32) / float(1 << (info['bps'] - 1))
    if data.shape[1] == 1 and not always_2d:
        data = data[:, 0]
    return data, info['sample_rate']


def write_flac(f, data, samplerate):
    """Write ``(n,)`` or ``(n, channels)`` float or int16 data to a binary
    file object as 16-bit FLAC (floats rounded from [-1, 1) and clipped)."""
    data = np.asarray(data)
    if data.dtype.kind == 'f':
        data = np.clip(np.round(data * 32768.0), -32768, 32767) \
            .astype(np.int16)
    f.write(flac.encode(data, int(samplerate)))


def flac_frames(f):
    """Number of frames of a FLAC file object, from its STREAMINFO (read
    through a window that grows until the metadata chain fits)."""
    n = 64 * 1024
    while True:
        pos = f.tell()
        buf = f.read(n)
        f.seek(pos)
        try:
            return flac.parse_header(buf)[0]['total_samples']
        except flac.FlacError as e:
            if 'truncated' in str(e) and len(buf) == n:
                n *= 4
                continue
            raise


_CODECS = {'.wav': (read_wav, write_wav, wav_frames),
           '.flac': (read_flac, write_flac, flac_frames)}


def _codec(name):
    ext = os.path.splitext(str(name))[1].lower()
    if ext not in _CODECS:
        raise RuntimeError(f"cannot read or write '{ext}' audio: only .wav "
                           'and .flac are supported')
    return _CODECS[ext]


def read_audio(f, name, always_2d=False):
    """:func:`read_wav` or :func:`read_flac` of a file object, by the
    extension of ``name``."""
    return _codec(name)[0](f, always_2d=always_2d)


def write_audio(f, data, samplerate, name):
    """:func:`write_wav` or :func:`write_flac` into a file object, by the
    extension of ``name``."""
    _codec(name)[1](f, data, samplerate)


def audio_frames(f, name):
    """Number of frames of a WAV or FLAC file object, by the extension of
    ``name``."""
    return _codec(name)[2](f)
