"""The port's FLAC codec (brever_tpu_torch.flac) and FLAC datasets against
the JAX package's: the encoder's bytes equal ``brever_tpu.flac.encode``'s on
seeded signals (mono and stereo, odd lengths, silence, full scale, 8 and
16 kHz, a stream past 128 frames, whose frame numbers take two UTF-8
bytes), the decoder's samples and stream info equal
``brever_tpu.flac.decode``'s (with ``max_frames`` too), a truncated or
corrupt stream raises ``FlacError`` in both, and a FLAC ``audio.tar`` or
``audio/`` directory written with the port's encoder loads through the
port's dataset with the JAX ``BreverDataset``'s items."""

import io
import os
import tarfile

import numpy as np
import pytest
import scipy.signal

from brever_tpu import data as jax_data
from brever_tpu import flac as jax_flac
from brever_tpu_torch import audio, data, flac

FS = 16000


def _signal(kind, n, channels, seed=0):
    rng = np.random.RandomState(seed)
    if kind == 'silence':
        x = np.zeros((n, channels))
    elif kind == 'full_scale':
        x = np.where(rng.rand(n, channels) < 0.5, -32768, 32767)
    elif kind == 'noise':
        x = rng.randint(-32768, 32768, size=(n, channels))
    else:   # speech-like: an AR(1) process, which LPC predicts
        x = scipy.signal.lfilter([1], [1, -0.9], rng.randn(n, channels),
                                 axis=0) * 3000
    x = np.asarray(x).astype(np.int16)
    return x[:, 0] if channels == 1 else x


CASES = [
    ('speech', 30001, 2, 16000),
    ('speech', 12345, 1, 8000),
    ('speech', 4096, 2, 8000),
    ('speech', 1, 1, 16000),
    ('silence', 9001, 2, 16000),
    ('full_scale', 5003, 1, 16000),
    ('full_scale', 4097, 2, 8000),
    ('noise', 7777, 2, 16000),
    ('speech', 129 * 4096 + 17, 1, 8000),
]
IDS = [f'{k}-{n}-{c}ch-{fs // 1000}k' for k, n, c, fs in CASES]


@pytest.mark.parametrize('kind,n,channels,fs', CASES, ids=IDS)
def test_encoder_bytes_and_decoder_match_jax(kind, n, channels, fs):
    x = _signal(kind, n, channels)
    stream = flac.encode(x, fs)
    assert stream == jax_flac.encode(x, fs)
    got, info = flac.decode(stream)
    want, want_info = jax_flac.decode(stream)
    assert got.dtype == want.dtype and info == want_info
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.reshape(n, channels))
    assert flac.parse_header(stream) == jax_flac.parse_header(stream)
    for max_frames in (1, n // 3 + 1, 4096, n + 10):
        part, _ = flac.decode(stream, max_frames=max_frames)
        ref, _ = jax_flac.decode(stream, max_frames=max_frames)
        np.testing.assert_array_equal(part, ref)


@pytest.mark.parametrize('cut', ['header', 'streaminfo', 'frame', 'sync',
                                 'magic'])
def test_bad_streams_raise_in_both(cut):
    stream = flac.encode(_signal('speech', 9000, 2), FS)
    bad = {'header': stream[:6], 'streaminfo': stream[:20],
           'frame': stream[:200],
           'sync': stream[:42] + bytes([stream[42] ^ 0xFF]) + stream[43:],
           'magic': b'fLaX' + stream[4:]}[cut]
    for codec in (flac, jax_flac):
        with pytest.raises(codec.FlacError):
            codec.decode(bad)


def test_audio_dispatches_on_the_extension():
    x = np.random.RandomState(3).uniform(-1, 1, (3000, 2)).astype(np.float32)
    buf = io.BytesIO()
    audio.write_audio(buf, x, FS, 'a.flac')
    assert buf.getvalue() == jax_flac.encode(
        np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16), FS)
    buf.seek(0)
    assert audio.audio_frames(buf, 'a.flac') == 3000 and buf.tell() == 0
    got, fs = audio.read_audio(buf, 'a.flac')
    assert fs == FS and got.dtype == np.float32 and got.shape == (3000, 2)
    np.testing.assert_allclose(got, x, atol=1 / 32768)
    buf.seek(0)
    mono, _ = audio.read_audio(io.BytesIO(flac.encode(
        np.arange(100, dtype=np.int16), FS)), 'b.FLAC')
    assert mono.shape == (100,)
    wav = io.BytesIO()
    audio.write_audio(wav, x, FS, 'a.wav')
    wav.seek(0)
    np.testing.assert_array_equal(audio.read_audio(wav, 'a.wav')[0], x)
    with pytest.raises(RuntimeError, match='.ogg'):
        audio.read_audio(buf, 'a.ogg')


def write_flac_dataset(path, lengths, tar=True, seed=0):
    """A dataset as scripts/create_dataset.py writes it by default:
    ``audio/{i:05d}_{source}.flac``, two channels, in ``audio.tar`` or a
    directory, written with the port's encoder. The foreground is a tone,
    the mixture it plus noise."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(path, 'audio'), exist_ok=True)
    archive = tarfile.open(os.path.join(path, 'audio.tar'), 'w') \
        if tar else None
    for i, n in enumerate(lengths):
        t = np.arange(n) / FS
        clean = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
        items = {'foreground': clean, 'mixture': clean + 0.3 * rng.randn(n)}
        for source, signal in items.items():
            x = np.stack([signal] * 2, axis=1).astype(np.float32)
            name = f'audio/{i:05d}_{source}.flac'
            buf = io.BytesIO()
            audio.write_audio(buf, x, FS, name)
            if archive is None:
                with open(os.path.join(path, name), 'wb') as f:
                    f.write(buf.getvalue())
                continue
            info = tarfile.TarInfo(name)
            info.size = buf.tell()
            buf.seek(0)
            archive.addfile(info, buf)
    if archive is not None:
        archive.close()
    return path


@pytest.mark.parametrize('tar', [True, False], ids=['tar', 'directory'])
@pytest.mark.parametrize('strategy,segment', [('pass', 0.0), ('pass', 0.2),
                                              ('pad', 0.3), ('drop', 0.25)])
def test_flac_dataset_matches_jax(tmp_path, tar, strategy, segment):
    path = write_flac_dataset(str(tmp_path / 'flac'), [4000, 6001, 2500],
                              tar=tar)
    kwargs = dict(tar=tar, segment_length=segment, segment_strategy=strategy)
    got = data.BreverDataset(path, **kwargs)
    want = jax_data.BreverDataset(path, **kwargs)
    assert len(got) == len(want) and got._duration == want._duration
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
        assert got[i].dtype == np.float32
