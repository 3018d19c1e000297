"""The port's data pipeline (brever_tpu_torch.data, .batching) against the
JAX package's on WAV datasets written in its layout (``audio.tar`` or an
``audio/`` directory): the same items for every segment strategy, the
same collated batches, the same batches from every sampler for the same
seed and epoch."""

import io
import os
import tarfile

import numpy as np
import pytest

from brever_tpu import batching as jax_batching
from brever_tpu import data as jax_data
from brever_tpu.audio import write_audio
from brever_tpu_torch import batching, data

FS = 16000


def write_wav_dataset(path, lengths, tar=True, seed=0, sources=('mixture',
                                                               'foreground')):
    """A dataset as scripts/create_dataset.py writes it with --format wav:
    ``audio/{i:05d}_{source}.wav``, two channels, in ``audio.tar`` or a
    directory. The foreground is a tone, the mixture it plus noise."""
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    archive = tarfile.open(os.path.join(path, 'audio.tar'), 'w') \
        if tar else None
    if not tar:
        os.makedirs(os.path.join(path, 'audio'))
    for i, n in enumerate(lengths):
        t = np.arange(n) / FS
        clean = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
        items = {'foreground': clean, 'mixture': clean + 0.3 * rng.randn(n)}
        for source in sources:
            x = np.stack([items[source]] * 2, axis=1).astype(np.float32)
            name = f'audio/{i:05d}_{source}.wav'
            if archive is None:
                write_audio(os.path.join(path, name), x, FS, name=name)
                continue
            buf = io.BytesIO()
            write_audio(buf, x, FS, name=name)
            info = tarfile.TarInfo(name)
            info.size = buf.tell()
            buf.seek(0)
            archive.addfile(info, buf)
    if archive is not None:
        archive.close()
    return path


LENGTHS = [8000, 12345, 4000, 16000, 9999, 7001]


@pytest.fixture(scope='module', params=[True, False], ids=['tar', 'dir'])
def dataset_dir(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp('dset'))
    return write_wav_dataset(path, LENGTHS, tar=request.param), request.param


@pytest.mark.parametrize('strategy,segment,overlap', [
    ('pass', 0.0, 0.0), ('pass', 0.3, 0.0), ('drop', 0.3, 0.1),
    ('pad', 0.3, 0.0), ('overlap', 0.3, 0.0)])
def test_items_match_jax(dataset_dir, strategy, segment, overlap):
    path, tar = dataset_dir
    kwargs = dict(segment_length=segment, overlap_length=overlap,
                  segment_strategy=strategy, tar=tar)
    ref = jax_data.BreverDataset(path, **kwargs)
    got = data.BreverDataset(path, **kwargs)
    assert len(got) == len(ref)
    assert got._duration == ref._duration
    assert got.get_max_segment_length() == ref.get_max_segment_length()
    for i in range(len(ref)):
        assert got.get_segment_length(i) == ref.get_segment_length(i)
        np.testing.assert_array_equal(got[i], ref[i])


@pytest.mark.parametrize('workers', [0, 2])
@pytest.mark.parametrize('pad', [None, 8000])
def test_loader_and_collate_match_jax(dataset_dir, workers, pad):
    path, tar = dataset_dir
    ref_ds = jax_data.BreverDataset(path, tar=tar)
    got_ds = data.BreverDataset(path, tar=tar)
    ref = jax_data.BreverDataLoader(
        ref_ds, jax_batching.BatchSamplerRegistry.get('sorted')(
            ref_ds, batch_size=2), pad_to_multiple=pad)
    got = data.BreverDataLoader(
        got_ds, batching.BatchSamplerRegistry.get('sorted')(
            got_ds, batch_size=2), num_workers=workers, pad_to_multiple=pad)
    for loader in (ref, got):
        loader.set_epoch(0)
    pairs = list(zip(got, ref))
    assert len(pairs) == len(ref) == 3
    for (batch, lengths), (ref_batch, ref_lengths) in pairs:
        np.testing.assert_array_equal(batch, ref_batch)
        np.testing.assert_array_equal(lengths, ref_lengths)
    # tuples of arrays collate per input
    items = [(np.ones((2, n)), np.ones(n // 2)) for n in (5, 9)]
    for got_x, ref_x in zip(data.collate(items, 4),
                            jax_data.collate(items, 4)):
        for a, b in zip(got_x, ref_x):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name,kwargs', [
    ('random', dict(batch_size=2)),
    ('sorted', dict(batch_size=2)),
    ('bucket', dict(batch_size=2, num_buckets=3)),
    ('random', dict(batch_size=1.5, dynamic=True)),
    ('bucket', dict(batch_size=2.0, dynamic=True, num_buckets=2)),
])
def test_samplers_match_jax(dataset_dir, name, kwargs):
    path, tar = dataset_dir
    ds = data.BreverDataset(path, tar=tar)
    ref = jax_batching.BatchSamplerRegistry.get(name)(ds, seed=3, **kwargs)
    got = batching.BatchSamplerRegistry.get(name)(ds, seed=3, **kwargs)
    for epoch in (0, 1, 5):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        assert list(got) == list(ref)
        assert len(got) == len(ref)


def test_what_the_port_refuses(tmp_path):
    """FLAC items load (tests/test_torch_flac.py holds them against the
    JAX package); an item in any other format, dynamic mixing and
    preloading onto a device are refused."""
    path = str(tmp_path / 'flac')
    os.makedirs(os.path.join(path, 'audio'))
    write_audio(os.path.join(path, 'audio', '00000_mixture.flac'),
                np.zeros((160, 2), np.float32), FS,
                name='00000_mixture.flac')
    ds = data.BreverDataset(path, tar=False, sources=['mixture'])
    assert ds[0].shape == (1, 2, 160)
    path = str(tmp_path / 'ogg')
    os.makedirs(os.path.join(path, 'audio'))
    with open(os.path.join(path, 'audio', '00000_mixture.ogg'), 'wb') as f:
        f.write(b'OggS')
    with pytest.raises(RuntimeError, match='.ogg'):
        data.BreverDataset(path, tar=False)
    wav = write_wav_dataset(str(tmp_path / 'wav'), [800])
    with pytest.raises(NotImplementedError, match='dynamic mixing'):
        data.BreverDataset(wav, dynamic_mixing=True)
    ds = data.BreverDataset(wav)
    with pytest.raises(NotImplementedError, match='device'):
        ds.preload(device='cuda')
    ds.preload()
    np.testing.assert_array_equal(ds[0], data.BreverDataset(wav)[0])
