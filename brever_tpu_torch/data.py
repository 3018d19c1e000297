"""Host-side data pipeline: datasets, tar access, padded collation
(counterpart of ``brever_tpu/data.py``).

Dataset layout as the JAX package writes it: ``audio/{i:05d}_{source}.flac``
(``scripts/create_dataset.py``'s default) or ``.wav`` (``--format wav``)
inside a directory or an ``audio.tar`` archive, read through
``audio.read_audio``. Dynamic mixing and preloading onto a device raise
``NotImplementedError`` (ROADMAP.md, Queue 1). Batches are numpy ``(batch, lengths)`` pairs padded to the batch
maximum, rounded up to ``pad_to_multiple``; moving them to the device is
the trainer's job.
"""

import logging
import os
import random
import re
import tarfile
import threading

import numpy as np

from .audio import audio_frames, read_audio


def _not_ported(what):
    return NotImplementedError(f'{what} is not ported yet (ROADMAP.md, '
                               'Queue 1)')


class BreverDataset:
    """Reads segments of multi-source audio from a created dataset.

    The parameters are those of ``brever_tpu.data.BreverDataset``: segment
    strategies ``drop``/``pass``/``pad``/``overlap``/``random``,
    ``max_segment_length`` auto-split, tar or directory storage and an
    optional per-item ``transform``.
    """

    def __init__(
        self,
        path: str,
        segment_length: float = 0.0,
        overlap_length: float = 0.0,
        fs: int = 16000,
        sources: list[str] = ['mixture', 'foreground'],
        segment_strategy: str = 'pass',
        max_segment_length: float = 0.0,
        tar: bool = True,
        transform=None,
        dynamic_mixing: bool = False,
        dynamic_mixtures_per_epoch: int = 1000,
        dynamic_mixing_device: bool = False,
    ):
        if dynamic_mixing:
            raise _not_ported('dynamic mixing')
        self.path = path
        self.segment_length = round(segment_length * fs)
        self.overlap_length = round(overlap_length * fs)
        self.fs = fs
        self.sources = sources
        self.segment_strategy = segment_strategy
        self.max_segment_length = round(max_segment_length * fs)
        self.archive = TarArchive(os.path.join(path, 'audio.tar')) \
            if tar else None
        self.rmm_dset = None
        self.transform = transform
        self.preloaded_data = None
        self._ext = None
        self.get_segment_info()

    # ------------------------------------------------------------------
    # segment bookkeeping

    def get_segment_info(self):
        file_lengths = self.get_file_lengths()
        if self.segment_length == 0 and self.max_segment_length != 0:
            if max(file_lengths) > self.max_segment_length:
                logging.warning(
                    'Found a file longer than max_segment_length. Setting '
                    f'segment_length to max_segment_length '
                    f'({self.max_segment_length}).')
                self.segment_length = self.max_segment_length
        self._segment_info = []
        if self.segment_length == 0:
            for file_idx, n in enumerate(file_lengths):
                self._segment_info.append((file_idx, (0, n)))
        else:
            for file_idx, n in enumerate(file_lengths):
                self._add_segment_info(file_idx, n)
        self._effective_duration = sum(
            end - start for _, (start, end) in self._segment_info) / self.fs

    def _add_segment_info(self, file_idx, file_length):
        strategy = self.segment_strategy
        if strategy == 'random':
            self._segment_info.append(
                (file_idx, (0, max(file_length, self.segment_length))))
            return
        hop = self.segment_length - self.overlap_length
        n_segments = (file_length - self.segment_length) // hop + 1
        end = 0  # stays 0 when the file is shorter than one segment
        for i in range(n_segments):
            start = i * hop
            end = start + self.segment_length
            self._segment_info.append((file_idx, (start, end)))
        if end == file_length:
            return
        if strategy == 'drop':
            pass
        elif strategy == 'pass':
            self._segment_info.append(
                (file_idx, (n_segments * hop, file_length)))
        elif strategy == 'pad':
            start = n_segments * hop
            self._segment_info.append(
                (file_idx, (start, start + self.segment_length)))
        elif strategy == 'overlap':
            self._segment_info.append(
                (file_idx, (file_length - self.segment_length, file_length)))
        else:
            raise ValueError(
                f'unrecognized segment strategy, got {strategy}')

    def get_file_lengths(self):
        n_files = self.count_files()
        file_lengths = []
        logging.info('Reading file lengths...')
        for file_idx in range(n_files):
            lengths = []
            for p in self.build_paths(file_idx):
                with self.get_file(p) as f:
                    lengths.append(audio_frames(f, p))
            if len(set(lengths)) > 1:
                raise ValueError(
                    f'sources {file_idx} do not all have the same length')
            file_lengths.append(lengths[0])
        self._duration = sum(file_lengths) / self.fs
        return file_lengths

    def count_files(self):
        if self.archive is None:
            files = [f'audio/{f}'
                     for f in os.listdir(os.path.join(self.path, 'audio'))]
        else:
            files = self.archive.members
        matches = [re.match(r'audio/(\d+)_(.+)(\.\w+)$', f) for f in files]
        matches = [m for m in matches if m]
        if not matches:
            raise ValueError(f'no audio files found in {self.path}')
        self._ext = matches[0].group(3)
        return max(int(m.group(1)) for m in matches) + 1

    def build_paths(self, file_idx):
        return [os.path.join('audio', f'{file_idx:05d}_{source}{self._ext}')
                for source in self.sources]

    def get_file(self, name):
        if self.archive is None:
            return open(os.path.join(self.path, name), 'rb')
        return self.archive.get_file(name.replace('\\', '/'))

    # ------------------------------------------------------------------
    # item access

    def __getitem__(self, index):
        if self.preloaded_data is not None:
            return self.preloaded_data[index]
        sources = self.load_segment(index)
        if self.transform is not None:
            sources = self.transform(sources)
        return sources

    def load_segment(self, index):
        file_idx, (start, end) = self._segment_info[index]
        if self.segment_strategy == 'random' and self.segment_length != 0:
            start = random.randint(start, end - self.segment_length)
            end = start + self.segment_length
        sources = np.stack([self.load_file(p)
                            for p in self.build_paths(file_idx)])
        if sources.ndim == 2:
            sources = sources[:, None, :]  # mono -> (sources, 1, samples)
        else:
            sources = sources.transpose(0, 2, 1)  # -> (sources, ch, samples)
        if end > sources.shape[-1]:
            if self.segment_strategy not in ('pad', 'random'):
                raise ValueError(
                    'attempting to load a segment outside of file range but '
                    "segment strategy is not in ['pad', 'random'], got "
                    f'{self.segment_strategy}')
            pad = end - sources.shape[-1]
            sources = np.pad(sources, ((0, 0), (0, 0), (0, pad)))
        return np.ascontiguousarray(sources[..., start:end])

    def load_file(self, path):
        with self.get_file(path) as f:
            x, fs = read_audio(f, path)
        if fs != self.fs:
            raise ValueError(
                'file sampling rate does not match dataset fs attribute, '
                f'got {fs} and {self.fs}')
        return x.astype('float32')

    def __len__(self):
        return len(self._segment_info)

    def get_segment_length(self, i):
        """Sample length of item ``i`` (segment length for 'random')."""
        if self.segment_strategy == 'random':
            return self.segment_length
        _, (start, end) = self._segment_info[i]
        return end - start

    def get_max_segment_length(self):
        if self.segment_strategy == 'random':
            return self.segment_length
        return max(end - start for _, (start, end) in self._segment_info)

    def preload(self, device=None, tqdm_desc=None):
        """Materialise every item in host memory."""
        if device is not None:
            raise _not_ported('preloading a dataset onto a device')
        if self.segment_strategy == 'random':
            raise ValueError(
                "can't preload when segment_strategy is 'random'")
        self.preloaded_data = [self[i] for i in range(len(self))]

    def set_epoch(self, epoch):
        pass


class TarArchive:
    """Thread-safe tar access: one ``tarfile`` handle per thread."""

    def __init__(self, archive):
        self.archive = archive
        self._local = threading.local()
        with tarfile.open(archive) as tar:
            self.members = {m.name: m for m in tar.getmembers()}

    def _handle(self):
        if not hasattr(self._local, 'tar'):
            self._local.tar = tarfile.open(self.archive)
        return self._local.tar

    def get_file(self, name):
        return self._handle().extractfile(self.members[name])


def collate(items, pad_to_multiple=None):
    """Pad variable-length items into batch arrays.

    ``items``: list of arrays or tuples of arrays; last dim is time.
    Pads every array to the batch max along the last dim, rounded up to a
    multiple of ``pad_to_multiple`` when given. Returns ``(batched,
    lengths)`` with ``lengths[i, j]`` the original last-dim length of
    input ``j`` of item ``i`` (squeezed when items are single arrays).
    """
    tensors_in = not isinstance(items[0], (tuple, list))
    items = [(x,) if tensors_in else x for x in items]
    lengths = np.array(
        [[np.shape(x)[-1] for x in item] for item in items], dtype=np.int32)
    max_lengths = lengths.max(axis=0)
    if pad_to_multiple:
        max_lengths = (
            (max_lengths + pad_to_multiple - 1) // pad_to_multiple
        ) * pad_to_multiple
    batched = []
    for j, target in enumerate(max_lengths):
        stack = []
        for item in items:
            x = np.asarray(item[j])
            pad = int(target) - x.shape[-1]
            if pad:
                widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
                x = np.pad(x, widths)
            stack.append(x)
        batched.append(np.stack(stack))
    if tensors_in:
        return batched[0], lengths[:, 0]
    return batched, lengths


class BreverDataLoader:
    """Iterates sampler batches and collates them; yields numpy
    ``(batch, lengths)`` pairs. ``num_workers`` above 0 loads the items
    of a batch with a thread pool, in order."""

    def __init__(self, dataset, batch_sampler, num_workers=0,
                 pad_to_multiple=None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = num_workers
        self.pad_to_multiple = pad_to_multiple
        self._pool = None
        if num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def set_epoch(self, epoch):
        self.batch_sampler.set_epoch(epoch)
        self.dataset.set_epoch(epoch)

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        for indices in self.batch_sampler:
            if self._pool is not None:
                items = list(self._pool.map(self.dataset.__getitem__,
                                            indices))
            else:
                items = [self.dataset[i] for i in indices]
            yield collate(items, self.pad_to_multiple)
