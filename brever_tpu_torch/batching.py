"""Batch samplers: random / sorted / bucket (counterpart of
``brever_tpu/batching.py``, which imports no JAX at module level; the
same code, so the same batches come out for the same seed and epoch).

Epoch-seeded shuffling with a mandatory ``set_epoch`` before iteration,
*dynamic* batch sizes expressed as a total padded length budget in
seconds, and length bucketing. Sharding batches across processes
(``DistributedBatchSamplerWrapper``) waits for the port's DDP item
(ROADMAP.md, Queue 1).
"""

import logging
import random

import numpy as np

from .registry import Registry

BatchSamplerRegistry = Registry('batch_sampler')


class BreverBatchSampler:
    """Base sampler: generates lists of segment indices per batch.

    Subclasses implement ``_generate_batches(indices)`` returning a
    list of batches of ``(segment_idx, segment_length)`` pairs.

    Parameters
    ----------
    dataset : BreverDataset
    batch_size : int or float
        Segments per batch (``dynamic=False``) or total padded batch
        length in **seconds** (``dynamic=True``).
    drop_last, shuffle, seed, sort, fs, reverse : see reference.
    """

    def __init__(self, dataset, batch_size, drop_last=False, shuffle=True,
                 seed=0, dynamic=False, sort=False, fs=16000, reverse=False):
        self.dataset = dataset
        if dynamic:
            self.batch_size = round(fs * batch_size)
        else:
            if isinstance(batch_size, float):
                logging.warning('Got float batch_size even though dynamic '
                                'is False. Casting batch_size to int.')
            self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.dynamic = dynamic
        self.sort = sort
        self.reverse = reverse
        self._seed = random.Random(seed).randrange(2**32)
        self._epoch = 0
        self._previous_epoch = -1
        self._segment_lengths = None
        self._batches = None

    def __iter__(self):
        if self.shuffle:
            if self._epoch == self._previous_epoch:
                raise ValueError(
                    'the set_epoch method must be called before iterating '
                    'over the dataloader in order to regenerate the batches '
                    'with the correct seed')
            self.generate_batches()
            self.shuffle_batches()
            self._previous_epoch = self._epoch
        elif self._batches is None:
            self.generate_batches()
        for batch in self._batches:
            yield [idx for idx, _ in batch]

    def generate_batches(self):
        self._batches = self._generate_batches(self._generate_indices())

    def _generate_indices(self):
        self.get_segment_lengths()
        if self.sort:
            if self.shuffle:
                # stable length sort with shuffled ties
                rng = random.Random(self._seed + self._epoch)
                ordered = sorted(self._segment_lengths,
                                 key=lambda x: (x[1], rng.random()),
                                 reverse=self.reverse)
            else:
                ordered = sorted(self._segment_lengths, key=lambda x: x[1],
                                 reverse=self.reverse)
            return [idx for idx, _ in ordered]
        indices = list(range(len(self._segment_lengths)))
        if self.shuffle:
            random.Random(self._seed + self._epoch).shuffle(indices)
        return indices

    def get_segment_lengths(self):
        refresh = self._segment_lengths is None \
            or getattr(self.dataset, 'rmm_dset', None) is not None
        if refresh:
            self._segment_lengths = [
                (i, self.dataset.get_segment_length(i))
                for i in range(len(self.dataset))
            ]

    def _generate_batches(self, indices):
        raise NotImplementedError

    def set_epoch(self, epoch):
        self._epoch = epoch

    def shuffle_batches(self):
        random.Random(self._seed + self._epoch).shuffle(self._batches)

    def __len__(self):
        if self._batches is None:
            self.generate_batches()
        return len(self._batches)

    def calc_batch_stats(self, transform_length=None):
        """Total padded sizes and padding waste per batch."""
        if transform_length is None:
            def transform_length(x):
                return x
        batch_sizes, pad_amounts = [], []
        for batch in self._batches:
            lengths = [transform_length(n) for _, n in batch]
            max_length = max(lengths)
            batch_sizes.append(len(batch) * max_length)
            pad_amounts.append(sum(max_length - n for n in lengths))
        return batch_sizes, pad_amounts


class _SequentialBatchSampler(BreverBatchSampler):
    """Fill batches in index order until the size budget is exceeded."""

    def _generate_batches(self, indices):
        batches, batch = [], []
        for i in indices:
            seg_idx, seg_len = self._segment_lengths[i]
            if self._batch_full(batch, seg_len):
                batches.append(batch)
                batch = []
            batch.append((seg_idx, seg_len))
        if batch and not self.drop_last:
            batches.append(batch)
        return batches

    def _batch_full(self, batch, seg_len):
        if self.dynamic:
            if seg_len > self.batch_size:
                raise ValueError('got a segment that is longer than the '
                                 'dynamic batch size')
            current_max = max((n for _, n in batch), default=0)
            return (len(batch) + 1) * max(seg_len, current_max) \
                > self.batch_size
        return len(batch) + 1 > self.batch_size


@BatchSamplerRegistry.register('random')
class RandomBatchSampler(_SequentialBatchSampler):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, sort=False, **kwargs)


@BatchSamplerRegistry.register('sorted')
class SortedBatchSampler(_SequentialBatchSampler):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, sort=True, **kwargs)


@BatchSamplerRegistry.register('bucket')
class BucketBatchSampler(BreverBatchSampler):
    """Length-bucketed batching.

    ``num_buckets`` right limits are uniformly spaced up to the max
    segment length; batches are formed within buckets (dynamic bucket
    batch size = ``batch_size // right_limit``). With
    ``pad_to_bucket=True`` the loader can pad every batch to its
    bucket's right limit, giving at most ``num_buckets`` distinct XLA
    input shapes per source.
    """

    def __init__(self, *args, num_buckets=10, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_buckets = num_buckets

    def _generate_batches(self, indices):
        max_length = max(n for _, n in self._segment_lengths)
        right_limits = np.linspace(
            max_length / self.num_buckets, max_length, self.num_buckets)
        self.right_bucket_limits = right_limits  # exposed for testing

        if self.dynamic:
            bucket_sizes = self.batch_size // right_limits
        else:
            bucket_sizes = [self.batch_size] * self.num_buckets

        batches = []
        buckets = [[] for _ in range(self.num_buckets)]
        for i in indices:
            seg_idx, seg_len = self._segment_lengths[i]
            b = int(np.searchsorted(right_limits, seg_len))
            if not 0 <= b < self.num_buckets:
                raise ValueError('attempted to assign a segment to a '
                                 'non-existent bucket')
            buckets[b].append((seg_idx, seg_len))
            if len(buckets[b]) == bucket_sizes[b]:
                batches.append(buckets[b])
                buckets[b] = []
            elif len(buckets[b]) > bucket_sizes[b]:
                raise ValueError('maximum number of segments allowed in '
                                 'bucket exceeded')
        if not self.drop_last:
            batches.extend(batch for batch in buckets if batch)
        return batches
