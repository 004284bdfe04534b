"""Triplet dataset (numpy copy of feat3dnet_tpu/data/datagenerator.py).

Metadata lines `fname | positives | nonnegatives`; per triplet the positive
is drawn uniformly from the anchor's positives and the negative uniformly
from the clouds outside positives and nonnegatives; per cloud a crop to a
20 m radius around the origin, then a random downsample without
replacement to num_points, or duplicate-padding with random resampling.
Epoch e's order is `RandomState((seed, e)).permutation`, sliced per shard.

Two readers, as in the JAX package, each bit-equal to its JAX branch:
`use_native="auto"` (the default) takes the native C++ reader
(utils/native.py: every cloud of a batch read, cropped and resampled on
host threads, with a seed per cloud drawn from the epoch's RandomState)
when it builds, else numpy; True, "true" or "yes" takes the native reader
and raises if it cannot be built; anything else takes numpy. The two draw
different resamples: the same command trains on different clouds with
either reader. `use_native` after construction says which one runs.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Callable, Iterator, List, Optional, Set, Tuple

import numpy as np

from feat3dnet_tpu_torch.data.io import load_point_cloud
from feat3dnet_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TripletMetadata:
    fname: str
    positives: Set[int]
    nonnegatives: Set[int]


def parse_metadata(path: str) -> List[TripletMetadata]:
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            fname, pos, nonneg = [p.strip() for p in line.split("|")]
            out.append(TripletMetadata(fname=fname,
                                       positives={int(s) for s in pos.split()},
                                       nonnegatives={int(s) for s in nonneg.split()}))
    return out


class TripletDataset:
    """Seeded triplet sampler over a train.txt metadata file."""

    def __init__(self, metadata_file: str, num_cols: int = 6, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1, use_native="auto"):
        from feat3dnet_tpu_torch.utils import native

        self.folder = os.path.split(metadata_file)[0]
        self.meta = parse_metadata(metadata_file)
        self.num_cols = num_cols
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        if use_native == "auto":
            self.use_native = native.native_available()
        else:
            self.use_native = use_native in (True, "true", "yes")
            if self.use_native:
                native.library()          # raises where the reader cannot be built
        self.size = len(self.meta)
        # each anchor's negative pool: the complement of positives | nonnegatives
        self._neg_pool = [np.array([i for i in range(self.size)
                                    if i not in m.positives | m.nonnegatives], dtype=np.int64)
                          for m in self.meta]

    def epoch_order(self, epoch: int) -> np.ndarray:
        """Deterministic global permutation for this epoch, sliced per shard."""
        order = np.random.RandomState((self.seed, epoch)).permutation(self.size)
        return order[self.shard_index::self.num_shards]

    def sample_triplet_indices(self, anchor: int, rng: np.random.RandomState
                               ) -> Tuple[int, int]:
        positives = sorted(self.meta[anchor].positives)
        positive = positives[rng.randint(len(positives))]
        pool = self._neg_pool[anchor]
        return positive, int(pool[rng.randint(len(pool))])

    def load_processed(self, i: int, num_points: int, rng: np.random.RandomState,
                       crop_radius: float = 20.0) -> np.ndarray:
        cloud = load_point_cloud(os.path.join(self.folder, self.meta[i].fname),
                                 num_cols=self.num_cols)
        return crop_and_resample(cloud, num_points, rng, crop_radius)

    def epoch_triplets(self, epoch: int, batch_size: int, num_points: int,
                       crop_radius: float = 20.0
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(anchors, positives, negatives) batches of (batch_size, num_points,
        num_cols); the ragged tail is dropped."""
        order = self.epoch_order(epoch)
        rng = np.random.RandomState((self.seed, epoch, self.shard_index, 0xA5))
        if self.use_native:
            from feat3dnet_tpu_torch.utils.native import load_processed_batch

            for start in range(0, len(order) - batch_size + 1, batch_size):
                ids = []
                for anchor in order[start:start + batch_size]:
                    pos, neg = self.sample_triplet_indices(int(anchor), rng)
                    ids.extend((int(anchor), pos, neg))
                paths = [os.path.join(self.folder, self.meta[i].fname) for i in ids]
                seeds = [int(rng.randint(0, 2**31)) for _ in ids]
                flat = load_processed_batch(paths, self.num_cols, crop_radius, num_points,
                                            seeds).reshape(batch_size, 3, num_points,
                                                           self.num_cols)
                yield flat[:, 0], flat[:, 1], flat[:, 2]
            return
        batch_a, batch_p, batch_n = [], [], []
        for anchor in order:
            pos, neg = self.sample_triplet_indices(int(anchor), rng)
            batch_a.append(self.load_processed(int(anchor), num_points, rng, crop_radius))
            batch_p.append(self.load_processed(pos, num_points, rng, crop_radius))
            batch_n.append(self.load_processed(neg, num_points, rng, crop_radius))
            if len(batch_a) == batch_size:
                yield np.stack(batch_a), np.stack(batch_p), np.stack(batch_n)
                batch_a, batch_p, batch_n = [], [], []


def crop_and_resample(cloud: np.ndarray, num_points: int, rng: np.random.RandomState,
                      crop_radius: float = 20.0) -> np.ndarray:
    """Crop to the radius, then an exact-size random resample."""
    cloud = cloud[np.sum(np.square(cloud[:, :3]), axis=1) <= crop_radius * crop_radius]
    n = cloud.shape[0]
    if n == 0:
        raise ValueError("empty cloud after crop")
    if n <= num_points:
        return np.concatenate([cloud, cloud[rng.choice(n, size=num_points - n, replace=True)]])
    return cloud[rng.choice(n, size=num_points, replace=False)]


def prefetch(iterator: Iterator, depth: int = 2,
             transform: Optional[Callable] = None) -> Iterator:
    """Run `iterator` (and `transform` on each item, e.g. the host-to-device
    copy) in a background thread, `depth` items ahead. Under a profiler the
    worker's `transform` of each item shows as the span `f3d.data.upload`
    and the consumer's wait for an item as `f3d.data.wait`."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in iterator:
                if transform is not None:
                    with span("f3d.data.upload"):
                        item = transform(item)
                q.put(item)
        except BaseException as e:  # handed to the consumer, which re-raises it
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        with span("f3d.data.wait"):
            item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
