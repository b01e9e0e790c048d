"""Host-side training data loader.

The port's copy of ``air_tpu/data/loader.py``: the train set lives in host
RAM, each epoch is a seeded permutation, and batches are assembled by a
prefetch thread (depth 2) and handed to ``device_put`` on the consumer's
thread (``to_device`` moves a numpy batch to a torch device).

Determinism & recovery: the shuffle for epoch ``e`` is ``PRNG(seed, e)``,
so the loader's position is fully described by ``(epoch, index)`` —
checkpoint those two ints and resume is exact. The native C++ backend
(air_tpu_torch.runtime) is chosen the way the JAX package chooses it
(whenever ``g++`` builds it), and both backends give the JAX package's
permutations for the same ``(seed, epoch)``.

``DeviceDataPipeline`` keeps the whole train set on the card for the
trainer's device-data loop and gathers each batch there through the same
epoch permutations, uploaded once per epoch.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

import torch

from air_tpu_torch.data.records import read_records, read_test_data


class TrainLoader:
    """Epoch-shuffled batch iterator with optional background prefetch.

    Yields (images [B, canvas^2] float32, digits [B] int32), through
    ``device_put`` when one is given. Drops the final partial batch
    (fixed-size batches, matching the reference's ``shuffle_batch``).
    """

    def __init__(self, path_or_arrays, batch_size: int, epochs: int | None = None,
                 seed: int = 0, prefetch: int = 2, device_put=None,
                 native: bool | None = None, reader_threads: int = 4):
        if isinstance(path_or_arrays, str):
            rec = read_records(path_or_arrays)
            self.images = np.asarray(rec["images"], np.float32)
            self.digits = np.asarray(rec["digits"], np.int32)
        else:
            images, digits = path_or_arrays
            self.images = np.asarray(images, np.float32).reshape(
                len(images), -1)
            self.digits = np.asarray(digits, np.int32)
        self.n = len(self.images)
        self.batch_size = batch_size
        if self.n < batch_size:
            # the final-partial-batch drop would yield ZERO batches per
            # epoch — downstream loops would spin without training (same
            # guard as fast_pipeline.DeviceDataPipeline)
            raise ValueError(
                f"dataset has {self.n} examples < batch_size {batch_size}: "
                f"no full batch can be formed")
        self.epochs = epochs
        self.seed = seed
        self.prefetch = prefetch
        self.device_put = device_put
        self.epoch = 0
        self.index = 0
        self._native = None
        if native or native is None:
            try:
                from air_tpu_torch.runtime import NativeShuffleLoader
                self._native = NativeShuffleLoader(
                    self.images, self.digits, batch_size, seed,
                    n_threads=reader_threads)
            except Exception:
                if native:
                    raise
                self._native = None

    @property
    def batches_per_epoch(self) -> int:
        return self.n // self.batch_size

    def state(self) -> dict:
        """Data-order state for exact checkpoint/resume. Records which
        permutation backend produced the order: the native C++ stream and
        the numpy stream are DIFFERENT permutations for the same (seed,
        epoch), so resuming under the other backend silently replays a
        different data order."""
        return {"epoch": self.epoch, "index": self.index, "seed": self.seed,
                "perm_backend": "native" if self._native else "numpy"}

    def restore(self, state: dict):
        self.epoch = int(state["epoch"])
        self.index = int(state["index"])
        self.seed = int(state["seed"])
        if self._native is not None:
            self._native.seed = self.seed
        saved = state.get("perm_backend")
        now = "native" if self._native else "numpy"
        if saved is not None and saved != now:
            import warnings
            warnings.warn(
                f"loader resumed under the '{now}' permutation backend but "
                f"was checkpointed under '{saved}': the data order will "
                f"differ from the original run (exact-resume is per-"
                f"backend)", stacklevel=2)

    def reseed(self, seed: int):
        """Fresh data order from the start (stall auto-recovery): rewind
        to epoch 0 and key future epoch permutations off ``seed`` — the
        native backend reads its seed per perm() call, so updating both
        attributes takes effect on the next epoch. NOTE: an already-
        running prefetch iterator holds its own local position and is not
        interrupted; reseed before (re)starting iteration."""
        self.seed = int(seed)
        self.epoch = 0
        self.index = 0
        if self._native is not None:
            self._native.seed = self.seed

    def _perm(self, epoch: int) -> np.ndarray:
        if self._native is not None:
            return self._native.perm(epoch)
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])).permutation(self.n)

    def _iter_host(self):
        """Yields ((images, digits), position) where ``position`` is the
        (epoch, index) AFTER this batch — i.e. the next batch to deliver.
        Works on LOCAL position variables so a prefetching producer thread
        never mutates the loader's consumed position (``state()`` must
        reflect what the consumer has actually received, not what the
        producer has staged ahead)."""
        epoch, index = self.epoch, self.index
        while self.epochs is None or epoch < self.epochs:
            perm = self._perm(epoch)
            bs = self.batch_size
            while index + bs <= self.n:
                sel = perm[index:index + bs]
                if self._native is not None:
                    batch = self._native.gather(sel)
                else:
                    batch = (self.images[sel], self.digits[sel])
                index += bs
                yield batch, (epoch, index)
            epoch += 1
            index = 0

    def __iter__(self):
        def emit(item):
            batch, (epoch, index) = item
            # consumed-position bookkeeping happens HERE, on the consumer
            # thread, exactly when the batch is handed over
            self.epoch, self.index = epoch, index
            return self.device_put(batch) if self.device_put else batch

        if self.prefetch <= 0:
            for item in self._iter_host():
                yield emit(item)
            return

        # The producer thread assembles HOST batches only (numpy + native
        # gather, GIL-released); device_put happens on the consumer thread,
        # where the copy to the card queues behind the in-flight step.
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            # bounded put so an abandoned iterator (consumer broke out of
            # its for-loop) releases the producer instead of leaking a
            # thread blocked on a full queue holding staged batches
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=1.0)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in self._iter_host():
                    if not put(item):
                        return
                put(stop)
            except BaseException as e:       # propagate to the consumer —
                if not put(e):               # a swallowed producer error
                    raise                    # would end training "cleanly";
                # (re-raise only if the consumer is gone, else threading's
                # excepthook double-logs an error the consumer will raise)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield emit(item)
        finally:
            abandoned.set()


def load_test_data(path: str, shift_zero_digits_images: bool = True):
    """Full test set as dense arrays (reference training.py:154-156 usage).
    Returns (images [N, canvas^2] float32, digits [N] int32)."""
    images, digits, *_ = read_test_data(
        path, shift_zero_digits_images=shift_zero_digits_images)
    return np.asarray(images, np.float32), np.asarray(digits, np.int32)


def to_device(device):
    """A ``device_put`` for TrainLoader: (images, digits) numpy -> float32
    and int32 tensors on ``device``."""
    def put(batch):
        images, digits = batch
        return (torch.from_numpy(np.asarray(images, np.float32)).to(device),
                torch.from_numpy(np.asarray(digits, np.int32)).to(device))
    return put


def gather_batch(images, digits, perm, index: int, batch_size: int,
                 out=None, offset: int = 0, rows: int | None = None):
    """Batch ``index`` of the permutation ``perm`` of the device-resident
    ``images`` and ``digits``; into the (images, digits) tensors ``out``
    when given. Past the last full batch the slice is clamped to it, as
    ``jax.lax.dynamic_slice`` clamps in the JAX package. ``offset`` and
    ``rows`` take rows ``[offset, offset + rows)`` of the batch (a data
    rank's part of it)."""
    lo = min(index * batch_size, len(images) - batch_size) + offset
    idx = perm[lo:lo + (batch_size if rows is None else rows)]
    if out is None:
        return images.index_select(0, idx), digits.index_select(0, idx)
    return (torch.index_select(images, 0, idx, out=out[0]),
            torch.index_select(digits, 0, idx, out=out[1]))


class DeviceDataPipeline:
    """The train set resident on ``device`` and the position of the
    trainer's device-data loop: the host ``TrainLoader``'s epoch
    permutations (native or numpy, as it chose), each uploaded once, and
    batches gathered on the device by ``index_select``.

    Counterpart of the JAX package's ``fast_pipeline.DeviceDataPipeline``,
    whose permutation comes from ``jax.random``; here it is the host
    loader's, so both loops of the port see the same data order for a seed.
    ``index`` counts batches within the epoch; ``state()`` gives it in
    examples, as the host loader's does.
    """

    def __init__(self, images, digits, batch_size: int, seed: int = 0,
                 device="cuda", native: bool | None = None):
        self.host = TrainLoader((images, digits), batch_size, seed=seed,
                                prefetch=0, native=native)
        self.n = self.host.n
        self.batch_size = batch_size
        self.batches_per_epoch = self.host.batches_per_epoch
        self.device = torch.device(device)
        self.images, self.digits = (
            torch.from_numpy(np.require(a, requirements="W")).to(self.device)
            for a in (self.host.images, self.host.digits))
        self.epoch = 0
        self.index = 0
        self._perm = None
        self._perm_key = None

    @property
    def seed(self) -> int:
        return self.host.seed

    def state(self) -> dict:
        return {**self.host.state(), "epoch": self.epoch,
                "index": self.index * self.batch_size,
                "device_pipeline": True}

    def restore(self, state: dict):
        self.host.restore(state)
        self.epoch = self.host.epoch
        self.index = self.host.index // self.batch_size

    def reseed(self, seed: int):
        """Fresh data order from the start (stall auto-recovery)."""
        self.host.reseed(seed)
        self.epoch = 0
        self.index = 0

    def perm(self) -> torch.Tensor:
        """The current epoch's permutation on the device (int64), in one
        buffer that keeps its address: a new epoch's is copied into it."""
        key = (self.host.seed, self.epoch)
        if self._perm_key != key:
            perm = torch.from_numpy(
                np.asarray(self.host._perm(self.epoch), np.int64))
            if self._perm is None:
                self._perm = perm.to(self.device)
            else:
                self._perm.copy_(perm)
            self._perm_key = key
        return self._perm

    def gather_batch(self, offset: int = 0):
        """Batch ``index + offset`` of the epoch as device tensors
        (``gather_batch``), without advancing."""
        return gather_batch(self.images, self.digits, self.perm(),
                            self.index + offset, self.batch_size)

    def chunk(self, max_steps: int) -> int:
        """How many steps can run from the current position; rolls over to
        the next epoch when this one is exhausted."""
        remaining = self.batches_per_epoch - self.index
        if remaining <= 0:
            self.epoch += 1
            self.index = 0
            remaining = self.batches_per_epoch
        return min(max_steps, remaining)

    def advance(self, steps: int):
        self.index += steps
