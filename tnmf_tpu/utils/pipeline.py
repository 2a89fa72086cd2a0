"""Host→device input pipeline: background prefetch for streaming fits.

Online and minibatch drivers consume batches one at a time
(``partial_fit``, ``fit_stream``); without a pipeline, every step first
blocks on the host→device copy of its batch.  :func:`prefetch_to_device`
overlaps those copies with compute: a daemon thread pulls batches from
the source iterator and stages them on the accelerator (optionally in a
sharded layout) a few steps ahead, so the training step always finds its
next batch already resident::

    from tnmf_tpu.utils.pipeline import prefetch_to_device
    for batch in prefetch_to_device(batch_source(), buffer_size=2):
        model.partial_fit(batch)          # batch is already on device

The model keeps device-resident inputs on device (no host round trip —
``models/tnmf.py::_initialize_matrices``), so a prefetched batch's
host-to-device copy overlaps the previous step's compute.  No reference
counterpart: the
reference's data loading is a single test image
(``tnmf/utils/data_loading.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import jax
import numpy as np

__all__ = ['prefetch_to_device']

_END = object()


def prefetch_to_device(source: Iterable, buffer_size: int = 2,
                       sharding: Optional[jax.sharding.Sharding] = None,
                       dtype=None) -> Iterator[jax.Array]:
    """Iterate ``source``, yielding each batch as a device array staged by
    a background thread up to ``buffer_size`` batches ahead.

    ``sharding`` places every batch in the given layout (e.g.
    ``tnmf_tpu.parallel.data_sharding(mesh, ndim)`` for a sample-sharded
    mesh); ``dtype`` casts on the way in (e.g. ``'bfloat16'`` halves the
    transfer).  Order is preserved; an exception in the source is
    re-raised at the consumption point; the staging thread is a daemon,
    so abandoning the iterator cannot hang interpreter exit.
    """
    if buffer_size < 1:
        raise ValueError(f'buffer_size must be >= 1, got {buffer_size}')
    q: queue.Queue = queue.Queue(maxsize=buffer_size)

    def stage():
        try:
            for batch in source:
                arr = np.asarray(batch)
                if dtype is not None:
                    arr = arr.astype(dtype)
                if sharding is not None:
                    arr = jax.device_put(arr, sharding)
                else:
                    arr = jax.device_put(arr)
                q.put(arr)
        except BaseException as e:  # noqa: BLE001 - re-raised at consumption
            q.put(e)
            return
        q.put(_END)

    threading.Thread(target=stage, daemon=True,
                     name='tnmf-tpu-prefetch').start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
