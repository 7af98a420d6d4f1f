# encodermap_tpu_torch/train/core.py
"""The training core: TrainState, the clip + Adam optimizer, the chunked
trainer.

Counterpart of ``encodermap_tpu/train/core.py`` (``TrainState``,
``make_optimizer``, ``make_scan_trainer``). A chunk is ``steps_per_scan``
optimizer steps run from one host call; its batch indices are one
``(steps, B)`` draw on the device, as ``core.py:119-120`` draws them, and a
caller may inject its own ``(steps, B)`` indices instead (the parity tests
feed the exact indices the JAX trainer drew).

The Adam state is ``{"count": int, "mu": tree, "nu": tree}`` with ``mu`` and
``nu`` in the parameters' ``{"encoder": [...], "decoder": [...]}`` layout:
the fused route and the general route share it, and checkpoints interchange
with the JAX package's optax state (see ``misc/saving.py``).

The batch RNG is a 64-bit seed kept as two uint32 words (the shape of a JAX
PRNG key, so the ``.rng.npy`` checkpoint sidecar loads in both packages);
each chunk seeds a ``torch.Generator`` on the device from it and advances it
by a SplitMix64 step.

Out-of-core training (``encodermap_tpu/train/core.py:135-626``): a batch
source yields superbatches of ``(steps, B, ...)`` host arrays
(:class:`ArrayBatchSource` samples them from arrays or memory maps, and
:class:`HDF5BatchSource` from an HDF5 file, with the JAX package's numpy
RNG calls, so one seed gives the same superbatches in both packages); :class:`PrefetchSource` assembles them in a background thread;
:func:`run_streaming` uploads each one through a pinned host buffer on a
dedicated CUDA stream while the previous chunk computes, and
:func:`make_streaming_trainer` runs a chunk over its leading axis with the
same train step as :func:`make_scan_trainer`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from ..misc.profiling import span
from ..nn import TPLayer
from ..ops.clip_adam import clip_adam

__all__ = [
    "ArrayBatchSource",
    "HDF5BatchSource",
    "PrefetchSource",
    "TrainState",
    "ClipAdam",
    "make_optimizer",
    "make_scan_trainer",
    "make_streaming_trainer",
    "run_streaming",
    "draw_indices",
    "seed_rng",
    "tree_map",
    "tree_leaves",
    "tree_unflatten",
]

_MASK64 = (1 << 64) - 1


def tree_leaves(tree: Any) -> list:
    """Leaves of a dict/list tree, dict keys sorted (JAX's leaf order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Any, leaves: list) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` in
    :func:`tree_leaves` order; a tp-sharded layer of ``template`` stays one
    (``nn.TPLayer``), with its kind and group."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return node.like(out) if isinstance(node, TPLayer) else out
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(template)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf-wise over trees of one structure."""
    return tree_unflatten(tree, [fn(*xs) for xs in
                                 zip(tree_leaves(tree), *map(tree_leaves, rest))])


@dataclasses.dataclass
class TrainState:
    """Everything that evolves during training: parameters, Adam state,
    global step and the batch RNG (two uint32 words)."""

    params: Any
    opt_state: Any
    step: int
    rng: np.ndarray

    def replace(self, **changes: Any) -> "TrainState":
        """A copy with ``changes`` applied."""
        return dataclasses.replace(self, **changes)

    @classmethod
    def create(cls, params: Any, optimizer: "ClipAdam", rng: np.ndarray,
               step: int = 0) -> "TrainState":
        """A fresh state: zero Adam moments at count 0."""
        return cls(params=params, opt_state=optimizer.init(params),
                   step=int(step), rng=np.asarray(rng, np.uint32))


class ClipAdam:
    """``optax.chain(optax.clip(clip_value), optax.adam(lr, eps=1e-7))``:
    element-wise clip, then Adam with bias correction, eps added after
    ``sqrt(v_hat)``. ``learning_rate`` is a float or a schedule
    ``step -> lr`` evaluated at the step count before the update. A step
    is :func:`~encodermap_tpu_torch.ops.clip_adam.clip_adam` over the
    leaves: one kernel launch for all of them on the card, the plain
    ``_adam_update`` a leaf on the CPU."""

    def __init__(self, learning_rate: Union[float, Callable],
                 clip_value: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7) -> None:
        self.learning_rate = learning_rate
        self.clip_value = clip_value
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Any) -> dict:
        """Zero moments shaped like ``params``, count 0."""
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def lr_at(self, count: int) -> float:
        """The learning rate of the update at ``count`` previous steps."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def update(self, grads: Any, opt_state: dict, params: Any
               ) -> tuple[Any, dict]:
        """One step: ``(new_params, new_opt_state)``."""
        count = opt_state["count"]
        p, m, v = clip_adam(tree_leaves(params), tree_leaves(opt_state["mu"]),
                            tree_leaves(opt_state["nu"]), tree_leaves(grads),
                            float(count + 1), self.lr_at(count), self.b1, self.b2,
                            self.eps, self.clip_value)
        new_params = tree_unflatten(params, p)
        new_state = {"count": count + 1, "mu": tree_unflatten(params, m),
                     "nu": tree_unflatten(params, v)}
        return new_params, new_state


def make_optimizer(learning_rate, clip_value: float = 1.0) -> ClipAdam:
    """Adam with element-wise gradient clipping, the reference's
    ``Adam(lr, clipvalue=1.0)`` with Keras' ``epsilon=1e-7``."""
    return ClipAdam(learning_rate, clip_value)


def seed_rng(seed: int) -> np.ndarray:
    """The batch RNG of a run seeded with ``seed``."""
    return _split(np.array([0, int(seed) & 0xFFFFFFFF], np.uint32))


def _split(rng: np.ndarray) -> np.ndarray:
    """The next RNG: one SplitMix64 step of the 64-bit seed."""
    x = (int(rng[0]) << 32 | int(rng[1])) + 0x9E3779B97F4A7C15 & _MASK64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    x ^= x >> 31
    return np.array([x >> 32, x & 0xFFFFFFFF], np.uint32)


def draw_indices(rng: np.ndarray, n: int, shape: tuple, device: Any
                 ) -> tuple[torch.Tensor, np.ndarray]:
    """``(indices, next_rng)``: uniform int64 ``indices`` of ``shape`` in
    ``[0, n)``, drawn on ``device`` by a generator seeded from ``rng``."""
    seed = (int(rng[0]) << 32 | int(rng[1])) & ((1 << 63) - 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    idx = torch.randint(0, n, shape, generator=gen, device=device)
    return idx, _split(rng)


def shard_rows(n: int, shard: Optional[tuple[int, int]]) -> slice:
    """The rows ``[r k, (r + 1) k)`` of ``n`` that data-parallel rank ``r``
    of ``size`` takes, ``shard = (r, size)``; every row without one."""
    if shard is None:
        return slice(None)
    rank, size = shard
    if n % size:
        raise ValueError(f"a batch of {n} rows does not divide over the {size} "
                         f"ranks of the dp axis")
    k = n // size
    return slice(rank * k, (rank + 1) * k)


def make_scan_trainer(
    train_step: Callable[[TrainState, Any], tuple[TrainState, dict]],
    batch_size: int,
    steps_per_scan: int,
    full_batch: bool = False,
    shard: Optional[tuple[int, int]] = None,
) -> Callable:
    """Wrap a one-step function into a chunk of ``steps_per_scan`` steps.

    Args:
        train_step: ``(state, batch) -> (state, metrics_dict)``.
        batch_size: per-step batch size.
        steps_per_scan: optimizer steps per call.
        full_batch: train every step on the ENTIRE dataset instead of
            sampling ``batch_size`` rows (``Parameters(batched=False)``).
        shard: ``(rank, size)`` of a data-parallel run: every rank draws
            (or is given) the same global indices and its step gets its
            equal share of each batch (:func:`shard_rows`), which the step
            gathers where its losses need the global batch.

    Returns:
        ``(state, data, idx=None) -> (state, metrics)`` where each metrics
        entry is a ``(steps,)`` tensor; ``idx`` injects the ``(steps, B)``
        batch indices. ``data`` is one tensor or a tuple of tensors (the ADC
        trainer's CVs): the indices are drawn from the first one's rows
        and every tensor is gathered with them.
    """

    def chunk(state: TrainState, data: Union[torch.Tensor, tuple],
              idx: Optional[torch.Tensor] = None):
        rows = []
        if full_batch:
            first = data[0] if isinstance(data, tuple) else data
            own = shard_rows(first.shape[0], shard)
            local = tuple(d[own] for d in data) if isinstance(data, tuple) else data[own]
            for _ in range(steps_per_scan):
                with span("trainer.step", state.step):
                    state, metrics = train_step(state, local)
                rows.append(metrics)
        else:
            first = data[0] if isinstance(data, tuple) else data
            if idx is None:
                idx, rng = draw_indices(state.rng, first.shape[0],
                                        (steps_per_scan, batch_size),
                                        first.device)
                state = state.replace(rng=rng)
            idx = idx.to(first.device)[:, shard_rows(idx.shape[1], shard)]
            for s in range(idx.shape[0]):
                with span("trainer.step", state.step):
                    batch = (tuple(d[idx[s]] for d in data)
                             if isinstance(data, tuple) else data[idx[s]])
                    state, metrics = train_step(state, batch)
                rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return chunk


def make_streaming_trainer(
    train_step: Callable[[TrainState, Any], tuple[TrainState, dict]],
) -> Callable:
    """A chunk over a superbatch already on the device: one optimizer step
    per slice of its leading axis, with the step :func:`make_scan_trainer`
    runs. ``superbatch`` is a ``(steps, B, ...)`` tensor or a tuple of
    them (the ADC's CVs); returns ``(state, metrics)`` with ``(steps,)``
    metrics (``encodermap_tpu/train/core.py:135-157``)."""

    def chunk(state: TrainState, superbatch: Union[torch.Tensor, tuple]):
        first = superbatch[0] if isinstance(superbatch, tuple) else superbatch
        rows = []
        for s in range(first.shape[0]):
            batch = (tuple(d[s] for d in superbatch)
                     if isinstance(superbatch, tuple) else superbatch[s])
            state, metrics = train_step(state, batch)
            rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return chunk


class ArrayBatchSource:
    """Random-batch sampler over array-like datasets read a window at a
    time (h5py datasets, ``np.memmap`` arrays, arrays): the out-of-core path
    for million-frame ensembles (the reference streams the same way through
    an HDF5-generator ``tf.data`` pipeline,
    ``trajinfo/info_all.py:2870-3078``).

    Sampling is slab-based, matching the reference's contiguous-read
    design: per superbatch ``n_windows`` contiguous random windows
    totalling ``slab_frames`` rows are read per CV (at most two reads
    each, for wrap-around), shuffled resident in RAM, and the
    ``steps_per_scan x batch`` samples are carved from them with numpy
    fancy-indexing. Per-sample scattered h5py gathers (the previous
    design) cost ~1000 seeks per chunk and capped streaming at ~180k
    samples/s; a handful of sequential window reads keeps the I/O
    pattern while successive superbatches draw new random windows, so
    training covers the whole file.

    ``n_windows`` exists because a SINGLE window correlates batches on
    time-ordered trajectories: every batch of a superbatch then comes
    from one contiguous stretch of simulation time. Measured on a
    worst-case smooth feature-space walk (8192 frames, slab 1/16 of the
    file), single-window training converged to a 9x worse full-data
    loss than uniform in-memory sampling; 8 windows recovers uniform
    quality within noise while keeping >95% of the single-window read
    throughput (``scripts/slab_stats_experiment.py``, numbers in
    BASELINE.md). The default is therefore 8 (capped so each window
    still holds at least one batch); pass ``n_windows=1`` to reproduce
    the pure single-slab read pattern.

    When the file (or slab) holds fewer rows than a batch needs, samples
    repeat (with-replacement semantics) instead of raising — the
    reference's ``replace`` flag behavior (``info_all.py:2870-2960``).

    ``datasets`` holds one sequence of datasets (one per CV) for each
    member (one for a flat file, one per trajectory of an ensemble); the
    members' datasets are virtually concatenated along the frame axis (they
    must be width-aligned, which ``load_CVs(..., ensemble=True)``
    guarantees). :class:`HDF5BatchSource` opens them from a file.

    Yields tuples of ``(steps_per_scan, batch, ...)`` numpy stacks suitable
    for :func:`make_streaming_trainer`.

    The sampler of ``encodermap_tpu/train/core.py::HDF5BatchSource`` (host
    numpy): the same numpy RNG calls in the same order, so one seed and the
    same frames yield the same superbatches bit for bit in both packages.
    """

    def __init__(self, datasets, batch_size: int, steps_per_scan: int,
                 seed: Optional[int] = 0,
                 slab_frames: Optional[int] = None,
                 replace: bool = True,
                 skip_all_nan: bool = False,
                 n_windows: int = 8) -> None:
        """``seed=None`` draws OS entropy (non-reproducible streams).
        ``replace=False`` keeps samples unique within each batch (raising
        when a slab holds fewer valid rows than a batch, mirroring the
        reference's unique-index guard). ``skip_all_nan=True`` drops slab
        rows that are all-NaN for any CV (ragged NaN-aligned ensembles) —
        the training paths keep the default False because the models'
        sparse mode consumes NaN rows directly. ``n_windows`` splits each
        superbatch's slab into that many independent contiguous windows
        (see the class docstring for the statistics)."""
        self._dset_groups = [list(group) for group in datasets]
        if not self._dset_groups or not self._dset_groups[0]:
            raise KeyError("no CV datasets")
        self.n_cvs = len(self._dset_groups[0])
        self.batch_size = batch_size
        self.steps_per_scan = steps_per_scan
        self.slab_frames = slab_frames
        lengths = [dsets[0].shape[0] for dsets in self._dset_groups]
        self._offsets = np.concatenate([[0], np.cumsum(lengths)])
        self.n_frames = int(self._offsets[-1])
        self._rng = np.random.default_rng(seed)
        self.replace = replace
        self.skip_all_nan = skip_all_nan
        self.n_windows = n_windows

    def __iter__(self):
        return self

    def _read_contiguous(self, k: int, start: int, length: int):
        """Rows ``[start, start + length)`` of CV #k across the
        virtually-concatenated groups — pure sequential reads."""
        parts = []
        for gi, dsets in enumerate(self._dset_groups):
            lo, hi = self._offsets[gi], self._offsets[gi + 1]
            s, e = max(start, lo), min(start + length, hi)
            if s < e:
                parts.append(dsets[k][s - lo : e - lo])
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def _read_slab(self, k: int, start: int, length: int):
        """Contiguous slab with wrap-around at the end of the file."""
        if start + length <= self.n_frames:
            return self._read_contiguous(k, start, length)
        head = self._read_contiguous(k, start, self.n_frames - start)
        tail = self._read_contiguous(k, 0, length - (self.n_frames - start))
        return np.concatenate([head, tail], axis=0)

    def __next__(self):
        total = self.steps_per_scan * self.batch_size
        S = self.slab_frames if self.slab_frames else total
        S = max(1, min(S, self.n_frames))
        kw = max(1, int(self.n_windows))
        if S >= self.n_frames:
            kw = 1  # the slab already covers the whole file
        # each window should still hold at least one batch worth of rows
        kw = min(kw, max(1, S // self.batch_size))
        w = -(-S // kw)
        n_rows = kw * w
        for _ in range(8):
            starts = self._rng.integers(0, self.n_frames, size=kw)
            slabs = [
                np.concatenate(
                    [self._read_slab(c, int(s), w) for s in starts], axis=0
                ) if kw > 1 else self._read_slab(c, int(starts[0]), w)
                for c in range(self.n_cvs)
            ]
            # global frame number of each slab row, for frame identity
            # (yield_index) and cross-window dedup
            global_rows = np.concatenate(
                [(int(s) + np.arange(w)) % self.n_frames for s in starts]
            )
            if self.skip_all_nan:
                valid = np.ones(n_rows, bool)
                for s in slabs:
                    if s.dtype.kind == "f":
                        valid &= ~np.all(
                            np.isnan(s.reshape(n_rows, -1)), axis=1
                        )
                rows = np.where(valid)[0]
            else:
                rows = np.arange(n_rows)
            if not self.replace and len(rows):
                # windows may overlap: keep one slab row per distinct frame
                # so unique-within-batch means unique FRAMES, not just rows
                _, first = np.unique(global_rows[rows], return_index=True)
                rows = rows[np.sort(first)]
            if len(rows):
                break
        else:
            raise ValueError(
                "no valid (non-all-NaN) rows found in 8 random slabs"
            )
        n_valid, B = len(rows), self.batch_size
        if not self.replace and n_valid < B:
            raise Exception(
                f"Can't find {B} unique indices among {n_valid} valid "
                f"frames in the slab. Pass replace=True."
            )
        if self.replace:
            # shuffled resident rows; repeats only when the slab holds
            # fewer valid rows than the superbatch consumes
            reps = -(-total // n_valid)
            idx_rows = np.concatenate(
                [self._rng.permutation(n_valid) for _ in range(reps)]
            )[:total]
        else:
            # duplicate-free batches: carve batch-sized chunks from
            # permutations WITHOUT crossing permutation boundaries (a
            # chunk straddling two permutations could repeat a row)
            per_perm = n_valid // B
            n_perm = -(-self.steps_per_scan // per_perm)
            idx_rows = np.concatenate(
                [
                    self._rng.permutation(n_valid)[: per_perm * B]
                    for _ in range(n_perm)
                ]
            )[:total]
        idx = rows[idx_rows].reshape(self.steps_per_scan, B)
        # global row numbers of the sampled frames, for consumers that
        # need frame identity (TrajEnsemble.batch_iterator yield_index)
        self.last_indices = global_rows[idx]
        return tuple(slab[idx] for slab in slabs)

    def read_prototype(self, n: int = 4):
        """First ``n`` frames of *every* member group, concatenated — a
        small deterministic sample that sees each topology (so NaN-aligned
        ensemble columns are visible for sparse-mode detection)."""
        out = []
        for k in range(self.n_cvs):
            parts = [
                dsets[k][: min(n, dsets[k].shape[0])]
                for dsets in self._dset_groups
            ]
            out.append(np.concatenate(parts, axis=0).astype(np.float32))
        return tuple(out)

    def close(self):
        """Nothing to release here; :class:`HDF5BatchSource` closes its
        file."""


class HDF5BatchSource(ArrayBatchSource):
    """:class:`ArrayBatchSource` over the CVs of an HDF5 file — the
    out-of-core path for million-frame ensembles. Two on-disk layouts are
    supported:

    * flat: one group (default ``"CVs"``) holding one dataset per CV name;
    * ensemble: the layout :meth:`TrajEnsemble.save` writes — ``traj_N/CVs/
      <name>`` per member trajectory.

    A copy of ``encodermap_tpu/train/core.py::HDF5BatchSource``; ``h5py``
    is imported in ``__init__`` only. The sampling arguments after
    ``group`` are :class:`ArrayBatchSource`'s.
    """

    def __init__(self, path: str, cv_names, batch_size: int,
                 steps_per_scan: int, group: str = "CVs",
                 seed: Optional[int] = 0,
                 slab_frames: Optional[int] = None,
                 replace: bool = True,
                 skip_all_nan: bool = False,
                 n_windows: int = 8) -> None:
        import h5py

        self.path = str(path)
        self.cv_names = list(cv_names)
        self.group = group
        self._h5 = h5py.File(path, "r")
        try:
            flat = bool(group) and group in self._h5
            if flat:
                # the explicitly-requested flat group wins — and is
                # resolved BEFORE scanning traj_* names, so an unrelated
                # top-level item like 'traj_joined' or a traj_0 DATASET
                # can't crash the scan below
                traj_groups: list = []
            else:
                def _is_member(k: str) -> bool:
                    if not k.startswith("traj_"):
                        return False
                    try:
                        int(k.split("_")[1])
                    except (IndexError, ValueError):
                        return False  # e.g. 'traj_joined'
                    node = self._h5[k]
                    return isinstance(node, h5py.Group) and "CVs" in node

                traj_groups = sorted(
                    (k for k in self._h5 if _is_member(k)),
                    key=lambda k: int(k.split("_")[1]),
                )
            if flat:
                dset_groups = [
                    [self._h5[group][n] for n in self.cv_names]
                ]
            elif traj_groups:
                dset_groups = [
                    [self._h5[f"{k}/CVs"][n] for n in self.cv_names]
                    for k in traj_groups
                ]
            else:
                if all(n in self._h5 for n in self.cv_names):
                    # flat file with top-level datasets (the group kwarg
                    # default "CVs" must not hide them behind a KeyError)
                    g = self._h5
                else:
                    raise KeyError(
                        f"{path} has no {group!r} group, no traj_* member "
                        f"groups, and its top level lacks {self.cv_names}"
                    )
                dset_groups = [[g[n] for n in self.cv_names]]
            super().__init__(dset_groups, batch_size, steps_per_scan, seed,
                             slab_frames, replace, skip_all_nan, n_windows)
        except Exception:
            # don't leak the open handle on ANY init failure (absent CVs,
            # oddly-named traj_* groups, empty cv_names, ...)
            self._h5.close()
            raise

    def close(self):
        self._h5.close()


class PrefetchSource:
    """Wrap a batch source with a background thread + bounded queue so host
    batch assembly (HDF5 reads, stacking) overlaps device compute — the
    analog of the reference's ``tf.data ... .prefetch()`` input
    pipeline (``trajinfo/info_all.py:3080-3154``). h5py/numpy reads release
    the GIL, so a plain thread achieves real overlap.
    """

    def __init__(self, source, depth: int = 2) -> None:
        import queue
        import threading

        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: list = []
        self._stop = threading.Event()

        def put_with_stop(item) -> bool:
            """Blocking put that gives up when close() was requested."""
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in source:
                    if not put_with_stop(item):
                        return
            except Exception as e:  # propagate to the consumer
                self._err.append(e)
            finally:
                put_with_stop(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the worker and wait for it to fully exit.

        Must NOT return while the worker is mid-read: callers that own the
        underlying source (e.g. an HDF5 file) close it right after, and
        h5py is not safe against a concurrent close. The worker can finish
        its current item (it never blocks on put once the stop event is
        set), so joining to completion terminates promptly."""
        self._stop.set()
        while self._thread.is_alive():
            # drain so a blocked put can finish
            try:
                while True:
                    self._queue.get_nowait()
            except Exception:
                pass
            self._thread.join(timeout=0.2)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._sentinel:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item


class _Upload:
    """A superbatch array on its way to the card: the device tensor and the
    event recorded on the upload stream after its copy."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event) -> None:
        self.tensor, self.event = tensor, event

    def ready(self) -> torch.Tensor:
        """The tensor, usable on the current (compute) stream: the stream
        waits for the copy, and the caching allocator learns that the
        tensor, allocated on the upload stream, is used on this one."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
        return self.tensor


class PinnedUploader:
    """``put(x)`` of the streaming pipeline: a host array (its dp shard of
    the batch axis, with ``shard = (rank, size)``) to the trainer's device.

    On the card every copy goes from a pinned host buffer, with
    ``non_blocking=True``, on a dedicated upload stream, so it overlaps the
    chunk computing on the default stream. The buffers are a ring per
    shape: a buffer is refilled only after the event of the copy that last
    read it has completed. ``put`` is called from the pipeline's worker
    thread, whose current stream would otherwise be the default one and
    serialise the copy with compute. On the CPU it is a plain copy."""

    #: pinned buffers per superbatch shape: one filling while the copy of
    #: the other may still run
    N_BUFFERS = 2

    def __init__(self, device: torch.device, shard: Optional[tuple[int, int]] = None
                 ) -> None:
        self.device = torch.device(device)
        self.shard = shard
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._rings: dict = {}
        self.copies = 0

    def __call__(self, x: np.ndarray) -> _Upload:
        x = np.asarray(x)
        if self.shard is not None:
            x = x[:, shard_rows(x.shape[1], self.shard)]
        if self.stream is None:
            return _Upload(torch.tensor(x), None)
        key = (x.shape, x.dtype.str)
        ring = self._rings.setdefault(key, {"next": 0, "slots": []})
        if len(ring["slots"]) < self.N_BUFFERS:
            dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
            ring["slots"].append([torch.empty(x.shape, dtype=dtype, pin_memory=True),
                                  None])
        slot = ring["slots"][ring["next"] % self.N_BUFFERS]
        ring["next"] += 1
        if slot[1] is not None:
            slot[1].synchronize()  # the last copy from this buffer is done
        slot[0].numpy()[...] = x
        with torch.cuda.stream(self.stream):
            dev = slot[0].to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        slot[1] = event
        self.copies += 1
        return _Upload(dev, event)


def _upload_stage(source, put, n_steps: int):
    """Yield ``(n_optimizer_steps, device_superbatch)`` pairs, trimming the
    final chunk so training never runs past ``n_steps`` (as ``train()``
    does: ``state.step`` and soft-start schedules must not overshoot the
    history). Runs the ``put`` uploads itself, so a :class:`PrefetchSource`
    around this generator moves them off the consumer thread."""
    done = 0
    for superbatch in source:
        remaining = n_steps - done
        if remaining <= 0:
            return
        if isinstance(superbatch, tuple) and len(superbatch) == 1:
            # HDF5BatchSource yields tuples; the plain EncoderMap step takes
            # a bare array, so EncoderMap(...).train_streaming(
            # HDF5BatchSource(...)) works without an adapter
            superbatch = superbatch[0]
        if isinstance(superbatch, tuple):
            if superbatch[0].shape[0] > remaining:
                superbatch = tuple(x[:remaining] for x in superbatch)
            dev = tuple(put(x) for x in superbatch)
            n = int(superbatch[0].shape[0])
        else:
            if superbatch.shape[0] > remaining:
                superbatch = superbatch[:remaining]
            dev = put(superbatch)
            n = int(superbatch.shape[0])
        done += n
        yield n, dev


def run_streaming(autoencoder, source, n_steps: int,
                  sharding: Optional[tuple[int, int]] = None,
                  prefetch: int = 2) -> dict:
    """Drive a streaming training loop for an autoencoder-like object (with
    ``._make_train_step()``, ``.state``, ``.p``, ``.device``); returns the
    metric history (``encodermap_tpu/train/core.py:516-626``).

    ``source`` yields superbatches: a tuple of ``(steps_per_scan, batch,
    ...)`` arrays, or one array for plain EncoderMap data.

    ``sharding``: ``(rank, size)`` of a data-parallel run: every rank reads
    the same superbatch and uploads its share of the batch axis (the JAX
    package's ``P(None, "dp")``), BASELINE config 5's streaming with
    data-parallel training.

    ``prefetch``: depth of the background host queue (0 disables it and
    uploads on the consumer thread; 2 double-buffers assembly against
    compute). The uploads run in a second background stage, so chunk k+1's
    copy overlaps chunk k's compute.
    """
    from ..misc.summaries import MetricsWriter
    from .callbacks import NaNInterrupt

    put = PinnedUploader(autoencoder.device, sharding)
    trainer = make_streaming_trainer(autoencoder._make_train_step())
    # callbacks and per-step metric rows as train() has them: JSONL rows
    # are numbered first_step + i + 1
    cbs = (autoencoder._setup_callbacks()
           if hasattr(autoencoder, "_setup_callbacks") else [])
    if not getattr(autoencoder, "read_only", True):
        if getattr(autoencoder, "_metrics_writer", None) is not None:
            autoencoder._metrics_writer.close()
        autoencoder._metrics_writer = MetricsWriter(
            autoencoder.p.main_path,
            tensorboard=getattr(autoencoder.p, "tensorboard", False))
    for cb in cbs:
        cb.on_train_begin(autoencoder)
    autoencoder._streaming_nan_stop = False
    if prefetch:
        source = PrefetchSource(source, depth=prefetch)
    uploads = _upload_stage(source, put, n_steps)
    stream = PrefetchSource(uploads, depth=1) if prefetch else uploads
    history: dict[str, list] = {}
    done = 0
    # the step read once before the loop; the labels advance by the chunk
    # sizes
    step0 = int(autoencoder.state.step)
    try:
        for n, dev in stream:
            first_step = step0 + done
            batch = (tuple(u.ready() for u in dev) if isinstance(dev, tuple)
                     else dev.ready())
            autoencoder.state, metrics = trainer(autoencoder.state, batch)
            # the chunk's metrics fetched from the device once
            keys = list(metrics)
            vals = torch.stack([metrics[k].float() for k in keys]).cpu().numpy()
            metrics = dict(zip(keys, vals))
            for k, v in metrics.items():
                history.setdefault(k, []).append(v)
            writer = getattr(autoencoder, "_metrics_writer", None)
            if writer is not None:
                stride = max(1, getattr(autoencoder.p, "summary_step", 1))
                for i in range(n):
                    step_i = first_step + i + 1
                    if step_i % stride == 0:
                        writer.write_scalars(step_i, {k: v[i] for k, v in metrics.items()})
            stop = False
            for cb in cbs:
                if cb.on_chunk_end(first_step, metrics) is False:
                    stop = True
                    # a NaN abort must not reach CheckpointSaver with the
                    # diverged parameters (isinstance: a user's subclass
                    # keeps the protection)
                    autoencoder._streaming_nan_stop = isinstance(cb, NaNInterrupt)
                    break
            done += n
            if stop or done >= n_steps:
                break
    finally:
        for cb in cbs:
            cb.on_train_end(autoencoder)
        writer = getattr(autoencoder, "_metrics_writer", None)
        if writer is not None:
            writer.close()
            autoencoder._metrics_writer = None
        if isinstance(stream, PrefetchSource):
            stream.close()
        if isinstance(source, PrefetchSource):
            source.close()
    return {k: np.concatenate([np.asarray(x) for x in v])[:n_steps]
            for k, v in history.items()}
