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
by a SplitMix64 step. Streaming sources wait for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

__all__ = [
    "TrainState",
    "ClipAdam",
    "make_optimizer",
    "make_scan_trainer",
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
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
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
    ``step -> lr`` evaluated at the step count before the update."""

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
        from ..ops.fused_train import _adam_update

        count = opt_state["count"]
        lr = self.lr_at(count)
        t = float(count + 1)
        out = [_adam_update(p, m, v, g, t, lr, self.b1, self.b2, self.eps,
                            self.clip_value)
               for p, m, v, g in zip(tree_leaves(params),
                                     tree_leaves(opt_state["mu"]),
                                     tree_leaves(opt_state["nu"]),
                                     tree_leaves(grads))]
        new_params = tree_unflatten(params, [o[0] for o in out])
        new_state = {"count": count + 1,
                     "mu": tree_unflatten(params, [o[1] for o in out]),
                     "nu": tree_unflatten(params, [o[2] for o in out])}
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


def make_scan_trainer(
    train_step: Callable[[TrainState, Any], tuple[TrainState, dict]],
    batch_size: int,
    steps_per_scan: int,
    full_batch: bool = False,
) -> Callable:
    """Wrap a one-step function into a chunk of ``steps_per_scan`` steps.

    Args:
        train_step: ``(state, batch) -> (state, metrics_dict)``.
        batch_size: per-step batch size.
        steps_per_scan: optimizer steps per call.
        full_batch: train every step on the ENTIRE dataset instead of
            sampling ``batch_size`` rows (``Parameters(batched=False)``).

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
            for _ in range(steps_per_scan):
                state, metrics = train_step(state, data)
                rows.append(metrics)
        else:
            first = data[0] if isinstance(data, tuple) else data
            if idx is None:
                idx, rng = draw_indices(state.rng, first.shape[0],
                                        (steps_per_scan, batch_size),
                                        first.device)
                state = state.replace(rng=rng)
            idx = idx.to(first.device)
            for s in range(idx.shape[0]):
                batch = (tuple(d[idx[s]] for d in data)
                         if isinstance(data, tuple) else data[idx[s]])
                state, metrics = train_step(state, batch)
                rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return chunk
