"""Faults planted in the program's objects under a run (tests and the
calibration of the limits only; the benchmark's own runs plant nothing).
Each is a `plant(kind, obj)` hook for `harness.Run`.

- `token`: every served token at index 1 is altered in the engine's
  output buffer right after each chunk produces it;
- `unchanged`: the training step leaves the state as it was (the
  optimizer's update is skipped);
- `half`: the training step sees the first half of each batch only, so
  its loss is the mean over the rest.
"""

from __future__ import annotations

from typing import Any, Callable


def token(kind: str, obj: Any) -> Any:
    if kind != "engine":
        return obj
    step_fn = obj.step_fn
    vocab = obj.cfg.vocab_size

    def altered(state, *a, **k):
        state = step_fn(state, *a, **k)
        state.tokens_out[:, 1] = (state.tokens_out[:, 1] + 1) % vocab
        return state

    obj.step_fn = altered
    return obj


def unchanged(kind: str, obj: Any) -> Any:
    if kind != "train_step":
        return obj

    def step(state, batch, seed):
        state.optimizer.opt.step = lambda *a, **k: None
        return obj(state, batch, seed)

    return step


def half(kind: str, obj: Any) -> Any:
    if kind != "train_step":
        return obj

    def step(state, batch, seed):
        n = len(batch[0]) // 2
        return obj(state, type(batch)(*(None if x is None else x[:n]
                                        for x in batch)), seed)

    return step


FAULTS: dict[str, Callable[[str, Any], Any]] = {
    "token": token, "unchanged": unchanged, "half": half}
