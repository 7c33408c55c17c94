"""Generic training loop (port of ``train/loop.py``).

One host loop drives any ``step_fn(state, batch) -> (state, metrics)``:

* first-order steps from ``make_train_step`` (SGD, Adam, raw SGD from
  ``optim/manual.py``), with optional micro-batch accumulation;
* the host-driven LanczosSGD trainer (``optim/lanczos_sgd_host.py``).

Eager PyTorch: no jit and no buffer donation.  Losses stay on the device
between log points and are fetched in one transfer there, as the JAX loop
drains them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
from hessian_llm_vision_tpu_torch.optim.manual import GradientTransformation, apply_updates
from hessian_llm_vision_tpu_torch.utils.norms import norm


class EpochResampledBatches:
    """Re-iterable batch source that redraws per epoch.

    ``train()`` calls ``iter(batches)`` once per epoch; this wrapper maps
    the n-th iteration to ``make_batches(n)`` (per-epoch stochastic
    augmentation).  ``transform`` (optional) post-processes each fresh list
    (e.g. micro-batch regrouping)."""

    def __init__(self, make_batches: Callable[[int], list],
                 transform: Optional[Callable[[list], list]] = None):
        self._make = make_batches
        self._transform = transform
        self._epoch = 0

    def __iter__(self):
        batches = self._make(self._epoch)
        if self._transform is not None:
            batches = self._transform(batches)
        self._epoch += 1
        return iter(batches)


class TrainState(NamedTuple):
    params: dict
    opt_state: Any
    step: int


def global_norm(tensors: dict) -> torch.Tensor:
    """L2 norm over every tensor of the dict (optax's ``global_norm``).  On
    the CPU each tensor's squares are summed in float64 (``utils/norms.py``:
    PyTorch's f32 CPU norm drifts with the length); on the card the f32
    multi-tensor reduction is kept."""
    ts = list(tensors.values())
    if ts[0].device.type == "cpu":
        return norm(torch.stack([norm(t) for t in ts]))
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))


def make_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    optimizer: GradientTransformation,
    *,
    accum_steps: int = 1,
):
    """First-order step; ``accum_steps > 1`` loops over the micro-batches
    (the leading axis of every batch tensor) and takes the mean of their
    losses and gradients, summed in micro-batch order as the JAX scan
    does."""

    def init_fn(params) -> TrainState:
        return TrainState(params=dict(params), opt_state=optimizer.init(params), step=0)

    def step_fn(state: TrainState, batch):
        if accum_steps == 1:
            loss, grads = grad_and_loss(loss_fn, state.params, batch)
        else:
            names = list(state.params)
            loss = torch.zeros((), dtype=torch.float32, device=state.params[names[0]].device)
            acc = [torch.zeros_like(state.params[n]) for n in names]
            for i in range(accum_steps):
                l_i, g_i = grad_and_loss(loss_fn, state.params, {k: v[i] for k, v in batch.items()})
                loss = loss + l_i
                torch._foreach_add_(acc, [g_i[n] for n in names])
                del g_i
            loss = loss / accum_steps
            grads = dict(zip(names, torch._foreach_div(acc, accum_steps)))
            del acc
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        return TrainState(params, opt_state, state.step + 1), metrics

    return init_fn, step_fn


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def train(
    step_fn,
    state,
    batches: Iterable[Any],
    *,
    num_epochs: int = 1,
    max_steps: int = 0,
    log_every: int = 10,
    on_log: Optional[Callable[[int, Dict[str, float]], None]] = None,
    on_epoch_end: Optional[Callable[[int, Any], None]] = None,
    on_state: Optional[Callable[[int, Any, Any], None]] = None,
    on_state_every: int = 0,
    ema_decay: float = 0.99,
) -> Any:
    """Drive ``step_fn(state, batch) -> (state, metrics)`` over
    ``num_epochs`` passes of ``batches`` (re-iterable), stopping after
    ``max_steps`` steps in all (0 = all epochs).  Tracks the reference's EMA
    loss (0.99 decay) and the wall-clock per step averaged over each log
    interval; ``on_log(step, metrics)`` fires every ``log_every`` steps and
    at the last step.  ``on_state(step, state, batch)`` fires every
    ``on_state_every`` steps (0 = never) with the live state.  Returns the
    final state."""
    ema_loss = None
    global_step = 0
    last_logged = -1
    last = None
    pending_losses = []
    t_interval = time.perf_counter()
    steps_in_interval = 0

    def _drain_ema():
        nonlocal ema_loss
        if not pending_losses:
            return
        # one device-to-host transfer for the whole interval
        vals = torch.stack([torch.as_tensor(v).reshape(()) for v in pending_losses])
        pending_losses.clear()
        for v in vals.to("cpu", torch.float64).tolist():
            ema_loss = v if ema_loss is None else ema_decay * ema_loss + (1 - ema_decay) * v

    def emit(step, metrics):
        nonlocal t_interval, steps_in_interval
        _drain_ema()
        host = {}
        for k, v in metrics.items():
            a = _host(v)
            if a.size == 0:
                host[k] = 0.0
            elif a.size == 1:
                host[k] = float(a.reshape(-1)[0])
            else:
                # vector metrics pass through whole, plus scalar summaries
                host[k] = a
                host[f"{k}_min"] = float(a.min())
                host[f"{k}_max"] = float(a.max())
        host["ema_loss"] = ema_loss
        now = time.perf_counter()
        host["step_time"] = (now - t_interval) / max(steps_in_interval, 1)
        t_interval, steps_in_interval = now, 0
        on_log(step, host)

    done = False
    for epoch in range(num_epochs):
        if done:
            break
        steps_this_epoch = 0
        for batch in batches:
            if max_steps and global_step >= max_steps:
                done = True
                break
            state, metrics = step_fn(state, batch)
            pending_losses.append(metrics["loss"])
            if on_log is None and len(pending_losses) >= log_every:
                _drain_ema()
            steps_in_interval += 1
            last = (global_step, metrics)
            if on_state is not None and on_state_every > 0 and global_step % on_state_every == 0:
                on_state(global_step, state, batch)
            if on_log is not None and global_step % log_every == 0:
                emit(global_step, metrics)
                last_logged = global_step
            global_step += 1
            steps_this_epoch += 1
        # max_steps can trip on an epoch's first iteration: no epoch-end
        # hook for an epoch that ran no step
        if on_epoch_end is not None and steps_this_epoch > 0:
            on_epoch_end(epoch, state)
    # the final step always reaches the log (sweeps read the last loss)
    if on_log is not None and last is not None and last[0] != last_logged:
        emit(*last)
    else:
        _drain_ema()
    return state
