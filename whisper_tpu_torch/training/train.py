"""Training: teacher-forced fine-tuning of Whisper on (mel, token) pairs.

The port of `whisper_tpu/training/train.py`: the same loss over the same
forward functions the inference path uses, AdamW with the optax chain's
arithmetic, the same schedule and clip, and `remat` of every block.

Where JAX is functional the port updates in place: the train step writes
the new params into the tree's parameters and the new moments into the
optimizer state's tensors, and returns a TrainState over those same
tensors with the step advanced (the state passed in is consumed). The
step runs the plain path: no hand-written kernel has a backward (nor has
any TPU kernel a VJP in the JAX package), so the trainer refuses
`attention="flash"`, and the kernels refuse to launch on inputs that
require grad (`ops/kernels/_build.refuse_grad`).

optax's parts, as this step reproduces them:
  * `clip_by_global_norm(max_norm)`: g / norm * max_norm only when
    norm >= max_norm (torch's `clip_grad_norm_` divides by norm + 1e-6
    on every call);
  * `adamw(schedule, weight_decay)` = `scale_by_adam` (b1 0.9, b2 0.999,
    eps 1e-8 outside the square root), `add_decayed_weights` on EVERY
    leaf (biases, LayerNorms and embeddings too), then the schedule read
    at the count BEFORE it increments: the first update has learning
    rate 0, so step 0 leaves the params unchanged;
  * `warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))`.
The per-step scalars (bias corrections, learning rate) are computed in
float32, as JAX computes them.

Over a mesh (`make_train_step(..., mesh=)`, the params sharded by
`parallel/sharding.shard_params`), each rank takes its dp rows of the
batch and runs the model's tp layout with Megatron's f and g around the
projections (models/whisper.py), as JAX's jitted step does over a sharded
tree. The loss divides by the mask count summed over dp, and the
gradients are summed over dp, so they are the meshless batch's; the
global norm sums the squares of the tp-sharded leaves over tp and counts
the replicated leaves once; AdamW runs elementwise on the shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..config import WhisperConfig
from ..models import whisper as M
from ..parallel import context as pctx
from ..parallel.sharding import is_sharded
from ..params import ParamTree

Tensors = Dict[str, torch.Tensor]  # flat parameter name -> tensor
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


class AdamWState(NamedTuple):
    """count: updates applied so far (optax's ScaleByAdamState and
    ScaleByScheduleState counts, always equal); mu, nu: the moments, by
    parameter name, in the params' dtype."""

    count: int
    mu: Tensors
    nu: Tensors


class TrainState(NamedTuple):
    step: int
    params: ParamTree
    opt_state: AdamWState


class Batch(NamedTuple):
    """One training batch.

    mel: (B, n_mels, T) log-mel features (T <= n_audio_ctx)
    tokens: (B, S) int32 -- full sequences [prompt..., text..., EOT, pad...]
    loss_mask: (B, S) f32 -- 1 where the NEXT-token prediction is scored
        (i.e. mask[i, t] scores the prediction of tokens[i, t+1]; the last
        column is ignored). Prompt and padding positions get 0.
    """

    mel: torch.Tensor
    tokens: torch.Tensor
    loss_mask: torch.Tensor


def cross_entropy_loss(params: ParamTree, batch: Batch, cfg: WhisperConfig,
                       remat: bool = False
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy over masked positions: f32
    log-softmax of the logits, the mask normalised by max(sum, 1), and the
    argmax accuracy over the same positions. When the batch's rows are
    split over dp (`parallel/context.dp_rows`), the count is summed over
    dp first: the rank's loss is its share of the whole batch's, and the
    metrics are the whole batch's."""
    logits = M.whisper_forward(params, batch.mel, batch.tokens, cfg,
                               remat=remat)
    logits = logits[:, :-1]  # predict token t+1 from position t
    targets = batch.tokens[:, 1:].long()
    mask = batch.loss_mask[:, :-1].float()

    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    split = pctx.dp_shard() is not None
    count = pctx.dp_sum(mask.sum().detach()) if split else mask.sum()
    denom = torch.clamp(count, min=1.0)
    loss = (nll * mask).sum() / denom

    acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
    metrics = {"loss": loss, "accuracy": acc, "tokens": count}
    if split:
        metrics.update(loss=pctx.dp_sum(loss.detach()),
                       accuracy=pctx.dp_sum(acc.detach()))
    return loss, metrics


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of their sums of squares
    (`optax.global_norm`)."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def sharded_global_norm(grads: Tensors, cfg: WhisperConfig,
                        mesh) -> torch.Tensor:
    """`global_norm` of the whole tree from this rank's shards: the
    squares of the tp-sharded leaves summed over tp, the replicated leaves
    (equal on every tp rank) counted once."""
    sq = {True: [], False: []}
    for name, g in grads.items():
        sq[is_sharded(name, cfg)].append((g * g).sum())
    total = sum(sq[False])
    if sq[True]:
        total = total + pctx.tp_sum(sum(sq[True]).reshape(1), mesh)[0]
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """`optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    weight_decay))` with `make_optimizer`'s schedule."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0

    def schedule(self, count: int) -> float:
        """`warmup_cosine_decay_schedule(0, lr, warmup, max(total,
        warmup + 1))` at `count`: a linear warmup from 0, then a cosine
        decay to 0 (optax's `join_schedules` of a linear and a cosine
        schedule), in float32."""
        f = np.float32
        lr, warmup = f(self.learning_rate), self.warmup_steps
        if count < warmup:  # optax's polynomial schedule at power 1
            frac = f(1) - f(min(max(count, 0), warmup)) / f(warmup)
            return float((f(0) - lr) * frac + lr)
        decay = f(max(self.total_steps, warmup + 1) - warmup)
        c = min(f(count - warmup), decay)
        cosine = f(0.5) * (f(1) + np.cos(f(math.pi) * c / decay))
        return float(lr * cosine)

    def init(self, params: ParamTree) -> AdamWState:
        zeros = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
        return AdamWState(0, zeros,
                          {n: torch.zeros_like(t) for n, t in zeros.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState,
               params: ParamTree, norm=None) -> AdamWState:
        """Clip `grads` (in place) by their global `norm` (computed here
        when not given), then one AdamW update of `params` and the
        moments, all in place; returns the state with the count
        advanced."""
        if norm is None:
            norm = global_norm(grads.values())
        if not bool(norm < self.max_grad_norm):
            for g in grads.values():
                g.div_(norm.to(g.dtype)).mul_(self.max_grad_norm)
        f = np.float32
        count = state.count + 1
        bc1 = float(f(1) - f(B1) ** f(count))
        bc2 = float(f(1) - f(B2) ** f(count))
        neg_lr = -self.schedule(state.count)
        for name, p in params.named_parameters():
            g, mu, nu = grads[name], state.mu[name], state.nu[name]
            mu.mul_(B1).add_(g * (1 - B1))
            nu.mul_(B2).add_(g.square().mul_(1 - B2))
            u = (nu / bc2).sqrt_().add_(EPS)
            u = torch.div(mu / bc1, u, out=u)
            u.add_(p * self.weight_decay).mul_(neg_lr)
            p.add_(u)
        return AdamWState(count, state.mu, state.nu)


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 100, total_steps: int = 10_000,
                   max_grad_norm: float = 1.0) -> AdamW:
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps,
                 max_grad_norm)


def init_train_state(params: ParamTree, optimizer: AdamW) -> TrainState:
    """A TrainState at step 0 over `params` (a `params.trainable` tree),
    its moments zeros like the params."""
    if not any(True for _ in params.parameters()):
        raise ValueError("init_train_state takes a trainable tree "
                         "(params.trainable)")
    return TrainState(0, params, optimizer.init(params))


def _on_params_device(batch: Batch, params: ParamTree) -> Batch:
    device = next(itertools.chain(params.parameters(), params.buffers())).device
    return Batch(*(t.to(device) for t in batch))


def value_and_grad(params: ParamTree, batch: Batch, cfg: WhisperConfig,
                   remat: bool = False) -> Tuple[Dict[str, torch.Tensor],
                                                 Tensors]:
    """(metrics, gradients by parameter name) of `cross_entropy_loss` at
    the params' current values (the `jax.value_and_grad` of the JAX train
    step); the batch moves to the params' device. A leaf the loss does not
    reach gets a zero gradient, as in JAX. With the rows split over dp
    (`context.dp_rows`) the gradients are summed over dp."""
    names, leaves = zip(*params.named_parameters())
    batch = _on_params_device(batch, params)
    with torch.enable_grad():
        loss, metrics = cross_entropy_loss(params, batch, cfg, remat)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    if pctx.dp_shard() is not None:
        grads = [pctx.dp_sum(g) for g in grads]
    return ({k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


def make_train_step(cfg: WhisperConfig, optimizer: AdamW,
                    remat: bool = False, mesh=None):
    """(state, batch) -> (state, metrics): the loss and its gradients over
    every parameter, `grad_norm` of the UNCLIPPED gradients in the
    metrics, then the optimizer update in place. The batch moves to the
    params' device. `cfg.attention == "flash"` raises ValueError: the
    kernels have no backward.

    `mesh`: the state's params are this rank's shards
    (`sharding.shard_params`), and every rank of the mesh passes the same
    whole batch: a rank takes its B / dp rows (all of them when dp does not
    divide B) and the step runs as the module docstring says. The metrics
    are the whole batch's on every rank."""
    if cfg.attention == "flash":
        raise ValueError("attention='flash' is inference-only: no kernel "
                         "has a backward; train with attention='xla'")

    def train_step(state: TrainState, batch: Batch):
        with pctx.kernel_mesh(mesh), _dp_split(batch, mesh) as batch:
            metrics, grads = value_and_grad(state.params, batch, cfg, remat)
            norm = (global_norm(grads.values()) if mesh is None
                    else sharded_global_norm(grads, cfg, mesh))
        metrics["grad_norm"] = norm
        opt_state = optimizer.update(grads, state.opt_state, state.params,
                                     norm)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return train_step


@contextlib.contextmanager
def _dp_split(batch: Batch, mesh):
    """This rank's rows of `batch`, inside `context.dp_rows` when the mesh's
    dp divides the batch; the whole batch otherwise."""
    b = batch.mel.shape[0]
    if mesh is None or pctx.dp_axis(mesh, b) is None:
        yield batch
        return
    n = b // mesh.shape["dp"]
    first = mesh.dp_rank * n
    with pctx.dp_rows(first, b):
        yield Batch(*(t[first:first + n] for t in batch))


def make_eval_step(cfg: WhisperConfig):
    """(params, batch) -> metrics, under no_grad."""

    @torch.no_grad()
    def eval_step(params: ParamTree, batch: Batch):
        _, metrics = cross_entropy_loss(
            params, _on_params_device(batch, params), cfg)
        return metrics

    return eval_step
