"""The training step: loss, gradients, optimizer update, metrics — the twin of
``valle_tpu/train/step.py``:

  - reduction "sum" loss, no normalisation before the optimizer;
  - gradients summed over the A micro-batches of the batch's leading axis
    before one optimizer step (``backward`` accumulates into ``.grad``);
  - stage-filtered parameters: only ``ar_*`` / ``nar_*`` parameters get
    gradients and optimizer state at stages 1 / 2;
  - every trainable parameter takes a gradient, zero where it took no part
    in the forward, as JAX's optimizer updates every trainable leaf;
  - a global grad-norm clip (1.0 for plain Adam / AdamW only);
  - the learning rate from ``lr_fn(step, epoch)``, and model averaging.

The step takes a CPU ``torch.Generator`` as its random source: dropout seeds
and the forward's draws (NAR stage, prefix length) come from it, so drawing
them never syncs the card, and the same generator state repeats a step.

Data parallelism (``mesh``, from ``parallel/mesh.py``): each rank runs its
own part of the global batch, padded to the group's text and audio widths
(``parallel.mesh.pad_to_group_widths``), then the gradients are summed over the data
group in flattened buckets (SUM, as JAX's gradient of the sum loss over the
global batch; DistributedDataParallel would average), the zero-filled ones
of parameters that took no part included, before the clip and the update;
the summed metrics are summed over the group before ``inf_check`` reads the
loss, so every rank takes the same branch.  The forward's shared draws (the
NAR stage) are the group's first rank's and its batch-wide quantities the
whole batch's (``parallel.mesh.global_batch``), and dropout seeds are folded
with the rank (``ops/philox.py::draw_seed``).  A group of
one gives the single-process step bit for bit.

Mixed precision follows the JAX package: under ``dtype="bfloat16"`` the
parameters, gradients, optimizer state and averaged model are f32, the
modules compute in bf16 and cast the weights at each call (the training
build, ``models.get_model(cfg, training=True)``), and the losses sum in
f32.  ``init_train_state`` refuses a model whose parameters are not f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from valle_tpu_torch.parallel import dist
from valle_tpu_torch.parallel.mesh import global_batch, pad_to_group_widths
from valle_tpu_torch.train.state import TrainState, partition_params, update_model_avg


def _forward(model, micro: Dict[str, torch.Tensor], a: int, train_stage: int, rng):
    kw = {}
    if "prompt_codes" in micro:
        kw["y_prompts_codes"] = micro["prompt_codes"][a]
    if "example_mask" in micro:
        kw["example_mask"] = micro["example_mask"][a]
    return model(micro["text_tokens"][a], micro["text_tokens_lens"][a],
                 micro["audio_features"][a], micro["audio_features_lens"][a],
                 train_stage=train_stage, rng=rng, **kw)


def accumulate_gradients(model, batch: Dict[str, torch.Tensor], train_stage: int,
                         rng: torch.Generator) -> Dict[str, torch.Tensor]:
    """Forward and backward over the A micro-batches of ``batch``, the
    gradients summed into ``.grad``; the summed metrics (detached)."""
    metrics = None
    names = model.metric_names(train_stage)
    for a in range(batch["text_tokens"].shape[0]):
        out = _forward(model, batch, a, train_stage, rng)
        out["loss"].backward()
        part = {k: out[k].detach() for k in names}
        metrics = part if metrics is None else {k: metrics[k] + part[k] for k in names}
    return metrics


def reduce_gradients_(params, group) -> int:
    """Sum the ``.grad`` of ``params`` over ``group`` in flattened buckets, in
    place; returns the bytes reduced."""
    return dist.coalesced_([p.grad for p in params], "sum", group)


def reduce_metrics_(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The summed metrics summed over ``group`` (one collective)."""
    if group is None:
        return metrics
    total = dist.all_reduce_(torch.stack([metrics[k].float() for k in metrics]), "sum", group)
    return {k: v.to(metrics[k].dtype) for k, v in zip(metrics, total.unbind())}


class NonFiniteLoss(FloatingPointError):
    """The step's loss is not finite; raised before the update, so the
    weights are those that gave it."""

    def __init__(self, metrics: Dict[str, torch.Tensor]):
        super().__init__(f"non-finite loss: { {k: float(v) for k, v in metrics.items()} }")
        self.metrics = metrics


def make_train_step(
    lr_fn: Callable[[int, int], float],
    *,
    train_stage: int = 0,
    clip_grad_norm: Optional[float] = None,
    average_period: int = 0,
    deterministic: bool = False,
    inf_check: bool = False,
    mesh=None,
):
    """Returns ``step(state, batch, rng, epoch) -> (state, metrics)``; the
    state is updated in place and returned.  With ``mesh`` (a data-parallel
    ``parallel.mesh.Mesh``) ``batch`` is this rank's part of the global
    batch and the step is the global batch's (module docstring).

    ``batch`` is a dict with a leading micro-batch axis A: text_tokens
    (A,B,S), text_tokens_lens (A,B), audio_features (A,B,T,Q) codes (or
    (A,B,T,M) float mels for the Transformer baseline), audio_features_lens
    (A,B), and optionally prompt_codes (A,B,P,Q) for prefix mode 4 and
    example_mask (A,B).  ``deterministic`` turns dropout
    off (the model runs in eval mode); the forward's draws still come from
    ``rng``.  ``inf_check`` reads the loss on the host before the update
    and raises :class:`NonFiniteLoss` if it is not finite, leaving the
    weights and the optimizer as they were (JAX checks after the update).
    """

    group = None if mesh is None else mesh.data_group

    def step(state: TrainState, batch: dict, rng: torch.Generator, epoch: int = 0):
        model, opt = state.model, state.optimizer
        model.train(not deterministic)
        opt.zero_grad(set_to_none=True)
        with global_batch(model, group):
            metrics = accumulate_gradients(model, pad_to_group_widths(batch, group),
                                           train_stage, rng)
        metrics = reduce_metrics_(metrics, group)
        if inf_check and not bool(torch.isfinite(metrics["loss"])):
            opt.zero_grad(set_to_none=True)
            raise NonFiniteLoss(metrics)

        # a trainable parameter that took no part in the forward (a NAR stage
        # that was not drawn) gets a zero gradient: JAX's optimizer updates
        # every trainable leaf, so its moments decay and its momentum moves it
        params = [p for pg in opt.param_groups for p in pg["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        reduce_gradients_(params, group)
        if clip_grad_norm is not None:
            grads = [p.grad for p in params]
            gnorm = torch.stack(torch._foreach_norm(grads)).pow(2).sum().sqrt()
            torch._foreach_mul_(grads, (clip_grad_norm / (gnorm + 1e-12)).clamp(max=1.0))

        lr = lr_fn(state.step, epoch)
        opt.step(lr=lr)
        opt.zero_grad(set_to_none=True)
        state.step += 1
        if average_period and state.model_avg is not None:
            params = dict(model.named_parameters(remove_duplicate=True))
            update_model_avg(state.model_avg, params, state.step, average_period)
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        return state, metrics

    return step


def make_eval_step(*, train_stage: int = 0):
    """Validation loss / metrics: no dropout and no gradients; the NAR stage
    draw uses ``rng``.  Returns ``eval_step(model, batch, rng) -> out`` for
    one micro-batch (no leading A axis)."""

    def eval_step(model, batch: dict, rng: torch.Generator):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return _forward(model, {k: v[None] for k, v in batch.items()}, 0,
                                train_stage, rng)
        finally:
            model.train(was_training)

    return eval_step


def init_train_state(
    model,
    make_optimizer: Callable,
    *,
    train_stage: int = 0,
    with_model_avg: bool = False,
) -> TrainState:
    """The state of a fresh run: ``model`` in train mode, the optimizer built
    by ``make_optimizer(params)`` over the stage's trainable parameters
    only (the frozen ones get no gradient and no optimizer state), and an f32
    copy of every parameter when ``with_model_avg``.  ``model`` holds f32
    parameters whatever its compute dtype: the training build of
    ``models.get_model(cfg, training=True)``."""
    low = sorted({str(p.dtype) for p in model.parameters()
                  if p.is_floating_point() and p.dtype != torch.float32})
    if low:
        raise ValueError(
            f"training needs f32 parameters, found {', '.join(low)} (bf16 parameters come "
            "from the inference build): mixed precision keeps f32 master weights, "
            "gradients and optimizer state and computes in cfg.dtype; build the model with "
            "get_model(cfg, training=True)")
    model.train()
    trainable, frozen = partition_params(model, train_stage)
    for p in trainable.values():
        p.requires_grad_(True)
    for p in frozen.values():
        p.requires_grad_(False)
    model_avg = None
    if with_model_avg:
        model_avg = {name: p.detach().float().clone()
                     for name, p in model.named_parameters(remove_duplicate=True)}
    return TrainState(step=0, model=model, optimizer=make_optimizer(list(trainable.values())),
                      model_avg=model_avg)
