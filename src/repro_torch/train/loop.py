"""The training step on one device (``repro.train.loop``): loss, gradients,
optional int8 gradient compression, clipping and AdamW, with strided
microbatch accumulation.

``make_train_step(model)`` returns ``train_step(opt_state, batch[,
compress_state])``.  It unfreezes the model's parameters, takes their
gradients with ``torch.autograd.grad`` and updates them in place; parameters,
gradients and moments are dicts keyed by the model's ``state_dict`` names.
The reference annotates the one-hot and the microbatches with sharding hints
(``distributed.annotate.ann``), which are the identity without a mesh; on one
device the port has none.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import compression
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.optim.schedules import linear_warmup_cosine


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Next-token cross-entropy (logits float32 (B, S, V), labels (B, S)) with
    z-loss.  The gold logit is a one-hot contraction, as in the reference,
    written as a product and a sum: with one nonzero term a row it is exact
    in any order."""
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:]
    logz = torch.logsumexp(shift_logits, dim=-1)
    onehot = F.one_hot(shift_labels.long(), logits.shape[-1]).to(shift_logits.dtype)
    gold = torch.sum(shift_logits * onehot, dim=-1)
    ce = torch.mean(logz - gold)
    return ce + z_loss * torch.mean(logz ** 2)


def make_loss_fn(model: Model, aux_weight: float = 0.01) -> Callable:
    """loss_fn(batch) -> (loss, {"ce", "aux"}) over the model's parameters."""
    def loss_fn(batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        logits, aux = model.apply(batch)
        ce = cross_entropy_loss(logits, batch["labels"])
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def _strided(x: torch.Tensor, microbatch: int) -> torch.Tensor:
    """(B, ...) -> (microbatch, B / microbatch, ...); microbatch i holds rows
    i, i + microbatch, ... (the reference's reshape and swap)."""
    return x.reshape((-1, microbatch) + tuple(x.shape[1:])).transpose(0, 1)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    compress_grads: bool = False, microbatch: int = 1) -> Callable:
    """Build the train step over ``model``, whose parameters it unfreezes.

    ``train_step(opt_state, batch[, compress_state])`` updates the parameters
    in place and returns ``(opt_state, metrics, grads)``, with the new
    error-feedback state appended under ``compress_grads``.  ``grads`` are the
    loss's gradients before compression and clipping.  ``metrics`` are the
    reference's: loss, grad_norm (before clipping), lr_scale, and ce and aux
    without microbatches.  ``microbatch`` > 1 splits the batch strided and
    averages float32 gradients over the microbatches (the reference's scan
    and its unrolled loop are the same arithmetic; this is the loop).
    """
    model.requires_grad_(True)
    loss_fn = make_loss_fn(model)
    groups = model.stacked_groups()

    def single_grads(params, batch):
        loss, metrics = loss_fn(batch)
        found = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), found)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(opt_state: Dict, batch: Dict[str, torch.Tensor], compress_state=None):
        params = dict(model.named_parameters())
        if microbatch > 1:
            parts = {k: _strided(v, microbatch) for k, v in batch.items()}
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in params.items()}
            losses = []
            for i in range(microbatch):
                loss, _, g = single_grads(params, {k: v[i] for k, v in parts.items()})
                gsum = {k: gsum[k] + g[k] for k in gsum}
                losses.append(loss)
            grads = {k: g / microbatch for k, g in gsum.items()}
            loss = torch.mean(torch.stack(losses))
            metrics = {}
        else:
            loss, metrics, grads = single_grads(params, batch)

        applied = grads
        if compress_grads:
            applied, compress_state = compression.compress_decompress(applied, compress_state,
                                                                      groups)
        applied, gnorm = adamw.clip_by_global_norm(applied, opt_cfg.grad_clip_norm)
        lr_scale = linear_warmup_cosine(opt_state["step"] + 1, warmup_steps, total_steps)
        newp, opt_state = adamw.adamw_update(params, applied, opt_state, opt_cfg, lr_scale)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(newp[k])
        out = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale, **metrics}
        if compress_grads:
            return opt_state, out, grads, compress_state
        return opt_state, out, grads

    return train_step


@torch.no_grad()
def load_params(model: Model, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy ``params`` (keyed by ``state_dict`` names) into the model's own
    parameters, which the train step reads and updates in place, skipping
    those that already are them; returns the model's parameters by name."""
    live = dict(model.named_parameters())
    for k, p in live.items():
        if params[k] is not p:
            p.copy_(params[k])
    return live


def make_eval_step(model: Model) -> Callable:
    """eval_step(batch) -> {"loss", "ce", "aux"}, recording no graph."""
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(batch):
        loss, metrics = loss_fn(batch)
        return {"loss": loss, **metrics}

    return eval_step
