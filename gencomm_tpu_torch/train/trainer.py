"""Training step machinery: the optimizer and LR schedule from the hypes,
and the train step.

Counterpart of ``gencomm_tpu/train/trainer.py``:
  ``make_lr_schedule``  trainer.py:40-60 (optax schedules, stepped per update)
  ``make_optimizer``    trainer.py:63-89 (optax ``adamw`` / ``adam``)
  ``make_train_step``   trainer.py:258-319 (forward in train mode, loss,
                        backward, one optimizer update)
optax's ``adamw`` applies the decay decoupled and scaled by the learning
rate, with eps added after the square root of the bias-corrected second
moment: torch's ``AdamW`` with the same ``weight_decay`` and ``eps`` does
the same update. Freezing (stage 2), ``supervise_single``, distillation and
gradient matching are not ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


class PiecewiseConstant:
    """optax ``piecewise_constant_schedule``: the base value times every
    scale whose boundary the update count has reached."""

    def __init__(self, base: float, boundaries: Dict[int, float]):
        self.base = float(base)
        self.boundaries = dict(sorted(boundaries.items()))

    def factor(self, count: int) -> float:
        f = 1.0
        for bound, scale in self.boundaries.items():
            if count >= bound:
                f *= scale
        return f

    def __call__(self, count: int) -> float:
        return self.base * self.factor(count)


def make_lr_schedule(hypes: dict, steps_per_epoch: int = 1) -> PiecewiseConstant:
    """The learning rate as a function of the update count (0 for the first
    update). ``multistep`` scales by ``gamma`` at each ``step_size`` epoch;
    other schedules are not ported yet."""
    cfg = hypes.get("lr_scheduler", {"core_method": "constant"})
    base_lr = hypes.get("optimizer", {}).get("lr", 1e-3)
    method = cfg.get("core_method", "constant")
    if method == "multistep":
        return PiecewiseConstant(base_lr, {
            int(e * steps_per_epoch): cfg["gamma"] for e in cfg["step_size"]})
    if method == "constant":
        return PiecewiseConstant(base_lr, {})
    raise NotImplementedError(f"lr_scheduler {method!r} is not ported yet")


def make_optimizer(hypes: dict, params, steps_per_epoch: int = 1,
                   frozen_predicate: Callable | None = None):
    """(optimizer, scheduler): AdamW from the hypes ``optimizer`` block
    (with no ``weight_decay`` it is optax's ``adam``), and a ``LambdaLR``
    that steps the schedule of ``make_lr_schedule`` once per update."""
    if frozen_predicate is not None:
        raise NotImplementedError("parameter freezing is not ported yet")
    opt_cfg = hypes.get("optimizer", {"core_method": "Adam", "lr": 1e-3})
    if opt_cfg.get("core_method", "Adam").lower() not in ("adam", "adamw"):
        raise NotImplementedError(
            f"optimizer {opt_cfg['core_method']!r} is not ported yet")
    schedule = make_lr_schedule(hypes, steps_per_epoch)
    args = opt_cfg.get("args", {})
    opt = torch.optim.AdamW(params, lr=schedule.base, betas=(0.9, 0.999),
                            eps=float(args.get("eps", 1e-8)),
                            weight_decay=float(args.get("weight_decay", 0.0)))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule.factor)


def make_train_step(model, criterion, optimizer, scheduler=None,
                    supervise_single: bool = False):
    """``step(batch, noises=None, generator=None) -> losses``: the model's
    forward in train mode on ``batch`` (tensors on the model's device,
    labels included), the criterion, the backward and one update, all on
    the model's device. After a step the parameters' ``.grad`` hold that
    step's gradients. ``noises`` / ``generator`` feed the diffusion."""
    if supervise_single:
        raise NotImplementedError("supervise_single is not ported yet")

    def step(batch: Dict[str, torch.Tensor], noises=None,
             generator: torch.Generator | None = None) -> Dict[str, torch.Tensor]:
        model.train()
        out = model(batch, noises=noises, generator=generator)
        losses = criterion(out, batch)
        optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_kd_train_step(*args, **kwargs):
    """DiscoNet distillation (trainer.py:375): not ported yet."""
    raise NotImplementedError("the distillation train step is not ported yet")


def make_gmatch_train_step(*args, **kwargs):
    """GenComm gradient-matching ablation (trainer.py:415): not ported yet."""
    raise NotImplementedError("the gradient-matching train step is not "
                              "ported yet")
