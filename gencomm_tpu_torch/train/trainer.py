"""Training step machinery: the optimizer and LR schedule from the hypes,
parameter freezing for the stage-2 protocol, the train and eval steps and
the recalibration of the running statistics.

Counterpart of ``gencomm_tpu/train/trainer.py``:
  ``make_lr_schedule``    trainer.py:40-60 (optax schedules, stepped per
                          update; an unknown name is constant)
  ``make_optimizer``      trainer.py:63-89 (optax ``adamw`` / ``adam``, and
                          ``multi_transform`` with ``set_to_zero`` for the
                          frozen parameters)
  freezing predicates     trainer.py:92-135
  ``restore_frozen_batch_stats`` trainer.py:147-158
  ``make_train_step``     trainer.py:258-319 (forward in train mode, loss,
                          backward, one optimizer update)
  ``refresh_batch_stats`` trainer.py:322-353
  ``make_eval_step``      trainer.py:356-372
  ``make_kd_train_step``  trainer.py:375-414 (DiscoNet distillation)
optax's ``adamw`` applies the decay decoupled and scaled by the learning
rate, with eps added after the square root of the bias-corrected second
moment: torch's ``AdamW`` with the same ``weight_decay`` and ``eps`` does
the same update. A frozen parameter is left out of AdamW's groups (and its
``requires_grad`` turned off), since AdamW would move a parameter it holds
by the decoupled decay even at a zero gradient, where optax's
``set_to_zero`` leaves it bit for bit. A predicate takes a parameter's path,
the ``state_dict`` key split at its dots, whose first component is the flax
path's first component. Gradient matching and the BackAlign freeze are
not ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Sequence

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


class ExponentialDecay:
    """optax ``exponential_decay`` from update 0: the base value times
    ``decay_rate ** (count / transition_steps)``, the exponent floored with
    ``staircase``; constant when ``transition_steps`` is not positive."""

    def __init__(self, base: float, transition_steps: int, decay_rate: float,
                 staircase: bool = False):
        self.base, self.decay_rate = float(base), float(decay_rate)
        self.transition_steps, self.staircase = int(transition_steps), staircase

    def factor(self, count: int) -> float:
        if self.transition_steps <= 0:
            return 1.0
        p = count / self.transition_steps
        if self.staircase:
            p = float(int(p))
        return self.decay_rate ** p

    def __call__(self, count: int) -> float:
        return self.base * self.factor(count)


def make_lr_schedule(hypes: dict, steps_per_epoch: int = 1):
    """The learning rate as a function of the update count (0 for the first
    update): ``multistep`` scales by ``gamma`` at each ``step_size`` epoch,
    ``step`` by ``gamma`` every ``step_size`` epochs (a staircase),
    ``exponential`` by ``gamma`` per epoch, continuously; any other name is
    constant."""
    cfg = hypes.get("lr_scheduler", {"core_method": "constant"})
    base_lr = hypes.get("optimizer", {}).get("lr", 1e-3)
    method = cfg.get("core_method", "constant")
    if method == "multistep":
        return PiecewiseConstant(base_lr, {
            int(e * steps_per_epoch): cfg["gamma"] for e in cfg["step_size"]})
    if method == "step":
        return ExponentialDecay(base_lr,
                                int(cfg["step_size"] * steps_per_epoch),
                                cfg["gamma"], staircase=True)
    if method == "exponential":
        return ExponentialDecay(base_lr, steps_per_epoch, cfg["gamma"])
    return PiecewiseConstant(base_lr, {})


def make_optimizer(hypes: dict, named_params, steps_per_epoch: int = 1,
                   frozen_predicate: Callable[[tuple], bool] | None = None):
    """(optimizer, scheduler): AdamW from the hypes ``optimizer`` block
    (with no ``weight_decay`` it is optax's ``adam``), and a ``LambdaLR``
    that steps the schedule of ``make_lr_schedule`` once per update.

    ``named_params`` are a model's ``named_parameters()``. Each parameter
    whose dotted name the ``frozen_predicate`` takes is frozen
    (``requires_grad_(False)``) and left out of the optimizer."""
    opt_cfg = hypes.get("optimizer", {"core_method": "Adam", "lr": 1e-3})
    if opt_cfg.get("core_method", "Adam").lower() not in ("adam", "adamw"):
        raise NotImplementedError(
            f"optimizer {opt_cfg['core_method']!r} is not ported yet")
    params = []
    for name, p in named_params:
        if frozen_predicate is not None and frozen_predicate(
                tuple(name.split("."))):
            p.requires_grad_(False)
        else:
            params.append(p)
    schedule = make_lr_schedule(hypes, steps_per_epoch)
    args = opt_cfg.get("args", {})
    opt = torch.optim.AdamW(params, lr=schedule.base, betas=(0.9, 0.999),
                            eps=float(args.get("eps", 1e-8)),
                            weight_decay=float(args.get("weight_decay", 0.0)))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule.factor)


def freeze_by_prefixes(prefixes: Sequence[str]) -> Callable[[tuple], bool]:
    """Predicate taking the paths whose first component starts with any of
    ``prefixes`` (e.g. ['gencomm', 'heads', 'fusion_net', 'branch_m1'])."""

    def pred(path: tuple) -> bool:
        return any(str(path[0]).startswith(p) for p in prefixes)

    return pred


def freeze_all_except(trainable_prefixes: Sequence[str]
                      ) -> Callable[[tuple], bool]:
    """The inverse: every path is frozen unless its first component starts
    with a trainable prefix."""

    def pred(path: tuple) -> bool:
        return not any(str(path[0]).startswith(p) for p in trainable_prefixes)

    return pred


def stage2_trainable_prefixes(hypes: dict) -> list[str]:
    """GenComm stage 2: only the new (non-ego) agents' message extractors
    train."""
    args = hypes["model"]["args"]
    ego = str(args.get("ego_modality", "m1"))
    mods = [k for k in args if k.startswith("m") and k[1:].isdigit()]
    # ``not in ego``, a substring test, as the JAX package has it
    return [f"message_extractor_{m}" for m in mods if m not in ego]


def freeze_exact(names: Sequence[str]) -> Callable[[tuple], bool]:
    """Predicate taking the paths whose first component equals one of
    ``names`` (so 'heads' does not take 'heads_single')."""
    nameset = set(names)

    def pred(path: tuple) -> bool:
        return str(path[0]) in nameset

    return pred


def backalign_frozen_modules(hypes: dict) -> list[str]:
    """BackAlign's freeze schedule, for ``freeze_exact``: the fusion, the
    shared heads and the ego modality's whole branch are fixed; the new
    agents' branches train to align backwards."""
    ego = str(hypes["model"]["args"].get("ego_modality", "m1"))
    return ["fusion_net", "heads", f"branch_{ego}"]


def _running_stats(model) -> Dict[str, torch.Tensor]:
    """The norms' running statistics: flax's ``batch_stats``."""
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def restore_frozen_batch_stats(new_stats: Mapping[str, torch.Tensor],
                               old_stats: Mapping[str, torch.Tensor],
                               frozen_predicate: Callable[[tuple], bool]
                               ) -> Dict[str, torch.Tensor]:
    """``new_stats`` with the frozen modules' entries taken from
    ``old_stats``. A frozen module still normalises with its batch
    statistics in train mode (flax's ``train=True``); only its running
    statistics are kept."""
    return {k: (old_stats[k] if frozen_predicate(tuple(k.split(".")))
                and k in old_stats else v)
            for k, v in new_stats.items()}


def make_train_step(model, criterion, optimizer, scheduler=None,
                    supervise_single: bool = False,
                    frozen_predicate: Callable[[tuple], bool] | None = None):
    """``step(batch, noises=None, generator=None) -> losses``: the model's
    forward in train mode on ``batch`` (tensors on the model's device,
    labels included), the criterion, the backward and one update, all on
    the model's device. After a step the trainable parameters' ``.grad``
    hold that step's gradients. ``noises`` / ``generator`` feed the
    diffusion. With a ``frozen_predicate`` the frozen modules' running
    statistics are put back after the step. With ``supervise_single`` the
    criterion runs a second time with the suffix "_single" (per-agent heads
    or, for the HEAL pyramid, its occupancy maps, against the per-agent
    labels): its terms join the losses, a term whose name the first pass
    already has as ``<term>_single``, and its total is added."""

    def loss_fn(out, batch):
        losses = criterion(out, batch)
        if supervise_single:
            single = criterion(out, batch, suffix="_single")
            losses = dict(losses, **{
                (k if k not in losses else f"{k}_single"): v
                for k, v in single.items() if k != "total_loss"})
            losses["total_loss"] = losses["total_loss"] + single["total_loss"]
        return losses

    def step(batch: Dict[str, torch.Tensor], noises=None,
             generator: torch.Generator | None = None) -> Dict[str, torch.Tensor]:
        model.train()
        if frozen_predicate is not None:
            stats = _running_stats(model)
            old = {k: v.clone() for k, v in stats.items()
                   if frozen_predicate(tuple(k.split(".")))}
        out = model(batch, noises=noises, generator=generator)
        losses = loss_fn(out, batch)
        optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        if frozen_predicate is not None:
            with torch.no_grad():
                for k, v in restore_frozen_batch_stats(
                        stats, old, frozen_predicate).items():
                    stats[k].copy_(v)
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_eval_step(model, criterion):
    """``eval_step(batch, noises=None, generator=None) -> losses``: the
    model's forward in eval mode (running statistics) and the criterion, no
    gradient and no update; the validation half of an epoch."""

    def eval_step(batch: Dict[str, torch.Tensor], noises=None,
                  generator: torch.Generator | None = None
                  ) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            out = model(batch, noises=noises, generator=generator)
            return criterion(out, batch)

    return eval_step


def refresh_batch_stats(model, batches: Iterable, momentum: float = 0.99,
                        generator: torch.Generator | None = None,
                        noises: Sequence | None = None) -> None:
    """Replace the norms' running averages by the data's own statistics
    (precise BN): one train-mode forward per batch from the same running
    values gives ra' = m * ra + (1 - m) * b per layer, so each batch's
    statistics are b = (ra' - m * ra) / (1 - m), averaged over ``batches``.
    ``momentum`` is flax's convention (0.99, torch's 0.01), the port's
    norms' own. ``noises``, one entry per batch, replaces the diffusion
    noise drawn from ``generator``."""
    stats = _running_stats(model)
    start = {k: v.clone() for k, v in stats.items()}
    acc, n = {k: torch.zeros_like(v) for k, v in stats.items()}, 0
    model.train()
    with torch.no_grad():
        for i, batch in enumerate(batches):
            for k, v in stats.items():
                v.copy_(start[k])
            model(batch, noises=None if noises is None else noises[i],
                  generator=generator)
            for k, v in stats.items():
                acc[k] += (v - momentum * start[k]) / (1.0 - momentum)
            n += 1
        for k, v in stats.items():
            v.copy_(acc[k] / n if n else start[k])


def make_kd_train_step(student, teacher, criterion, optimizer,
                       scheduler=None, feature_key: str = "feature"):
    """DiscoNet knowledge distillation (trainer.py:375-414): ``step(batch,
    noises=None, generator=None) -> losses``. The teacher runs frozen in
    eval mode (running statistics, no gradient) and its ``feature_key``
    output is injected into the student's outputs as ``teacher_feature``,
    the student's own as ``student_feature``, for the KD criterion
    (``point_pillar_disconet_loss``); then the student's backward and one
    update. Both draw the same diffusion noise, as both JAX applies take
    the step's rngs: the given ``noises``, or from ``generator``, whose
    state the student's forward starts from again."""

    def step(batch: Dict[str, torch.Tensor], noises=None,
             generator: torch.Generator | None = None) -> Dict[str, torch.Tensor]:
        teacher.eval()
        start = generator.get_state() if generator is not None else None
        with torch.no_grad():
            teacher_feature = teacher(batch, noises=noises,
                                      generator=generator)[feature_key]
        if generator is not None:
            generator.set_state(start)
        student.train()
        out = dict(student(batch, noises=noises, generator=generator))
        out["teacher_feature"] = teacher_feature
        out["student_feature"] = out[feature_key]
        losses = criterion(out, batch)
        optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_gmatch_train_step(*args, **kwargs):
    """GenComm gradient-matching ablation (trainer.py:415): not ported yet."""
    raise NotImplementedError(
        "the gradient-matching train step is not ported yet (ROADMAP item 16)")
