"""The labelers' step decay, the detector's OneCycle schedule, the torchie LR
policies and their AdamW.

Port of ``tdal/runtime/schedules.py``: ``labeler_step_decay`` (:21-38), ``one_cycle``
(:41-79), the torchie ``LrUpdaterHook`` policies ``fixed_lr``, ``step_lr``,
``exp_lr``, ``poly_lr``, ``inv_lr``, ``cosine_lr`` and the ``with_warmup`` wrapper
(:82-164), and the optax chain of ``adam_with_schedule`` (:166-193). Every schedule is
a function of the number of updates already taken. Only ``one_cycle`` and the step
decay drive the port's trainers, as in tdal.
"""

from __future__ import annotations

import math

import torch


def labeler_step_decay(init_lr: float, steps_per_epoch: int, step_size: int = 20,
                       gamma: float = 0.7, eta_min: float = 1e-5):
    """The labeler tools' per-epoch LambdaLR (tools/static_train.py:222-227) as a
    function of the number of updates taken: init_lr * gamma^(epoch // step_size)
    while that exceeds ``eta_min``, else init_lr * 0.01 (the reference's quirk: the
    rate jumps to 1% of its start once the decay reaches the floor)."""

    def schedule(step):
        lr = init_lr * gamma ** ((step // steps_per_epoch) // step_size)
        return lr if lr > eta_min else init_lr * 0.01

    return schedule


def one_cycle(lr_max: float, total_steps: int, moms=(0.95, 0.85), div_factor: float = 10.0,
              pct_start: float = 0.4):
    """fastai OneCycle (det3d/solver/learning_schedules_fastai.py:77-97): cosine ramp
    lr_max/div -> lr_max over the first ``pct_start`` of the steps, then lr_max ->
    lr_max/1e4; momentum high -> low -> high. Returns (lr_schedule, momentum_schedule),
    functions of the number of updates already taken."""
    low_lr = lr_max / div_factor
    a1 = int(total_steps * pct_start)
    a2 = total_steps - a1

    def _cos(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def _phase(step):
        step = min(step, total_steps)
        pct1 = min(max(step / max(a1, 1), 0.0), 1.0)
        pct2 = min(max((step - a1) / max(a2, 1), 0.0), 1.0)
        return step <= a1, pct1, pct2

    def lr_schedule(step):
        first, pct1, pct2 = _phase(step)
        return _cos(low_lr, lr_max, pct1) if first else _cos(lr_max, lr_max / 1e4, pct2)

    def momentum_schedule(step):
        first, pct1, pct2 = _phase(step)
        return _cos(moms[0], moms[1], pct1) if first else _cos(moms[1], moms[0], pct2)

    return lr_schedule, momentum_schedule


def fixed_lr(base_lr: float):
    """torchie FixedLrUpdaterHook (lr_updater.py:85-90)."""
    return lambda step: base_lr


def step_lr(base_lr: float, step_size, gamma: float = 0.1, steps_per_epoch: int = 1):
    """torchie StepLrUpdaterHook (lr_updater.py:93-119): base_lr * gamma^k, k the
    number of ``step_size`` periods (an int, in epochs) or of milestones (a list of
    epochs) passed; ``steps_per_epoch=1`` is by_epoch=False."""

    def schedule(step):
        progress = step // steps_per_epoch
        if isinstance(step_size, int):
            exp = progress // step_size
        else:
            exp = sum(progress >= m for m in step_size)
        return base_lr * gamma**exp

    return schedule


def exp_lr(base_lr: float, gamma: float, steps_per_epoch: int = 1):
    """torchie ExpLrUpdaterHook (lr_updater.py:122-129)."""
    return lambda step: base_lr * gamma ** (step // steps_per_epoch)


def poly_lr(base_lr: float, total_steps: int, power: float = 1.0, min_lr: float = 0.0):
    """torchie PolyLrUpdaterHook (lr_updater.py:132-146)."""

    def schedule(step):
        coeff = (1.0 - min(step, total_steps) / total_steps) ** power
        return (base_lr - min_lr) * coeff + min_lr

    return schedule


def inv_lr(base_lr: float, gamma: float, power: float = 1.0, steps_per_epoch: int = 1):
    """torchie InvLrUpdaterHook (lr_updater.py:149-157)."""
    return lambda step: base_lr * (1.0 + gamma * (step // steps_per_epoch)) ** (-power)


def cosine_lr(base_lr: float, total_steps: int, target_lr: float = 0.0):
    """torchie CosineLrUpdaterHook (lr_updater.py:160-175)."""

    def schedule(step):
        pct = min(step, total_steps) / total_steps
        return target_lr + 0.5 * (base_lr - target_lr) * (1.0 + math.cos(math.pi * pct))

    return schedule


def with_warmup(schedule, warmup_steps: int, warmup_ratio: float = 1.0 / 3.0,
                mode: str = "linear"):
    """torchie's warmup (trainer/hooks/lr_updater.py:36-55): below ``warmup_steps`` the
    schedule's value times a ratio that is constant, or ramps linearly or
    exponentially from ``warmup_ratio`` to 1."""
    if mode not in ("constant", "linear", "exp"):
        raise ValueError(mode)

    def warmed(step):
        base = schedule(step)
        if step >= warmup_steps:
            return base
        if mode == "constant":
            return base * warmup_ratio
        pct = step / max(warmup_steps, 1)
        if mode == "linear":
            return base * (1.0 - (1.0 - pct) * (1.0 - warmup_ratio))
        return base * warmup_ratio ** (1.0 - pct)

    return warmed


class AdamWSchedule(torch.optim.Optimizer):
    """optax ``chain(clip_by_global_norm(grad_clip), inject_hyperparams(adamw)(b1=
    momentum_schedule, learning_rate=lr_schedule))`` as a torch optimizer.

    Per step, with n the number of updates already taken: the gradients are scaled
    by max_norm / norm when their global norm is at least ``grad_clip``; then
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, u = m / (1 - b1^(n+1)) /
    (sqrt(v / (1 - b2^(n+1))) + eps) + weight_decay * p (decoupled, every parameter),
    and p -= lr u, with lr and b1 the schedules evaluated at n."""

    def __init__(self, params, lr_schedule, weight_decay: float = 0.0,
                 grad_clip: float | None = None, momentum_schedule=None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(weight_decay=weight_decay, b2=b2, eps=eps))
        self.lr_schedule, self.momentum_schedule = lr_schedule, momentum_schedule
        self.grad_clip, self.b1 = grad_clip, b1
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        groups = [(g, [p for p in g["params"] if p.grad is not None])
                  for g in self.param_groups]
        grads = {p: p.grad for _, ps in groups for p in ps}
        if self.grad_clip is not None:
            norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))
            clip = norm >= self.grad_clip
            grads = {p: torch.where(clip, g / norm * self.grad_clip, g)
                     for p, g in grads.items()}
        n = self.count
        lr = float(self.lr_schedule(n))
        b1 = float(self.momentum_schedule(n)) if self.momentum_schedule else self.b1
        for group, ps in groups:
            b2, eps, wd = group["b2"], group["eps"], group["weight_decay"]
            for p in ps:
                g = grads[p]
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros_like(p)
                    st["v"] = torch.zeros_like(p)
                m, v = st["m"], st["v"]
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g * g * (1 - b2))
                u = (m / (1 - b1 ** (n + 1))) / (torch.sqrt(v / (1 - b2 ** (n + 1))) + eps)
                p.sub_(lr * (u + wd * p))
        self.count += 1
        return None


def adam_with_schedule(params, lr_schedule, weight_decay: float = 0.0,
                       grad_clip: float | None = None, momentum_schedule=None,
                       b2: float = 0.999):
    """AdamW with decoupled weight decay on every parameter, an optional global-norm
    gradient clip and an optional scheduled b1 (tdal's detector optimizer)."""
    return AdamWSchedule(params, lr_schedule, weight_decay, grad_clip, momentum_schedule,
                         b2=b2)
