"""The reference's training steps: the PointPillars loss, its gradients by autograd,
the global-norm clip and AdamW under fastai's OneCycle (det3d's
learning_schedules_fastai and its adam with decoupled, fixed weight decay), in plain
float32 torch.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.models import center_loss, pointpillars_train


def total_steps(config_file: dict, batch: int) -> int:
    """Steps of the published job's schedule: its epochs over the assumed training
    frames at the published global batch (``batch`` a card, ``device_ids`` cards)."""
    cards = len(config_file["published"]["device_ids"])
    frames = int(config_file["assumed"]["train_frames"])
    return math.ceil(frames / (batch * cards)) * int(config_file["config"]["total_epochs"])


def one_cycle(lr_max, total, moms, div, pct):
    """(lr(n), b1(n)) after n updates: a cosine from lr_max / div up to lr_max over the
    first ``pct`` of the steps, then down to lr_max / 1e4; b1 the other way."""
    a1 = int(total * pct)
    a2 = total - a1

    def cos(start, end, f):
        return end + (start - end) / 2.0 * (math.cos(math.pi * f) + 1.0)

    def at(n, up, down):
        n = min(n, total)
        if n <= a1:
            return cos(up[0], up[1], min(max(n / max(a1, 1), 0.0), 1.0))
        return cos(down[0], down[1], min(max((n - a1) / max(a2, 1), 0.0), 1.0))

    def lr(n):
        return at(n, (lr_max / div, lr_max), (lr_max, lr_max / 1e4))

    def b1(n):
        return at(n, (moms[0], moms[1]), (moms[1], moms[0]))

    return lr, b1


def reference_steps(w: dict, params, batches, cfg, total: int, device) -> dict:
    """Train the reference from the weights ``w`` on ``batches`` (numpy points and
    targets): {losses, grad1 (each parameter's first clipped gradient norm), after3
    (each parameter's change over the steps, its norm), delta (that change)}."""
    lc = cfg["lr_config"]
    lr, b1 = one_cycle(lc["lr_max"], total, lc["moms"], lc["div_factor"], lc["pct_start"])
    clip, wd = float(cfg["grad_clip"]["max_norm"]), float(cfg["optimizer"]["wd"])
    head = cfg["model"]["bbox_head"]
    leaves = {k: w[k].clone().requires_grad_(True) for k in params}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    losses, grad1 = [], None
    for n, (pts, tasks) in enumerate(batches):
        weights = dict(w)
        weights.update(leaves)
        points = torch.as_tensor(pts, device=device)
        targets = [tuple(torch.as_tensor(t, device=device) for t in task) for task in tasks]
        loss = center_loss(pointpillars_train(points, weights, cfg), targets,
                           head["code_weights"], float(head["weight"]))
        grads = torch.autograd.grad(loss, [leaves[k] for k in params], allow_unused=True)
        losses.append(loss.item())
        with torch.no_grad():
            g = {k: (torch.zeros_like(leaves[k]) if gr is None else gr)
                 for k, gr in zip(params, grads)}
            norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
            if float(norm) >= clip:
                g = {k: x / norm * clip for k, x in g.items()}
            if n == 0:
                grad1 = {k: float(x.norm()) for k, x in g.items()}
            beta1, rate = b1(n), lr(n)
            for k, p in leaves.items():
                m[k].mul_(beta1).add_(g[k] * (1 - beta1))
                v2[k].mul_(0.999).add_(g[k] * g[k] * (1 - 0.999))
                u = (m[k] / (1 - beta1 ** (n + 1))) / (
                    torch.sqrt(v2[k] / (1 - 0.999 ** (n + 1))) + 1e-8)
                p.sub_(rate * (u + wd * p))
    with torch.no_grad():
        delta = {k: leaves[k].detach() - w[k] for k in params}
    return {"losses": losses, "grad1": grad1, "delta": delta,
            "after3": {k: float(d.norm()) for k, d in delta.items()}}
