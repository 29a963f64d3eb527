"""Noam learning-rate schedule and the FastSpeech2 optimizer; the JAX
package's ``train/schedule.py``.

``lr = d_model^-0.5 · lr_scale · min(step^-0.5, warmup^-1.5 · step) ·
anneal_rate^#{s in anneal_steps : step > s}``, with ``step = count + 1`` on
the ``count``-th update (counted from 0), as the reference's
ScheduledOptim.

The update is optax's chain, written out over the parameter list (no
``torch.optim`` scheduler, whose step counting is off by one against it):

1. clip by the global norm (``clip_by_global_norm``);
2. Adam with bias correction (``scale_by_adam``: ``m / (sqrt(v) + eps)``);
3. decoupled weight decay added after Adam (``add_decayed_weights``);
4. times ``-lr(count)`` (``scale_by_learning_rate``).

With ``grad_acc_step = k > 1`` it follows ``optax.MultiSteps``: the running
mean of k gradients, one update on every k-th call; the Adam count and the
schedule count updates, not calls.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable

import torch

from ..config import OptimizerConfig


def noam_schedule(d_model: int, warmup_steps: int,
                  anneal_steps: tuple[int, ...], anneal_rate: float,
                  lr_scale: float = 1.0) -> Callable[[int], float]:
    init_lr = d_model ** -0.5 * lr_scale

    def schedule(count: int) -> float:
        step = count + 1.0  # the first update is step 1
        scale = min(step ** -0.5, warmup_steps ** -1.5 * step)
        for s in anneal_steps:
            if step > s:
                scale *= anneal_rate
        return init_lr * scale

    return schedule


class Optimizer:
    """Clip + Adam + weight decay + Noam over named float32 parameters,
    updated in place. ``step(grads)`` takes one gradient per parameter, in
    the order of ``named_params``, and returns whether it updated."""

    def __init__(self, named_params: Iterable[tuple[str, torch.Tensor]],
                 cfg: OptimizerConfig, d_model: int):
        self.cfg = cfg
        self.names: list[str] = []
        self.params: list[torch.Tensor] = []
        for name, p in named_params:
            self.names.append(name)
            self.params.append(p)
        self.schedule = noam_schedule(d_model, cfg.warm_up_step,
                                      cfg.anneal_steps, cfg.anneal_rate,
                                      cfg.lr_scale)
        self.count = 0       # updates applied
        self.mini_step = 0   # gradients accumulated towards the next one
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.grad_acc_step > 1 else [])

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> bool:
        cfg = self.cfg
        if cfg.grad_acc_step > 1:
            # acc += (g - acc) / (n + 1): the running mean of the calls.
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < cfg.grad_acc_step:
                return False
            grads, self.mini_step = self.acc, 0
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = torch.where(norm < cfg.grad_clip_thresh, 1.0,
                           cfg.grad_clip_thresh / norm)
        g = torch._foreach_mul(grads, clip)
        b1, b2 = cfg.betas
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - b2)
        n = self.count + 1
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        update = torch._foreach_div(self.mu, 1.0 - b1 ** n)
        torch._foreach_div_(update, denom)
        if cfg.weight_decay:
            torch._foreach_add_(update, self.params, alpha=cfg.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-self.lr)
        self.count = n
        if self.acc:
            torch._foreach_zero_(self.acc)
        return True

    def state_dict(self) -> dict:
        def named(ts):
            return {n: t.detach().clone() for n, t in zip(self.names, ts)}

        return {"count": self.count, "mini_step": self.mini_step,
                "mu": named(self.mu), "nu": named(self.nu),
                "acc": named(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.names):
            raise KeyError("optimizer state does not match the parameters")
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for key in ("mu", "nu", "acc"):
            for name, t in zip(self.names, getattr(self, key)):
                t.copy_(state[key][name])

