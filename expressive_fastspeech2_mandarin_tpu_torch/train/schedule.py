"""Noam learning-rate schedule and the FastSpeech2 optimizer; the JAX
package's ``train/schedule.py``.

``lr = d_model^-0.5 · lr_scale · min(step^-0.5, warmup^-1.5 · step) ·
anneal_rate^#{s in anneal_steps : step > s}``, with ``step = count + 1`` on
the ``count``-th update (counted from 0), as the reference's
ScheduledOptim; in float32 on the count's device, as the JAX package
computes it inside its jitted step.

The update is optax's chain, written out over the parameter list (no
``torch.optim`` scheduler, whose step counting is off by one against it):

1. clip by the global norm (``clip_by_global_norm``);
2. Adam with bias correction (``scale_by_adam``: ``m / (sqrt(v) + eps)``);
3. decoupled weight decay added after Adam (``add_decayed_weights``);
4. times ``-lr(count)`` (``scale_by_learning_rate``).

With ``grad_acc_step = k > 1`` it follows ``optax.MultiSteps``: every call
adds to the running mean of the gradients and computes the update from
it, and only every k-th call keeps it (the Adam moments, the count and the
parameters are selected by a device flag, the mean zeroed), so the
schedule counts updates, not calls.

The counts live on the parameters' device, as everything the update
reads, so that a step makes no host round trip and a CUDA graph can
capture it (``train.step.make_train_step``); ``lr`` and ``state_dict`` read
them back.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable

import torch

from ..config import OptimizerConfig


def noam_schedule(d_model: int, warmup_steps: int,
                  anneal_steps: tuple[int, ...], anneal_rate: float,
                  lr_scale: float = 1.0
                  ) -> Callable[[torch.Tensor | int], torch.Tensor]:
    """The learning rate of update ``count`` (an int, or an integer tensor
    on any device), a float32 tensor on the count's device."""
    init_lr = d_model ** -0.5 * lr_scale

    def schedule(count: torch.Tensor | int) -> torch.Tensor:
        step = torch.as_tensor(count).float() + 1.0  # the first update is 1
        scale = torch.minimum(step ** -0.5, warmup_steps ** -1.5 * step)
        for s in anneal_steps:
            scale = torch.where(step > s, scale * anneal_rate, scale)
        return init_lr * scale

    return schedule


class Optimizer:
    """Clip + Adam + weight decay + Noam over named float32 parameters,
    updated in place. ``step(grads)`` takes one gradient per parameter, in
    the order of ``named_params``."""

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
        device = self.params[0].device
        # Updates applied, and gradients accumulated towards the next one.
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.mini_step = torch.zeros((), dtype=torch.int64, device=device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.grad_acc_step > 1 else [])

    @property
    def lr(self) -> float:
        """The learning rate of the next update (read from the device)."""
        return float(self.schedule(self.count))

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor of the optimizer's state, the counts included."""
        return [self.count, self.mini_step, *self.mu, *self.nu, *self.acc]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        cfg = self.cfg
        k = cfg.grad_acc_step
        mu, nu, emit = self.mu, self.nu, None
        if k > 1:
            # acc += (g - acc) / (n + 1): the running mean of the calls.
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, (self.mini_step + 1).float())
            torch._foreach_add_(self.acc, diff)
            emit = self.mini_step == k - 1
            self.mini_step.copy_((self.mini_step + 1) % k)
            grads = self.acc
            # The inner update on copies, kept where ``emit`` holds.
            mu, nu = torch._foreach_mul(mu, 1.0), torch._foreach_mul(nu, 1.0)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = torch.where(norm < cfg.grad_clip_thresh, 1.0,
                           cfg.grad_clip_thresh / norm)
        g = torch._foreach_mul(grads, clip)
        b1, b2 = cfg.betas
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        n = (self.count + 1).float()
        denom = torch._foreach_div(nu, 1.0 - b2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        update = torch._foreach_div(mu, 1.0 - b1 ** n)
        torch._foreach_div_(update, denom)
        if cfg.weight_decay:
            torch._foreach_add_(update, self.params, alpha=cfg.weight_decay)
        torch._foreach_mul_(update, -self.schedule(self.count))
        if emit is None:
            self.count.add_(1)
        else:
            for old, new in ((self.mu, mu), (self.nu, nu)):
                for o, v in zip(old, new):
                    torch.where(emit, v, o, out=o)
            # optax.MultiSteps: a zero update between updates and the mean
            # cleared at one (not a product, which lets a NaN through).
            zero = torch.zeros((), device=emit.device)
            for u, a in zip(update, self.acc):
                torch.where(emit, u, zero, out=u)
                torch.where(emit, zero, a, out=a)
            self.count.add_(emit.long())
        torch._foreach_add_(self.params, update)

    def state_dict(self) -> dict:
        def named(ts):
            return {n: t.detach().clone() for n, t in zip(self.names, ts)}

        return {"count": int(self.count), "mini_step": int(self.mini_step),
                "mu": named(self.mu), "nu": named(self.nu),
                "acc": named(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """In place, so that the graphs that read these tensors stay
        valid."""
        if set(state["mu"]) != set(self.names):
            raise KeyError("optimizer state does not match the parameters")
        self.count.fill_(int(state["count"]))
        self.mini_step.fill_(int(state["mini_step"]))
        for key in ("mu", "nu", "acc"):
            for name, t in zip(self.names, getattr(self, key)):
                t.copy_(state[key][name])
