"""Adam and SGD as optax computes them, with the learning rate on the
device (counterpart of optax.adam / optax.sgd over
optax.piecewise_constant_schedule, which mst_tpu's trainer builds:
mst_tpu/train/trainer.py:452-471).

The step count and the base learning rate are device tensors and the
schedule is a function of the count (`schedule`), so a step launches
kernels only: it needs no host value and can be captured in a CUDA graph
(train/fused.py) and replayed with its learning rate moving. The update
is one function of tensors (`adam_update`, `sgd_update`) that the
optimizer objects apply in place (the loop and --fused) and the grid
applies under torch.func.vmap, so every path rounds the same way.

The arithmetic is optax's, in f32: mu = (1 - b1) g + b1 mu,
nu = (1 - b2) g*g + b2 nu, each corrected by 1 - b^(count + 1), then
p + (-lr) * mu_hat / (sqrt(nu_hat) + eps). torch.optim.Adam's default
path corrects in float64 on the host and divides in another order, so
its bits differ from optax's and could not be captured with a moving
learning rate.
"""

from typing import Callable, NamedTuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def schedule(base_lr, count, milestones=(), gamma=0.1):
    """optax.piecewise_constant_schedule(base_lr, {m: gamma}) at count: the
    learning rate times gamma once for each distinct milestone m <= count
    (a repeated milestone decays once), in f32 on count's device."""
    lr = base_lr
    for m in milestones:
        lr = torch.where(count >= m, lr * gamma, lr)
    return lr


def adam_update(p, g, mu, nu, count, lr):
    """One optax.adam step of leaf p with gradient g and moments mu, nu;
    count is the number of steps before this one -> (p, mu, nu) new."""
    mu = (1 - B1) * g + B1 * mu
    nu = (1 - B2) * (g * g) + B2 * nu
    c = count + 1
    mu_hat = mu / (1 - B1 ** c)
    nu_hat = nu / (1 - B2 ** c)
    return p + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + EPS)), mu, nu


def sgd_update(p, g, lr):
    """One optax.sgd step: p + (-lr) g."""
    return p + (-lr) * g


class Functional(NamedTuple):
    """An update in optax's functional form, for the grid's vmapped
    runner: init({path: leaf}) -> opt_state; update(trainable, grads,
    opt_state) -> (trainable, opt_state), all dicts of tensors."""
    init: Callable
    update: Callable


def adam(lr, milestones=(), gamma=0.1):
    """optax.adam(piecewise_constant_schedule(lr, ...)) as a Functional;
    lr a 0-d tensor (a run's own under vmap). opt_state: 'count' (int32)
    and the moments 'mu', 'nu' ({path: tensor})."""

    def init(trainable):
        leaf = next(iter(trainable.values()))
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                "mu": {k: torch.zeros_like(v) for k, v in trainable.items()},
                "nu": {k: torch.zeros_like(v) for k, v in trainable.items()}}

    def update(trainable, grads, st):
        step_lr = schedule(lr, st["count"], milestones, gamma)
        new, mu, nu = {}, {}, {}
        for k, p in trainable.items():
            new[k], mu[k], nu[k] = adam_update(
                p, grads[k], st["mu"][k], st["nu"][k], st["count"], step_lr)
        return new, {"count": st["count"] + 1, "mu": mu, "nu": nu}

    return Functional(init, update)


def sgd(lr, milestones=(), gamma=0.1):
    """optax.sgd over the same schedule as a Functional; opt_state holds
    the count only."""

    def init(trainable):
        leaf = next(iter(trainable.values()))
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device)}

    def update(trainable, grads, st):
        step_lr = schedule(lr, st["count"], milestones, gamma)
        return ({k: sgd_update(p, grads[k], step_lr)
                 for k, p in trainable.items()},
                {"count": st["count"] + 1})

    return Functional(init, update)


class Adam:
    """optax.adam over the schedule above, on the leaves `params`, updating
    them in place from their .grad.

    state[p] holds the moments 'exp_avg' (mu) and 'exp_avg_sq' (nu);
    `count` is optax's int32 step count and the schedule's, one for all
    leaves. Every buffer is allocated here and only written in place, so a
    captured step finds them where it left them."""

    def __init__(self, params, lr, milestones=(), gamma=0.1, device=None):
        self.params = list(params)
        if device is None:
            device = self.params[0].device
        self.base_lr = torch.tensor(float(lr), dtype=torch.float32,
                                    device=device)
        self.milestones = tuple(sorted({int(m) for m in milestones}))
        self.gamma = float(gamma)
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.state = self._init_state()

    functional = staticmethod(adam)

    def functional_state(self, named):
        """This optimizer's state as its Functional's opt_state over
        `named` ({path: leaf of params}): copies."""
        return {"count": self.count.clone(),
                "mu": {k: self.state[p]["exp_avg"].clone()
                       for k, p in named.items()},
                "nu": {k: self.state[p]["exp_avg_sq"].clone()
                       for k, p in named.items()}}

    def _init_state(self):
        return {p: {"exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)} for p in self.params}

    def lr(self):
        """The learning rate of the next step, a 0-d f32 device tensor."""
        return schedule(self.base_lr, self.count, self.milestones,
                        self.gamma)

    def zero_grad(self):
        """Zero the gradients in place (a captured step writes its
        gradients into the same buffers on every replay)."""
        for p in self.params:
            if p.grad is not None:
                p.grad.zero_()

    def _update(self, p, lr):
        s = self.state[p]
        return zip((p, s["exp_avg"], s["exp_avg_sq"]), adam_update(
            p, p.grad, s["exp_avg"], s["exp_avg_sq"], self.count, lr))

    @torch.no_grad()
    def step(self):
        """Update every leaf that has a gradient (a leaf without one keeps
        its value, as optax's zero update leaves it), then count."""
        lr = self.lr()
        for p in self.params:
            if p.grad is not None:
                for dst, src in self._update(p, lr):
                    dst.copy_(src)
        self.count.add_(1)


class SGD(Adam):
    """optax.sgd over the same schedule: no moments (`state` is empty)."""

    functional = staticmethod(sgd)

    def functional_state(self, named):
        return {"count": self.count.clone()}

    def _init_state(self):
        return {}

    def _update(self, p, lr):
        return ((p, sgd_update(p, p.grad, lr)),)
