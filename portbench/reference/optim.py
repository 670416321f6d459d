"""The optimizers' updates in plain float32 PyTorch, as optax defines them
(the semantics the configuration files name): AdamW with the clip by the
global norm first, bias correction at the incremented count and epsilon
outside the square root, weight decay added to every leaf's update; SGD
without momentum."""

from __future__ import annotations

import torch


def clipped(grads: dict, max_norm: float) -> dict:
    if not max_norm:
        return grads
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = min(1.0, max_norm / float(norm))
    return {name: g * scale for name, g in grads.items()}


class AdamW:
    def __init__(self, settings: dict) -> None:
        self.lr = settings['lr']
        self.b1, self.b2 = settings['b1'], settings['b2']
        self.eps = settings['eps']
        self.weight_decay = settings['weight_decay']
        self.grad_clip = settings['grad_clip']
        self.count = 0
        self.mu, self.nu = {}, {}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Update ``params`` in place; returns the gradients the update
        used (after the clip)."""
        grads = clipped(grads, self.grad_clip)
        self.count += 1
        for name, g in grads.items():
            mu = self.mu.setdefault(name, torch.zeros_like(g))
            nu = self.nu.setdefault(name, torch.zeros_like(g))
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            update = (mu / (1 - self.b1 ** self.count)) / (
                torch.sqrt(nu / (1 - self.b2 ** self.count)) + self.eps)
            update += self.weight_decay * params[name]
            params[name] -= self.lr * update
        return grads


class SGD:
    def __init__(self, settings: dict) -> None:
        self.lr = settings['lr']

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        for name, g in grads.items():
            params[name] -= self.lr * g
        return grads


OPTIMIZERS = {'adamw': AdamW, 'sgd': SGD}


def optimizer(settings: dict):
    return OPTIMIZERS[settings['name']](settings)
