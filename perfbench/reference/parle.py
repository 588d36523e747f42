"""Parle's equations in plain PyTorch (Chaudhari et al., arXiv:1707.00424,
Eq. 8a-8d with the scoping of Eq. 9 and the Nesterov momentum of
Remark 2), for n replicas in one process, one replica at a time:

  inner step, every step, per replica a:
    g_y = grad f(y) + (y - x) / gamma                       (8a)
    v_y <- mu v_y + g_y ;  y <- y - lr' (g_y + mu v_y)
    z <- alpha z + (1 - alpha) y                            (8b)
  sync, every L steps:
    xbar = mean_a x^a                                       (8d)
    g_x = (x - z) s + (x - xbar) / rho,  s = 1 (Remark 1) or 1/gamma  (8c)
    v_x <- mu v_x + g_x ;  x <- x - lr (g_x + mu v_x)
    y, z <- x ;  v_y <- 0
    gamma <- max(gamma f, gamma_min), rho <- max(rho f, rho_min),
    f = 1 - 1 / (2 B)                                       (Eq. 9)

The state is one flat float32 row per replica and field, the leaves
concatenated in the param tree's order.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.weights import leaf_items


class Flat:
    """A param tree's leaves as one flat row: ``tree(row)`` gives the
    nested dict of views of a row, ``norms(row)`` each leaf's norm."""

    def __init__(self, params):
        self.items = [(p, tuple(t.shape)) for p, t in leaf_items(params)]
        self.sizes = [math.prod(s) for _, s in self.items]

    def flatten(self, params) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for _, t in leaf_items(params)])

    def tree(self, row) -> dict:
        out = {}
        for (path, shape), part in zip(self.items, row.split(self.sizes)):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = part.view(shape)
        return out

    def norms(self, row) -> list:
        return [float(torch.linalg.vector_norm(part))
                for part in row.split(self.sizes)]


def run_rounds(loss_fn, params, hp, batches, rounds: int):
    """``rounds`` Parle rounds from ``params`` (every replica starts
    there).  ``loss_fn(tree, tokens, labels)`` is the model's loss;
    ``batches(r)`` the r-th round's {"tokens", "labels"} of (L, n, B, T).
    Returns the readings the check compares: ``losses`` (rounds x L, the
    replica mean of each step's loss), ``grad`` (each replica's leaf
    norms of the first sync's g_x, read back as the program's are, from
    the change of x over the first round) and ``change`` (each replica's
    leaf norms of x after ``rounds`` rounds less x at the start)."""
    n, L = hp["replicas"], hp["L"]
    mu, alpha = hp["momentum"], hp["alpha"]
    lr, lr_in = hp["lr"], hp["lr_inner"]
    f = 1.0 - 1.0 / (2.0 * hp["batches_per_epoch"])
    gamma, rho = hp["gamma0"], hp["rho0"]
    flat = Flat(params)
    x0 = flat.flatten(params)
    x = [x0.clone() for _ in range(n)]
    y = [x0.clone() for _ in range(n)]
    z = [x0.clone() for _ in range(n)]
    v_y = [torch.zeros_like(x0) for _ in range(n)]
    v_x = [torch.zeros_like(x0) for _ in range(n)]
    losses, grad = [], None
    for r in range(rounds):
        b = batches(r)
        for i in range(L):
            step = []
            for a in range(n):
                row = y[a].detach().requires_grad_(True)
                loss = loss_fn(flat.tree(row), b["tokens"][i, a],
                               b["labels"][i, a])
                (g,) = torch.autograd.grad(loss, row)
                step.append(float(loss.detach()))
                g_y = g + (y[a] - x[a]) / gamma                      # (8a)
                v_y[a] = mu * v_y[a] + g_y
                y[a] = y[a] - lr_in * (g_y + mu * v_y[a])
                z[a] = alpha * z[a] + (1.0 - alpha) * y[a]           # (8b)
                del row, loss, g, g_y
            losses.append(sum(step) / n)
        xbar = sum(x) / n                                            # (8d)
        s = 1.0 if hp["scale_lr_by_gamma"] else 1.0 / gamma
        for a in range(n):
            g_x = (x[a] - z[a]) * s + (x[a] - xbar) / rho            # (8c)
            v_x[a] = mu * v_x[a] + g_x
            x[a] = x[a] - lr * (g_x + mu * v_x[a])
            y[a], z[a] = x[a].clone(), x[a].clone()
            v_y[a] = torch.zeros_like(x0)
        gamma = max(gamma * f, hp["gamma_min"])                      # (9)
        rho = max(rho * f, hp["rho_min"])
        if r == 0:
            grad = [flat.norms((x0 - x[a]) / (lr * (1.0 + mu)))
                    for a in range(n)]
    change = [flat.norms(x[a] - x0) for a in range(n)]
    return {"losses": losses, "grad": grad, "change": change,
            "paths": [p for p, _ in flat.items]}
