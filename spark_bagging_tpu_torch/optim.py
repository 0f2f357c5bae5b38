"""Adam over a replica axis, in optax's arithmetic.

The JAX package trains its SGD learners and its streamed fits with
``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), ``vmap``ped
over replicas. Here every parameter is one tensor with a leading
replica axis and the update runs in place over the whole stack; the
replicas share the step count, as the vmapped counts are all equal.

``torch.optim.Adam`` is not used: it folds the bias corrections into
the step size and eps, a different rounding from optax's, and Adam's
normalized steps carry such differences forward. The order here is
optax's:

    m = (1 - b1) g + b1 m
    v = (1 - b2) g^2 + b2 v
    p += -lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
"""

from __future__ import annotations

import numpy as np
import torch

Params = dict[str, torch.Tensor]


class Adam:
    """optax's ``adam(lr)`` over a dict of ``(R, ...)`` tensors: the
    moments live here; :meth:`step` updates the parameters in place."""

    def __init__(self, params: Params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0  # optax's int32 step count
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def with_moments(self, mu: Params, nu: Params) -> "Adam":
        """This optimizer's hyperparameters and step count over other
        moment tensors (a mesh shard's slices of the replica axis)."""
        other = object.__new__(Adam)
        other.__dict__.update(self.__dict__)
        other.mu, other.nu = mu, nu
        return other

    def _f32(self, x: float) -> float:
        """A Python float rounded to float32, as a weakly typed scalar
        meets float32 arrays in JAX."""
        return float(np.float32(x))

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.count += 1
        t = np.float32(self.count)
        # 1 - decay**t in float32, as optax's bias_correction
        c1 = self._f32(np.float32(1) - np.float32(self.b1) ** t)
        c2 = self._f32(np.float32(1) - np.float32(self.b2) ** t)
        a1, d1 = self._f32(1 - self.b1), self._f32(self.b1)
        a2, d2 = self._f32(1 - self.b2), self._f32(self.b2)
        neg_lr, eps = self._f32(-self.lr), self._f32(self.eps)
        for k, p in params.items():
            g, m, v = grads[k], self.mu[k], self.nu[k]
            m.mul_(d1).add_(g * a1)
            v.mul_(d2).add_((g * g) * a2)
            u = (m / c1) / ((v / c2).sqrt_() + eps)
            p.add_(u.mul_(neg_lr))
