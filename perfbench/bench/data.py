"""The benchmark's inputs, made from ``--seed``: a Gaussian-mixture
classification table at a configuration's published shape.

A frozen, vectorised copy of the arithmetic of the port's
``utils/datasets.make_classification`` (spark_bagging_tpu_torch/utils/
datasets.py:146-185 at d3bc302), ``synthetic_covtype`` (:236) and
``standardize`` (:188): one centre a class at ``class_sep``, the first
``axis_features`` features given axis-aligned class levels
``axis_gap`` apart, Dirichlet(2) class priors, unit-variance clouds.

The mixture itself (centres and priors) is drawn by numpy from the
configuration's fixed ``structure_seed`` exactly as the port draws it,
so every seed has the same classes, priors and shapes. The rows are
drawn from the run's seed on the device with a ``torch.Generator``
(Philox), in two bulk calls for the fit table and two for the predict
table: the same distribution as the port's generator, not its numpy
bits. Both tables are standardised with the fit table's column mean
and deviation, then handed over as host float32 arrays (fit
labels int64), as a user hands them to ``fit`` and ``predict_proba``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Tables:
    X_fit: np.ndarray       # (n, F) float32, host
    y_fit: np.ndarray       # (n,) int64, host
    X_pred: np.ndarray      # (m, F) float32, host


def structure(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """The mixture's class centres ``(C, F)`` float32 and priors ``(C,)``
    float64, from ``spec["structure_seed"]`` as the port draws them."""
    C, F = spec["n_classes"], spec["n_features"]
    srng = np.random.default_rng(spec["structure_seed"])
    centers = srng.normal(0.0, spec["class_sep"], (C, F)).astype(np.float32)
    for j in range(min(spec["axis_features"], F)):
        perm = srng.permutation(C).astype(np.float32)
        centers[:, j] = (perm - (C - 1) / 2.0) * spec["axis_gap"]
    if spec["class_imbalance"]:
        p = srng.dirichlet(np.full(C, 2.0))
    else:
        p = np.full(C, 1.0 / C)
    return centers, p


def _draw(g: torch.Generator, n: int, centers: torch.Tensor,
          p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    y = torch.multinomial(p, n, replacement=True, generator=g)
    X = torch.randn((n, centers.shape[1]), generator=g, device=p.device,
                    dtype=torch.float32)
    X += centers[y]
    return X, y


def make(spec: dict, seed: int, device: torch.device) -> Tables:
    """The fit and predict tables of one run."""
    centers_np, p_np = structure(spec)
    centers = torch.from_numpy(centers_np).to(device)
    p = torch.from_numpy(p_np).to(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    X_fit, y_fit = _draw(g, spec["n_rows"], centers, p)
    X_pred, _ = _draw(g, spec["n_predict_rows"], centers, p)
    if spec.get("standardize", True):
        Xd = X_fit.double()
        mu = Xd.mean(0)
        sigma = Xd.std(0, unbiased=False) + 1e-8
        X_fit = ((Xd - mu) / sigma).float()
        X_pred = ((X_pred.double() - mu) / sigma).float()
        del Xd
    return Tables(X_fit.cpu().numpy(), y_fit.cpu().numpy(),
                  X_pred.cpu().numpy())
