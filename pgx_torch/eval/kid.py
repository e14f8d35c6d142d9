"""Kernel Inception Distance (counterpart of ``pgx/eval/kid.py``; Binkowski
et al. 2018, "Demystifying MMD GANs").

The squared MMD between real and generated pool3 feature sets under the
cubic polynomial kernel, with the unbiased estimator over random subsets:
unlike FID, whose finite-sample bias is large in the low-sample regime, the
estimate is unbiased and carries a per-subset standard deviation.  numpy
float64 on the host, the same ``RandomState(seed)`` subset draws as
``pgx``; the features and their preprocessing are ``pgx_torch.eval.fid``'s.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def polynomial_kernel(x: np.ndarray, y: np.ndarray, degree: int = 3,
                      gamma: Optional[float] = None,
                      coef0: float = 1.0) -> np.ndarray:
    """k(a, b) = (gamma <a, b> + coef0) ** degree, gamma 1/dim by default
    (the KID paper's kernel, sklearn's parameterization)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def mmd2_unbiased(k_xx: np.ndarray, k_yy: np.ndarray,
                  k_xy: np.ndarray) -> float:
    """Unbiased squared MMD from kernel matrices (the diagonals left out of
    the within-set sums)."""
    m = k_xx.shape[0]
    n = k_yy.shape[0]
    if m < 2 or n < 2:
        raise ValueError("unbiased MMD^2 needs >= 2 samples per set")
    sum_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    sum_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    sum_xy = k_xy.mean()
    return float(sum_xx + sum_yy - 2.0 * sum_xy)


def kid_from_activations(real_acts: np.ndarray, fake_acts: np.ndarray,
                         subset_size: int = 1000, num_subsets: int = 100,
                         degree: int = 3, gamma: Optional[float] = None,
                         coef0: float = 1.0,
                         seed: int = 0) -> Tuple[float, float]:
    """(mean, std) of the unbiased polynomial MMD^2 over ``num_subsets``
    random subsets of the two sets (subset_size clamps to the smaller
    set).  When the subsets are the whole sets, one pass: MMD^2 does not
    depend on the order."""
    real_acts = np.asarray(real_acts, np.float64)
    fake_acts = np.asarray(fake_acts, np.float64)
    m = min(subset_size, len(real_acts), len(fake_acts))
    if m < 2:
        raise ValueError("KID needs >= 2 samples per set")
    rng = np.random.RandomState(seed)
    if m == len(real_acts) and m == len(fake_acts):
        num_subsets = 1
    vals = np.empty(num_subsets, np.float64)
    for i in range(num_subsets):
        x = real_acts[rng.choice(len(real_acts), m, replace=False)]
        y = fake_acts[rng.choice(len(fake_acts), m, replace=False)]
        k_xx = polynomial_kernel(x, x, degree, gamma, coef0)
        k_yy = polynomial_kernel(y, y, degree, gamma, coef0)
        k_xy = polynomial_kernel(x, y, degree, gamma, coef0)
        vals[i] = mmd2_unbiased(k_xx, k_yy, k_xy)
    return float(vals.mean()), float(vals.std())


def calculate_kid_given_data(real: np.ndarray, fake: np.ndarray,
                             extractor: Optional[Callable] = None,
                             batch_size: int = 50, subset_size: int = 1000,
                             num_subsets: int = 100,
                             seed: int = 0) -> Tuple[float, float]:
    """KID between two image sets through FID's extractor and
    preprocessing."""
    from pgx_torch.eval.fid import get_activations, make_extractor
    if extractor is None:
        extractor = make_extractor()
    real_acts = get_activations(real, extractor, batch_size)
    fake_acts = get_activations(fake, extractor, batch_size)
    return kid_from_activations(real_acts, fake_acts,
                                subset_size=subset_size,
                                num_subsets=num_subsets, seed=seed)
