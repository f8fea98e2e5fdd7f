"""Theorem 1/2 hyperparameter bounds -- implementation guidance from §3.3.

The port's own copy of the JAX package's numpy-only module (the port
imports nothing of that package); the two agree on every input.

Given smoothness/strong-convexity constants of the device losses, these
helpers return the admissible step sizes and the K/L schedules the theory
requires (K = Omega(T), L = Omega(K)). The MCLR model with l2 regularizer
sigma has mu_f = sigma and L_f <= max_eig(X^T X)/n + sigma, so the
strongly-convex experiments can be run strictly inside the theory.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["TheoryBounds", "inner_iteration_schedule", "mclr_constants",
           "nonconvex_bounds", "pick_hparams_strongly_convex",
           "strongly_convex_bounds"]


@dataclass(frozen=True)
class TheoryBounds:
    """Admissible step sizes of Theorem 1 or 2 for given constants, whether
    gamma > 2 lam > 4 L_f holds, and the per-round contraction factor."""
    alpha_max: float
    eta_max: float
    beta_max: float
    mu_f_tilde_big: float      # mu_{F~} (strong convexity of the envelope)
    gamma_ok: bool             # gamma > 2*lambda > 4*L_f
    rate: float                # contraction factor per global round (sc case)


def strongly_convex_bounds(mu_f: float, l_f: float, lam: float,
                           gamma: float) -> TheoryBounds:
    """Theorem 1: beta <= mu_F~/(4 gamma), eta <= 1/(2(lam+gamma)),
    alpha <= 1/(L_f + lam), gamma > 2 lam > 4 L_f."""
    mu_ft = (lam * gamma * mu_f) / (lam * mu_f + gamma * mu_f + lam * gamma)
    beta_max = mu_ft / (4.0 * gamma)
    return TheoryBounds(
        alpha_max=1.0 / (l_f + lam),
        eta_max=1.0 / (2.0 * (lam + gamma)),
        beta_max=beta_max,
        mu_f_tilde_big=mu_ft,
        gamma_ok=(gamma > 2.0 * lam > 4.0 * l_f),
        rate=1.0 - beta_max,
    )


def nonconvex_bounds(l_f: float, lam: float, gamma: float) -> TheoryBounds:
    """Theorem 2: beta <= 1/(4 gamma), eta <= 1/(lam+gamma),
    alpha <= 1/lam, gamma > 2 lam > 4 L_f."""
    return TheoryBounds(
        alpha_max=1.0 / lam,
        eta_max=1.0 / (lam + gamma),
        beta_max=1.0 / (4.0 * gamma),
        mu_f_tilde_big=0.0,
        gamma_ok=(gamma > 2.0 * lam > 4.0 * l_f),
        rate=float("nan"),
    )


def inner_iteration_schedule(t_rounds: int, *, mu_f: float, l_f: float,
                             lam: float, gamma: float, alpha: float,
                             eta: float, beta: float,
                             c_k: float = 1.0, c_l: float = 1.0):
    """K = Omega(T), L = Omega(K) with the log-ratio slopes of eqs. (58)
    and (61): K >= ln(1 - beta*mu_F~/2)/ln(1 - eta*(mu_F+gamma)/2) * T and
    L >= ln(1 - eta*(mu_F+gamma)/2)/ln(1 - alpha*mu_f) * K (constants c_K,
    c_L absorb the Gamma terms)."""
    mu_big_f = lam * mu_f / (lam + mu_f)
    mu_ft = (lam * gamma * mu_f) / (lam * mu_f + gamma * mu_f + lam * gamma)
    k_slope = math.log(max(1e-12, 1 - beta * mu_ft / 2)) / \
        math.log(max(1e-12, 1 - eta * (mu_big_f + gamma) / 2))
    l_slope = math.log(max(1e-12, 1 - eta * (mu_big_f + gamma) / 2)) / \
        math.log(max(1e-12, 1 - alpha * (mu_f + lam)))
    k = max(1, math.ceil(c_k * k_slope * t_rounds))
    l = max(1, math.ceil(c_l * l_slope * k))
    return k, l


def mclr_constants(x_data: np.ndarray, l2_reg: float):
    """(mu_f, L_f) for l2-regularized multinomial logistic regression.

    CE-softmax Hessian is bounded by 0.5 * max_eig(X^T X / n); with the l2
    term, mu_f = l2_reg, L_f = 0.5 * eig_max + l2_reg.
    """
    xf = np.asarray(x_data, np.float64).reshape(x_data.shape[0], -1)
    n = xf.shape[0]
    cov = xf.T @ xf / n
    eig_max = float(np.linalg.eigvalsh(cov).max())
    return l2_reg, 0.5 * eig_max + l2_reg


def pick_hparams_strongly_convex(mu_f: float, l_f: float, *,
                                 safety: float = 1.0):
    """A theory-consistent default hyperparameter set: the paper requires
    gamma > 2 lam > 4 L_f; we take lam = 2.5 L_f, gamma = 2.5 lam and the
    max admissible step sizes scaled by `safety`."""
    lam = 2.5 * l_f
    gamma = 2.5 * lam
    b = strongly_convex_bounds(mu_f, l_f, lam, gamma)
    return {
        "lam": lam, "gamma": gamma,
        "alpha": safety * b.alpha_max,
        "eta": safety * b.eta_max,
        "beta": safety * b.beta_max,
    }
