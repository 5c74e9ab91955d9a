"""Special functions that torch does not provide.

``betainc`` is the regularised incomplete beta function I_x(a, b), which the
LSD detector's NFA test needs for its binomial tail (``ops/lsd.py``).  It
follows the algorithm of ``jax.scipy.special.betainc`` (XLA's
``RegularizedIncompleteBeta``): the continued fraction of DLMF 8.17.22,
evaluated with the modified Lentz method, on the side of the symmetry
relation I_x(a, b) = 1 - I_{1-x}(b, a) where it converges quickly, times
the prefactor x^a (1-x)^b / (a B(a, b)).  It computes in float64 and stops
when every element's last factor is within 1e-15 of 1 (at most 600
steps), so it is more precise than JAX's float32 version; the tests state
the difference.
"""

from __future__ import annotations

import torch

_MAX_ITERS = 600
_TOL = 1e-15


def betainc(a: torch.Tensor, b: torch.Tensor, x: float) -> torch.Tensor:
    """I_x(a, b) elementwise for tensors ``a``, ``b`` > 0 and a scalar
    ``0 < x < 1``; returns float64."""
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    xt = torch.full_like(a, float(x))
    # the fraction converges fast for x < (a + 1) / (a + b + 2); elsewhere
    # evaluate I_{1-x}(b, a) and reflect
    fast = xt < (a + 1.0) / (a + b + 2.0)
    aa = torch.where(fast, a, b)
    bb = torch.where(fast, b, a)
    xx = torch.where(fast, xt, 1.0 - xt)

    tiny = torch.finfo(torch.float64).eps / 2
    # modified Lentz: f = 1 + d_1/(1 + d_2/(1 + ...)), partial denominators
    # all 1 after the first (which is 0), partial numerators d_n below
    h = torch.full_like(aa, tiny)          # |b_0| = 0 < tiny
    c = h.clone()
    d = torch.zeros_like(aa)
    n = 1
    while True:
        if n == 1:
            num = torch.ones_like(aa)
        else:
            m = float((n - 1) // 2)
            if n % 2 == 0:
                if m == 0:
                    num = -(aa + bb) * xx / (aa + 1.0)
                else:
                    num = (-(aa + m) * (aa + bb + m) * xx
                           / ((aa + 2.0 * m) * (aa + 2.0 * m + 1.0)))
            else:
                num = (m * (bb - m) * xx
                       / ((aa + 2.0 * m - 1.0) * (aa + 2.0 * m)))
        c = 1.0 + num / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1.0 + num * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        d = 1.0 / d
        delta = c * d
        h = h * delta
        n += 1
        # converged elements keep delta = 1, so testing every 8th step (one
        # host sync each on a GPU) only adds steps that change nothing
        if n > _MAX_ITERS or (n % 8 == 0 and not bool(
                ((delta - 1.0).abs() >= _TOL).any())):
            break

    lbeta = torch.lgamma(aa) + torch.lgamma(bb) - torch.lgamma(aa + bb)
    factor = torch.exp(torch.log(xx) * aa + torch.log1p(-xx) * bb
                       - lbeta) / aa
    out = h * factor
    return torch.where(fast, out, 1.0 - out)
