"""Numeric gradient checking: the reference's F utility (math/F.scala).

The port of the JAX package's ops/gradcheck.py: a central difference
``(f(x + e_i) - f(x - e_i)) / 2 eps`` for each probed coordinate i, with
an eps that suits f32 (the reference's 1e-25 only makes sense in
arbitrary precision), and ``check_grad`` holding an analytic gradient to
it.  The JAX package vmaps the probes into one compiled evaluation; here
they run in a loop, on whatever device `x` lives on.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def numeric_grad(
    f: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    eps: float = 1e-3,
    coords: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Central-difference gradient of scalar ``f`` at ``x``: one entry for
    each of `coords` (default: every coordinate)."""
    x = torch.as_tensor(x)
    if coords is None:
        coords = range(x.shape[0])
    out = []
    for i in torch.as_tensor(coords).tolist():
        e = torch.zeros_like(x)
        e[i] = eps
        out.append((f(x + e) - f(x - e)) / (2.0 * eps))
    return torch.stack(out)


def check_grad(
    f: Callable[[torch.Tensor], torch.Tensor],
    grad_f: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    eps: float = 1e-3,
    atol: float = 1e-3,
    rtol: float = 1e-2,
    coords: Optional[Sequence[int]] = None,
) -> bool:
    """True iff ``grad_f(x)`` matches ``numeric_grad`` on `coords`
    (default: all) within `atol` + `rtol` * |analytic|."""
    num = numeric_grad(f, x, eps=eps, coords=coords)
    ana = torch.as_tensor(grad_f(x))
    if coords is not None:
        ana = ana[torch.as_tensor(coords, device=ana.device)]
    return bool(torch.allclose(num, ana.to(num.dtype), atol=atol, rtol=rtol))
