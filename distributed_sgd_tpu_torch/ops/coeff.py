"""A model's per-sample gradient coefficient, as the kernels take it.

The counterpart of the JAX package's ``coeff_fn`` (distributed_sgd_tpu/
ops/pallas_sparse.py::worker_grads), which traces any model's
``grad_coeff`` into the Pallas kernel.  A torch function cannot be traced
into CUDA, so a rule reaches the port's kernels in one of two forms:

- a built-in kind (HINGE, LOGISTIC, LEAST_SQUARES): the models of
  models/linear.py that keep their class's rule.  ``builtin_rule`` is the
  torch definition of each and ``csrc/coeff.cuh`` its CUDA twin; the
  kernels' libraries compile them as they always did;
- a user rule (kind USER): a model whose ``grad_coeff`` is its own.  Its
  torch ``grad_coeff`` is the plain version (the CPU route and the card's
  reference), and its class attribute ``coeff_cuda`` is the body of the
  CUDA device function ``float coeff(float m, float y)``.  ops/_build.py
  compiles each kernel once more with that body behind the
  ``DSGD_USER_COEFF`` macro, into a library named by the source's content
  key (`Coeff.key`), so two rules never share a library.

`Coeff` is what every route passes down in place of a bare kind; an int
kind is still taken (`resolve`).  A user rule without ``coeff_cuda`` runs
on the CPU and raises before it reaches the card (`check_launchable`):
there is no quiet route to the plain version and no built-in stand-in.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Callable, NamedTuple, Optional

import torch

HINGE, LOGISTIC, LEAST_SQUARES = 0, 1, 2
COEFF_KINDS = (HINGE, LOGISTIC, LEAST_SQUARES)  # the built-in kinds
USER = 3  # a model's own rule: the kernels' variant built from its coeff_cuda


def builtin_rule(kind: int, margins: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample gradient coefficient of built-in rule `kind` (labels as f32)."""
    yf = y.float()
    if kind == HINGE:
        # backward = 0 if y*(x.w) < 0 else y  (reference hinge subgradient)
        return torch.where(yf * margins < 0, torch.zeros_like(yf), yf)
    if kind == LOGISTIC:
        return -yf * torch.sigmoid(-yf * margins)
    if kind == LEAST_SQUARES:
        return 2.0 * (margins - yf)
    raise ValueError(f"coeff_kind must be one of {COEFF_KINDS}, got {kind!r}")


@functools.lru_cache(maxsize=64)
def content_key(cuda: str) -> str:
    """The key that names a user rule's libraries: 12 hex digits of the
    sha256 of its CUDA source."""
    return hashlib.sha256(cuda.encode()).hexdigest()[:12]


class Coeff(NamedTuple):
    """One coefficient rule: a built-in `kind`, or USER with the model's
    torch rule `fn(margins, y)` and its CUDA body `cuda` (None when the
    model gives none: it then runs on the CPU only)."""

    kind: int
    fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None
    cuda: Optional[str] = None
    name: str = ""  # the model's class, for messages

    @property
    def key(self) -> Optional[str]:
        """The CUDA source's content key, None for a built-in kind or a
        rule without CUDA."""
        return None if self.cuda is None else content_key(self.cuda)

    def plain(self, margins: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The rule in torch: the built-in definition, or the model's own."""
        if self.kind == USER:
            return self.fn(margins, y).float()
        return builtin_rule(self.kind, margins, y)


def resolve(rule) -> Coeff:
    """A `Coeff` from a built-in kind (int) or a `Coeff`; raises on
    anything else."""
    if type(rule) is int and rule in _BUILTIN:  # the hot path: a built-in kind
        return _BUILTIN[rule]
    if isinstance(rule, Coeff):
        if rule.kind == USER:
            if not callable(rule.fn):
                raise ValueError(f"a user coefficient rule needs its torch function, got "
                                 f"{rule.fn!r}")
            if rule.cuda is not None and not isinstance(rule.cuda, str):
                raise TypeError(f"coeff_cuda must be a str, got {type(rule.cuda).__name__}")
        elif rule.kind not in COEFF_KINDS:
            raise ValueError(f"coeff_kind must be one of {COEFF_KINDS} or {USER}, "
                             f"got {rule.kind!r}")
        return rule
    if isinstance(rule, bool) or rule not in COEFF_KINDS:
        raise ValueError(f"coeff_kind must be one of {COEFF_KINDS} or a Coeff, got {rule!r}")
    return _BUILTIN[int(rule)]


_BUILTIN = {kind: Coeff(kind) for kind in COEFF_KINDS}


def user(fn: Callable, cuda: Optional[str], name: str = "") -> Coeff:
    """A user rule: torch `fn(margins, y)` and the CUDA body `cuda`."""
    return resolve(Coeff(USER, fn, cuda, name))


def check_launchable(rule: Coeff, device) -> None:
    """Raise when `rule` is to run on a CUDA device and has no CUDA form:
    a user rule without ``coeff_cuda``.  Nothing on the CPU."""
    if rule.kind == USER and rule.cuda is None and torch.device(device).type == "cuda":
        raise ValueError(
            f"{rule.name or 'the model'} has its own grad_coeff but no coeff_cuda: the CUDA "
            f"kernels need the rule as CUDA too.  Give the class a coeff_cuda, the body of "
            f"'float coeff(float m, float y)', or run on device='cpu'")


def cuda_header(rule: Coeff) -> str:
    """The header the user variant of a kernel is compiled with
    (``csrc/coeff.cuh`` includes it under ``DSGD_USER_COEFF``)."""
    return (f"// Generated from {rule.name or 'a model'}.coeff_cuda (content key {rule.key}).\n"
            "#pragma once\n"
            "#include <cuda_runtime.h>\n"
            "#include <math.h>\n\n"
            "__device__ __forceinline__ float dsgd_user_coeff(float m, float y) {\n"
            f"{rule.cuda}\n"
            "}\n")
