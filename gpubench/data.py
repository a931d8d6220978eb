"""The benchmark's rows, made on the device from the seed.

A torch copy of the statistics of the program's ``rcv1_like`` generator
(RCV1-v2's shape, Lewis et al. 2004): each row draws `nnz` feature ids
over a 1/rank popularity, sorted, with repeated draws zeroed as inert pad
entries; |N(0, 1)| values, cosine-normalised rows; labels from a planted
separator split at its median, `noise` of them flipped; the first
`train_share` of the rows train, the rest test.  It draws its own stream,
not the program's numpy one: one seed gives the same rows on one device
and torch version, and every seed the same sizes.

The rows are made in a few large calls with a ``torch.Generator`` on the
device; the caller copies them to the host where the program wants host
arrays.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gpubench.reference.linear import Split

ID_BLOCK = 1 << 22  # rows of ids drawn per call, bounding the float64 draws


def make_rows(spec: Dict, seed: int, device) -> Tuple[Split, Split]:
    """(train, test) splits of `spec` (``n_rows``, ``n_features``, ``nnz``,
    ``noise``, ``train_share``) from `seed`."""
    n, d, p = int(spec["n_rows"]), int(spec["n_features"]), int(spec["nnz"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pop = 1.0 / torch.arange(1, d + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(pop / pop.sum(), 0)
    idx = torch.empty((n, p), dtype=torch.int32, device=device)
    for a in range(0, n, ID_BLOCK):
        u = torch.rand((min(ID_BLOCK, n - a), p), generator=gen, dtype=torch.float64,
                       device=device)
        idx[a:a + u.shape[0]] = torch.searchsorted(cdf, u).clamp_(max=d - 1).to(torch.int32)
    idx = idx.sort(dim=1).values
    val = torch.randn((n, p), generator=gen, device=device).abs_()
    val[:, 1:].masked_fill_(idx[:, 1:] == idx[:, :-1], 0.0)  # repeated draws: inert pads
    val /= val.norm(dim=1, keepdim=True).clamp_min(1e-12)
    w_true = torch.randn(d, generator=gen, device=device)
    margins = (val * w_true[idx.long()]).sum(dim=1)
    y = torch.where(margins > margins.median(), 1, -1).to(torch.int32)
    flip = torch.rand(n, generator=gen, device=device) < float(spec["noise"])
    y = torch.where(flip, -y, y)
    cut = int(n * float(spec["train_share"]))
    return (Split(idx[:cut], val[:cut], y[:cut]), Split(idx[cut:], val[cut:], y[cut:]))
