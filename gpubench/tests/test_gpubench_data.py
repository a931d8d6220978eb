"""The rows made from the seed: shapes and the statistics of RCV1-like data."""

import torch

from gpubench.data import make_rows

SPEC = {"n_rows": 4000, "n_features": 2000, "nnz": 20, "noise": 0.05, "train_share": 0.8}


def test_shapes_split_and_types():
    train, test = make_rows(SPEC, 7, "cpu")
    assert (len(train), len(test)) == (3200, 800)
    assert train.indices.shape == (3200, 20) and train.indices.dtype == torch.int32
    assert train.values.dtype == torch.float32 and train.labels.dtype == torch.int32


def test_row_statistics():
    train, _ = make_rows(SPEC, 7, "cpu")
    idx, val = train.indices, train.values
    assert bool((idx[:, 1:] >= idx[:, :-1]).all()), "rows are sorted"
    assert int(idx.min()) >= 0 and int(idx.max()) < SPEC["n_features"]
    dup = idx[:, 1:] == idx[:, :-1]
    assert bool((val[:, 1:][dup] == 0).all()), "repeated draws are inert pads"
    assert bool((val >= 0).all())
    assert torch.allclose(val.norm(dim=1), torch.ones(len(train)), atol=1e-5)
    counts = torch.bincount(idx.flatten().long(), minlength=SPEC["n_features"])
    assert counts[:10].sum() > counts[-1000:].sum(), "a 1/rank popularity"
    y = train.labels
    assert set(y.unique().tolist()) == {-1, 1}
    assert 0.4 < float((y == 1).float().mean()) < 0.6, "split at the median"


def test_same_seed_same_rows_other_seed_other_rows():
    a, _ = make_rows(SPEC, 3, "cpu")
    b, _ = make_rows(SPEC, 3, "cpu")
    c, _ = make_rows(SPEC, 2 ** 31 + 5, "cpu")
    assert torch.equal(a.indices, b.indices) and torch.equal(a.values, b.values)
    assert not torch.equal(a.indices, c.indices)
