"""The port's host-side data code (distributed_sgd_tpu_torch/data/) gives
arrays identical to the JAX package's for the same seed or file."""

import numpy as np
import pytest

from distributed_sgd_tpu.data import rcv1 as jrcv1
from distributed_sgd_tpu.data import synthetic as jsyn
from distributed_sgd_tpu_torch.data import rcv1 as trcv1
from distributed_sgd_tpu_torch.data import synthetic as tsyn


def _same(a, b):
    for name in ("indices", "values", "labels"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.n_features == b.n_features


@pytest.mark.parametrize("idf", [False, True])
def test_rcv1_like_is_bit_identical(idf):
    kw = dict(n_features=500, nnz=12, seed=11, idf_values=idf)
    _same(tsyn.rcv1_like(300, **kw), jsyn.rcv1_like(300, **kw))


def test_dim_sparsity_and_split_are_identical():
    t = tsyn.rcv1_like(257, n_features=400, nnz=9, seed=2, idf_values=True)
    j = jsyn.rcv1_like(257, n_features=400, nnz=9, seed=2, idf_values=True)
    for tp, jp in zip(trcv1.train_test_split(t), jrcv1.train_test_split(j)):
        _same(tp, jp)
    tr, jr = trcv1.train_test_split(t)[0], jrcv1.train_test_split(j)[0]
    np.testing.assert_array_equal(trcv1.dim_sparsity(tr), jrcv1.dim_sparsity(jr))


@pytest.mark.parametrize("pad_width", [None, 2, 8])
def test_pack_csr_is_identical_including_truncation(pad_width):
    rng = np.random.default_rng(5)
    nnz = rng.integers(0, 7, 40)
    row_ptr = np.zeros(41, np.int64)
    np.cumsum(nnz, out=row_ptr[1:])
    cols = rng.integers(0, 100, row_ptr[-1]).astype(np.int32)
    vals = rng.choice([0.5, -0.5, 1.0, 2.0], row_ptr[-1]).astype(np.float32)  # ties
    got = trcv1.pack_csr(row_ptr, cols, vals, pad_width=pad_width)
    want = jrcv1.pack_csr(row_ptr, cols, vals, pad_width=pad_width)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _write_corpus(folder):
    rows = [
        "101  3:0.5 7:0.25 12:1.0",
        "102  1:0.125",
        "",
        "103  2:0.5 3:0.5 4:0.5 5:0.5 9:2.0",
        "104  12:0.75 40:0.01",
    ]
    (folder / "lyrl2004_vectors_train.dat").write_text("\n".join(rows) + "\n")
    (folder / "rcv1-v2.topics.qrels").write_text(
        "CCAT 101 1\nE11 101 1\nCCAT 102 1\nGCAT 103 1\nCCAT 104 1\n")


@pytest.mark.parametrize("pad_width", [None, 3])
def test_load_rcv1_is_identical_on_a_tiny_corpus(tmp_path, pad_width):
    _write_corpus(tmp_path)
    got = trcv1.load_rcv1(str(tmp_path), n_features=50, pad_width=pad_width)
    want = jrcv1.load_rcv1(str(tmp_path), n_features=50, pad_width=pad_width)
    _same(got, want)
    # last topic wins: doc 101 is CCAT then E11 -> -1
    np.testing.assert_array_equal(got.labels, [-1, 1, -1, 1])
    parsed = trcv1.parse_svm_file_py(str(tmp_path / "lyrl2004_vectors_train.dat"))
    for g, w in zip(parsed, jrcv1.parse_svm_file_py(str(tmp_path / "lyrl2004_vectors_train.dat"))):
        np.testing.assert_array_equal(g, w)
    assert trcv1.read_labels(str(tmp_path / "rcv1-v2.topics.qrels")) == \
        jrcv1.read_labels(str(tmp_path / "rcv1-v2.topics.qrels"))
