"""The port's reference-format corpus writer (distributed_sgd_tpu_torch/
data/corpus.py) and its text-to-training path (data/rcv1.py ``load_rcv1``,
data/row_store.py ``build_from_corpus``, main.py ``load_data``) against
the JAX package's, on the CPU.

For the same arguments the port writes the JAX writer's bytes, file for
file, with equal metadata, at 8,000 rows (n_template 2048, as
tests/test_data_scale.py's corpus) and two seeds, and its template bodies
keep the two rounding invariants tests/test_data_scale.py holds JAX's to.
``load_rcv1`` of the port equals JAX's on that corpus with ``full=True``,
through the pool's per-file fan-out and with 3 threads a parse; the row
store built from it equals JAX's byte for byte; and ``main()`` on the CPU
with DSGD_DATA_PATH trains from the text files on arrays equal to JAX
``main.load_data``'s, its data seconds covering the native parse and
pack, landing within the main-path parity test's 0.03 of the JAX
trainer's test accuracy.  Each test runs under a time limit of its own
(`LIMIT_S`)."""

import filecmp
import logging
import os
import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu import main as jmain
from distributed_sgd_tpu.config import Config as JConfig
from distributed_sgd_tpu.core.trainer import SyncTrainer as JaxTrainer
from distributed_sgd_tpu.data import corpus as jcorpus
from distributed_sgd_tpu.data import rcv1 as jrcv1
from distributed_sgd_tpu.data import row_store as jrow_store
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.data import _native, corpus, rcv1, row_store
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

LIMIT_S = 120  # each test's own time limit, seconds
# tests/test_data_scale.py's small corpus: 8,000 rows, 2,048 templates
SMALL = dict(n_rows=8000, n_train=6400, n_template=2048, nnz_mean=40, n_features=2048)
SEEDS = (7, 11)


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{seed: (port's folder, JAX's folder, port's metadata, JAX's metadata)}."""
    out = {}
    for seed in SEEDS:
        port_dir = str(tmp_path_factory.mktemp(f"port_{seed}"))
        jax_dir = str(tmp_path_factory.mktemp(f"jax_{seed}"))
        out[seed] = (port_dir, jax_dir, corpus.write_rcv1_corpus(port_dir, seed=seed, **SMALL),
                     jcorpus.write_rcv1_corpus(jax_dir, seed=seed, **SMALL))
    return out


def _bits(a: np.ndarray) -> tuple:
    return a.dtype.str, a.shape, a.tobytes()


def _same_dataset(a, b) -> None:
    assert a.n_features == b.n_features
    for name in ("indices", "values", "labels"):
        assert _bits(getattr(a, name)) == _bits(getattr(b, name)), name


def test_the_constants_are_the_jax_writers():
    assert (corpus.N_ROWS_FULL, corpus.N_TRAIN_ROWS, corpus.FIRST_DOC_ID) == (
        jcorpus.N_ROWS_FULL, jcorpus.N_TRAIN_ROWS, jcorpus.FIRST_DOC_ID) == (804414, 23149, 2286)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_written_corpus_is_byte_equal_to_the_jax_writers(corpora, seed):
    port_dir, jax_dir, port_meta, jax_meta = corpora[seed]
    assert port_meta == jax_meta
    assert port_meta["n_rows"] == 8000 and port_meta["bytes"] > 0
    assert sorted(os.listdir(port_dir)) == sorted(port_meta["files"])
    for name in port_meta["files"]:
        assert filecmp.cmp(os.path.join(port_dir, name), os.path.join(jax_dir, name),
                           shallow=False), name
    with open(os.path.join(port_dir, "lyrl2004_vectors_train.dat")) as f:
        first = f.readline()
    assert first.startswith(f"{corpus.FIRST_DOC_ID}  ")  # the reference's double space


@pytest.mark.parametrize("seed", [17, 29])
def test_the_template_bodies_equal_jaxs_with_the_debug_values(seed):
    args = (64, 8, 512)
    bodies, labels, dbg = corpus._template_bodies(*args, np.random.default_rng(seed),
                                                  return_debug=True)
    jbodies, jlabels, jdbg = jcorpus._template_bodies(*args, np.random.default_rng(seed),
                                                      return_debug=True)
    assert bodies == jbodies
    assert _bits(labels) == _bits(jlabels)
    for key in ("w_true", "margins"):
        assert _bits(dbg[key]) == _bits(jdbg[key])
    plain = corpus._template_bodies(*args, np.random.default_rng(seed))
    assert plain[0] == bodies and _bits(plain[1]) == _bits(labels)


def test_no_token_formats_to_zero():
    """tests/test_data_scale.py:137's invariant on the port's writer: the
    keep floor and the degenerate fallback are 1e-6, so no token reads
    0.000000."""
    bodies, labels, _ = corpus._template_bodies(64, 8, 512, np.random.default_rng(17),
                                                return_debug=True)
    assert len(bodies) == 64 and len(labels) == 64
    for body in bodies:
        assert ":0.000000" not in body, body
        for tok in body.split():
            fid, _, val = tok.partition(":")
            assert int(fid) >= 1
            assert float(val) > 0.0, tok


def test_the_planted_margins_match_the_parsed_values():
    """tests/test_data_scale.py:155's invariant on the port's writer: each
    planted margin is the dot of the file's %.6f values with w_true."""
    bodies, labels, dbg = corpus._template_bodies(48, 8, 256, np.random.default_rng(23),
                                                  return_debug=True)
    w_true, margins = dbg["w_true"], dbg["margins"]
    reparsed = np.zeros(len(bodies))
    for r, body in enumerate(bodies):
        for tok in body.split():
            fid, _, val = tok.partition(":")
            reparsed[r] += float(val) * w_true[int(fid) - 1]
    np.testing.assert_allclose(margins, reparsed, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(labels, np.where(reparsed > np.median(reparsed), 1, -1))


@pytest.mark.parametrize("n_threads", [0, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_load_rcv1_equals_jaxs_on_the_corpus(corpora, monkeypatch, seed, n_threads):
    port_dir, _, meta, _ = corpora[seed]
    assert _native.native_loaded()
    # 16 cores: with n_threads 0 each of the five files parses on the pool
    monkeypatch.setattr(os, "cpu_count", lambda: 16)
    pool = mm.global_metrics().counter("pool.submitted")
    submitted = pool.value
    got = rcv1.load_rcv1(port_dir, full=True, n_threads=n_threads)
    fanned_out = pool.value - submitted
    want = jrcv1.load_rcv1(port_dir, full=True, n_threads=n_threads)
    _same_dataset(got, want)
    assert len(got) == meta["n_rows"] == 8000
    assert fanned_out == (5 if n_threads == 0 else 0)
    nnz = (got.values != 0).sum(axis=1)
    assert got.pad_width == nnz.max()
    # the train file alone, the python route's arrays
    train = rcv1.load_rcv1(port_dir, full=False, n_threads=n_threads)
    assert len(train) == SMALL["n_train"]
    py = rcv1.parse_svm_file_py(os.path.join(port_dir, "lyrl2004_vectors_train.dat"))
    idx, val = rcv1.pack_csr(py[1], py[2], py[3], pad_width=train.pad_width)
    assert _bits(idx) == _bits(train.indices) and _bits(val) == _bits(train.values)


def test_a_forced_pad_width_truncates_as_jax_does(corpora, caplog):
    port_dir = corpora[SEEDS[0]][0]
    with caplog.at_level(logging.WARNING, logger="dsgd.data"):
        got = rcv1.load_rcv1(port_dir, full=True, pad_width=32)
    want = jrcv1.load_rcv1(port_dir, full=True, pad_width=32)
    _same_dataset(got, want)
    assert got.pad_width == 32
    assert any("pad_width=32 truncated" in r.getMessage() for r in caplog.records)


def test_build_from_corpus_passes_n_threads_and_writes_jaxs_store(corpora, tmp_path,
                                                                  monkeypatch):
    port_dir = corpora[SEEDS[1]][0]
    seen = []
    parse = _native.parse_svm_file
    monkeypatch.setattr(_native, "parse_svm_file",
                        lambda path, n_threads=0, index_offset=-1: seen.append(n_threads)
                        or parse(path, n_threads=n_threads, index_offset=index_offset))
    port_meta = row_store.build_from_corpus(port_dir, str(tmp_path / "port.rows"), full=True,
                                            n_threads=2)
    jax_meta = jrow_store.build_from_corpus(port_dir, str(tmp_path / "jax.rows"), full=True,
                                            n_threads=2)
    assert seen == [2] * 5
    assert port_meta == jax_meta and port_meta["n_rows"] == 8000
    for suffix in ("", ".meta.json", ".ds.npy"):
        assert filecmp.cmp(str(tmp_path / "port.rows") + suffix,
                           str(tmp_path / "jax.rows") + suffix, shallow=False), suffix


def test_main_trains_from_the_text_files_as_jax_loads_them(corpora, monkeypatch):
    port_dir = corpora[SEEDS[0]][0]
    for k in ("DSGD_SYNTHETIC", "DSGD_ENGINE", "DSGD_ASYNC", "DSGD_ROLE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DSGD_DATA_PATH", port_dir)
    monkeypatch.setenv("DSGD_FULL", "1")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "2")
    # the native parse and pack, timed where main reaches them
    spent = {"parse": 0.0, "pack": 0.0, "files": 0}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
                spent["files"] += key == "parse"
        return run

    monkeypatch.setattr(_native, "parse_svm_file", timed("parse", _native.parse_svm_file))
    monkeypatch.setattr(_native, "pack_csr", timed("pack", _native.pack_csr))
    held = {}
    load = tmain.load_data
    monkeypatch.setattr(tmain, "load_data", lambda cfg: held.setdefault("data", load(cfg)))
    run = tmain.main(device="cpu")
    data = held["data"]
    assert spent["files"] == 5 and spent["pack"] > 0
    assert run.data_seconds >= spent["parse"] + spent["pack"]

    jcfg = JConfig.from_env()
    assert (jcfg.data_path, jcfg.full) == (port_dir, True)
    want = jmain.load_data(jcfg)
    _same_dataset(data, want)
    assert len(data) == 8000 and data.n_features == rcv1.N_FEATURES

    fit = run.fit
    assert fit.epochs_run == 2 and fit.test_losses[-1] < 1.0
    train, test = jrcv1.train_test_split(want)
    n, virtual = jmain.select_topology(jcfg.node_count, 1, False)
    jr = JaxTrainer(jax_make_model(jcfg.model, jcfg.lam, train.n_features,
                                   dim_sparsity=jnp.asarray(jrcv1.dim_sparsity(train))),
                    make_mesh(n), batch_size=jcfg.batch_size,
                    learning_rate=jcfg.learning_rate, seed=jcfg.seed,
                    virtual_workers=virtual).fit(train, test, 2)
    # the main-path parity test's band: each side draws its own ids
    assert abs(fit.test_accuracies[-1] - jr.test_accuracies[-1]) <= 0.03
    assert fit.test_accuracies[-1] > 0.6
