"""The Hogwild settings of chip_smoke.py phase 16 (b) through the JAX
engine and through the port's on the CPU, at full width: each codec's
best weights' test accuracy and the updates run.

    python tests/torch_hogwild_compress_reference.py [none|topk|qint8 ...]

804,414 synthetic RCV1 rows (seed 0, ltc values), 47,236 features, hinge
with the dim-sparsity regularizer, 3 workers, 64 steps a dispatch, B=100,
lr 0.5, the smoothed test loss checked every 16,000 updates and the fit
stopped at its 10th check; compress_k 0.01 with error feedback.  Prints
one JSON line a package and codec.  Several minutes a codec; not a test
(the file name keeps pytest from collecting it).  The phase's top-k check
holds the card to the JAX engine's accuracy that this prints.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split  # noqa: E402
from distributed_sgd_tpu.data.synthetic import rcv1_like  # noqa: E402
from distributed_sgd_tpu.models.linear import make_model as jax_make_model  # noqa: E402
from distributed_sgd_tpu.parallel.hogwild import HogwildEngine as JaxHogwild  # noqa: E402
from distributed_sgd_tpu.parallel.mesh import make_mesh  # noqa: E402
from distributed_sgd_tpu.parallel.sync import SyncEngine as JaxSyncEngine  # noqa: E402
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics  # noqa: E402
from distributed_sgd_tpu_torch.data.rcv1 import Dataset  # noqa: E402
from distributed_sgd_tpu_torch.models.linear import make_model  # noqa: E402
from distributed_sgd_tpu_torch.parallel.hogwild import HogwildEngine  # noqa: E402
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine  # noqa: E402
from distributed_sgd_tpu_torch.utils.metrics import Metrics  # noqa: E402

ROWS, WORKERS, K, B, LR = 804414, 3, 64, 100, 0.5
CHECK_EVERY, CHECKS, COMPRESS_K = 16000, 10, 0.01


def main(codecs) -> None:
    train, test = train_test_split(rcv1_like(ROWS, seed=0, idf_values=True))
    ds = dim_sparsity(train)
    jmodel = jax_make_model("hinge", 1e-5, train.n_features, dim_sparsity=jnp.asarray(ds))
    tmodel = make_model("hinge", 1e-5, train.n_features, dim_sparsity=ds, device="cpu")
    jeval = JaxSyncEngine(jmodel, make_mesh(1), B, 0.0).bind(test)
    ttrain, ttest = (Dataset(d.indices, d.values, d.labels, d.n_features)
                     for d in (train, test))
    teval = SyncEngine(tmodel, B, 0.0, device="cpu").bind(ttest)
    for codec in codecs:
        kw = {} if codec == "none" else {"compress": codec, "compress_k": COMPRESS_K}
        common = dict(n_workers=WORKERS, batch_size=B, learning_rate=LR,
                      check_every=CHECK_EVERY, backoff_s=0.05, seed=0, steps_per_dispatch=K)
        for pkg in ("jax", "port"):
            t0 = time.perf_counter()
            if pkg == "jax":
                eng = JaxHogwild(jmodel, metrics=JaxMetrics(), **common, **kw)
                fit = eng.fit(train, test, max_epochs=1, criterion=lambda h: len(h) >= CHECKS)
                loss, acc = jeval.evaluate(jnp.asarray(fit.state.weights))
            else:
                eng = HogwildEngine(tmodel, metrics=Metrics(), device="cpu", **common, **kw)
                fit = eng.fit(ttrain, ttest, max_epochs=1,
                              criterion=lambda h: len(h) >= CHECKS)
                loss, acc = teval.evaluate(torch.as_tensor(fit.state.weights))
            print(json.dumps({"package": pkg, "codec": codec, "updates": int(fit.state.updates),
                              "seconds": round(time.perf_counter() - t0, 1),
                              "best_test_loss": float(loss), "best_test_acc": float(acc)}),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["none", "topk", "qint8"])
