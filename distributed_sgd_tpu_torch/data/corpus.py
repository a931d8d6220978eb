"""Full-scale corpus writer in the reference's exact RCV1 text format.

The port's own copy of the JAX package's writer (distributed_sgd_tpu/
data/corpus.py): for the same arguments it writes the same bytes and
returns the same metadata.

The reference gates its loader on the real dataset: parse all 804,414
rows in < 40 s (src/test/scala/epfl/distributed/utils/DatasetTests.scala:11-23).
The real files are not shipped, so this writer produces a corpus with the
same file layout (Dataset.scala:47-50: one train file + four test parts),
the same row format (Dataset.scala:19-34: ``docid␣␣f:v f:v ...`` — double
space after the id, 1-based feature ids), and the same qrels label format
(Dataset.scala:36-45: ``TOPIC docid 1``, CCAT → +1, last line per doc
wins) at the same row count and nnz density, so the parser can be held to
the reference's gate at the scale it exists for.

Speed: formatting ~61M ``f:v`` tokens in python would dominate a run, so
a pool of ``n_template`` fully random row bodies is formatted once and
tiled across the corpus with unique sequential doc ids.  The parser sees
the same byte volume, token count, and per-line work as a fully unique
corpus; only the value *strings* repeat every ``n_template`` rows.

Two rounding facts are kept as the JAX writer has them (so the bytes
match): the degenerate row's fallback and the floor are 1e-6, and the
planted margin is computed from the values rounded to the file's
``%.6f``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple, Union

import numpy as np

# real RCV1 layout: 23,149 train docs + 781,265 test docs = 804,414
N_ROWS_FULL = 804414
N_TRAIN_ROWS = 23149
FIRST_DOC_ID = 2286  # real RCV1 ids start here


def _template_bodies(
    n_template: int, nnz_mean: int, n_features: int, rng: np.random.Generator,
    return_debug: bool = False,
) -> Union[Tuple[List[str], np.ndarray],
           Tuple[List[str], np.ndarray, Dict[str, np.ndarray]]]:
    """Format `n_template` random row bodies ("f:v f:v ...", 1-based ids).

    Returns (bodies, labels): labels come from a planted linear separator
    over the row features (like data/synthetic.rcv1_like), so a corpus
    written from these templates is LEARNABLE — training on the parsed
    files converges, closing the text->parse->train loop end to end.

    `return_debug=True` additionally returns {"w_true", "margins"} so a
    test can check the two rounding invariants from the outside: every
    emitted token formats nonzero, and each planted margin equals the dot
    product of the parsed (file-precision) values with w_true, i.e. the
    label a reader derives from the file bytes is the label planted.
    """
    nnz = np.clip(rng.poisson(nnz_mean, size=n_template), 1, None)
    max_nnz = int(nnz.max())
    # Zipf-ish feature popularity like term frequencies (matches synthetic.py)
    pop = 1.0 / np.arange(1, n_features + 1, dtype=np.float64)
    pop /= pop.sum()
    idx = rng.choice(n_features, size=(n_template, max_nnz), p=pop).astype(np.int32)
    val = rng.uniform(0.001, 1.0, size=(n_template, max_nnz))
    w_true = rng.normal(size=n_features).astype(np.float64)
    rows: List[Tuple[np.ndarray, np.ndarray]] = []
    for r in range(n_template):
        # slice to this row's draws FIRST, then sort: sorting the full
        # max_nnz row and truncating would leave short rows holding the
        # sorted prefix (systematically low feature ids), skewing the
        # corpus's popularity profile beyond the intended Zipf draw
        row_idx = np.sort(idx[r, : nnz[r]])
        # file rows cannot repeat a feature id (they decode into a map in
        # the reference, Dataset.scala:24-33): drop duplicate draws
        keep = np.ones(len(row_idx), dtype=bool)
        keep[1:] = row_idx[1:] != row_idx[:-1]
        rows.append((row_idx[keep], val[r, : nnz[r]][keep]))

    # ltc term weighting, like the REAL RCV1-v2 vectors (LYRL2004): weight
    # each entry by its feature's inverse DOCUMENT frequency over the
    # template pool (once per row, so df <= n_template and idf >= 0), then
    # cosine-normalize the row.  Without it Zipf-head features carry
    # unattenuated values no real term weighting produces and the
    # reference's lr=0.5 oscillates.
    # The small floor keeps a ubiquitous feature's token nonzero in the
    # text (a 0-valued f:v entry would decode into the reference's map)
    df = np.zeros(n_features, dtype=np.int64)
    for row_idx, _ in rows:
        df[row_idx] += 1
    idf = np.maximum(np.log(n_template / np.maximum(df, 1.0)), 0.01)

    bodies: List[str] = []
    margins = np.zeros(n_template)
    for r, (row_idx, row_val) in enumerate(rows):
        row_val = row_val * idf[row_idx]
        row_val /= max(float(np.linalg.norm(row_val)), 1e-12)
        # drop entries the %.6f text format would round to 0.000000 (a
        # floored ubiquitous feature over a large row norm): real RCV1
        # files carry no zero-valued tokens, and the floor must sit at a
        # value %.6f keeps nonzero — 5e-7 itself formats as 0.000000
        # (round-half-even), so the floor and the degenerate fallback are
        # both 1e-6, the smallest value the format preserves
        keep = row_val >= 1e-6
        row_idx, row_val = row_idx[keep], row_val[keep]
        if len(row_idx) == 0:  # degenerate all-dropped row: keep one token
            row_idx, row_val = np.array([1], np.int32), np.array([1e-6], np.float64)
        # the planted margin must see exactly the values the parser will
        # read back: round to the %.6f wire precision BEFORE the dot, or a
        # margin near the median could flip its label relative to the file
        # contents even at noise=0
        row_val = np.round(row_val, 6)
        margins[r] = float(np.dot(row_val, w_true[row_idx]))
        bodies.append(
            " ".join(f"{c + 1}:{v:.6f}" for c, v in zip(row_idx, row_val))
        )
    labels = np.where(margins > np.median(margins), 1, -1).astype(np.int32)
    if return_debug:
        return bodies, labels, {"w_true": w_true, "margins": margins}
    return bodies, labels


def write_rcv1_corpus(
    folder: str,
    n_rows: int = N_ROWS_FULL,
    n_train: int = N_TRAIN_ROWS,
    n_template: int = 16384,
    # Zipf-popularity draws collide and are deduped, so the DRAW mean must
    # exceed the target ~76 distinct features/row (real RCV1 density);
    # 115 draws land at ~76 distinct, reported as `nnz_per_row` in metadata
    nnz_mean: int = 115,
    n_features: int = 47236,
    label_noise: float = 0.05,
    seed: int = 0,
    chunk: int = 65536,
) -> Dict[str, object]:
    """Write train + 4 test parts + qrels into `folder`; returns metadata.

    Labels follow the templates' planted separator (CCAT = +1 side) with
    `label_noise` random flips, so the corpus is learnable after parsing.
    """
    rng = np.random.default_rng(seed)
    bodies, tmpl_labels = _template_bodies(
        min(n_template, n_rows), nnz_mean, n_features, rng)
    n_template = len(bodies)
    tokens_per_row = sum(b.count(":") for b in bodies) / n_template

    os.makedirs(folder, exist_ok=True)
    n_test = n_rows - n_train
    part_sizes = [(n_test + i) // 4 for i in range(4)]  # reference's 4 test parts
    plan = [("lyrl2004_vectors_train.dat", n_train)] + [
        (f"lyrl2004_vectors_test_pt{d}.dat", part_sizes[d]) for d in range(4)
    ]

    doc = FIRST_DOC_ID
    total_bytes = 0
    for fname, rows in plan:
        path = os.path.join(folder, fname)
        with open(path, "w") as f:
            written = 0
            while written < rows:
                n = min(chunk, rows - written)
                lines = [
                    f"{doc + i}  {bodies[(doc + i) % n_template]}\n" for i in range(n)
                ]
                f.write("".join(lines))
                doc += n
                written += n
        total_bytes += os.path.getsize(path)

    # qrels: one line per doc (+ an extra preceding topic line for every
    # 50th doc so the last-line-wins overwrite path runs at scale too).
    # doc i reuses template (FIRST_DOC_ID + i) % n_template — same mapping
    # as the row bodies above — so its label matches its features
    doc_labels = tmpl_labels[(FIRST_DOC_ID + np.arange(n_rows)) % n_template]
    flip = rng.random(n_rows) < label_noise
    is_ccat = np.where(flip, -doc_labels, doc_labels) == 1
    other = rng.choice(["ECAT", "GCAT", "MCAT"], size=n_rows)
    qrels = os.path.join(folder, "rcv1-v2.topics.qrels")
    with open(qrels, "w") as f:
        for start in range(0, n_rows, chunk):
            n = min(chunk, n_rows - start)
            lines: List[str] = []
            for i in range(start, start + n):
                d = FIRST_DOC_ID + i
                if i % 50 == 0:
                    lines.append(f"C15 {d} 1\n")
                lines.append(f"{'CCAT' if is_ccat[i] else other[i]} {d} 1\n")
            f.write("".join(lines))

    return {
        "n_rows": n_rows,
        "files": [name for name, _ in plan] + ["rcv1-v2.topics.qrels"],
        "bytes": total_bytes,
        "n_ccat": int(is_ccat.sum()),
        "nnz_per_row": tokens_per_row,
    }
