"""Criteo preprocessing CLI (``openembedding_tpu/data/preprocess.py``):
raw TSV -> preprocessed CSV, in one streaming pass.

    python -m openembedding_tpu_torch.data.preprocess train.txt train.csv
    python -m openembedding_tpu_torch.data.preprocess train.txt train.csv --repeat 2

* categoricals: first-seen label encoding per column (missing -> 0), the
  encoder built in the same pass;
* counts: log1p squash (this framework's TSV convention) or min-max when
  ``--minmax`` (two passes, the sklearn recipe);
* ``--repeat N`` writes the output N times (throughput amplification);
* ``--expand N`` derives N rows from a preprocessed csv (see ``expand``).

Output header: label,I1..I13,C1..C26 — the ``read_criteo_csv`` contract.
The bytes written equal the JAX package's for the same input.
"""

from __future__ import annotations

import argparse
import math
import sys

from . import criteo


def _open_out(path: str):
    return sys.stdout if path == "-" else open(path, "w")


def preprocess(in_path: str, out_path: str, *, repeat: int = 1,
               minmax: bool = False, limit: int = 0) -> int:
    """Returns number of data rows written (before repetition)."""
    encoders = [dict() for _ in range(criteo.NUM_SPARSE)]
    lo = [math.inf] * criteo.NUM_DENSE
    hi = [-math.inf] * criteo.NUM_DENSE

    def parse(line):
        parts = line.rstrip("\n").split("\t")
        parts += [""] * (1 + criteo.NUM_DENSE + criteo.NUM_SPARSE
                         - len(parts))
        label = parts[0] or "0"
        dense = []
        for j in range(criteo.NUM_DENSE):
            v = parts[1 + j]
            dense.append(float(v) if v else 0.0)
        cats = []
        for j in range(criteo.NUM_SPARSE):
            raw = parts[1 + criteo.NUM_DENSE + j]
            enc = encoders[j]
            if raw not in enc:
                enc[raw] = len(enc)
            cats.append(enc[raw])
        return label, dense, cats

    if minmax:
        # dense-only first pass: building the 26 label dictionaries here
        # would churn memory only to be discarded
        with open(in_path) as f:
            for i, line in enumerate(f):
                if limit and i >= limit:
                    break
                parts = line.rstrip("\n").split("\t")
                for j in range(criteo.NUM_DENSE):
                    v = parts[1 + j] if 1 + j < len(parts) else ""
                    fv = float(v) if v else 0.0
                    lo[j] = min(lo[j], fv)
                    hi[j] = max(hi[j], fv)

    n = 0
    header = "label," + ",".join(criteo.DENSE_NAMES) + "," + ",".join(
        criteo.SPARSE_NAMES)
    out = _open_out(out_path)
    try:
        out.write(header + "\n")
        # repetition re-walks the input instead of buffering rows: repeating
        # a Criteo-scale file must stay O(1) in host memory (the tool's
        # whole reason to exist is streaming through files >> RAM)
        for rep in range(repeat):
            rows_this_rep = 0
            with open(in_path) as f:
                for i, line in enumerate(f):
                    if limit and i >= limit:
                        break
                    label, dense, cats = parse(line)
                    if minmax:
                        scaled = [
                            (v - lo[j]) / (hi[j] - lo[j])
                            if hi[j] > lo[j] else 0.0
                            for j, v in enumerate(dense)]
                    else:
                        scaled = [math.log1p(max(v, 0.0)) for v in dense]
                    row = (label + ","
                           + ",".join(f"{v:.6g}" for v in scaled) + ","
                           + ",".join(str(c) for c in cats))
                    out.write(row + "\n")
                    rows_this_rep += 1
            if rep == 0:
                n = rows_this_rep
            elif rows_this_rep != n:
                # a pipe / process substitution drains on the first walk —
                # fail loudly instead of silently writing fewer copies
                raise IOError(
                    f"--repeat re-reads the input, but pass {rep + 1} saw "
                    f"{rows_this_rep} rows vs {n} on the first pass; input "
                    "must be a re-readable regular file (not a pipe)")
    finally:
        if out is not sys.stdout:
            out.close()
    return n


def expand(in_csv: str, out_path: str, *, rows: int, noise: float = 0.3,
           seed: int = 7) -> int:
    """Derive a LARGE learnable sample from a small PREPROCESSED csv.

    ``--repeat`` duplicates rows verbatim — fine for throughput
    amplification (the C++ tool's use), statistically meaningless for a
    held-out AUC (eval rows would be exact copies of train rows). This
    derives ``rows`` new rows instead: each picks a parent row and
    re-draws a ``noise`` fraction of its 26 categoricals from that
    column's empirical pool (dense features and the label stay the
    parent's). The label remains predictable from the surviving parent
    fields, so the task is learnable but not memorizable — a held-out
    split measures real generalization on a deterministic, seeded set.
    The number is comparable across runs of this benchmark, NOT to AUCs
    on the real Criteo-1TB distribution.
    """
    import csv as csv_mod
    import numpy as np
    from . import criteo
    names = ("label",) + criteo.DENSE_NAMES + criteo.SPARSE_NAMES
    with open(in_csv) as f:
        reader = csv_mod.reader(f)
        header = next(reader)
        try:
            # header-name driven like read_criteo_csv — tolerates extra
            # columns (the reference fixture has a pandas index column)
            cols = [header.index(n) for n in names]
        except ValueError as e:
            raise ValueError(f"{in_csv} is not a preprocessed "
                             "label,I1..I13,C1..C26 csv") from e
        parents = [[row[c] for c in cols] for row in reader if row]
    if not parents:
        raise ValueError(f"no data rows in {in_csv}")
    cat0 = 1 + criteo.NUM_DENSE
    pools = [sorted({r[cat0 + j] for r in parents})
             for j in range(criteo.NUM_SPARSE)]
    rng = np.random.RandomState(seed)
    out = _open_out(out_path)
    try:
        out.write(",".join(names) + "\n")
        chunk = 8192
        for lo in range(0, rows, chunk):
            m = min(chunk, rows - lo)
            pidx = rng.randint(0, len(parents), m)
            flip = rng.random_sample((m, criteo.NUM_SPARSE)) < noise
            draws = [rng.randint(0, len(pools[j]), m)
                     for j in range(criteo.NUM_SPARSE)]
            for i in range(m):
                r = list(parents[pidx[i]])
                for j in range(criteo.NUM_SPARSE):
                    if flip[i, j]:
                        r[cat0 + j] = pools[j][draws[j][i]]
                out.write(",".join(r) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help="raw Criteo TSV (label \\t 13 ints \\t "
                                 "26 categoricals); with --expand: an "
                                 "already-PREPROCESSED csv")
    p.add_argument("output", help="csv path ('-' = stdout)")
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--minmax", action="store_true",
                   help="two-pass min-max scaling (sklearn recipe) instead "
                        "of log1p")
    p.add_argument("--limit", type=int, default=0, help="max input rows")
    p.add_argument("--expand", type=int, default=0, metavar="N",
                   help="derive N rows from a preprocessed csv (seeded "
                        "categorical noise around parent rows; see expand())")
    p.add_argument("--noise", type=float, default=0.3,
                   help="--expand: fraction of categoricals re-drawn")
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    if args.expand:
        n = expand(args.input, args.output, rows=args.expand,
                   noise=args.noise, seed=args.seed)
        print(f"derived {n} rows (noise={args.noise}, seed={args.seed})",
              file=sys.stderr)
        return 0
    n = preprocess(args.input, args.output, repeat=args.repeat,
                   minmax=args.minmax, limit=args.limit)
    print(f"wrote {n} rows x {args.repeat}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
