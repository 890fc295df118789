"""Tune an SVC on iris with the PyTorch port's fully-Bayesian BayesSearchCV.

The run of ``examples/searchcv_svc.py`` on ``bask_tpu_torch`` (the
reference's doctest example, ``bask/searchcv.py:133-164``): a mixed
log-uniform / integer / categorical space, 32 iterations.

It needs scikit-learn. The repository's CUDA test machine has none, so
this example is run there on the CPU only (``--cpu``); on a machine with
scikit-learn and a CUDA card it runs on the card.

Run:  python examples/torch_searchcv_svc.py        (the CUDA card)
      python examples/torch_searchcv_svc.py --cpu  (the CPU)

``--iters N`` runs N search iterations (default 32). Without ``--cpu``
the run needs a CUDA card and raises where there is none.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def device_arg(cpu: bool):
    """"cpu" with ``--cpu``; else ``None``, the entry points' CUDA card,
    which must exist: there is no fallback to the CPU."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: run on a machine with one, or pass --cpu")
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--iters", type=int, default=32, help="search iterations")
    args = ap.parse_args(argv)
    device = device_arg(args.cpu)

    from sklearn.datasets import load_iris
    from sklearn.model_selection import train_test_split
    from sklearn.svm import SVC

    from bask_tpu_torch import BayesSearchCV
    from bask_tpu_torch.space import Categorical, Integer, Real

    X, y = load_iris(return_X_y=True)
    X_train, X_test, y_train, y_test = train_test_split(X, y, train_size=0.75, random_state=0)
    opt = BayesSearchCV(
        SVC(),
        {
            "C": Real(1e-6, 1e6, prior="log-uniform"),
            "gamma": Real(1e-6, 1e1, prior="log-uniform"),
            "degree": Integer(1, 8),
            "kernel": Categorical(["linear", "poly", "rbf"]),
        },
        n_iter=args.iters,
        random_state=0,
        optimizer_kwargs={"device": device},
    )
    t0 = time.time()
    opt.fit(X_train, y_train)
    print(f"{args.iters} iterations: {time.time() - t0:.1f}s")
    print("best params:", opt.best_params_)
    print("test score:", round(opt.score(X_test, y_test), 4))
    return 0


if __name__ == "__main__":
    sys.exit(main())
