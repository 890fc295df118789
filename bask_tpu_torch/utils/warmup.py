"""Warm-up of a production BO loop before its first tell.

PyTorch counterpart of :mod:`bask_tpu.utils.warmup`, with its signature
and return value. What JAX compiles here, the port builds or captures: the
kernel library (``nvcc`` on a checkout with no build; see
:func:`bask_tpu_torch.utils.aot.enable_aot_cache` to keep it across
processes), the CUDA graphs of the chain step for each padding bucket
(:mod:`bask_tpu_torch.parallel.mcmc`; one capture serves every n in a
bucket) and of the consensus's geometric median, the cuBLAS/cuSOLVER
handles and the caching allocator's blocks.
The graphs are cached at module level (:mod:`bask_tpu_torch.utils.graphs`)
and keyed by value and by the
identity of the priors (guessed priors are module-level functions,
resolved SciPy and tabulated priors are cached across models), so a
throwaway clone sharing ``opt``'s kernel, priors and acquisition fills the
cache that ``opt``'s own tells then hit.

Call with the SAME ``gp_samples`` / ``gp_burnin`` / ``n_samples`` the real
``tell`` loop will use, as for the JAX package.
"""

from __future__ import annotations

import warnings
from typing import Iterable

import numpy as np

__all__ = ["warmup_optimizer"]


def warmup_optimizer(
    opt,
    n_observations: Iterable[int],
    gp_samples: int = 100,
    gp_burnin: int = 10,
    n_samples: int = 0,
    rng_seed: int = 0,
):
    """Build, capture and allocate what the tells of ``opt`` run, for each
    padding bucket covered by ``n_observations``.

    Runs a cold and a warm synthetic ``tell`` per bucket on a throwaway
    clone that shares ``opt``'s kernel / prior / acquisition instances and
    its device and dtype; ``opt`` itself is not touched. Returns the sorted
    list of warmed bucket sizes.
    """
    from ..models.bayesgpr import _bucket
    from ..optimizer import Optimizer
    from .median import geometric_median

    if opt.gp.device.type == "cuda":
        from ..ops import _cuda

        _cuda.library()
    clone = Optimizer(
        dimensions=opt.space.dimensions,
        n_points=opt.n_points,
        n_initial_points=0,
        init_strategy=None,
        gp_kernel=opt.gp._user_kernel,
        gp_kwargs=dict(
            alpha=opt.gp.alpha,
            normalize_y=opt.gp.normalize_y,
            warp_inputs=opt.gp.warp_inputs,
            noise=opt.gp.noise,
            # the move mixture picks which step graphs a chain replays
            moves=opt.gp.moves,
            chain_init=getattr(opt.gp, "chain_init", "ball"),
            ml2_objective=getattr(opt.gp, "ml2_objective", "lml"),
            # how an opaque prior resolves decides whether the chain is
            # graphed (tabulated) or eager (host adapter)
            host_prior_mode=opt.gp.host_prior_mode,
        ),
        gp_priors=opt.gp_priors,
        acq_func=opt.acq_func,
        acq_func_kwargs=opt.acq_func_kwargs,
        random_state=rng_seed,
        # a mesh keeps the chain eager and rounds the walker count
        mesh=getattr(opt, "mesh", None),
        gp_sample_kwargs=getattr(opt, "gp_sample_kwargs", {}),
        acq_polish=getattr(opt, "acq_polish", 0),
        acq_polish_starts=getattr(opt, "acq_polish_starts", 4),
        acq_polish_lr=getattr(opt, "acq_polish_lr", 0.05),
        device=opt.gp.device,
        dtype=opt.gp.dtype,
    )
    if "until_rhat" not in clone.gp_sample_kwargs:
        # the default cold fit warm-extends the chain in 300-step legs to
        # R-hat 1.1; one leg on the synthetic data runs the same chain
        # configuration without sampling a throwaway posterior to
        # convergence (the warm tell below keeps the real loop's kwargs)
        cold_kwargs = dict(
            clone.gp_sample_kwargs,
            until_rhat=1.1, max_extensions=1, extension_steps=300,
        )
    else:
        cold_kwargs = clone.gp_sample_kwargs
    warm_kwargs = clone.gp_sample_kwargs
    rng = np.random.RandomState(rng_seed)
    d = opt.space.transformed_n_dims
    buckets = sorted({_bucket(max(int(n), 1)) for n in n_observations})
    for b in buckets:
        # fill the bucket up to one point below (b >= 64 always): any n
        # in (b-64, b] pads to the same shapes, hence the same graphs
        X = rng.uniform(size=(b - 1, d))
        y = np.sin(3.0 * X[:, 0]) + 0.1 * rng.randn(X.shape[0])
        pts = opt.space.inverse_transform(X)
        clone.gp_sample_kwargs = cold_kwargs
        try:
            with warnings.catch_warnings():
                # the cold tell's R-hat budget is one leg by design; its
                # non-convergence warning means nothing here
                warnings.filterwarnings("ignore", message=".*did not reach R-hat.*")
                clone.tell(
                    pts,
                    list(y),
                    replace=True,
                    n_samples=n_samples,
                    gp_samples=gp_samples,
                    gp_burnin=gp_burnin,
                )
        finally:
            clone.gp_sample_kwargs = warm_kwargs
        # one more point inside the same bucket drives the warm tell, the
        # loop's steady state
        x1 = opt.space.inverse_transform(rng.uniform(size=(1, d)))[0]
        clone.tell(
            x1,
            float(np.sin(3.0 * rng.uniform())),
            n_samples=n_samples,
            gp_samples=gp_samples,
            gp_burnin=gp_burnin,
        )
        if opt.gp.device.type == "cuda":
            # the warm tell's consensus may be its median's first call at
            # this shape, which runs eagerly; a second call captures the
            # median's graph, so the loop's first warm tell replays it
            # (utils/graphs.py: MEDIAN captures on a key's second call; a
            # CPU median always runs eagerly)
            geometric_median(clone.gp._tensor(clone.gp.chain_))
    return buckets
