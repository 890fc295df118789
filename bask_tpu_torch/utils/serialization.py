"""Checkpoint and resume for BayesGPR and Optimizer state.

PyTorch counterpart of :mod:`bask_tpu.utils.serialization`, writing and
reading the same file: one ``.npz`` with a JSON ``__meta__`` entry (kernel
specs, settings, observations, RNG states) and the arrays (chain, walker
positions, consensus theta, training data) under the JAX package's keys.
A checkpoint written by either package loads in the other. Loading
recomputes the consensus posterior on the model's device; the loaders
take ``device`` and ``dtype`` for that (``device=None`` is the CUDA card).
"""

from __future__ import annotations

import json
import pickle
import warnings

import numpy as np
import torch

from .. import space as sp
from ..ops import kernels as bk

__all__ = [
    "kernel_to_dict",
    "kernel_from_dict",
    "save_optimizer",
    "load_optimizer",
    "save_gpr",
    "load_gpr",
]


def _json_default(obj):
    """json.dumps fallback for NumPy scalars and arrays (in Xi or
    acq_func_kwargs when users tell() NumPy values)."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"Object of type {type(obj).__name__} is not JSON serializable")


def _jsonable_or_warn(d: dict, name: str) -> dict:
    """``d`` if it serializes to JSON, else ``{}`` with a warning: a
    checkpoint degrades rather than failing on an exotic value."""
    try:
        json.dumps(d, default=_json_default)
        return d
    except TypeError:
        warnings.warn(
            f"save_optimizer: {name} contains values that cannot be "
            "serialized and was dropped from the checkpoint — re-assign "
            f"opt.{name} after load_optimizer.",
            UserWarning,
            stacklevel=3,
        )
        return {}


# -- kernel spec <-> dict ----------------------------------------------------


def kernel_to_dict(k: bk.Kernel) -> dict:
    if isinstance(k, bk.CompoundKernel):
        return {"type": "CompoundKernel", "kernels": [kernel_to_dict(kk) for kk in k.kernels]}
    if isinstance(k, bk.Sum):  # Product subclasses Sum
        return {"type": type(k).__name__, "k1": kernel_to_dict(k.k1), "k2": kernel_to_dict(k.k2)}
    if isinstance(k, bk.Exponentiation):
        return {"type": "Exponentiation", "kernel": kernel_to_dict(k.kernel),
                "exponent": k.exponent}
    if isinstance(k, bk.ConstantKernel):
        return {"type": "ConstantKernel", "value": k.constant_value,
                "bounds": k.constant_value_bounds}
    if isinstance(k, bk.WhiteKernel):
        return {"type": "WhiteKernel", "value": k.noise_level, "bounds": k.noise_level_bounds}
    if isinstance(k, bk.RBF):  # Matern subclasses RBF
        ls = k.length_scale
        d = {"type": "Matern" if isinstance(k, bk.Matern) else "RBF",
             "value": list(ls) if np.iterable(ls) else ls, "bounds": k.length_scale_bounds}
        if isinstance(k, bk.Matern):
            d["nu"] = k.nu
        return d
    raise TypeError(f"Cannot serialize kernel {type(k).__name__}")


def _bounds(b):
    return tuple(b) if isinstance(b, list) else b


def _ls(v):
    return tuple(v) if isinstance(v, list) else v


def kernel_from_dict(d: dict) -> bk.Kernel:
    t = d["type"]
    if t == "CompoundKernel":
        return bk.CompoundKernel(tuple(kernel_from_dict(kk) for kk in d["kernels"]))
    if t in ("Sum", "Product"):
        cls = bk.Sum if t == "Sum" else bk.Product
        return cls(kernel_from_dict(d["k1"]), kernel_from_dict(d["k2"]))
    if t == "Exponentiation":
        return bk.Exponentiation(kernel_from_dict(d["kernel"]), d["exponent"])
    if t == "ConstantKernel":
        return bk.ConstantKernel(d["value"], _bounds(d["bounds"]))
    if t == "WhiteKernel":
        return bk.WhiteKernel(d["value"], _bounds(d["bounds"]))
    if t == "Matern":
        return bk.Matern(_ls(d["value"]), _bounds(d["bounds"]), nu=d["nu"])
    if t == "RBF":
        return bk.RBF(_ls(d["value"]), _bounds(d["bounds"]))
    raise TypeError(f"Unknown kernel type {t}")


# -- dimension <-> dict ------------------------------------------------------


def _dim_to_dict(d) -> dict:
    if isinstance(d, (sp.Real, sp.Integer)):
        return {"type": type(d).__name__, "low": d.low, "high": d.high,
                "prior": d.prior, "name": d.name}
    if isinstance(d, sp.Categorical):
        return {"type": "Categorical", "categories": d.categories, "name": d.name}
    raise TypeError(f"Cannot serialize dimension {d!r}")


def _dim_from_dict(d: dict):
    t = d["type"]
    if t == "Real":
        return sp.Real(d["low"], d["high"], prior=d["prior"], name=d["name"])
    if t == "Integer":
        return sp.Integer(d["low"], d["high"], prior=d.get("prior", "uniform"), name=d["name"])
    if t == "Categorical":
        return sp.Categorical(d["categories"], name=d["name"])
    raise TypeError(f"Unknown dimension type {t}")


# -- GPR state ---------------------------------------------------------------

_GPR_ARRAYS = ("chain_", "chain_steps_", "pos_", "warp_alphas_", "warp_betas_", "_theta")


def _gpr_state(gp) -> dict:
    meta = {
        "alpha": gp.alpha,
        "normalize_y": gp.normalize_y,
        "warp_inputs": gp.warp_inputs,
        "noise": gp.noise,
        "noise_": gp.noise_,
        "lml_value": gp.log_marginal_likelihood_value_,
        "kernel_user": kernel_to_dict(gp._user_kernel),
        # the post-fit spec (White included); theta is stored apart
        "kernel_fitted": kernel_to_dict(gp._spec) if gp._spec is not None else None,
        "y_mean": gp.y_train_mean_,
        "y_std": gp.y_train_std_,
        "n_accepted": gp.n_accepted_,
        "n_proposals": gp.n_proposals_,
        "moves": gp.moves,
        "chain_init": gp.chain_init,
        "ml2_subsample": gp.ml2_subsample,
        "ml2_objective": gp.ml2_objective,
    }
    arrays = {}
    for name in _GPR_ARRAYS:
        v = getattr(gp, name)
        if v is not None:
            arrays[f"gpr{name}"] = np.asarray(v)
    # chain_ is a reshaped view of chain_steps_ when their sizes agree
    if (
        "gprchain_" in arrays and "gprchain_steps_" in arrays
        and arrays["gprchain_"].size == arrays["gprchain_steps_"].size
    ):
        del arrays["gprchain_"]
    if gp._X_orig is not None:
        arrays["gpr_X"] = gp._X_orig
        arrays["gpr_y"] = gp._y_orig
    if gp._noise_vector is not None:
        arrays["gpr_noise_vector"] = gp._noise_vector
    return {"meta": meta, "arrays": arrays}


def _restore_gpr(gp, meta, arrays):
    from ..models.bayesgpr import _canonical_moves

    # a checkpoint without "moves" predates them and sampled pure stretch
    gp.moves = _canonical_moves(meta["moves"]) if "moves" in meta else None
    gp.chain_init = meta.get("chain_init", "ball")
    gp.ml2_subsample = meta.get("ml2_subsample", None)
    gp.ml2_objective = meta.get("ml2_objective", "lml")
    gp.noise_ = meta["noise_"]
    gp.log_marginal_likelihood_value_ = meta["lml_value"]
    if meta["kernel_fitted"] is not None:
        gp._spec = kernel_from_dict(meta["kernel_fitted"])
    gp.y_train_mean_ = meta["y_mean"]
    gp.y_train_std_ = meta["y_std"]
    if meta.get("n_proposals") is not None:
        gp.n_accepted_ = meta["n_accepted"]
        gp.n_proposals_ = meta["n_proposals"]
    for name in _GPR_ARRAYS[:-1]:
        if f"gpr{name}" in arrays:
            setattr(gp, name, np.array(arrays[f"gpr{name}"], dtype=float))
    if gp.chain_ is None and gp.chain_steps_ is not None:
        gp.chain_ = gp.chain_steps_.reshape(-1, gp.chain_steps_.shape[-1])
    if "gpr_X" in arrays:
        gp._X_orig = np.array(arrays["gpr_X"], dtype=float)
        gp._y_orig = np.array(arrays["gpr_y"], dtype=float)
        nv = arrays.get("gpr_noise_vector")
        gp._noise_vector = None if nv is None else np.array(nv, dtype=float)
        gp._upload()
    if "gpr_theta" in arrays:
        theta = np.array(arrays["gpr_theta"], dtype=float)
        if gp._X_orig is not None:
            gp.theta = theta  # refreshes the consensus posterior
        else:
            gp._theta = theta
    return gp


def save_gpr(gp, path: str) -> None:
    state = _gpr_state(gp)
    np.savez_compressed(path, __meta__=json.dumps(state["meta"]), **state["arrays"])


def load_gpr(path: str, device=None, dtype=torch.float32):
    """A BayesGPR from ``path`` on ``device`` in ``dtype``."""
    from ..models.bayesgpr import BayesGPR

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    gp = BayesGPR(
        kernel=kernel_from_dict(meta["kernel_user"]),
        alpha=meta["alpha"],
        normalize_y=meta["normalize_y"],
        warp_inputs=meta["warp_inputs"],
        noise=meta["noise"],
        device=device,
        dtype=dtype,
    )
    return _restore_gpr(gp, meta, arrays)


# -- Optimizer state ---------------------------------------------------------


def _rng_meta(rng):
    state = rng.get_state()
    return state[1], [state[0], int(state[2]), int(state[3]), float(state[4])]


def _set_rng(rng, keys, m):
    rng.set_state((m[0], keys, m[1], m[2], m[3]))


def save_optimizer(opt, path: str, pickle_unsupported: bool = False) -> None:
    """Serialize an Optimizer (observations, GP, RNG states) to ``path``.

    Built-in acquisitions round-trip by registry name. A custom
    acquisition instance or callable ``gp_priors`` have no npz form; with
    ``pickle_unsupported=True`` they are embedded as pickle blobs, which
    only ``load_optimizer(path, allow_pickle=True)`` restores (unpickling
    executes code, so both ends opt in). Without it the save warns and the
    restored optimizer uses "pvrs" and guessed priors.
    """
    from ..optimizer import ACQUISITION_FUNC

    gstate = _gpr_state(opt.gp)
    pickle_arrays = {}
    acq_name = next(
        (name for name, fn in ACQUISITION_FUNC.items()
         if fn is opt.acq_func or type(fn) is type(opt.acq_func)),
        None,
    )

    def _try_pickle(obj, key, what):
        try:
            pickle_arrays[key] = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
            return True
        except Exception as exc:  # any object may refuse to pickle
            warnings.warn(
                f"save_optimizer: {what} could not be pickled ({exc!r}); "
                "saving the checkpoint without it — re-assign it after "
                "load_optimizer.",
                stacklevel=3,
            )
            return False

    if acq_name is None:
        if pickle_unsupported and _try_pickle(
            opt.acq_func, "pickle_acq", "the custom acquisition function"
        ):
            acq_name = "__pickled__"
        elif not pickle_unsupported:
            warnings.warn(
                "save_optimizer: acquisition function "
                f"{type(opt.acq_func).__name__!r} is not in ACQUISITION_FUNC "
                "and cannot be serialized; the restored optimizer will use "
                "'pvrs'. Pass pickle_unsupported=True to embed it as a "
                "pickle blob, or re-assign opt.acq_func after load_optimizer.",
                stacklevel=2,
            )
    if opt.gp_priors is not None:
        if pickle_unsupported:
            _try_pickle(opt.gp_priors, "pickle_priors", "gp_priors")
        else:
            warnings.warn(
                "save_optimizer: gp_priors are callables and are not "
                "serialized; the restored optimizer will guess priors from "
                "the kernel. Pass pickle_unsupported=True to embed them as "
                "a pickle blob, or re-assign opt.gp_priors after load_optimizer.",
                stacklevel=2,
            )
    meta = {
        "dimensions": [_dim_to_dict(d) for d in opt.space.dimensions],
        "n_points": opt.n_points,
        "n_initial_points": opt.n_initial_points_,
        "n_initial_remaining": opt._n_initial_points,
        "init_strategy": opt.init_strategy,
        "acq_func": acq_name or "pvrs",
        "acq_func_kwargs": opt.acq_func_kwargs,
        "gp_sample_kwargs": _jsonable_or_warn(opt.gp_sample_kwargs, "gp_sample_kwargs"),
        "acq_polish": opt.acq_polish,
        "acq_polish_starts": opt.acq_polish_starts,
        "acq_polish_lr": opt.acq_polish_lr,
        "Xi": opt.Xi,
        "yi": opt.yi,
        "noisei": opt.noisei,
        "next_x": opt._next_x,
        "gpr": gstate["meta"],
    }
    arrays = dict(gstate["arrays"])
    arrays.update(pickle_arrays)
    arrays["rng_keys"], meta["rng"] = _rng_meta(opt.rng)
    # the GP's own stream (chain seeds, sample_y seeds) too
    arrays["gp_rng_keys"], meta["gp_rng"] = _rng_meta(opt.gp.random_state)
    if getattr(opt, "_init_rng", None) is not None:
        arrays["init_rng_keys"], meta["init_rng"] = _rng_meta(opt._init_rng)
    np.savez_compressed(path, __meta__=json.dumps(meta, default=_json_default), **arrays)


def load_optimizer(path: str, allow_pickle: bool = False, device=None, dtype=torch.float32):
    """Restore an Optimizer saved by :func:`save_optimizer` (by either
    package) on ``device`` in ``dtype``.

    ``allow_pickle=True`` also restores a custom acquisition or callable
    gp_priors embedded by ``save_optimizer(..., pickle_unsupported=True)``.
    The blobs execute code on load: only for checkpoints you wrote.
    """
    from ..optimizer import Optimizer

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}

    acq_func = meta["acq_func"]
    if acq_func == "__pickled__":
        if allow_pickle and "pickle_acq" in arrays:
            warnings.warn(
                "load_optimizer: restoring a pickled custom acquisition "
                "function — unpickling executes code; only load "
                "checkpoints you trust.",
                stacklevel=2,
            )
            acq_func = pickle.loads(arrays["pickle_acq"].tobytes())
        else:
            warnings.warn(
                "load_optimizer: checkpoint contains a pickled custom "
                "acquisition function; pass allow_pickle=True to restore "
                "it. Falling back to 'pvrs'.",
                stacklevel=2,
            )
            acq_func = "pvrs"

    g = meta["gpr"]
    opt = Optimizer(
        dimensions=[_dim_from_dict(d) for d in meta["dimensions"]],
        n_points=meta["n_points"],
        n_initial_points=meta["n_initial_points"],
        init_strategy=meta["init_strategy"],
        gp_kernel=kernel_from_dict(g["kernel_user"]),
        acq_func=acq_func,
        acq_func_kwargs=meta["acq_func_kwargs"],
        gp_sample_kwargs=meta.get("gp_sample_kwargs") or {},
        acq_polish=meta.get("acq_polish", 0),
        acq_polish_starts=meta.get("acq_polish_starts", 4),
        acq_polish_lr=meta.get("acq_polish_lr", 0.05),
        gp_kwargs=dict(alpha=g["alpha"], normalize_y=g["normalize_y"],
                       warp_inputs=g["warp_inputs"], noise=g["noise"]),
        device=device,
        dtype=dtype,
    )
    opt.Xi = [list(x) for x in meta["Xi"]]
    opt.yi = list(meta["yi"])
    opt.noisei = list(meta["noisei"])
    opt._n_initial_points = meta["n_initial_remaining"]
    opt._next_x = meta["next_x"]
    _set_rng(opt.rng, arrays["rng_keys"], meta["rng"])
    if "init_rng_keys" in arrays and getattr(opt, "_init_rng", None) is not None:
        _set_rng(opt._init_rng, arrays["init_rng_keys"], meta["init_rng"])
    if "gp_rng_keys" in arrays:
        _set_rng(opt.gp.random_state, arrays["gp_rng_keys"], meta["gp_rng"])
    if "pickle_priors" in arrays:
        if allow_pickle:
            warnings.warn(
                "load_optimizer: restoring pickled gp_priors — unpickling "
                "executes code; only load checkpoints you trust.",
                stacklevel=2,
            )
            opt.gp_priors = pickle.loads(arrays["pickle_priors"].tobytes())
        else:
            warnings.warn(
                "load_optimizer: checkpoint contains pickled gp_priors; "
                "pass allow_pickle=True to restore them. Falling back to "
                "kernel-guessed priors.",
                stacklevel=2,
            )
    _restore_gpr(opt.gp, g, arrays)
    return opt
