"""Values of pathwise GP draws at a batch of queries (kernel K5).

For row ``b`` of a batch, query ``i`` and column ``r``:

    out[b, i, r] = coef[b] sum_j W[b, j, r] cos(<Xq[b, i], omega[b, j]> + phase[b, j])
                 + amp[b]  sum_j V[b, j, r] k_nu(sum_k ((Xq[b, i, k] - X[b, j, k]) inv_ls[b, k])^2)

the random-feature prior draw plus the cross-kernel against its
weights, the whole of a pathwise draw once ``V = K^-1 (y - f0(X) - eps)``
is known (:mod:`bask_tpu_torch.models.pathwise`). ``Xq`` is one grid
shared by every row (m, d) or one per row (B, m, d), ``X`` likewise;
``V`` carries the training mask (padded rows 0), so the sum needs no
count of real points. Without ``X`` the cross term is left out: that is
``f0`` at the training points.

What it replaces: the fusion XLA makes inside the JAX package's jitted
pathwise program, ``bask_tpu/models/pathwise.py`` lines 54-112
(``pathwise_samples``: ``features(Xq) @ w`` and ``_cross_kernel(...) @ v``)
and lines 130-215 (the ``lax.scan`` of ``pathwise_topk_hyper``, which runs
it per draw). There is no Pallas kernel for it. Run op by op, the port
wrote every (draws, queries, features) and (draws, queries, points)
intermediate to device memory, a 1 GiB slab at a time.

What bounds it on an H100: arithmetic. The count that defines its bound
(:func:`k5_operations`), at one column: per (query, feature) pair
``2d + 4`` float32 operations (the d-long dot, 2d; the phase; the cosine
counted as one; the multiply-add into the sum, 2), per (query, training
point) pair ``2d + 8`` (the scaled difference and its square per
dimension, 2d; the root, the exponential and the polynomial, 6; the
multiply-add, 2); each further column adds 2 to both. Only the training
points the mask keeps count. At the batch ask (256 rows, 65,536
queries, 1,024 features, n = 1,000 of 1,024 points, d = 15) that is
1.22e12 operations (1.24e12 with the padded points), 18.2 ms at the
card's 67 TFLOP/s outside the tensor cores, against ~0.1 GB of inputs
and output (0.03 ms at 3.35 TB/s).

What the design does about it (``csrc/pathwise.cu``): nothing but the
arithmetic reaches the card's memory. One thread per query keeps the
query in registers and R <= 8 sums; the block stages 64 features (then
64 training points, scaled by 1/ls) at a time in shared memory and every
thread reads them as broadcasts, so the kernel reads its inputs from L2
once a block and writes each output once. It is simple and right first:
the dots and distances run on the FP32 pipes, with full-precision
``cosf`` and ``expf``; the tensor cores (3xTF32, as K4 does) are later
work.

Numerics, shared by the kernel and the plain version so that both
compute one function: the cosine is exact to a few ulps (the Matern-1/2
frequencies have a Cauchy tail, arguments of 1e3-1e5 occur); the
distance is formed from differences of the scaled coordinates, summed
in dimension order, never as norms minus a dot. A float32 argument near
1e5 is off by up to ~1e-2 rad, so the kernel sums the argument of a
feature that may pass 256 for some query of its block in float64 and
reduces it by 2 pi there (the float64 plain version is exact; the
float32 one keeps the float32 argument, as the JAX package's float32
program does).

On a CUDA float32 tensor :func:`pathwise_values` launches the kernel
(and raises if it cannot); on a CPU tensor it runs
:func:`pathwise_values_plain`. The callers route float64 to the plain
version (``models.pathwise._values_for``), as K1's callers do.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import matern_from_d2

__all__ = ["pathwise_values", "pathwise_values_plain", "k5_operations"]

_NU_CODE = {0.5: 0, 1.5: 1, 2.5: 2, float("inf"): 3}
_MAX_R = 8  # columns a launch; more are launched in groups
_MAX_D = 256  # input dimensions the kernel takes


def k5_operations(B: int, m: int, n_features: int, n_points: int, d: int, r: int = 1) -> float:
    """Float32 operations of one call, the count that defines K5's bound:
    ``B m (n_features (2d + 2 + 2r) + n_points (2d + 6 + 2r))`` for ``r``
    columns and the ``n_points`` the mask keeps (0 without the cross
    term)."""
    return float(B) * m * (n_features * (2 * d + 2 + 2 * r) + n_points * (2 * d + 6 + 2 * r))


def pathwise_values_plain(nu, Xq, omega, phase, W, coef, X=None, inv_ls=None, V=None, amp=None):
    """Plain PyTorch version of K5: (B, m, R) in the dtype of the inputs.

    ``Xq`` (m, d) or (B, m, d); ``omega`` (B, M, d); ``phase`` (B, M);
    ``W`` (B, M, R); ``coef`` (B,); and for the cross term ``X`` (n, d)
    or (B, n, d), ``inv_ls`` (B, d), ``V`` (B, n, R) with the mask folded
    in, ``amp`` (B,). The feature dot and the two reductions are matmuls;
    the squared distance is summed from differences one dimension at a
    time, as in the kernel (so it holds a few (B, m, n) tensors, never
    (B, m, n, d))."""
    feats = torch.cos(Xq @ omega.transpose(-1, -2) + phase[:, None, :])
    out = coef[:, None, None] * (feats @ W)
    if X is None:
        return out
    del feats
    Qs = Xq * inv_ls[:, None, :]
    Xs = X * inv_ls[:, None, :]
    d2 = None
    for k in range(Xq.shape[-1]):
        diff = Qs[..., :, k, None] - Xs[..., None, :, k]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    del diff
    return out + amp[:, None, None] * (matern_from_d2(d2, nu) @ V)


def pathwise_values(nu, Xq, omega, phase, W, coef, X=None, inv_ls=None, V=None, amp=None):
    """K5: :func:`pathwise_values_plain`'s function, (B, m, R) float32.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (and raises if it cannot), once for every 8 columns of ``W``.
    ``pathwise_values.launches`` counts the launches."""
    if not Xq.is_cuda:
        return pathwise_values_plain(nu, Xq, omega, phase, W, coef, X, inv_ls, V, amp)
    R = W.shape[-1]
    if R <= _MAX_R:
        return _launch(nu, Xq, omega, phase, W, coef, X, inv_ls, V, amp)
    parts = []
    for lo in range(0, R, _MAX_R):
        cols = slice(lo, min(R, lo + _MAX_R))
        parts.append(_launch(nu, Xq, omega, phase, W[..., cols], coef, X, inv_ls,
                             None if V is None else V[..., cols], amp))
    return torch.cat(parts, dim=-1)


pathwise_values.launches = 0


def _launch(nu, Xq, omega, phase, W, coef, X, inv_ls, V, amp):
    """Check the arguments, then launch ``bask_pathwise_values_f32`` of
    ``csrc/pathwise.cu`` on the current stream: one device operation
    besides any copy that makes an input contiguous."""
    from ._cuda import check, library

    if nu not in _NU_CODE:
        raise ValueError(f"K5 takes nu in {sorted(_NU_CODE)}, got {nu}")
    B, M, d = omega.shape
    m, R = Xq.shape[-2], W.shape[-1]
    cross = X is not None
    named = {"Xq": Xq, "omega": omega, "phase": phase, "W": W, "coef": coef}
    if cross:
        named.update(X=X, inv_ls=inv_ls, V=V, amp=amp)
    for name, t in named.items():
        if t is None:
            raise ValueError(f"the cross term needs {name}")
        if t.dtype != torch.float32:
            raise TypeError(f"K5 takes float32 tensors, got {name} {t.dtype}")
        if t.device != Xq.device:
            raise ValueError(f"{name} is on {t.device}, Xq on {Xq.device}: one CUDA device")
    if not 1 <= d <= _MAX_D or not 1 <= B <= 65535 or not 1 <= R <= _MAX_R:
        raise ValueError(f"K5 takes 1 <= d <= {_MAX_D}, 1 <= B <= 65535 and 1 <= R <= "
                         f"{_MAX_R}, got d={d}, B={B}, R={R}")

    def shaped(name, t, shape, shared_ok=False):
        if tuple(t.shape) != shape and not (shared_ok and tuple(t.shape) == shape[1:]):
            raise ValueError(f"{name} must be {shape}{' or ' + str(shape[1:]) if shared_ok else ''}"
                             f", got {tuple(t.shape)}")
        return t.contiguous()

    Xq = shaped("Xq", Xq, (B, m, d), shared_ok=True)
    omega = shaped("omega", omega, (B, M, d))
    phase = shaped("phase", phase, (B, M))
    W = shaped("W", W, (B, M, R))
    coef = shaped("coef", coef, (B,))
    n = 0
    if cross:
        n = X.shape[-2]
        X = shaped("X", X, (B, n, d), shared_ok=True)
        inv_ls = shaped("inv_ls", inv_ls, (B, d))
        V = shaped("V", V, (B, n, R))
        amp = shaped("amp", amp, (B,))
    out = torch.empty((B, m, R), dtype=torch.float32, device=Xq.device)
    if m == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(Xq.device).cuda_stream
    err = library().bask_pathwise_values_f32(
        Xq.data_ptr(), ctypes.c_longlong(m * d if Xq.ndim == 3 else 0),
        omega.data_ptr(), phase.data_ptr(), W.data_ptr(), coef.data_ptr(),
        ptr(X), ctypes.c_longlong(n * d if cross and X.ndim == 3 else 0),
        ptr(inv_ls), ptr(V), ptr(amp), out.data_ptr(),
        B, m, M, n, d, R, _NU_CODE[nu], stream,
    )
    check(err, "bask_pathwise_values_f32")
    pathwise_values.launches += 1
    return out
