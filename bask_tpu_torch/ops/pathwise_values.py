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

What bounds it on an H100: arithmetic. The count that defines PR 10's
bound (:func:`k5_operations`), at one column: per (query, feature) pair
``2d + 4`` float32 operations (the d-long dot, 2d; the phase; the cosine
counted as one; the multiply-add into the sum, 2), per (query, training
point) pair ``2d + 8`` (the scaled difference and its square per
dimension, 2d; the root, the exponential and the polynomial, 6; the
multiply-add, 2); each further column adds 2 to both. Only the training
points the mask keeps count. At the batch ask (256 rows, 65,536
queries, 1,024 features, n = 1,000 of 1,024 points, d = 15) that is
1.22e12 operations (1.24e12 with the padded points), 18.2 ms at the
card's 67 TFLOP/s outside the tensor cores, against ~0.1 GB of inputs
and output (0.03 ms at 3.35 TB/s). The 2d of each pair are depth-d
products, which the tensor cores can do: :func:`k5_operations_split`
splits the same count into 1.02e12 of them (2.06 ms at 495 TFLOP/s TF32)
and 2.03e11 others (3.03 ms at 67 TFLOP/s), a least time of 3.03 ms
(:func:`k5_bound_ms`). Above that bound lies the design's practical
floor: 5.07e10 transcendental results (a cosine, or a root and an
exponential) at 16 a clock per SM on the MUFU, ~12 ms at 1.98 GHz.

What the design does about it (``csrc/pathwise.cu``): nothing but the
arithmetic reaches the card's memory, and the depth-d products run on
the tensor cores. For d <= 31 a block of 8 warps owns 256 queries of one
row (128 at d > 15), kept as split TF32 fragments in registers; features
and training points stream through double-buffered shared memory in
stages of 64; each product is 3xTF32 (``mma.sync.m16n8k8``, as K4), the
cosine and the Matern run on the accumulator fragments in registers, and
each thread's rows collect their sums by one FMA per element and column.
For d >= 32 PR 10's design stays: one thread per query on the FP32
pipes.

Numerics, shared by both kernels and the plain version so that all
compute one function: the cosine is within a few 1e-7 absolute (the
Matern-1/2 frequencies have a Cauchy tail, arguments of 1e3-1e5 occur);
every sum runs in a fixed order. The tensor-core kernel centres the
points on the unit box's midpoint (1/2 in every dimension, a centre no
input can change: a NaN query gives NaN at that query only), takes the
cosine's argument in revolutions from the centred dot plus the phase
reduced in float64 (so subtracting the nearest integer reduces it exactly) and the
distance as |q~|^2 + |x~|^2 - 2 <q~, x~> of the centred, scaled points,
formed again from differences for a near pair (d2 under 1/64 of the
norms, where the Matern-1/2 root would magnify the rounding); 3xTF32
carries each operand to ~2^-21 (``tests/test_torch_pathwise_values.py``
emulates the arithmetic). The FP32 kernel forms the distance from
differences. Both take the argument of a feature that may pass 256 rad
for some query of its block in float64 and reduce it by 2 pi there (the
float64 plain version is exact; the float32 one keeps the float32
argument, as the JAX package's float32 program does).

On a CUDA float32 tensor :func:`pathwise_values` launches the kernel
(and raises if it cannot); on a CPU tensor it runs
:func:`pathwise_values_plain`. The callers route float64 to the plain
version (``models.pathwise._values_for``), as K1's callers do.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import matern_from_d2

__all__ = ["pathwise_values", "pathwise_values_plain", "k5_operations", "k5_operations_split",
           "k5_bound_ms"]

_NU_CODE = {0.5: 0, 1.5: 1, 2.5: 2, float("inf"): 3}
_MAX_R = 8  # columns a launch; more are launched in groups
_MAX_D = 256  # input dimensions the kernel takes


def k5_operations(B: int, m: int, n_features: int, n_points: int, d: int, r: int = 1) -> float:
    """Float32 operations of one call, the count that defines K5's bound:
    ``B m (n_features (2d + 2 + 2r) + n_points (2d + 6 + 2r))`` for ``r``
    columns and the ``n_points`` the mask keeps (0 without the cross
    term)."""
    return float(B) * m * (n_features * (2 * d + 2 + 2 * r) + n_points * (2 * d + 6 + 2 * r))


def k5_operations_split(B: int, m: int, n_features: int, n_points: int, d: int,
                        r: int = 1) -> tuple:
    """:func:`k5_operations` split by the unit that can do the work:
    ``(depth-d products, everything else)``, the products ``2d`` per pair
    (tensor cores), the rest on the FP32 pipes; they sum to
    :func:`k5_operations`."""
    products = float(B) * m * (n_features + n_points) * 2 * d
    return products, k5_operations(B, m, n_features, n_points, d, r) - products


# published dense peaks of one H100 SXM at 700 W (NVIDIA's datasheet)
_TF32_FLOPS, _F32_FLOPS, _HBM_BYTES_PER_S = 495e12, 67e12, 3.35e12


def k5_bound_ms(B: int, m: int, n_features: int, n_points: int, d: int, r: int,
                n_bytes: float) -> tuple:
    """(the least milliseconds of one call, what bounds it): the larger
    of ``n_bytes`` over the HBM rate, the depth-d products over the TF32
    tensor-core rate and the other operations over the FP32 rate (the
    units run at once)."""
    products, other = k5_operations_split(B, m, n_features, n_points, d, r)
    t_bytes = n_bytes / _HBM_BYTES_PER_S
    t_ops = max(products / _TF32_FLOPS, other / _F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def _plan(d: int, r: int, nu: float) -> dict:
    """K5's launch plan on the current card for ``d``, ``r`` columns and
    ``nu``: the kernel, dynamic shared memory per block, queries per
    block, resident blocks per SM."""
    from ._cuda import check, library

    info = (ctypes.c_int * 4)()
    check(library().bask_pathwise_values_info(d, min(r, _MAX_R), _NU_CODE[nu], info),
          "bask_pathwise_values_info")
    return {"kernel": "pathwise_mma_kernel" if info[0] else "pathwise_values_kernel",
            "smem_bytes": info[1], "queries_per_block": info[2], "blocks_per_sm": info[3]}


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
