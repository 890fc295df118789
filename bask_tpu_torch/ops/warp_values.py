"""The Beta-CDF input warp (kernel K6) and its inverse (kernel K7), with
their plain versions.

K6 computes ``models.warping.warp``'s function, the regularized
incomplete beta function of the clamped inputs column by column,

    out[b, i, j] = I_x(exp(log_alphas[b, j]), exp(log_betas[b, j])),
    x = clamp(X[b, i, j], 0, 1),

for X shared (n, d) or one per row (B, n, d) and log-parameters (d,) or
(B, d); with ``with_pdf`` the same pass also writes the Beta pdf at the
clamped x, the derivative JAX's ``betainc`` has in x. K7 computes
``models.warping.unwarp``'s function, the Beta PPF: a bisection over the
type's ordered bit patterns of [0, 1], :func:`full_steps` steps (30 at
float32, 62 at float64) to two adjacent representable x, of which it
returns the one whose CDF lies nearer z. So x is as exact as its type
wherever the CDF is steep: a bisection that halves the bracket's width
stops at its last width, and at a = 0.03 sixty such steps leave every z
below 0.3 at about 2^-61. Their plain versions, here beside them, are
:func:`warp_plain` (:func:`betainc` of the clamped inputs),
:func:`beta_pdf_plain` and :func:`unwarp_plain`, the same bisection op
by op. K7's CDF is not the plain one bit for bit, and where rounding
makes a CDF non-monotone the two may part by a step, so K7 is held to the
float64 root within a limit (``chip_smoke.py`` phase 15,
``tests/test_torch_cuda.py``).

The route, in one place: :func:`warp_values` and :func:`unwarp_values`
run the plain versions on a CPU tensor and launch their kernel once on a
CUDA tensor of float32 or float64 (and raise if they cannot; nothing
falls back), with no device operation besides a copy that makes an input
contiguous. ``warp_values.launches`` and ``unwarp_values.launches`` count
the launches. On the card a gradient of the warp in x goes through
:class:`_Warp` (the incoming gradient times the pdf K6 writes beside the
warp); JAX's ``betainc`` has no derivative in a and b, and neither has
the card's warp: a gradient in the log-parameters raises there (no path
of the port asks for one: the Laplace init holds the warp fixed, the
polish and the prediction gradients differentiate in x, the row-mode
gradients in the kernel theta). On a CPU tensor autograd differentiates
the plain version.

What they replace: XLA's fusion of ``jax.scipy.special.betainc`` inside
the JAX package's jitted log-probability (``bask_tpu/models/warping.py``
lines 33-37) and its ``fori_loop`` bisection (lines 63-79), one device
program each; there is no Pallas kernel. Run op by op, the plain version
makes a ``(48, *x.shape)`` coefficient tensor per call and launches once
per continued-fraction term, and its unwarp runs that once a step.

What bounds them on an H100: operations. The counts that define their
bounds are what the function needs (a division, a log or an exp counted
as one), kept in ``scripts/kernel_costs.py``. ``CDF_OPERATIONS`` per Beta
CDF: the 48 continued-fraction coefficients depend on the column's (a, b)
and the side of the flip only, so with them made once per column a term
is 3 operations (the
coefficient times x, the division, the add), and 16 around them (the
flip, 1 - x, the front's logs, products, sums and exp, the division by
the fraction, the flip back). K6's count adds the clamp (2)
and, with the pdf, 5 more per entry (from the CDF's logs: two products,
two sums, the exp). K7's counts the bisection: each step
a CDF and 3 (the midpoint, the comparison, the update).

What the kernels do about it (``csrc/warp.cu``): each block makes its row's
coefficients once, for its group of at most 32 columns and both sides of
the flip, in shared memory; a term then costs an entry a multiply and an
FMA on the pair (P, Q) whose ratio is the fraction's tail, and no
division (one at the end); a thread carries several entries of its
column through the fraction at once (K6 4, K7 2, or 1 on a grid too small
to fill the card), one shared load of a term's pair serving them all.
K7 runs one thread per entry, 30 CDFs an entry at float32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.graphs import counted

__all__ = ["warp_values", "unwarp_values", "betainc", "warp_plain", "beta_pdf_plain",
           "unwarp_plain", "full_steps"]

CF_TERMS = 48  # terms of the continued fraction
# the bit pattern of 1.0, read as an integer of the same width, by type:
# the unwarp's bisection runs over the integers [0, that]
_ONE_BITS = {torch.float32: (0x3F800000, torch.int32),
             torch.float64: (0x3FF0000000000000, torch.int64)}


def full_steps(dtype) -> int:
    """The unwarp's bisection steps that leave two adjacent representable
    x of ``dtype`` (float32 or float64) in the bracket: the bit length of
    1.0's pattern, 30 and 62."""
    return _ONE_BITS[dtype][0].bit_length()


# -- the plain versions --


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def betainc(a, b, x, terms: int = CF_TERMS):
    """Regularized incomplete beta function I_x(a, b), elementwise over
    the broadcast shape of ``a``, ``b`` and ``x`` (x in [0, 1]), by
    ``terms`` terms of the continued fraction (``models.warping``
    documents it)."""
    flip = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(flip, b, a)
    bb = torch.where(flip, a, b)
    xx = torch.where(flip, 1.0 - x, x)
    log_front = (
        aa * torch.log(xx) + bb * torch.log1p(-xx) - _betaln(aa, bb) - torch.log(aa)
    )
    # coefficients d_k, k = 1..terms, term index leading so that each
    # step of the backward sum reads a contiguous slice:
    #   d_{2m+1} = -(a+m)(a+b+m) x / ((a+2m)(a+2m+1))
    #   d_{2m}   =  m(b-m) x / ((a+2m-1)(a+2m))
    k = torch.arange(1, terms + 1, dtype=xx.dtype, device=xx.device)
    k = k.view((-1,) + (1,) * xx.ndim)
    m = torch.floor(k / 2.0)
    num = torch.where(
        torch.remainder(k, 2.0) == 1.0, -(aa + m) * (aa + bb + m), m * (bb - m)
    )
    d = num * xx / ((aa + k - 1.0) * (aa + k))
    # 1 / (1 + d_1 / (1 + d_2 / (1 + ...))), summed from the tail
    one = torch.ones((), dtype=xx.dtype, device=xx.device)
    u = torch.ones_like(xx)
    for i in range(terms - 1, -1, -1):
        u = torch.addcdiv(one, d[i], u)
    front = torch.exp(log_front) / u
    return torch.where(flip, 1.0 - front, front)


def ab(log_alphas, log_betas):
    """(a, b) with a row axis inserted before the last: (..., 1, d)."""
    return torch.exp(log_alphas).unsqueeze(-2), torch.exp(log_betas).unsqueeze(-2)


def warp_plain(X, log_alphas, log_betas):
    """K6's plain version: :func:`betainc` of the clamped inputs."""
    a, b = ab(log_alphas, log_betas)
    return betainc(a, b, torch.clamp(X, 0.0, 1.0))


def beta_pdf_plain(X, log_alphas, log_betas):
    """The Beta pdf at the clamped inputs as JAX's ``betainc`` derivative
    in x forms it, ``exp((b - 1) log1p(-x) + (a - 1) log x - betaln(a,
    b))``: what K6 writes beside the warp for the backward (no 1e-12 clip,
    unlike ``warping.warp_grad``)."""
    a, b = ab(log_alphas, log_betas)
    x = torch.clamp(X, 0.0, 1.0)
    return torch.exp((b - 1.0) * torch.log1p(-x) + (a - 1.0) * torch.log(x) - _betaln(a, b))


def unwarp_plain(Z, log_alphas, log_betas, steps=None, terms: int = CF_TERMS):
    """K7's plain version, of the broadcast shape of Z (float32 or
    float64) and the log-parameters: ``steps`` (default
    :func:`full_steps`) bisection steps over the bit patterns of [0, 1]
    (CDFs of ``terms`` terms), then the end of the bracket whose CDF lies
    nearer z; a NaN z stays NaN."""
    a, b = ab(log_alphas, log_betas)
    Z = torch.clamp(Z, 0.0, 1.0)
    Z = Z.expand(torch.broadcast_shapes(Z.shape, a.shape))
    one, itype = _ONE_BITS[Z.dtype]
    lo = torch.zeros(Z.shape, dtype=itype, device=Z.device)
    hi = torch.full_like(lo, one)
    cdf_lo, cdf_hi = torch.zeros_like(Z), torch.ones_like(Z)
    for _ in range(full_steps(Z.dtype) if steps is None else steps):
        mid = lo + (hi - lo) // 2
        cdf = betainc(a, b, mid.view(Z.dtype), terms)
        below = cdf < Z
        lo, cdf_lo = torch.where(below, mid, lo), torch.where(below, cdf, cdf_lo)
        hi, cdf_hi = torch.where(below, hi, mid), torch.where(below, cdf_hi, cdf)
    x = torch.where(Z - cdf_lo <= cdf_hi - Z, lo, hi).view(Z.dtype)
    return torch.where(torch.isnan(Z), Z, x)


# -- the kernels --


def _layout(X, log_alphas, log_betas):
    """The kernels' view of the arguments: (X as (n, d) or (B, n, d),
    X's batch stride, log_alphas and log_betas as (B, d) or (1, d) with
    their row strides, B, n, d, the output's shape). The output's shape is
    the plain version's broadcast of X (..., n, d) against (..., 1, d)."""
    d = X.shape[-1]
    for name, t in (("X", X), ("log_alphas", log_alphas), ("log_betas", log_betas)):
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != X.dtype:
            raise TypeError(f"K6/K7 take float32 or float64, all one type: X {X.dtype}, "
                            f"{name} {t.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}: one CUDA device")
        if t.ndim < 1 or t.shape[-1] != d:
            raise ValueError(f"{name} must end in d = {d}, got {tuple(t.shape)}")
    lead = torch.broadcast_shapes(log_alphas.shape[:-1], log_betas.shape[:-1])
    out_shape = torch.broadcast_shapes(X.shape, lead + (1, d))
    if not lead:  # one (a, b) per column for every entry
        B, n = 1, math.prod(out_shape[:-1])
        Xk, x_stride = X.reshape(n, d), 0
        la, lb = log_alphas.reshape(1, d), log_betas.reshape(1, d)
    else:
        rows, n = out_shape[:-2], out_shape[-2]
        B = math.prod(rows)
        if all(s == 1 for s in X.shape[:-2]):  # shared by every row
            Xk, x_stride = X.reshape(-1, d), 0
        else:
            Xk, x_stride = X.expand(rows + (n, d)).reshape(B, n, d), n * d
        la = log_alphas.expand(rows + (d,)).reshape(B, d)
        lb = log_betas.expand(rows + (d,)).reshape(B, d)
    Xk = Xk.contiguous()
    la = la if la.stride(-1) == 1 else la.contiguous()
    lb = lb if lb.stride(-1) == 1 else lb.contiguous()
    return Xk, x_stride, la, lb, B, n, d, out_shape


class _Warp(torch.autograd.Function):
    """The warp with its derivative in x: ``values(X, log_alphas,
    log_betas, True)`` gives (warp, pdf); the backward is the incoming
    gradient times the pdf where the clamp kept X (0 <= x <= 1, torch's
    convention at the ends) and zero where it cut X, summed over the rows
    that X was broadcast to. That is JAX's derivative of ``betainc`` in x
    (JAX halves it at x exactly 0 or 1 and gives NaN past an end where the
    pdf is infinite). Reverse mode only: no ``torch.func`` transform of the
    port reaches the warp (the row-mode jvp differentiates the kernel theta
    of an unwarped sweep), so forward mode and vmap raise here."""

    @staticmethod
    def forward(X, log_alphas, log_betas, values):
        return values(X, log_alphas, log_betas, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(inputs[0], output[1])

    @staticmethod
    def backward(ctx, grad, _grad_pdf):
        X, pdf = ctx.saved_tensors
        inside = (X >= 0.0) & (X <= 1.0)
        return torch.where(inside, grad * pdf, 0.0).sum_to_size(X.shape), None, None, None


_NO_AB_GRADIENT = (
    "the warp on the card has no derivative in log_alphas or log_betas (neither has JAX's "
    "betainc): detach them, or warp CPU tensors, whose plain version autograd differentiates"
)


@counted
def warp_values(X, log_alphas, log_betas, with_pdf: bool = False):
    """K6: ``warping.warp``'s function, and with ``with_pdf`` also the Beta
    pdf at the clamped x: ``out`` or ``(out, pdf)``, each of the plain
    version's broadcast shape, in X's type (float32 or float64).

    A CPU tensor runs the plain versions (:func:`warp_plain`,
    :func:`beta_pdf_plain`); a CUDA tensor takes :func:`_warp_on_card`.
    ``warp_values.launches`` counts the launches."""
    if not X.is_cuda:
        out = warp_plain(X, log_alphas, log_betas)
        return (out, beta_pdf_plain(X, log_alphas, log_betas)) if with_pdf else out
    return _warp_on_card(X, log_alphas, log_betas, with_pdf)


def _warp_on_card(X, log_alphas, log_betas, with_pdf=False):
    """The card's warp: one K6 launch, through :class:`_Warp` where a
    gradient in X is wanted; a gradient in the log-parameters raises."""
    if torch.is_grad_enabled():
        if log_alphas.requires_grad or log_betas.requires_grad:
            raise RuntimeError(_NO_AB_GRADIENT)
        if X.requires_grad and not with_pdf:
            return _Warp.apply(X, log_alphas, log_betas, _launch_warp)[0]
    return _launch_warp(X, log_alphas, log_betas, with_pdf)


def _launch_warp(X, log_alphas, log_betas, with_pdf=False):
    from ._cuda import check, library

    Xk, x_stride, la, lb, B, n, d, out_shape = _layout(X, log_alphas, log_betas)
    out = torch.empty(out_shape, dtype=X.dtype, device=X.device)
    pdf = torch.empty_like(out) if with_pdf else None
    if out.numel():
        entry = "bask_warp_f32" if X.dtype == torch.float32 else "bask_warp_f64"
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = getattr(library(), entry)(
            Xk.data_ptr(), ctypes.c_longlong(x_stride), la.data_ptr(),
            ctypes.c_longlong(la.stride(0) if B > 1 else 0), lb.data_ptr(),
            ctypes.c_longlong(lb.stride(0) if B > 1 else 0), out.data_ptr(),
            None if pdf is None else pdf.data_ptr(), B, ctypes.c_longlong(n), d, stream,
        )
        check(err, entry)
        warp_values.launches += 1
    return (out, pdf) if with_pdf else out


@counted
def unwarp_values(Z, log_alphas, log_betas, steps=None):
    """K7: ``warping.unwarp``'s function, the Beta PPF, of the plain
    version's broadcast shape, in Z's type (float32 or float64), by
    ``steps`` (default :func:`full_steps`) bisection steps over the bit
    patterns of [0, 1].

    A CPU tensor runs the plain version (:func:`unwarp_plain`); a CUDA
    tensor launches the kernel once (and raises if it cannot): one thread
    per entry, held to the float64 root within a limit, not to the plain
    version bit for bit.
    ``unwarp_values.launches`` counts the launches."""
    steps = full_steps(Z.dtype) if steps is None else int(steps)
    if not Z.is_cuda:
        return unwarp_plain(Z, log_alphas, log_betas, steps)
    return _launch_unwarp(Z, log_alphas, log_betas, steps)


def _launch_unwarp(Z, log_alphas, log_betas, steps):
    from ._cuda import check, library

    Zk, z_stride, la, lb, B, n, d, out_shape = _layout(Z, log_alphas, log_betas)
    out = torch.empty(out_shape, dtype=Z.dtype, device=Z.device)
    if out.numel():
        entry = "bask_unwarp_f32" if Z.dtype == torch.float32 else "bask_unwarp_f64"
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = getattr(library(), entry)(
            Zk.data_ptr(), ctypes.c_longlong(z_stride), la.data_ptr(),
            ctypes.c_longlong(la.stride(0) if B > 1 else 0), lb.data_ptr(),
            ctypes.c_longlong(lb.stride(0) if B > 1 else 0), out.data_ptr(), B,
            ctypes.c_longlong(n), d, steps, stream,
        )
        check(err, entry)
        unwarp_values.launches += 1
    return out
