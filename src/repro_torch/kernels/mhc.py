"""Kernel G: one site of the manifold-constrained hyper-connection (mHC)
residual of ``models/hyper.py``, in two launches.

Per token, with the stream ``x [n, C]`` (``n`` rows of the residual), the
site's projection ``phi [n C, 2n + n^2]``, group scales ``alpha [3]``,
bias ``b [2n + n^2]`` and norm scale ``w [n C]``, all float32::

    h     = alpha (.) (RMSNorm_{nC}(vec x) phi) + b      (alpha: one a group)
    H_pre = sigmoid(h[:n]),  H_post = 2 sigmoid(h[n:2n])
    H_res = Sinkhorn(exp(clamp(h[2n:], lo, hi)))        (n x n, float32)
    u     = H_pre x                                       (:meth:`Mhc.pre`)
    x'    = H_res x + H_post^T y                          (:meth:`Mhc.post`)

``Sinkhorn``: :data:`SINKHORN_ITERS` alternations of ``M <- M /
(M.sum(rows) + eps)`` then ``M <- M / (M.sum(columns) + eps)``, ``eps``
:data:`SINKHORN_EPS`; ``(lo, hi)`` is :data:`RES_CLAMP`.  These three are
Xing4.0's published ``hc_sinkhorn_iters``, ``hc_eps`` and
``mhc_h_res_clamp_*``, and constants of ``csrc/mhc.cu`` as well (the one
model with mHC; a second with other values makes them settings).  The
norm, the coefficients and the Sinkhorn in float32; ``u`` and ``x'`` in
the stream's dtype.

Two routes: the plain PyTorch forms (:func:`mhc_pre_plain`,
:func:`mhc_post_plain`) run on a CPU (or ``meta``) tensor, training's
included.  A CUDA call launches ``csrc/mhc.cu`` (``mhc_pre_kernel``,
``mhc_post_kernel``) through the lean launch path
(:mod:`repro_torch.kernels.lib`) or raises: the kernels take ``n`` 4 and
``C`` a multiple of 16 bytes of the stream's type (float32 or bfloat16),
and have no backward, so a CUDA call that autograd would record raises
``NotImplementedError`` rather than run the plain forms under G's name.
:data:`mhc` counts the launches (``launches``, both kernels) and the
sites by route (``calls_by_route``, one a :meth:`Mhc.pre` call).

At a decode's few rows :func:`pre_plan` spreads the projection's columns
over several CTAs a row block, whose partial sums the block's last CTA
adds up (an atomic counter a row block in :meth:`Mhc.counters`, left at
zero by every launch; allocated before any graph capture).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import lib

F32 = torch.float32
_PRE = lib.MHC_PRE_ARGS.pack
_POST = lib.MHC_POST_ARGS.pack
_DTYPES = (torch.float32, torch.bfloat16)
N = 4  # the kernels' stream rows
TILE = 256  # rows of phi a shared-memory tile (csrc/mhc.cu kTile)
WARPS = 8
SMS = 132  # an H100's multiprocessors: a decode's slices fill about two CTAs an SM
MAX_SPLITS = 16
WIDE_ROWS = 8192  # from here a CTA takes 32 rows (4 a warp), one slice
COUNTERS = 4096  # row blocks a sliced launch may have
SINKHORN_ITERS = 20  # csrc/mhc.cu kIters
SINKHORN_EPS = 1e-6  # kEps
RES_CLAMP = (-30.0, 30.0)  # kClampLo, kClampHi: h_res before its exp


# ---------------------------------------------------------------------------
# the plain forms: what the CPU runs, and what G is held to
# ---------------------------------------------------------------------------
def sinkhorn(m: torch.Tensor) -> torch.Tensor:
    """:data:`SINKHORN_ITERS` alternations of row then column
    normalisation of the ``[..., n, n]`` matrices ``m``."""
    for _ in range(SINKHORN_ITERS):
        m = m / (m.sum(-1, keepdim=True) + SINKHORN_EPS)
        m = m / (m.sum(-2, keepdim=True) + SINKHORN_EPS)
    return m


def coefficients(x, phi, alpha, bias, norm, *, norm_eps):
    """``(H_pre [T, n], H_post [T, n], H_res [T, n, n])`` in float32 for
    ``x [T, n, C]``."""
    t, n, c = x.shape
    xf = x.reshape(t, n * c).float()
    xh = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + norm_eps) * norm
    scales = torch.cat([alpha[0].expand(n), alpha[1].expand(n), alpha[2].expand(n * n)])
    h = (xh @ phi) * scales + bias
    h_pre = torch.sigmoid(h[:, :n])
    h_post = 2.0 * torch.sigmoid(h[:, n : 2 * n])
    m = torch.exp(h[:, 2 * n :].clamp(*RES_CLAMP)).reshape(t, n, n)
    return h_pre, h_post, sinkhorn(m)


def mhc_pre_plain(x, phi, alpha, bias, norm, *, norm_eps):
    """``(u [T, C] in x's dtype, H_post [T, n], H_res [T, n, n])``."""
    h_pre, h_post, h_res = coefficients(x, phi, alpha, bias, norm, norm_eps=norm_eps)
    u = (h_pre[..., None] * x.float()).sum(-2)
    return u.to(x.dtype), h_post, h_res


def mhc_post_plain(x, y, h_post, h_res):
    """``x' [T, n, C] = H_res x + H_post^T y`` in x's dtype."""
    out = torch.einsum("tij,tjc->tic", h_res, x.float())
    return (out + h_post[..., None] * y.float()[:, None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------
def pre_plan(t: int, k: int) -> tuple[int, int, int]:
    """``(rows a warp, slices, tiles a slice)`` of a ``mhc_pre_kernel``
    launch over ``t`` rows of ``k = n C`` columns: 4 rows a warp and one
    slice from :data:`WIDE_ROWS` rows; else a row a warp and the columns
    cut into as many slices of whole tiles as bring the CTAs to about
    two an SM (at most :data:`MAX_SPLITS`)."""
    tiles = -(-k // TILE)
    if t >= WIDE_ROWS:
        return 4, 1, tiles
    blocks = -(-t // WARPS)
    want = min(tiles, MAX_SPLITS, max(1, -(-2 * SMS // blocks)))
    per = -(-tiles // want)
    return 1, -(-tiles // per), per


def _check(x, n_coef: int, *tensors) -> tuple[int, int, int]:
    if x.dim() != 3:
        raise ValueError(f"mhc wants the stream [T, n, C]; got {tuple(x.shape)}")
    t, n, c = x.shape
    if n_coef != 2 * n + n * n:
        raise ValueError(f"mhc: {n_coef} coefficients for {n} streams")
    if x.dtype not in _DTYPES or any(v.dtype is not F32 for v in tensors):
        raise TypeError(
            f"mhc wants a float32 or bfloat16 stream and float32 coefficients; got "
            f"{x.dtype} and {[v.dtype for v in tensors]}"
        )
    return t, n, c


def _kernel_ok(name: str, x, n: int, c: int, vectors, scalars) -> None:
    """Raise unless the kernel takes these: ``vectors`` read in 16-byte
    vectors, ``scalars`` (a group's slice of stacked leaves) element by
    element."""
    if n != N or (c * x.element_size()) % 16:
        raise ValueError(
            f"mhc {name}: the kernel takes {N} streams and C a multiple of 16 bytes; "
            f"got n {n}, C {c} in {x.dtype}"
        )
    if not all(v.is_contiguous() and v.data_ptr() % 16 == 0 for v in vectors):
        raise ValueError(f"mhc {name}: the operands it reads in vectors must be 16-byte aligned")
    if not all(v.is_contiguous() for v in vectors + scalars):
        raise ValueError(f"mhc {name} operands must be contiguous")


def _refuse_autograd(name: str, *tensors) -> None:
    """Raise where autograd would record a call on the card: G has no
    backward, and the plain forms there would run ~50 library kernels a
    site under G's name."""
    if torch.is_grad_enabled() and any(v.requires_grad for v in tensors):
        raise NotImplementedError(
            f"mhc {name}: kernel G has no backward; a card's mHC site runs where no "
            "gradient is recorded (prefill and decode), training on the CPU"
        )


def pre_launch_args(
    x_ptr, phi_ptr, alpha_ptr, bias_ptr, norm_ptr, u_ptr, post_ptr, res_ptr,
    partial_ptr, counters_ptr, stream, index, t, c, n, plan, norm_eps,
) -> bytes:  # fmt: skip
    """The packed ``MhcPreArgs`` of ``csrc/mhc.cu`` for one launch on the
    raw ``stream`` of device ``index`` (field order as in the C struct;
    the format is :data:`lib.MHC_PRE_ARGS`); ``plan`` is
    :func:`pre_plan`'s, a null pointer 0."""
    return _PRE(
        x_ptr, phi_ptr, alpha_ptr, bias_ptr, norm_ptr, u_ptr, post_ptr, res_ptr,
        partial_ptr, counters_ptr, stream, index, t, c, n, *plan, norm_eps,
    )  # fmt: skip


def post_launch_args(x_ptr, y_ptr, post_ptr, res_ptr, out_ptr, stream, index, t, c, n):
    """The packed ``MhcPostArgs`` of ``csrc/mhc.cu`` (the format is
    :data:`lib.MHC_POST_ARGS`)."""
    return _POST(x_ptr, y_ptr, post_ptr, res_ptr, out_ptr, stream, index, t, c, n)


class Mhc:
    """Kernel G's two launches and their counts."""

    def __init__(self):
        self.__name__ = "mhc"
        self.launches = 0  # mhc_pre_kernel and mhc_post_kernel launches
        self.calls_by_route = {"kernel": 0, "plain": 0}  # sites: one a pre
        self._counters: dict[int, torch.Tensor] = {}  # by device index

    def counters(self, index: int, blocks: int) -> torch.Tensor:
        """Device ``index``'s row-block counters (zeros), made once outside
        any graph capture."""
        if blocks > COUNTERS:
            raise ValueError(f"mhc: {blocks} sliced row blocks; at most {COUNTERS}")
        buf = self._counters.get(index)
        if buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("mhc: the counters must exist before a graph capture")
            buf = torch.zeros(COUNTERS, dtype=torch.int32, device=f"cuda:{index}")
            self._counters[index] = buf
        return buf

    def pre(self, x, phi, alpha, bias, norm, *, norm_eps):
        """``(u [T, C] in x's dtype, H_post [T, n], H_res [T, n, n])`` for
        the stream ``x [T, n, C]`` (the module docstring)."""
        t, n, c = _check(x, phi.shape[-1], phi, alpha, bias, norm)
        cols = 2 * n + n * n
        shapes = [tuple(v.shape) for v in (phi, alpha, bias, norm)]
        if shapes != [(n * c, cols), (3,), (cols,), (n * c,)]:
            raise ValueError(f"mhc pre: parameters {shapes} for the stream {tuple(x.shape)}")
        index = lib.device_index("mhc", x, phi, alpha, bias, norm)
        if index < 0:
            self.calls_by_route["plain"] += 1
            return mhc_pre_plain(x, phi, alpha, bias, norm, norm_eps=norm_eps)
        _refuse_autograd("pre", x, phi, alpha, bias, norm)
        _kernel_ok("pre", x, n, c, (x, phi), (alpha, bias, norm))
        u = torch.empty((t, c), dtype=x.dtype, device=x.device)
        h_post = torch.empty((t, n), dtype=F32, device=x.device)
        h_res = torch.empty((t, n, n), dtype=F32, device=x.device)
        self.calls_by_route["kernel"] += 1
        if t == 0:
            return u, h_post, h_res
        plan = pre_plan(t, n * c)
        rw, splits, _ = plan
        partial = counters = None
        if splits > 1:
            counters = self.counters(index, -(-t // (WARPS * rw)))
            partial = torch.empty((splits, t, cols + 1), dtype=F32, device=x.device)
        if lib.raw_stream is None:
            lib.load()
        args = pre_launch_args(
            x.data_ptr(), phi.data_ptr(), alpha.data_ptr(), bias.data_ptr(),
            norm.data_ptr(), u.data_ptr(), h_post.data_ptr(), h_res.data_ptr(),
            0 if partial is None else partial.data_ptr(),
            0 if counters is None else counters.data_ptr(), lib.raw_stream(index),
            index, t, c, n, plan, norm_eps,
        )  # fmt: skip
        rc = (lib.mhc_pre_f32 if x.dtype is F32 else lib.mhc_pre_bf16)(args)
        if rc:
            lib.check(rc, "mhc_pre")
        self.launches += 1
        return u, h_post, h_res

    def post(self, x, y, h_post, h_res):
        """``x' [T, n, C] = H_res x + H_post^T y`` (``y [T, C]``) in x's
        dtype."""
        t, n, c = _check(x, 2 * h_post.shape[-1] + h_res.shape[-1] ** 2, h_post, h_res)
        index = lib.device_index("mhc", x, y, h_post, h_res)
        if index < 0:
            return mhc_post_plain(x, y, h_post, h_res)
        _refuse_autograd("post", x, y, h_post, h_res)
        if y.dtype is not x.dtype or tuple(y.shape) != (t, c):
            raise ValueError(f"mhc post wants y [T, C] in {x.dtype}; got {tuple(y.shape)}")
        _kernel_ok("post", x, n, c, (x, y), (h_post, h_res))
        out = torch.empty_like(x)
        if t == 0:
            return out
        if lib.raw_stream is None:
            lib.load()
        args = post_launch_args(
            x.data_ptr(), y.data_ptr(), h_post.data_ptr(), h_res.data_ptr(),
            out.data_ptr(), lib.raw_stream(index), index, t, c, n,
        )  # fmt: skip
        rc = (lib.mhc_post_f32 if x.dtype is F32 else lib.mhc_post_bf16)(args)
        if rc:
            lib.check(rc, "mhc_post")
        self.launches += 1
        return out


mhc = Mhc()


__all__ = [
    "RES_CLAMP",
    "SINKHORN_EPS",
    "SINKHORN_ITERS",
    "Mhc",
    "coefficients",
    "mhc",
    "mhc_post_plain",
    "mhc_pre_plain",
    "post_launch_args",
    "pre_launch_args",
    "pre_plan",
    "sinkhorn",
]
