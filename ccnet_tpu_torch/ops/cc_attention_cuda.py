"""Criss-cross attention through the hand-written CUDA kernels, with its backward.

Counterpart of :mod:`ccnet_tpu.ops.cc_attention_pallas` (``_fwd_impl``,
``_bwd_both_paths`` and the custom VJP around them). The kernels live in
``ccnet_tpu_torch/csrc/cca_fwd.cu``, ``csrc/cca_bwd.cu``,
``csrc/cca_lines.cu`` and ``csrc/cca_lines_tc.cu``; each has a wrapper here
and a plain PyTorch version
beside it:

* K1 :func:`cca_fwd_col` replaces ``_fwd_col_kernel``: the column path with
  the self slot at −1e9, giving the unnormalised aggregate ``o_col`` in v's
  dtype (as the TPU function writes it) and its f32 stats ``m_col, l_col``;
  plain version :func:`cca_fwd_col_plain`.
* K2 :func:`cca_fwd_row` replaces ``_fwd_row_kernel``: the row path fused
  with the joint-softmax combine, giving ``out`` in v's dtype and the joint
  ``(m, L)`` residuals; plain version :func:`cca_fwd_row_plain`.
  K1 and K2 each have three designs (:func:`kernel_design`, from each
  kernel's own line: H for K1, W for K2): bf16 lines of at most
  :data:`LONG_LINE` go to the tensor-core kernel (one block per line, ``p``
  rounded to bf16 in registers between its two products, as the TPU kernels
  round it at the default precision), longer bf16 lines to K7a's
  tensor-core kernel (the same function: K1 on the column view, K2 on the
  rows with the combine fused into its stores), f32 to the CUDA-core kernel
  (f32 arithmetic, online softmax over key tiles).
* K3 :func:`cca_bwd_col` replaces ``_bwd_col_kernel``: the column path's
  dq, dk, dv in the input dtype, recomputed from ``(q, k, m, L)`` and
  ``delta``; plain version :func:`cca_bwd_col_plain`.
* K4 :func:`cca_bwd_row` replaces ``_bwd_row_kernel``: the row path's grads
  plus K3's, in the input dtype; plain version :func:`cca_bwd_row_plain`.
  K3 and K4 each have the same three designs: bf16 lines of at most
  :data:`LONG_LINE` go to the tensor-core kernel (one block per line, no
  scratch), longer bf16 lines to K7b's tensor-core kernels (K3 on the
  column view, K4 on the rows adding K3's grads before its one rounding),
  f32 to the CUDA-core pair (f32 arithmetic, p and de through f32 scratch).
* K7a :func:`cca_line_fwd` replaces ``_legacy_fwd_kernel``: ONE path over
  ``(B, M, N, C)`` lines, optionally self-masked, ``o`` in v's dtype;
  plain version :func:`cca_line_fwd_plain`.
* K7b :func:`cca_line_bwd` replaces ``_legacy_bwd_kernel``: that path's
  backward from the joint stats, with no O(N) scratch per pixel, the grads
  in the input dtype; plain version :func:`cca_line_bwd_plain`.
  K7a and K7b each have two designs (:func:`line_design`): bf16 goes to the
  tensor-core kernels of ``csrc/cca_lines_tc.cu`` (keys tiled, any line
  length; p and de rounded to bf16, outputs in bf16, as the TPU kernels at
  the default precision), f32 to the CUDA-core kernels of
  ``csrc/cca_lines.cu``.

:class:`CrissCrossAttentionFn` is the ``torch.autograd.Function`` around
them (the JAX package's ``_cca_pallas`` custom VJP). Like ``_fwd_impl`` and
``_bwd_both_paths`` it picks one of two routes per call and direction
(:func:`uses_line_route`, the JAX package's own budget arithmetic): K1 → K2
forward and K3 → K4 backward (the 97² sliding tiles and 769² crops), or
the line route (:func:`cca_line_route_fwd`, :func:`cca_line_route_bwd`, the
counterparts of ``_legacy_fwd_impl`` and ``_legacy_bwd_both_paths``): K7a/
K7b once per path, the column path read in place through a transposed
view, the two-path combine and the gradient sum in plain torch.
:func:`criss_cross_attention_cuda` goes through it.

The libraries are built with ``nvcc`` at first use (:mod:`._build`) and
bound with ctypes: every pointer and the stream go as ``c_void_p`` (a bare
Python int would be passed as a 32-bit C int and cut the pointer), every
int as ``c_int``, the line strides as ``c_longlong``. Launches are
asynchronous on the current stream.

Routing is by the tensors' device: CPU tensors take the plain versions and
leave :data:`LAUNCHES` alone; CUDA tensors launch the kernels or raise.
Nothing falls back.

Layout: NHWC contiguous ``(B, H, W, C)``, as the JAX op. The NCHW model
feeds it with ``permute(0, 2, 3, 1).contiguous()`` copies of q, k and v.
"""

from __future__ import annotations

import ctypes

import torch

from ccnet_tpu_torch.ops.cc_attention import NEG_INF

# launches of each kernel made by this process; callers may reset them to 0.
# ``cca_fwd_col_tc`` / ``cca_fwd_row_tc`` and ``cca_bwd_col_tc`` /
# ``cca_bwd_row_tc`` count the K1/K2 and K3/K4 launches that took the
# one-block-per-line tensor-core design, ``cca_line_fwd_tc`` /
# ``cca_line_bwd_tc`` every launch of K7a's / K7b's tensor-core kernels:
# K7a/K7b's own and those of K1–K4 on bf16 lines past :data:`LONG_LINE`
# (each also counts under the wrapper's own name).
LAUNCHES = {"cca_fwd_col": 0, "cca_fwd_row": 0, "cca_fwd_col_tc": 0, "cca_fwd_row_tc": 0,
            "cca_bwd_col": 0, "cca_bwd_row": 0, "cca_bwd_col_tc": 0, "cca_bwd_row_tc": 0,
            "cca_line_fwd": 0, "cca_line_bwd": 0, "cca_line_fwd_tc": 0, "cca_line_bwd_tc": 0}

# The longest line of the tensor-core K1–K4 (one block of 8 warps per line).
LONG_LINE = 128

MAX_CQ = 128  # the kernels stage 48 lines of Cq f32 q/k values in shared memory
MAX_SMEM = 227 * 1024  # dynamic shared memory one block may use on Hopper

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    from ccnet_tpu_torch.ops._build import load_library

    lib = load_library("cca_fwd")
    if not getattr(lib, "_ccnet_bound", False):
        lib.cca_fwd_col.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.cca_fwd_col.restype = ctypes.c_int
        lib.cca_fwd_row.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P]
        lib.cca_fwd_row.restype = ctypes.c_int
        lib.cca_fwd_col_tc.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        lib.cca_fwd_col_tc.restype = ctypes.c_int
        lib.cca_fwd_row_tc.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        lib.cca_fwd_row_tc.restype = ctypes.c_int
        lib._ccnet_bound = True
    return lib


def _bwd_lib():
    from ccnet_tpu_torch.ops._build import load_library

    lib = load_library("cca_bwd")
    if not getattr(lib, "_ccnet_bound", False):
        lib.cca_bwd_col.argtypes = [_P] * 12 + [_I] * 6 + [_P]
        lib.cca_bwd_col.restype = ctypes.c_int
        lib.cca_bwd_row.argtypes = [_P] * 15 + [_I] * 6 + [_P]
        lib.cca_bwd_row.restype = ctypes.c_int
        lib.cca_bwd_col_tc.argtypes = [_P] * 10 + [_I] * 5 + [_P]
        lib.cca_bwd_col_tc.restype = ctypes.c_int
        lib.cca_bwd_row_tc.argtypes = [_P] * 13 + [_I] * 5 + [_P]
        lib.cca_bwd_row_tc.restype = ctypes.c_int
        lib.cca_bwd_query_smem_bytes.argtypes = [_I, _I]
        lib.cca_bwd_query_smem_bytes.restype = ctypes.c_longlong
        lib._ccnet_bound = True
    return lib


def _lines_lib():
    from ccnet_tpu_torch.ops._build import load_library

    lib = load_library("cca_lines")
    if not getattr(lib, "_ccnet_bound", False):
        _L = ctypes.c_longlong
        lib.cca_line_fwd.argtypes = [_P] * 6 + [_I] * 5 + [_L] * 3 + [_I, _I, _P]
        lib.cca_line_fwd.restype = ctypes.c_int
        lib.cca_line_bwd.argtypes = [_P] * 10 + [_I] * 5 + [_L] * 3 + [_I, _I, _P]
        lib.cca_line_bwd.restype = ctypes.c_int
        lib.cca_line_bwd_smem_bytes.argtypes = [_I, _I]
        lib.cca_line_bwd_smem_bytes.restype = ctypes.c_longlong
        lib._ccnet_bound = True
    return lib


def _lines_tc_lib():
    from ccnet_tpu_torch.ops._build import load_library

    lib = load_library("cca_lines_tc")
    if not getattr(lib, "_ccnet_bound", False):
        _L = ctypes.c_longlong
        lib.cca_line_fwd_tc.argtypes = [_P] * 9 + [_I] * 5 + [_L] * 3 + [_I, _P]
        lib.cca_line_fwd_tc.restype = ctypes.c_int
        lib.cca_line_bwd_tc.argtypes = [_P] * 14 + [_I] * 5 + [_L] * 3 + [_I, _P]
        lib.cca_line_bwd_tc.restype = ctypes.c_int
        lib.cca_line_fwd_tc_max_n.argtypes = [_I]
        lib.cca_line_fwd_tc_max_n.restype = _I
        lib._ccnet_bound = True
    return lib


def _natural_lines(n: int, cq: int, cv: int, isz: int, osz: int, kind: str,
                   highp: bool) -> int:
    """How many lines of ``n`` pixels the JAX package's natural-layout
    kernels fit in their VMEM budget: ``_pick_tile``'s arithmetic
    (``ccnet_tpu/ops/cc_attention_pallas.py``), kept here because that
    module imports JAX. Below 8 the JAX package leaves its natural kernels
    (K1–K4) for the line route (K7a/K7b)."""
    if kind == "fwd_col":
        per_line = 2 * n * n * 4 + 3 * n * (2 * cq + cv) * isz + 2 * n * cv * 4 + 2 * n * cv * osz
    elif kind == "fwd_row":
        per_line = (2 * n * n * 4 + 2 * n * (2 * cq * isz + cv * isz + cv * osz)
                    + 2 * n * cv * 4 + 2 * n * cv * osz)
    elif kind == "bwd_col":
        per_line = (3 * n * n * 4 + 3 * n * 2 * (cq + cv) * isz + n * (2 * cq + cv) * (4 + osz)
                    + 2 * n * (2 * cq + cv) * osz)
    elif kind == "bwd_row":
        per_line = (3 * n * n * 4 + 2 * n * (2 * (cq + cv) * isz + (2 * cq + cv) * osz)
                    + n * (2 * cq + cv) * 4 + 2 * n * (2 * cq + cv) * osz)
    else:
        raise ValueError(kind)
    return int((8 if highp else 11) * 1024 * 1024 // max(per_line, 1))


DIRECTIONS = ("fwd", "bwd")


def uses_line_route(direction: str, H: int, W: int, Cq: int = 64, Cv: int = 512,
                    dtype=torch.bfloat16) -> bool:
    """Whether the ``direction`` (``"fwd"`` or ``"bwd"``) of a call on
    ``(B, H, W, C)`` features takes the line route (K7a/K7b) rather than
    K1–K4: where ``_fwd_impl`` / ``_bwd_both_paths`` take it, i.e. where the
    natural kernels' tile falls below 8 lines on either path. bf16 inputs
    stand for the JAX package's default precision (outputs and grads in
    bf16), f32 for its "highest". At the model's widths (the defaults) the
    forward leaves K1/K2 past H = 130 or W = 122 and the backward leaves
    K3/K4 past H = 99 or W = 106: the 97² sliding tiles and 769² crops run
    K1–K4 both ways, every whole-image shape (97×193 and up) K7a/K7b."""
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}; got {direction!r}")
    highp = dtype == torch.float32
    isz = osz = 4 if highp else torch.finfo(dtype).bits // 8
    return (_natural_lines(H, Cq, Cv, isz, osz, f"{direction}_col", highp) < 8
            or _natural_lines(W, Cq, Cv, isz, osz, f"{direction}_row", highp) < 8)


def _line_route_of(direction: str, q: torch.Tensor, v: torch.Tensor) -> bool:
    return uses_line_route(direction, q.shape[1], q.shape[2], q.shape[-1], v.shape[-1], q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lines: bool = False) -> str:
    """Validate q/k/v; return the route, ``"cpu"`` or ``"cuda"``. ``lines``:
    the K7a/K7b wrappers check the layout themselves (:func:`_check_lines`)."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"criss-cross attention wants q, k (B, H, W, Cq) and v "
                         f"(B, H, W, Cv); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must share one dtype, float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu":
        return "cpu"
    if q.device.type != "cuda":
        raise ValueError(f"criss-cross attention kernels: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not lines and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous NHWC")
    if q.shape[-1] > MAX_CQ:
        raise ValueError(f"Cq={q.shape[-1]} exceeds the kernels' limit of {MAX_CQ}")
    return "cuda"


def _check_like(name: str, t: torch.Tensor, shape, device, dtype=torch.float32,
                lines: bool = False) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if device.type == "cuda" and not lines and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_bwd(q, k, v, g, m, L, delta, lines: bool = False) -> str:
    """Validate the backward's inputs; return the route."""
    route = _check(q, k, v, lines)
    B, H, W, _ = q.shape
    _check_like("g", g, v.shape, q.device, v.dtype, lines)
    for name, t in (("m", m), ("L", L), ("delta", delta)):
        _check_like(name, t, (B, H, W), q.device, lines=lines)
    return route


# ------------------------------------------------------------ plain versions


def _to_col(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``(B, H, W, ...)`` → its column lines ``(B, W, H, ...)``, a view."""
    return x.transpose(1, 2)


def cca_line_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, masked: bool,
                       round_to=None):
    """One path over ``(B, M, N, C)`` lines in plain torch: ``(o f32, m, l)``
    with ``e = q·kᵀ`` along N (the diagonal at −1e9 when ``masked``),
    ``m = max e``, ``l = Σ exp(e − m)``, unnormalised ``o = exp(e − m)·v``.
    ``round_to`` (a dtype) rounds ``p = exp(e − m)`` to it before ``p·v``,
    as the TPU kernels feed their bf16 MXU operands under the default
    precision; ``m``, ``l`` and the sums stay f32."""
    e = torch.einsum("bmic,bmjc->bmij", q.float(), k.float())
    if masked:
        e = e.masked_fill(torch.eye(q.shape[2], dtype=torch.bool, device=q.device), NEG_INF)
    m = e.amax(dim=-1)
    p = torch.exp(e - m[..., None])
    p_v = p if round_to is None else p.to(round_to).float()
    return torch.einsum("bmij,bmjc->bmic", p_v, v.float()), m, p.sum(dim=-1)


def cca_line_bwd_plain(q, k, v, g, m, L, delta, masked: bool, round_to=None):
    """One path's backward over ``(B, M, N, C)`` lines in plain torch:
    ``(dq, dk, dv)`` f32. ``p = exp(e − m) / L`` with the joint stats,
    ``de = p·(g·vᵀ − delta)``, ``dq = de·k``, ``dk = deᵀ·q``, ``dv = pᵀ·g``.
    ``round_to`` (a dtype) rounds ``de`` and ``p`` to it before the
    products that consume them, as the TPU kernels feed their bf16 MXU
    operands under the default precision; the sums stay f32."""
    e = torch.einsum("bmic,bmjc->bmij", q.float(), k.float())
    if masked:
        e = e.masked_fill(torch.eye(q.shape[2], dtype=torch.bool, device=q.device), NEG_INF)
    p = torch.exp(e - m[..., None]) / L[..., None]
    de = p * (torch.einsum("bmic,bmjc->bmij", g.float(), v.float()) - delta[..., None])
    if round_to is not None:
        p, de = p.to(round_to).float(), de.to(round_to).float()
    return (torch.einsum("bmij,bmjc->bmic", de, k.float()),
            torch.einsum("bmij,bmic->bmjc", de, q.float()),
            torch.einsum("bmij,bmic->bmjc", p, g.float()))


def _combine(o_c, m_c, l_c, o_r, m_r, l_r):
    """The joint softmax over both paths: ``(out f32, m, L)`` with
    ``m = max(m_c, m_r)``, ``L = l_c·e^{m_c−m} + l_r·e^{m_r−m}`` and
    ``out = (o_c·e^{m_c−m} + o_r·e^{m_r−m}) / L``."""
    m = torch.maximum(m_c, m_r)
    a_c, a_r = torch.exp(m_c - m), torch.exp(m_r - m)
    L = l_c * a_c + l_r * a_r
    return (o_c * a_c[..., None] + o_r * a_r[..., None]) / L[..., None], m, L


def _mxu_round(q: torch.Tensor):
    """What the plain versions round ``p`` (and the backward's ``de``) to
    before the products that consume them: bf16 for bf16 inputs (the JAX
    package's default precision), nothing for f32 (its "highest")."""
    return torch.bfloat16 if q.dtype == torch.bfloat16 else None


def cca_fwd_col_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Column path in plain torch: ``(o_col, m_col, l_col)``, NHWC, ``o_col``
    in v's dtype and the stats f32, as ``_fwd_col_kernel`` writes them."""
    o, m, l = cca_line_fwd_plain(*map(_to_col, (q, k, v)), masked=True, round_to=_mxu_round(q))
    return _to_col(o).to(v.dtype), _to_col(m), _to_col(l)


def cca_fwd_row_plain(q, k, v, o_col, m_col, l_col):
    """Row path + joint-softmax combine in plain torch: ``(out, m, L)``, the
    combine in f32 from ``o_col`` (in v's dtype), ``out`` in v's dtype."""
    row = cca_line_fwd_plain(q, k, v, masked=False, round_to=_mxu_round(q))
    out, m, L = _combine(o_col.float(), m_col, l_col, *row)
    return out.to(v.dtype), m, L


def cca_bwd_col_plain(q, k, v, g, m, L, delta):
    """Column-path backward in plain torch: ``(dq_c, dk_c, dv_c)`` in the
    input dtype, NHWC (the self slot's −1e9 gives p = 0)."""
    cols = map(_to_col, (q, k, v, g, m, L, delta))
    grads = cca_line_bwd_plain(*cols, masked=True, round_to=_mxu_round(q))
    return tuple(_to_col(d).to(t.dtype) for d, t in zip(grads, (q, k, v)))


def cca_bwd_row_plain(q, k, v, g, m, L, delta, dq_c, dk_c, dv_c):
    """Row-path backward plus the column grads, in plain torch:
    ``(dq, dk, dv)`` in the input dtype."""
    row = cca_line_bwd_plain(q, k, v, g, m, L, delta, masked=False, round_to=_mxu_round(q))
    return tuple((r + c.float()).to(t.dtype)
                 for r, c, t in zip(row, (dq_c, dk_c, dv_c), (q, k, v)))


# ------------------------------------------------------------------ kernels


DESIGNS = ("tensor_core", "tensor_core_lines", "cuda_core")
PATHS = ("col", "row")


def kernel_design(q: torch.Tensor, path: str) -> str:
    """The design the ``path`` kernels (``"col"``: K1, K3; ``"row"``: K2, K4)
    take for ``q``, from their own line (H for the column path, W for the
    row path): for bf16 (the JAX package's default precision, p and de
    rounded to bf16) ``"tensor_core"`` (one block per line, no scratch) on
    lines of at most :data:`LONG_LINE`, ``"tensor_core_lines"`` (K7a's /
    K7b's tensor-core kernels, keys tiled) on longer ones, which at the
    model's widths the forward meets at H = 129 or 130 (K1 only);
    ``"cuda_core"`` (f32 arithmetic: K1/K2 an online softmax over key tiles,
    K3/K4 p and de through f32 scratch) for f32, the "highest" precision."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}; got {path!r}")
    if q.dtype != torch.bfloat16:
        return "cuda_core"
    return "tensor_core" if q.shape[1 if path == "col" else 2] <= LONG_LINE else "tensor_core_lines"


def _resolve_design(name: str, q: torch.Tensor, design, rule) -> str:
    """``design`` checked against ``q`` (``None``: ``rule(q)``, the kernel's
    own choice: :func:`kernel_design` of its path for K1–K4,
    :func:`line_design` for K7a/K7b). The CUDA-core design may be forced on
    any call (to time one design against the other); a tensor-core design
    only where it is the kernel's own choice."""
    if design is None:
        return rule(q)
    if design not in DESIGNS:
        raise ValueError(f"{name}: design must be one of {DESIGNS}; got {design!r}")
    if design != "cuda_core" and rule(q) != design:
        raise ValueError(f"{name}: the {design} design does not take {q.dtype} "
                         f"{tuple(q.shape)}")
    return design


def _col_design(q: torch.Tensor) -> str:
    return kernel_design(q, "col")


def _row_design(q: torch.Tensor) -> str:
    return kernel_design(q, "row")


def _fwd_launch(name, design, q, k, v, col_in, outs):
    """Launch K1 (``col_in`` empty) or K2 (K1's ``o_col, m_col, l_col``)
    in ``design``."""
    B, H, W, Cq = q.shape
    Cv = v.shape[-1]
    lib = _lib()
    stream = _P(torch.cuda.current_stream().cuda_stream)
    ptrs = [_P(t.data_ptr()) for t in (q, k, v, *col_in, *outs)]
    if design == "tensor_core":  # at most 106 KB of shared memory (N = Cq = 128)
        rc = getattr(lib, f"{name}_tc")(*ptrs, B, H, W, Cq, Cv, stream)
    else:
        rc = getattr(lib, name)(*ptrs, B, H, W, Cq, Cv, int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} ({design}) launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    if design == "tensor_core":
        LAUNCHES[f"{name}_tc"] += 1


def cca_fwd_col(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, design=None):
    """K1: ``(o_col (B,H,W,Cv) in v's dtype, m_col (B,H,W) f32, l_col
    (B,H,W) f32)``. ``design`` forces one of :data:`DESIGNS` (to time one
    against the other); ``None`` takes :func:`kernel_design`."""
    route = _check(q, k, v)
    design = _resolve_design("cca_fwd_col", q, design, _col_design)
    if route == "cpu":
        return cca_fwd_col_plain(q, k, v)
    B, H, W, _ = q.shape
    with torch.cuda.device(q.device):
        if design == "tensor_core_lines":  # K7a on the column view, o_col in bf16
            return tuple(map(_to_col, _line_fwd_tc(*map(_to_col, (q, k, v)), True,
                                                   ("cca_fwd_col",))))
        f32 = dict(device=q.device, dtype=torch.float32)
        outs = (torch.empty_like(v), torch.empty((B, H, W), **f32),
                torch.empty((B, H, W), **f32))
        _fwd_launch("cca_fwd_col", design, q, k, v, (), outs)
    return outs


def cca_fwd_row(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o_col: torch.Tensor,
                m_col: torch.Tensor, l_col: torch.Tensor, design=None):
    """K2: ``(out (B,H,W,Cv) in v's dtype, m (B,H,W) f32, L (B,H,W) f32)``
    from K1's outputs (``o_col`` in v's dtype). ``design`` as for
    :func:`cca_fwd_col`."""
    route = _check(q, k, v)
    B, H, W, _ = q.shape
    _check_like("o_col", o_col, v.shape, q.device, v.dtype)
    _check_like("m_col", m_col, (B, H, W), q.device)
    _check_like("l_col", l_col, (B, H, W), q.device)
    design = _resolve_design("cca_fwd_row", q, design, _row_design)
    if route == "cpu":
        return cca_fwd_row_plain(q, k, v, o_col, m_col, l_col)
    with torch.cuda.device(q.device):
        if design == "tensor_core_lines":  # K7a on the rows, the combine in its stores
            return _line_fwd_tc(q, k, v, False, ("cca_fwd_row",), (o_col, m_col, l_col))
        f32 = dict(device=q.device, dtype=torch.float32)
        outs = (torch.empty_like(v), torch.empty((B, H, W), **f32),
                torch.empty((B, H, W), **f32))
        _fwd_launch("cca_fwd_row", design, q, k, v, (o_col, m_col, l_col), outs)
    return outs


def _bwd_launch(name, design, q, k, v, g, m, L, delta, extra_in, outs):
    """Launch K3 or K4 in ``design``. The CUDA-core design gets freshly
    allocated P/DE scratch of the path."""
    B, H, W, Cq = q.shape
    Cv = v.shape[-1]
    lib = _bwd_lib()
    stream = _P(torch.cuda.current_stream().cuda_stream)
    n = H if name == "cca_bwd_col" else W
    if design == "tensor_core":  # at most 142 KB of shared memory (N = Cq = 128)
        ptrs = (q, k, v, g, m, L, delta, *extra_in, *outs)
        rc = getattr(lib, f"{name}_tc")(*(_P(t.data_ptr()) for t in ptrs), B, H, W, Cq, Cv,
                                        stream)
    else:
        smem = lib.cca_bwd_query_smem_bytes(Cq, Cv)
        if smem > MAX_SMEM:
            raise ValueError(f"{name}: Cv={Cv} needs {smem} B of shared memory, over {MAX_SMEM}")
        P = torch.empty((B * H * W * n,), device=q.device, dtype=torch.float32)
        DE = torch.empty_like(P)
        ptrs = (q, k, v, g, m, L, delta, P, DE, *extra_in, *outs)
        rc = getattr(lib, name)(*(_P(t.data_ptr()) for t in ptrs), B, H, W, Cq, Cv,
                                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} ({design}) launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    if design == "tensor_core":
        LAUNCHES[f"{name}_tc"] += 1


def cca_bwd_col(q, k, v, g, m, L, delta, design=None):
    """K3: column-path ``(dq_c, dk_c, dv_c)``, ``(B, H, W, C)`` in the input
    dtype.

    ``g`` is the output grad in v's dtype; ``m``, ``L`` the joint stats of
    the forward; ``delta = Σ_c out·g``, all ``(B, H, W)`` f32. ``design``
    forces one of :data:`DESIGNS` on a CUDA tensor (to time one against
    the other); ``None`` takes :func:`kernel_design`."""
    route = _check_bwd(q, k, v, g, m, L, delta)
    design = _resolve_design("cca_bwd_col", q, design, _col_design)
    if route == "cpu":
        return cca_bwd_col_plain(q, k, v, g, m, L, delta)
    with torch.cuda.device(q.device):
        if design == "tensor_core_lines":  # K7b on the column view
            return tuple(map(_to_col, _line_bwd_tc(*map(_to_col, (q, k, v, g, m, L, delta)),
                                                   True, ("cca_bwd_col",))))
        outs = [torch.empty_like(t) for t in (q, k, v)]
        _bwd_launch("cca_bwd_col", design, q, k, v, g, m, L, delta, (), outs)
    return tuple(outs)


def cca_bwd_row(q, k, v, g, m, L, delta, dq_c, dk_c, dv_c, design=None):
    """K4: row-path grads plus K3's ``(dq_c, dk_c, dv_c)`` (in the input
    dtype): the final ``(dq, dk, dv)`` in the input dtype. ``design`` as
    for :func:`cca_bwd_col`."""
    route = _check_bwd(q, k, v, g, m, L, delta)
    for name, t, ref in (("dq_c", dq_c, q), ("dk_c", dk_c, k), ("dv_c", dv_c, v)):
        _check_like(name, t, ref.shape, q.device, ref.dtype)
    design = _resolve_design("cca_bwd_row", q, design, _row_design)
    if route == "cpu":
        return cca_bwd_row_plain(q, k, v, g, m, L, delta, dq_c, dk_c, dv_c)
    with torch.cuda.device(q.device):
        if design == "tensor_core_lines":  # K7b on the rows, K3's grads added before rounding
            return _line_bwd_tc(q, k, v, g, m, L, delta, False, ("cca_bwd_row",),
                                (dq_c, dk_c, dv_c))
        outs = [torch.empty_like(t) for t in (q, k, v)]
        _bwd_launch("cca_bwd_row", design, q, k, v, g, m, L, delta, (dq_c, dk_c, dv_c), outs)
    return tuple(outs)


def _check_lines(name: str, t: torch.Tensor, col: bool) -> None:
    """Raise unless ``t`` is laid out as the line kernels read it: contiguous
    lines (``col`` False), or the column lines ``x.transpose(1, 2)`` of a
    contiguous NHWC ``x``."""
    if not (_to_col(t) if col else t).is_contiguous():
        raise ValueError(f"{name} must be contiguous (B, M, N, ...) lines or the "
                         f"transpose(1, 2) of a contiguous tensor, as q is")


def line_design(q: torch.Tensor) -> str:
    """The design K7a/K7b take for ``q``: ``"tensor_core"`` for bf16 (the
    products on the tensor cores, p and de rounded to bf16 and the outputs
    written in bf16, as the TPU kernels do at the default precision), for
    every line length; ``"cuda_core"`` (f32 arithmetic, outputs in f32) for
    f32, the JAX package's "highest"."""
    return "tensor_core" if q.dtype == torch.bfloat16 else "cuda_core"


def _line_launch(name, design, q, tensors, outs, masked, counted, fused=()):
    """Launch K7a or K7b in ``design`` on ``(B, M, N, C)`` lines: row lines
    are contiguous, column lines a transposed view; the kernel reads and
    writes every tensor through the pixel strides (batch, line, position)
    of that layout. The tensor-core K7b also gets f32 scratch for the key
    blocks' parts of dq (``ceil(N / 64)`` × B·M·N × Cq floats). ``fused``:
    the tensor-core kernels' optional inputs in the same layout (K2's
    ``o_col, m_col, l_col`` for K7a, K4's column grads for K7b), or none.
    The launch counts once under each name of ``counted``."""
    B, M, N, Cq = q.shape
    col = not q.is_contiguous()
    for i, t in enumerate((*tensors, *fused, *outs)):
        _check_lines(f"{name} argument {i}", t, col)
    strides = (M * N, 1, M) if col else (M * N, N, 1)
    Cv = tensors[2].shape[-1]
    stream = _P(torch.cuda.current_stream().cuda_stream)
    if design == "tensor_core":
        scratch = ()
        if name == "cca_line_bwd":
            scratch = (torch.empty(((N + 63) // 64) * B * M * N * Cq, device=q.device,
                                   dtype=torch.float32),)
        ptrs = [_P(t.data_ptr()) for t in (*tensors, *scratch, *outs)]
        ptrs += [_P(t.data_ptr()) for t in fused] or [_P(None)] * 3
        rc = getattr(_lines_tc_lib(), f"{name}_tc")(*ptrs, B, M, N, Cq, Cv, *strides,
                                                    int(masked), stream)
    else:
        ptrs = [_P(t.data_ptr()) for t in (*tensors, *outs)]
        rc = getattr(_lines_lib(), name)(*ptrs, B, M, N, Cq, Cv, *strides, int(masked),
                                         int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} ({design}) launch failed: CUDA error {rc}")
    for n in counted:
        LAUNCHES[n] += 1


def _empty_lines(like: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``shape`` of ``dtype`` in ``like``'s line layout (contiguous or column
    view)."""
    if like.is_contiguous():
        return torch.empty(shape, device=like.device, dtype=dtype)
    return _to_col(torch.empty((shape[0], shape[2], shape[1], *shape[3:]),
                               device=like.device, dtype=dtype))


def _line_fwd_tc(q, k, v, masked: bool, counted, combine=()):
    """K7a's tensor-core kernel on ``(B, M, N, C)`` bf16 lines in q's layout:
    ``(o bf16, m, l)``; with ``combine`` (K1's ``o_col, m_col, l_col`` in
    that layout, K2) the joint ``(out bf16, m, L)``. Counts under
    ``counted`` and ``cca_line_fwd_tc``."""
    B, M, N, Cq = q.shape
    longest = _lines_tc_lib().cca_line_fwd_tc_max_n(Cq)
    if N > longest:
        raise ValueError(f"{counted[0]}: lines of {N} exceed the {longest} the tensor-core "
                         f"kernel's p tile holds at Cq={Cq}")
    outs = (_empty_lines(q, (B, M, N, v.shape[-1]), torch.bfloat16), _empty_lines(q, (B, M, N)),
            _empty_lines(q, (B, M, N)))
    _line_launch("cca_line_fwd", "tensor_core", q, (q, k, v), outs, masked,
                 (*counted, "cca_line_fwd_tc"), combine)
    return outs


def _line_bwd_tc(q, k, v, g, m, L, delta, masked: bool, counted, add=()):
    """K7b's tensor-core kernels on ``(B, M, N, C)`` bf16 lines in q's
    layout: ``(dq, dk, dv)`` in bf16, plus ``add`` (K3's grads in that
    layout, K4) in f32 before the rounding. Counts under ``counted`` and
    ``cca_line_bwd_tc``."""
    outs = tuple(_empty_lines(q, t.shape, torch.bfloat16) for t in (q, k, v))
    _line_launch("cca_line_bwd", "tensor_core", q, (q, k, v, g, m, L, delta), outs, masked,
                 (*counted, "cca_line_bwd_tc"), add)
    return outs


def cca_line_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, masked: bool, design=None):
    """K7a: one path over ``(B, M, N, C)`` lines, attention along N:
    ``(o (B,M,N,Cv), m (B,M,N) f32, l (B,M,N) f32)``, the outputs in q's
    line layout (so column stats land in NHWC order with no copy).
    ``masked`` sets the diagonal to −1e9 (the column path). ``o`` is in v's
    dtype, as ``_legacy_fwd_kernel`` writes it; for bf16, p is rounded to
    bf16 before ``p·v``. ``design`` forces one of :data:`DESIGNS` on a CUDA
    tensor (to time one against the other; the CUDA-core design neither
    rounds p nor writes ``o`` in bf16); ``None`` takes :func:`line_design`."""
    route = _check(q, k, v, lines=True)
    design = _resolve_design("cca_line_fwd", q, design, line_design)
    if route == "cpu":
        o, m, l = cca_line_fwd_plain(q, k, v, masked, round_to=_mxu_round(q))
        return o.to(v.dtype), m, l
    B, M, N, _ = q.shape
    with torch.cuda.device(q.device):
        if design == "tensor_core":
            return _line_fwd_tc(q, k, v, masked, ("cca_line_fwd",))
        outs = (_empty_lines(q, (B, M, N, v.shape[-1])), _empty_lines(q, (B, M, N)),
                _empty_lines(q, (B, M, N)))
        _line_launch("cca_line_fwd", design, q, (q, k, v), outs, masked, ("cca_line_fwd",))
    return outs


def cca_line_bwd(q, k, v, g, m, L, delta, masked: bool, design=None):
    """K7b: one path's ``(dq, dk, dv)`` over ``(B, M, N, C)`` lines from the
    joint stats ``m``, ``L`` and ``delta = Σ_c out·g`` (``(B, M, N)`` f32),
    ``g`` in v's dtype; every tensor in q's line layout. The grads are in
    the input dtype, as ``_legacy_bwd_kernel`` writes them; for bf16, p and
    de are rounded to bf16 before the products that consume them.
    ``design`` as for :func:`cca_line_fwd` (the CUDA-core design writes f32
    grads)."""
    route = _check_bwd(q, k, v, g, m, L, delta, lines=True)
    design = _resolve_design("cca_line_bwd", q, design, line_design)
    if route == "cpu":
        grads = cca_line_bwd_plain(q, k, v, g, m, L, delta, masked, round_to=_mxu_round(q))
        return tuple(d.to(t.dtype) for d, t in zip(grads, (q, k, v)))
    with torch.cuda.device(q.device):
        if design == "tensor_core":
            return _line_bwd_tc(q, k, v, g, m, L, delta, masked, ("cca_line_bwd",))
        smem = _lines_lib().cca_line_bwd_smem_bytes(q.shape[-1], v.shape[-1])
        if smem > MAX_SMEM:
            raise ValueError(f"cca_line_bwd: Cv={v.shape[-1]} needs {smem} B of shared memory, "
                             f"over {MAX_SMEM}")
        outs = tuple(_empty_lines(q, t.shape) for t in (q, k, v))
        _line_launch("cca_line_bwd", design, q, (q, k, v, g, m, L, delta), outs, masked,
                     ("cca_line_bwd",))
    return outs


def cca_line_route_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The line route's forward on NHWC q, k, v (``_legacy_fwd_impl``): K7a on
    the columns (masked) and on the rows, each ``o`` in v's dtype, then the
    joint combine in f32 in plain torch. Returns ``(out f32, m, L)``."""
    o_c, m_c, l_c = map(_to_col, cca_line_fwd(*map(_to_col, (q, k, v)), masked=True))
    o_r, m_r, l_r = cca_line_fwd(q, k, v, masked=False)
    return _combine(o_c.float(), m_c, l_c, o_r.float(), m_r, l_r)


def cca_line_route_bwd(q, k, v, g, m, L, delta):
    """The line route's backward (``_legacy_bwd_both_paths``): K7b on the
    columns and on the rows, each path's grads in the input dtype, summed
    (in bf16 for bf16 inputs, as the JAX package sums them)."""
    col = cca_line_bwd(*map(_to_col, (q, k, v, g, m, L, delta)), masked=True)
    row = cca_line_bwd(q, k, v, g, m, L, delta, masked=False)
    return tuple((_to_col(c) + r).to(t.dtype) for c, r, t in zip(col, row, (q, k, v)))


class CrissCrossAttentionFn(torch.autograd.Function):
    """Criss-cross attention with the kernels' backward, each direction
    routed as the JAX package routes it (:func:`uses_line_route`). Forward:
    K1 → K2 or the line route; the residual is the route's ``out`` as
    ``_cca_fwd`` saves it: bf16 after K1/K2, the f32 combine after the line
    route (returned cast to v's dtype). Backward: ``delta = Σ_c out·g`` from
    that residual in plain torch (as ``_cca_bwd`` does), then K3 → K4 or the
    line route. Returns ``(out, m, L)``; ``m`` and ``L`` are not
    differentiable. On CPU tensors every step takes its plain version."""

    @staticmethod
    def forward(ctx, q, k, v):
        if _line_route_of("fwd", q, v):
            saved, m, L = cca_line_route_fwd(q, k, v)
            out = saved.to(v.dtype)
        else:
            out, m, L = cca_fwd_row(q, k, v, *cca_fwd_col(q, k, v))
            saved = out
        ctx.save_for_backward(q, k, v, saved, m, L)
        ctx.mark_non_differentiable(m, L)
        return out, m, L

    @staticmethod
    def backward(ctx, g, _gm, _gL):
        q, k, v, out, m, L = ctx.saved_tensors
        g = g.to(v.dtype).contiguous()
        delta = (g.float() * out.float()).sum(dim=-1)
        if _line_route_of("bwd", q, v):
            return cca_line_route_bwd(q, k, v, g, m, L, delta)
        return cca_bwd_row(q, k, v, g, m, L, delta, *cca_bwd_col(q, k, v, g, m, L, delta))


def criss_cross_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Fused criss-cross attention through :class:`CrissCrossAttentionFn`:
    K1/K2 (K7a on long lines) forward, differentiable through K3/K4 (K7b):
    ``(out, m, L)``.

    q, k: (B, H, W, Cq); v: (B, H, W, Cv); NHWC, one dtype (f32 or bf16).
    ``out`` (B, H, W, Cv) is in v's dtype; ``m``, ``L`` are (B, H, W) f32,
    the joint-softmax row max and sum. Same semantics as
    :func:`ccnet_tpu_torch.ops.cc_attention.criss_cross_attention`.
    """
    return CrissCrossAttentionFn.apply(q, k, v)
