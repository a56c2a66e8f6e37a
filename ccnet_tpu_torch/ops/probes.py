"""The layout probes P1–P5 through the hand-written CUDA kernels.

Counterpart of the Pallas kernels of ``scripts/probe_mosaic.py``, which ask
what a fused criss-cross attention kernel needs of the compiler. The kernels
live in ``ccnet_tpu_torch/csrc/probes.cu``; each wrapper here has a plain
PyTorch version beside it and a launch count in :data:`LAUNCHES`:

* P1 :func:`mid_batch_dot` replaces ``_mid_batch_kernel``: ``(H, T, C)`` q, k
  bf16 → ``e (T, H, H)`` f32, ``e[t, h, g] = Σ_c q[h, t, c]·k[g, t, c]``.
* P2 :func:`swap_leading` replaces ``_swap_kernel``: ``(A, B, C)`` →
  ``(B, A, C)`` bf16.
* P3 :func:`scale_ragged` replaces ``_tile_kernel``: ``2·x`` over ``(M, N)``
  f32 (the TPU kernel's 16-row grid leaves a ragged tail at M = 97).
* P4 :func:`mid_batch_dot_4d` replaces ``_mid_batch4_kernel``: P1 on the
  columns of NHWC ``(B, H, W, C)`` q, k, read in place → ``(B, W, H, H)``
  f32, the column-path logits of K1.
* P5 :func:`store_transposed` replaces ``_store_transposed_kernel``: NHWC
  ``(B, H, W, C)`` → column-major ``(B, W, H, C)`` bf16.

P1/P4 share one kernel, and P2/P5 another. The TPU kernels pad P4's and P5's
outputs to a multiple of the 16-column tile; those rows are a block artefact
that nothing reads, and the port returns only the ``W`` used columns.

Each kernel takes a launch plan computed here, by the pure functions
:func:`dot_plan`, :func:`swap_plan` and :func:`scale_plan`;
:func:`dot_coverage`, :func:`swap_chunk_map` and :func:`scale_coverage`
replay the kernels' loops over a plan, so the CPU tests hold that every
element is written once, from the right source. The
wrappers keep their host work small, since a call of a few microseconds on
the card is paced by the host: the library is bound once, a plan is cached
per shape (and the scale's offset) and passed as one struct, the stream is
read as a raw handle, and the device is switched only when the tensor is
not on the current one.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version. A
wrong dtype, rank or layout raises on either device. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

# launches of each kernel made by this process; callers may reset them to 0
LAUNCHES = {"mid_batch_dot": 0, "swap_leading": 0, "scale_ragged": 0,
            "mid_batch_dot_4d": 0, "store_transposed": 0}

_P, _I, _L, _U, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
                        ctypes.c_ulonglong)

# csrc/probes.cu's block size and 16-byte loads per thread (copy and scale)
COPY_THREADS, COPY_UNROLL = 256, 1
# the dot's 16 x 16 output tiles a block holds per pass, channels staged per
# chunk (rows padded by 8 bf16), and its two builds: warps per block -> blocks
# resident per SM (128 registers a thread)
DOT_TILES, DOT_KC = 64, 64
DOT_DESIGNS = {8: 2, 16: 1}
DOT_PASS_KEYS = 512  # keys staged per pass at most (two buffers of them fit shared memory)
# an H100 SXM: its SMs and the dynamic shared memory a block may take
H100_SMS, SMEM_MAX = 132, 232448


class DotPlan(NamedTuple):
    """``probe_mid_batch_dot``'s launch: ``items`` (line, band of ``band``
    query rows) items, ``bands`` per line, on ``blocks`` blocks of ``warps``
    warps (block b takes items b, b + blocks, ...); keys in passes of
    ``group``; ``vec``: 16-byte ``cp.async`` staging; the band's f32 run of e takes
    ``es_bytes`` of the ``smem`` bytes of shared memory, two staging
    buffers the rest."""
    sN: int
    sH: int
    sT: int
    T: int
    H: int
    C: int
    band: int
    bands: int
    group: int
    vec: int
    warps: int
    es_bytes: int
    smem: int
    items: int
    blocks: int


class SwapPlan(NamedTuple):
    """``probe_swap_leading``'s launch: x ``(n, a, b, r chunks)`` → y ``(n,
    b, a, r chunks)`` on a ``(blocks, n)`` grid; ``i // r`` and ``i // a`` by
    :func:`fast_divider`'s multiplier and shift."""
    n: int
    a: int
    b: int
    r: int
    r_mul: int
    r_shift: int
    a_mul: int
    a_shift: int
    blocks: int


class ScalePlan(NamedTuple):
    """``probe_scale``'s launch: ``head`` scalars up to x's first 16-byte
    boundary, ``body`` float4s, ``tail`` scalars, on ``blocks`` blocks."""
    head: int
    body: int
    tail: int
    blocks: int


class _DotPlanC(ctypes.Structure):
    _fields_ = [(name, _L) for name in DotPlan._fields[:3]] + [
        (name, _I) for name in DotPlan._fields[3:-2]] + [("items", _U), ("blocks", _U)]


class _SwapPlanC(ctypes.Structure):
    _fields_ = [(name, _U) for name in SwapPlan._fields]


class _ScalePlanC(ctypes.Structure):
    _fields_ = [("head", _ULL), ("body", _ULL), ("tail", _ULL), ("blocks", _U)]


def fast_divider(d: int) -> tuple:
    """``(mul, shift)`` with ``i // d == ((i * mul >> 32) + i) >> shift`` for
    every ``0 <= i < 2**32`` and ``1 <= d < 2**31`` (the kernel adds in 64
    bits): shift = ceil(log2 d), mul = floor(2^32 (2^shift − d) / d) + 1."""
    if not 1 <= d < 2**31:
        raise ValueError(f"divisor {d} outside [1, 2**31)")
    shift = (d - 1).bit_length()
    return (1 << 32) * ((1 << shift) - d) // d + 1, shift


def fast_div(i, mul: int, shift: int):
    """The kernel's ``fast_div`` on a Python int or an int64 tensor of values
    below 2**32 (``umulhi`` in two 16-bit halves of ``mul``, exact in int64)."""
    hi = (i * (mul >> 16) + ((i * (mul & 0xFFFF)) >> 16)) >> 16
    return (hi + i) >> shift


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceil16(x: int) -> int:
    return -(-x // 16) * 16


def dot_smem(H: int, band: int, group: int) -> tuple:
    """``(es_bytes, smem)`` of a dot block: the band's f32 run of e (placed
    up to 3 floats in, at its offset modulo 16 bytes), then two staging
    buffers of the band's q rows and a pass's key rows, each padded to 16
    rows of DOT_KC + 8 bf16."""
    es = _ceil16((band * H + 3) * 4)
    return es, es + 2 * (_ceil16(band) + _ceil16(min(group, H))) * (DOT_KC + 8) * 2


def dot_plan(N: int, T: int, H: int, C: int, strides, aligned: bool = True,
             sms: int = H100_SMS) -> DotPlan:
    """The dot's launch for N·T lines of H pixels and C channels at element
    ``strides`` (sN, sH, sT); ``aligned``: q's and k's bases are 16-byte
    aligned. Keys go in one pass up to DOT_PASS_KEYS, else in passes of
    DOT_PASS_KEYS. Blocks of 8 warps, two per SM, when there are lines for
    every SM; else of 16, one per SM, so that each line's work spreads over
    more warps. A work item is a band of query rows of one line: the whole
    line when it fits DOT_TILES tiles and shared memory and the lines fill
    the card's resident blocks, else whole 16-row tiles, split so that the
    items fill them, then fewer rows while the shared memory does not fit.
    The grid is one block per resident slot (or per item, if fewer), each
    looping over its items. Raises for a shape no band fits."""
    sN, sH, sT = (int(x) for x in strides)
    lines = N * T
    if min(N, T, H, C) < 1:
        raise ValueError(f"dot of {(N, T, H, C)}")
    vec = int(aligned and C % 8 == 0 and all(x % 8 == 0 for x in (sN, sH, sT)))
    warps = 8 if lines >= sms else 16
    slots = sms * DOT_DESIGNS[warps]
    tiles = -(-H // 16)
    group = H if H <= DOT_PASS_KEYS else DOT_PASS_KEYS
    group_tiles = -(-group // 16)
    m_tiles = min(tiles, DOT_TILES // group_tiles)
    m_tiles = min(m_tiles, -(-tiles // max(1, slots // lines)))
    band = min(H, 16 * m_tiles)
    while dot_smem(H, band, group)[1] > SMEM_MAX and band > 1:
        band = _ceil16(band) - 16 if band > 16 else band - 1
    es_bytes, smem = dot_smem(H, band, group)
    bands = -(-H // band)
    items = lines * bands
    stages = items * -(-C // DOT_KC) * -(-H // group)
    if smem > SMEM_MAX or stages + slots >= 2**32:
        raise ValueError(f"dot of {(N, T, H, C)}: no band of query rows fits {SMEM_MAX} "
                         f"bytes of shared memory and 2**32 stages")
    return DotPlan(sN, sH, sT, T, H, C, band, bands, group, vec, warps, es_bytes, smem, items,
                   min(items, slots))


def dot_coverage(plan: DotPlan, lines=None) -> torch.Tensor:
    """Replay ``mid_batch_dot_kernel`` over ``plan`` for its first ``lines``
    lines (default all): for each logit of e, flat ``(lines, H, H)``, the
    writes of its shared-memory cell by the warps' tiles, summed over the
    blocks' visits of its item and the stores that copy that cell to it
    (1 everywhere: each logit written once, from a cell written once)."""
    H, band = plan.H, plan.band
    lines = plan.items // plan.bands if lines is None else lines
    visits = torch.bincount(torch.cat([torch.arange(b, plan.items, plan.blocks)
                                       for b in range(plan.blocks)]), minlength=plan.items)
    cover = torch.zeros(lines * H * H, dtype=torch.int32)
    warp, i = torch.arange(plan.warps)[:, None], torch.arange(DOT_TILES // plan.warps)
    rr, gg = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    for b in range(plan.bands):
        h0 = b * band
        bh = min(band, H - h0)
        es = torch.zeros(bh * H, dtype=torch.int32)
        for g0 in range(0, H, plan.group):
            nps = _ceil16(min(plan.group, H - g0)) // 16
            tiles = _ceil16(bh) // 16 * nps
            per = -(-tiles // plan.warps)
            tile = warp * per + i
            mine = tile[(i < per) & (tile < tiles)]
            r = ((mine // nps) * 16)[:, None, None] + rr
            g = g0 + ((mine % nps) * 16)[:, None, None] + gg
            ok = (r < bh) & (g < H)
            es += torch.bincount((r * H + g)[ok], minlength=bh * H).to(torch.int32)
        run = bh * H
        for line in range(lines):
            start = line * H * H + h0 * H
            head = min(run, (4 - start % 4) % 4)
            body = (run - head) // 4
            tail = run - head - 4 * body
            j = torch.cat([torch.arange(head), head + torch.arange(4 * body),
                           head + 4 * body + torch.arange(tail)])
            cover[start + j] += es[j] * int(visits[line * plan.bands + b])
    return cover


def swap_plan(n: int, a: int, b: int, r: int) -> SwapPlan:
    """The copy's launch for x ``(n, a, b, r chunks)``: one tile of
    ``COPY_THREADS·COPY_UNROLL`` chunks per block (the kernel's grid-stride
    loop also covers a smaller grid: ``plan._replace(blocks=k)``)."""
    plane = a * b * r
    if not 1 <= n <= 65535 or min(a, b, r) < 1:
        raise ValueError(f"swap of {(n, a, b, r)} chunks")
    blocks = _cdiv(plane, COPY_THREADS * COPY_UNROLL)
    if plane + blocks * COPY_THREADS * COPY_UNROLL >= 2**32:
        raise ValueError(f"a plane of {plane} 16-byte chunks does not fit 32-bit indices")
    return SwapPlan(n, a, b, r, *fast_divider(r), *fast_divider(a), blocks)


def scale_plan(numel: int, offset: int) -> ScalePlan:
    """The scale's launch for ``numel`` f32 values whose first lies
    ``offset`` values (0–3) past a 16-byte boundary: one tile of
    ``COPY_THREADS·COPY_UNROLL`` float4 per block."""
    if numel < 1 or not 0 <= offset < 4:
        raise ValueError(f"scale of {numel} values at offset {offset}")
    head = min(numel, (4 - offset) % 4)
    body = (numel - head) // 4
    blocks = max(1, _cdiv(body, COPY_THREADS * COPY_UNROLL))
    if blocks >= 2**31:
        raise ValueError(f"{numel} values need more than 2**31 - 1 blocks")
    return ScalePlan(head, body, numel - head - 4 * body, blocks)


def _grid_stride(blocks: int, size: int) -> torch.Tensor:
    """Every index ``base + u·COPY_THREADS`` the kernels' grid-stride loop
    visits below ``size``, over all blocks and threads, in int64."""
    per_block = COPY_THREADS * COPY_UNROLL
    start = (torch.arange(blocks)[:, None] * per_block + torch.arange(COPY_THREADS)).reshape(-1)
    rounds = max(1, _cdiv(size, blocks * per_block))
    base = (start[:, None] + torch.arange(rounds) * blocks * per_block).reshape(-1)
    base = base[base < size]
    i = (base[:, None] + torch.arange(COPY_UNROLL) * COPY_THREADS).reshape(-1)
    return i[i < size]


def swap_chunk_map(plan: SwapPlan) -> tuple:
    """Replay ``swap_leading_kernel`` over ``plan``: ``(src, writes)``, for
    each chunk of y (flat, int64) the chunk of x it copies and how many
    threads store it."""
    plane = plan.a * plan.b * plan.r
    i = _grid_stride(plan.blocks, plane)
    row = fast_div(i, plan.r_mul, plan.r_shift)
    b = fast_div(row, plan.a_mul, plan.a_shift)
    a = row - b * plan.a
    src_plane = (a * plan.b + b) * plan.r + (i - row * plan.r)
    n = torch.arange(plan.n)[:, None] * plane
    src = torch.full((plan.n * plane,), -1, dtype=torch.int64)
    src[(n + i).reshape(-1)] = (n + src_plane).reshape(-1)
    writes = torch.bincount((n + i).reshape(-1), minlength=plan.n * plane)
    return src, writes


def scale_coverage(plan: ScalePlan) -> torch.Tensor:
    """Replay ``scale_kernel`` over ``plan``: how many threads write each of
    the ``head + 4·body + tail`` values."""
    numel = plan.head + 4 * plan.body + plan.tail
    body = plan.head + (4 * _grid_stride(plan.blocks, plan.body)[:, None]
                        + torch.arange(4)).reshape(-1)
    tail = plan.head + 4 * plan.body + torch.arange(plan.tail)
    return torch.bincount(torch.cat([torch.arange(plan.head), body, tail]), minlength=numel)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a build of ``csrc/probes.cu``."""
    lib.probe_mid_batch_dot.argtypes = [_P, _P, _P, ctypes.POINTER(_DotPlanC), _P]
    lib.probe_mid_batch_dot_occupancy.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.probe_mid_batch_dot_occupancy.restype = ctypes.c_int
    lib.probe_swap_leading.argtypes = [_P, _P, ctypes.POINTER(_SwapPlanC), _P]
    lib.probe_scale.argtypes = [_P, _P, ctypes.POINTER(_ScalePlanC), ctypes.c_float, _P]
    for fn in (lib.probe_mid_batch_dot, lib.probe_swap_leading, lib.probe_scale):
        fn.restype = ctypes.c_int
    return lib


_LIB = None  # csrc/probes.cu, loaded and declared once


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ccnet_tpu_torch.ops._build import load_library

        _LIB = declare(load_library("probes"))
    return _LIB


@functools.lru_cache(maxsize=256)
def _dot_launch(N: int, T: int, H: int, C: int, strides: tuple, aligned: bool) -> _DotPlanC:
    return _DotPlanC(*dot_plan(N, T, H, C, strides, aligned))


@functools.lru_cache(maxsize=256)
def _swap_launch(n: int, a: int, b: int, r: int) -> _SwapPlanC:
    return _SwapPlanC(*swap_plan(n, a, b, r))


@functools.lru_cache(maxsize=256)
def _scale_launch(numel: int, offset: int) -> _ScalePlanC:
    return _ScalePlanC(*scale_plan(numel, offset))


def _check(name: str, x: torch.Tensor, ndim: int, dtype: torch.dtype) -> str:
    """Validate one operand; return the route, ``"cpu"`` or ``"cuda"``."""
    if x.dim() != ndim or x.dtype != dtype or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name} wants a non-empty contiguous {ndim}-D {dtype} tensor, got "
                         f"{tuple(x.shape)} {x.dtype} (contiguous: {x.is_contiguous()})")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _check_pair(name: str, q: torch.Tensor, k: torch.Tensor, ndim: int) -> str:
    route = _check(name, q, ndim, torch.bfloat16)
    _check(name, k, ndim, torch.bfloat16)
    if q.shape != k.shape or q.device != k.device:
        raise ValueError(f"{name}: q {tuple(q.shape)} on {q.device} and k "
                         f"{tuple(k.shape)} on {k.device} differ")
    return route


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream(device: int) -> int:
    # the raw cudaStream_t of the current stream: torch.cuda.current_stream()
    # builds a Stream object, several microseconds of a call of ~10
    return torch._C._cuda_getCurrentRawStream(device)


# ------------------------------------------------------------ plain versions


def mid_batch_dot_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("htc,gtc->thg", q.float(), k.float())


def mid_batch_dot_4d_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhwc,bgwc->bwhg", q.float(), k.float())


def swap_leading_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(0, 1).contiguous()


def store_transposed_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def scale_ragged_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


# ------------------------------------------------------------------ kernels


def _dot(name: str, q: torch.Tensor, k: torch.Tensor, N: int, T: int, H: int, C: int,
         strides) -> torch.Tensor:
    device = q.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _dot(name, q, k, N, T, H, C, strides)
    qp, kp = q.data_ptr(), k.data_ptr()
    plan = _dot_launch(N, T, H, C, strides, qp % 16 == 0 and kp % 16 == 0)
    e = torch.empty((N, T, H, H), device=q.device, dtype=torch.float32)
    _raise_on(_lib().probe_mid_batch_dot(qp, kp, e.data_ptr(), plan, _stream(device)), name)
    return e


def dot_occupancy(warps: int, smem: int) -> int:
    """Blocks of the dot kernel of ``warps`` warps resident on one SM of the
    current card at ``smem`` bytes of dynamic shared memory (what
    ``dot_plan`` assumes is ``DOT_DESIGNS[warps]``)."""
    blocks = _I(0)
    rc = _lib().probe_mid_batch_dot_occupancy(warps, smem, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return blocks.value


def mid_batch_dot(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """P1: ``(H, T, C)`` bf16 q, k → ``(T, H, H)`` f32."""
    if _check_pair("mid_batch_dot", q, k, 3) == "cpu":
        return mid_batch_dot_plain(q, k)
    H, T, C = q.shape
    return _dot("mid_batch_dot", q, k, 1, T, H, C, (0, T * C, C))[0]


def mid_batch_dot_4d(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """P4: NHWC ``(B, H, W, C)`` bf16 q, k → ``(B, W, H, H)`` f32, the
    logits of each column's H pixels (columns read in place)."""
    if _check_pair("mid_batch_dot_4d", q, k, 4) == "cpu":
        return mid_batch_dot_4d_plain(q, k)
    B, H, W, C = q.shape
    return _dot("mid_batch_dot_4d", q, k, B, W, H, C, (H * W * C, W * C, C))


def _swap(name: str, x: torch.Tensor, N: int, A: int, Bd: int, out_shape) -> torch.Tensor:
    row_bytes = x.shape[-1] * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {row_bytes} bytes at {x.data_ptr():#x}; the "
                         f"kernel moves 16-byte chunks (C % 8 == 0, 16-byte aligned)")
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _swap(name, x, N, A, Bd, out_shape)
    plan = _swap_launch(N, A, Bd, row_bytes // 16)
    y = torch.empty(out_shape, device=x.device, dtype=x.dtype)
    _raise_on(_lib().probe_swap_leading(x.data_ptr(), y.data_ptr(), plan, _stream(device)), name)
    return y


def swap_leading(x: torch.Tensor) -> torch.Tensor:
    """P2: ``(A, B, C)`` → ``(B, A, C)`` bf16."""
    if _check("swap_leading", x, 3, torch.bfloat16) == "cpu":
        return swap_leading_plain(x)
    A, Bd, C = x.shape
    return _swap("swap_leading", x, 1, A, Bd, (Bd, A, C))


def store_transposed(x: torch.Tensor) -> torch.Tensor:
    """P5: NHWC ``(B, H, W, C)`` → column-major ``(B, W, H, C)`` bf16."""
    if _check("store_transposed", x, 4, torch.bfloat16) == "cpu":
        return store_transposed_plain(x)
    B, H, W, C = x.shape
    return _swap("store_transposed", x, B, H, W, (B, W, H, C))


def scale_ragged(x: torch.Tensor) -> torch.Tensor:
    """P3: ``2·x`` over ``(M, N)`` f32, at any 4-byte offset of x (the
    output keeps x's offset modulo 16 bytes, so both split alike)."""
    if _check("scale_ragged", x, 2, torch.float32) == "cpu":
        return scale_ragged_plain(x)
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return scale_ragged(x)
    offset = x.data_ptr() % 16 // 4
    plan = _scale_launch(x.numel(), offset)
    if offset:
        y = torch.empty(x.numel() + offset, device=x.device, dtype=x.dtype)[offset:].view(x.shape)
    else:
        y = torch.empty_like(x)
    _raise_on(_lib().probe_scale(x.data_ptr(), y.data_ptr(), plan, 2.0, _stream(device)),
              "scale_ragged")
    return y
