"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODE[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}") from None


def weight_dtype(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    """The weights' dtype a layer kernel takes beside x: x's own, or bf16
    beside an f32 x (the JAX kernels' mixed pair of a layer whose
    parameters are bf16 and whose input is f32: f32 products of the bf16
    weights, the output in x's dtype, each weight gradient in the weights'
    dtype, its tiles' f32 partials rounded to bf16 as they are walked)."""
    if w.dtype == x.dtype or (x.dtype == torch.float32
                              and w.dtype == torch.bfloat16):
        return w.dtype
    raise TypeError(f"the layer kernels take weights in x's dtype or bf16 "
                    f"weights beside an f32 x; got x {x.dtype}, weights "
                    f"{w.dtype}")


def widened(x: torch.Tensor, *ts: torch.Tensor):
    """ts in x's dtype: the mixed pair's bf16 weights widened to f32 for
    the kernels' f32 products (exact: the JAX kernels' `jnp.dot(f32, bf16)`
    promotes the weights the same way)."""
    return tuple(t if t.dtype == x.dtype else t.to(x.dtype) for t in ts)


def check_cuda(name: str, t: torch.Tensor, dtype=None, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given dtype and
    shape (None entries of `shape` match any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None:
        if t.dim() != len(shape) or any(
                s is not None and s != a for s, a in zip(shape, t.shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when 16-byte aligned (the kernels load 16 bytes at once),
    else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# --- weight gradients summed over the JAX backward's row tiles --------------
#
# A JAX layer backward adds one f32 partial per row tile of its sequential
# grid into a gradient held in the weights' dtype (`dw_ref +=
# partial.astype(dw.dtype)`): in bf16 a running sum in which each partial,
# then the sum, is rounded after every tile. The port's kernels write the
# tiles' partials (already rounded: exact, since the walk rounds them first)
# and walk them in tile order (csrc/kan_common.cuh `walk_tiles`), in windows
# of at most WALK_WINDOW_BYTES of scratch that carry the running sum.

WALK_WINDOW_BYTES = 128 * 2 ** 20


def dw_tile(n: int, tile: int = 512) -> int:
    """The JAX backward's row tile: `_tile_for(n, tile)` of
    `kagnn_tpu/pallas/rbf_fused.py`, halved while above 256 rows and above
    twice n."""
    while tile > 256 and tile > 2 * n:
        tile //= 2
    return tile


def round_to(t: torch.Tensor, dtype) -> torch.Tensor:
    """f32 t rounded to `dtype` and back (no-op for f32)."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def tile_partials(a: torch.Tensor, b: torch.Tensor, tile: int):
    """The f32 partials a[r:r+tile]^T @ b[r:r+tile] of each row tile, in
    tile order."""
    a, b = a.float(), b.float()
    return (a[r:r + tile].T @ b[r:r + tile] for r in range(0, a.shape[0], tile))


def walk_tiles(parts, shape, dtype, device) -> torch.Tensor:
    """The JAX running sum of per-tile f32 partials: s = round(s + round(p))
    in `dtype`, tile by tile, from zeros. Returns f32."""
    s = torch.zeros(shape, dtype=torch.float32, device=device)
    for p in parts:
        s = round_to(s + round_to(p, dtype), dtype)
    return s


def tiled_gram(a: torch.Tensor, b: torch.Tensor, tile: int, dtype) -> torch.Tensor:
    """a^T @ b summed over row tiles as the JAX backward sums it, in
    `dtype`."""
    return walk_tiles(tile_partials(a, b, tile), (a.shape[1], b.shape[1]),
                      dtype, a.device).to(dtype)


def walk_window(tiles: int, m: int, elem_bytes: int) -> int:
    """Tiles of partials (m elements each) that one window of the walk
    holds."""
    return max(1, min(tiles, WALK_WINDOW_BYTES // max(1, m * elem_bytes)))


def segment_ids(row_ptr: torch.Tensor) -> torch.Tensor:
    """Row of each CSR entry: row_ptr (n+1,) -> (row_ptr[-1],) int64."""
    n = row_ptr.numel() - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device), counts)


# --- GAT (kernels/gat_fused.py, kernels/gat_bwd.py) -------------------------

# csrc/gat_common.cuh kMaxP: slots of 8 columns a head (C up to 2,048); a
# row of more than 8 passes of 32 slots is walked in groups of 8
GAT_MAX_HEAD_SLOTS = 256
# csrc/gat_common.cuh kPiece: a receiver row of more valid edges is split
# into pieces of the edges' chunks of GAT_PIECE
GAT_PIECE = 64


def gat_chunks(n_edge: int) -> int:
    """Chunks of GAT_PIECE edges that the valid edges make (the split's
    scratch holds two piece slots a chunk)."""
    return -(-int(n_edge) // GAT_PIECE)


def gat_head_slots(c: int) -> int:
    """Slots of 8 columns a GAT head of C columns takes
    (csrc/gat_common.cuh): the power of two >= ceil(C / 8)."""
    p = 1
    while p * 8 < c:
        p *= 2
    return p


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def dleaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, slope)


def gat_edges(row_ptr: torch.Tensor, idx: torch.Tensor, n_edge: int):
    """The valid edges of a CSR walk as (row, gathered index), int64: the
    padded edges are the tail [n_edge, E) of both the receiver and the
    sender order (their index n_pad - 1 is the largest), so the first
    n_edge entries are exactly the valid ones."""
    return segment_ids(row_ptr)[:n_edge], idx[:n_edge].long()


def check_gat(h: torch.Tensor, asrc: torch.Tensor, adst: torch.Tensor):
    """Shapes and types the GAT kernels take -> (n, H, C): h (N, H*C) f32
    or bf16 with any number of heads of 1 <= C <= 2,048 columns (at most
    GAT_MAX_HEAD_SLOTS slots of 8 a head), rows 16-byte aligned when C is a
    multiple of 8; asrc, adst (N, H) f32."""
    check_cuda("h", h, shape=(None, None))
    n, hc = h.shape
    heads = asrc.shape[1] if asrc.dim() == 2 else 0
    check_cuda("asrc", asrc, torch.float32, (n, heads))
    check_cuda("adst", adst, torch.float32, (n, heads))
    c = hc // max(heads, 1)
    if (heads == 0 or c == 0 or heads * c != hc
            or gat_head_slots(c) > GAT_MAX_HEAD_SLOTS):
        raise ValueError(f"the GAT kernels take H heads of 1 <= C <= "
                         f"{8 * GAT_MAX_HEAD_SLOTS} columns; got {hc} columns "
                         f"for {heads} heads")
    if c % 8 == 0 and h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned")
    return n, heads, c
