"""Batched raw CRC32C images as GF(2) bit-matmuls: the plain version of
the CRC that the fused CUDA kernel (rs_cuda.fused_apply_crc) computes.

For a chunk M the raw image g(M) = raw_update(0, M) is GF(2)-linear in
M's bits, so:

  1. split M into a power-of-two count of segments; each segment's g is a
     bit-matmul against a precomputed (8*seg, 32) matrix W with
     W[b*seg + j] = Adv_{seg-1-j}(T[1 << b]);
  2. fold adjacent segments with a log-tree of 32x32 advance matrices:
     g(A||B) = Adv_|B|(g(A)) ^ g(B);
  3. the host finalizes: crc32c(M) = g(M) ^ crc32c_zeros(len(M)).

Leading zeros leave g unchanged (state 0 is a fixed point of zero bytes),
so a chunk is padded at the front to nseg * seg for free.

PyTorch has no integer matmul on CUDA, so the products run in float32:
every term is 0 or 1 and each sum is at most 8 * seg, exact in float32
while 8 * seg < 2**24 (chunks up to 512 MiB).  TF32 would round those
sums, so the float32 matmuls here run with TF32 off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import crc32c as crc_host


def _plan_segments(length: int) -> tuple[int, int]:
    """(nseg, seg): nseg a power of two <= 256, nseg * seg >= length,
    with kiB-scale segments."""
    if length <= 0:
        raise ValueError(f"chunk length must be positive, got {length}")
    nseg = 1
    while nseg < 256 and (length + nseg - 1) // nseg > 1024:
        nseg *= 2
    return nseg, (length + nseg - 1) // nseg


@functools.lru_cache(maxsize=32)
def _segment_matrix(seg: int) -> np.ndarray:
    """W (8*seg, 32) int8 in bit-plane-major row order: row b*seg + j is
    g of byte (1 << b) at offset j of a seg-byte segment."""
    t0 = crc_host.tables()[0]
    rows = np.stack([crc_host.bits_of(int(t0[1 << b])) for b in range(8)])
    a1t = crc_host.advance_one().T.astype(np.int64)
    out = np.zeros((seg, 8, 32), dtype=np.uint8)
    cur = rows.astype(np.int64)
    for d in range(seg):
        out[seg - 1 - d] = cur
        if d + 1 < seg:
            cur = cur @ a1t % 2
    return np.ascontiguousarray(
        out.transpose(1, 0, 2).reshape(8 * seg, 32)).astype(np.int8)


@functools.lru_cache(maxsize=32)
def _tree_matrices(seg: int, nseg: int) -> tuple[np.ndarray, ...]:
    """Transposed advance matrices per fold level: level k merges nodes of
    seg * 2^k bytes, advancing the left node over the right one."""
    mats = []
    width = seg
    m = nseg
    while m > 1:
        mats.append(crc_host.advance_matrix(width).T.astype(np.int8))
        width *= 2
        m //= 2
    return tuple(mats)


def _gf2_matmul(a: torch.Tensor, b: np.ndarray) -> torch.Tensor:
    """(a @ b) mod 2 for 0/1 operands, exact in float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.from_numpy(np.ascontiguousarray(b)).to(a.device, torch.float32)
    return torch.matmul(a.to(torch.float32), w).to(torch.int64) & 1


def batched_crc32c_raw(data: torch.Tensor) -> torch.Tensor:
    """Raw CRC images g(M) for a batch of chunks: (..., L) uint8 ->
    (...,) int64 holding the uint32 values."""
    length = data.shape[-1]
    nseg, seg = _plan_segments(length)
    pad = nseg * seg - length
    lead = data.shape[:-1]
    if pad:
        data = torch.cat([data.new_zeros(*lead, pad), data], dim=-1)
    x = data.reshape(*lead, nseg, 1, seg)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((x >> shifts[:, None]) & 1).reshape(*lead, nseg, 8 * seg)
    state = _gf2_matmul(bits, _segment_matrix(seg))
    return combine_tree(state, seg, nseg)


def combine_tree(state: torch.Tensor, seg: int, nseg: int) -> torch.Tensor:
    """Fold per-segment 0/1 bit images (..., nseg, 32) into whole-chunk
    raw values (...,) int64."""
    for advt in _tree_matrices(seg, nseg):
        state = _gf2_matmul(state[..., 0::2, :], advt) ^ state[..., 1::2, :]
    weights = torch.ones(32, dtype=torch.int64, device=state.device) \
        << torch.arange(32, device=state.device)
    return (state[..., 0, :].to(torch.int64) * weights).sum(dim=-1)


def finalize(raw, length: int) -> np.ndarray:
    """Host finalize: standard CRC32C (uint32) from raw images."""
    if isinstance(raw, torch.Tensor):
        raw = raw.cpu().numpy()
    z = np.uint32(crc_host.crc32c_zeros(length))
    return np.asarray(raw).astype(np.uint32) ^ z
