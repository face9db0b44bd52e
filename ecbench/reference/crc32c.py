"""Plain CRC32C (Castagnoli) reference, batched over many messages.

The CRC is the reflected polynomial 0x82F63B78 with the register started
at 0xFFFFFFFF and inverted at the end, so crc32c(b"123456789") is
0xE3069283.  `crc32c_many` computes the CRCs of many messages at once with
plain PyTorch operations on any device: each message is cut into lanes of
LANE bytes (zeros in front of the first lane, which a register at zero
ignores), one byte of every lane goes through the byte table per step, and
the lanes' registers are folded together with the linear operator that
appends zero bytes (the method of zlib's crc32_combine).  It imports
nothing of the system under test.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x82F63B78
MASK = 0xFFFFFFFF
LANE = 256              # bytes per lane; a power of two
GROUP_BYTES = 256 << 20  # bytes of messages folded in one pass


@functools.lru_cache(maxsize=1)
def _byte_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.int64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        t[i] = c
    return t


def _apply_op(cols: list, x: int) -> int:
    out = 0
    for i in range(32):
        if (x >> i) & 1:
            out ^= cols[i]
    return out


@functools.lru_cache(maxsize=1)
def _zero_ops() -> list:
    """_zero_ops()[b]: the 32 columns of the operator that appends 2**b
    zero bytes to a register, for b in 0..47."""
    table = _byte_table()
    one = []
    for i in range(32):
        c = 1 << i
        one.append(int(table[c & 0xFF]) ^ (c >> 8))
    ops = [one]
    for _ in range(47):
        prev = ops[-1]
        ops.append([_apply_op(prev, c) for c in prev])
    return ops


def _apply_tensor(cols: list, s: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(s)
    for i in range(32):
        out ^= ((s >> i) & 1) * cols[i]
    return out


def _shift(s: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """Append nbytes[k] zero bytes to register s[k] (int64 tensors)."""
    ops = _zero_ops()
    top = int(nbytes.max().item()) if nbytes.numel() else 0
    b = 0
    while (1 << b) <= top:
        bit = ((nbytes >> b) & 1).bool()
        if bool(bit.any()):
            s = torch.where(bit, _apply_tensor(ops[b], s), s)
        b += 1
    return s


def _raw0_group(msgs: list, device) -> torch.Tensor:
    """The zero-started register after each message of `msgs` (1-D uint8
    tensors), as an int64 tensor."""
    lanes = [-(-m.numel() // LANE) for m in msgs]
    total = sum(lanes)
    if total == 0:
        return torch.zeros(len(msgs), dtype=torch.int64, device=device)
    flat = torch.zeros(total * LANE, dtype=torch.uint8, device=device)
    owner = torch.empty(total, dtype=torch.int64)
    ahead = torch.empty(total, dtype=torch.int64)
    at = 0
    for i, (m, n) in enumerate(zip(msgs, lanes)):
        pad = n * LANE - m.numel()
        flat[at * LANE + pad:(at + n) * LANE] = m.to(device)
        owner[at:at + n] = i
        ahead[at:at + n] = torch.arange(n - 1, -1, -1) * LANE
        at += n
    cols = flat.view(total, LANE).t().contiguous()
    del flat
    table = torch.from_numpy(_byte_table()).to(device)
    s = torch.zeros(total, dtype=torch.int64, device=device)
    for j in range(LANE):
        s = table[(s ^ cols[j].long()) & 0xFF] ^ (s >> 8)
    del cols
    s = _shift(s, ahead.to(device))
    out = torch.zeros(len(msgs), dtype=torch.int64, device=device)
    owner = owner.to(device)
    for b in range(32):
        bits = torch.zeros(len(msgs), dtype=torch.int64, device=device)
        bits.index_add_(0, owner, (s >> b) & 1)
        out |= (bits & 1) << b
    return out


def crc32c_many(msgs: list, device=None, init: list = None) -> list:
    """CRC32C of each message (bytes, numpy uint8 arrays or uint8
    tensors), each continued from init[i] (default 0, a fresh CRC)."""
    dev = torch.device(device or "cpu")
    tensors = []
    for m in msgs:
        if isinstance(m, torch.Tensor):
            tensors.append(m.reshape(-1))
        else:
            tensors.append(torch.from_numpy(
                np.frombuffer(bytes(m), dtype=np.uint8).copy()))
    # cut each message into pieces of at most GROUP_BYTES, fold groups of
    # pieces, then join each message's pieces in order
    pieces, whose = [], []
    for i, t in enumerate(tensors):
        if t.numel() == 0:
            continue
        for p0 in range(0, t.numel(), GROUP_BYTES):
            pieces.append(t[p0:p0 + GROUP_BYTES])
            whose.append(i)
    raw = []
    group, size = [], 0
    for p in pieces + [None]:
        if p is None or (group and size + p.numel() > GROUP_BYTES):
            raw.extend(_raw0_group(group, dev).tolist() if group else [])
            group, size = [], 0
        if p is not None:
            group.append(p)
            size += p.numel()
    ops = _zero_ops()
    regs = [(~(init[i] if init else 0)) & MASK for i in range(len(tensors))]
    for (i, p), r in zip(zip(whose, pieces), raw):
        n, reg, b = p.numel(), regs[i], 0
        while n >> b:
            if (n >> b) & 1:
                reg = _apply_op(ops[b], reg)
            b += 1
        regs[i] = reg ^ int(r)
    return [(~r) & MASK for r in regs]


def crc32c(data, crc: int = 0, device=None) -> int:
    """CRC32C of one message, continued from `crc`."""
    return crc32c_many([data], device=device, init=[crc])[0]
