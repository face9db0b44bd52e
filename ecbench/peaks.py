"""Published peaks of the cards a run may land on, and the bytes a kernel
call has to move.

HBM bandwidth from NVIDIA's data sheets (dense rates, full power limit):
the H100 SXM5 (80 GB HBM3) 3.35 TB/s, the H100 PCIe (80 GB HBM2e)
2.0 TB/s.  A card not listed gets no roofline share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def k1_bytes(p: int, d: int, length: int) -> int:
    """One K1 launch, out (p, L) = M (p, d) x X (d, L) over GF(2^8): each
    input byte read once (the d rows and the p x d matrix), each output
    byte written once."""
    return (d + p) * length + p * d


def roofline_share(ctx: dict, label: str, kernel: str) -> float | None:
    """100 x (least time the card's HBM allows for the recorded calls of
    `label`) / (device time of `kernel` in the traced window), or None
    where there is nothing to read."""
    tl = ctx.get("trace")
    calls = ctx.get("kernel_calls", {}).get(label)
    bw = HBM_BYTES_PER_S.get(ctx["device"].get("kind"))
    if not tl or not calls or not bw:
        return None
    seconds = tl["device_ops"].get(kernel, 0.0)
    if seconds <= 0:
        return None
    moved = sum(k1_bytes(p, d, n) for p, d, n in calls)
    return 100.0 * moved / bw / seconds
