"""The least time of an attention call, as `PERF.md`'s kernel table counts
it: the larger of its operations at the chip's dense bf16 rate (4 B H Sq
Sk D: two products of Sq x Sk x D per head) and its operand bytes at the
memory's rate (q, k, v read once and o written once, in bf16)."""
from __future__ import annotations

BYTES = 2  # bf16, the type the port's attention kernels read and write


def attention_flops(B: int, H: int, Sq: int, Sk: int, D: int) -> float:
    return 4.0 * B * H * Sq * Sk * D


def attention_bytes(B: int, H: int, Sq: int, Sk: int, D: int) -> float:
    return float(BYTES * B * H * D * (2 * Sq + 2 * Sk))


def least_seconds(calls, peak_flops: float, bytes_per_s: float) -> float:
    """Summed least time of (B, H, Sq, Sk, D) calls."""
    return sum(max(attention_flops(*c) / peak_flops,
                   attention_bytes(*c) / bytes_per_s) for c in calls)
