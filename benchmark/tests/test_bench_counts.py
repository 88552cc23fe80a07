"""The counts behind `mfu.*` and `attn_roofline.*` against hand counts."""
import pytest
import torch

from benchmark.counts.model import Counter
from benchmark.counts.roofline import (
    attention_bytes, attention_flops, least_seconds,
)
from benchmark.reference.vvref.ops.attention import attention

from .helpers import tiny_spec, tiny_workload


def test_counter_counts_products_by_hand():
    lin = torch.nn.Linear(16, 32)
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    q = torch.randn(2, 3, 5, 4)
    k = torch.randn(2, 3, 7, 4)
    c = Counter()
    with torch.no_grad(), c.counting():
        lin(torch.randn(4, 16))
        conv(torch.randn(1, 3, 10, 10))
        c.part = "attn"
        attention(q, k, k)
    assert c.attention == {"attn": [(2, 3, 5, 7, 4)]}
    assert c.flops == 2 * 4 * 16 * 32 + 2 * 8 * 3 * 9 * 100 \
        + 4 * 2 * 3 * 5 * 7 * 4


def test_least_time_by_hand():
    call = (1, 1, 1024, 1024, 64)
    assert attention_flops(*call) == 4 * 1024 * 1024 * 64
    assert attention_bytes(*call) == 2 * 64 * 4 * 1024
    assert least_seconds([call, call], 989e12, 3.35e12) == pytest.approx(
        2 * 4 * 1024 * 1024 * 64 / 989e12)
    small = (1, 1, 8, 8, 64)  # bound by its bytes
    assert least_seconds([small], 989e12, 3.35e12) == pytest.approx(
        2 * 64 * 32 / 3.35e12)


def test_infill_counts_at_tiny_config():
    """At tiny_config on a 8x64x96 clip the VAE's mid-block attention (one
    head of 32 over the 8x12 latent tokens) runs once per 8-frame encode of
    the masked frames and of the prior, and once per 8-frame decode: three
    (8, 1, 96, 96, 32) calls in DiffuEraser's part."""
    from benchmark.entries.infill import Entry
    d = Entry(tiny_spec(), tiny_workload("infill.720p.24f", 8), 5, "cpu",
               program=False)
    import numpy as np
    d.pool_from(np.random.default_rng(5))
    *_, counts = d.reference(0, count=True)
    calls = counts["attention"]["diffueraser"]
    assert calls.count((8, 1, 96, 96, 32)) == 3
    assert counts["flops"] > sum(attention_flops(*c) for c in calls) > 0
