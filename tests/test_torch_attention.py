"""The port's attention (videovanish_tpu_torch.ops.attention) against the
JAX package's: the plain versions of the Hopper kernels against the Pallas
kernels run in interpret mode (or `_xla_attention` where no interpret path
exists), f32, inputs from a seeded numpy generator, 1e-5 abs; and the
port's dispatch against the JAX predicates, shape by shape.

The CUDA kernels themselves run only on the card (chip_smoke.py holds each
against its plain version there).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu_torch.ops import attention as P

J = importlib.import_module("videovanish_tpu.ops.attention")

ATOL = 1e-5


def _inputs(seed, q_shape, k_shape):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal(k_shape).astype(np.float32)
    v = rng.standard_normal(k_shape).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("shape,blocks", [
    ((2, 3, 100, 150, 24), (32, 128)),   # ragged q and KV blocks
    ((1, 2, 600, 77, 40), (256, 128)),   # long query, short KV (UNet attn2)
    ((2, 2, 64, 256, 72), (64, 128)),    # Hiera stage-4 entry (q-pool)
    ((2, 2, 22, 300, 16), (32, 128)),    # SAM2 decoder token -> image
])
def test_flash_plain_matches_pallas_interpret(shape, blocks):
    B, H, Sq, Sk, D = shape
    q, k, v = _inputs(0, (B, H, Sq, D), (B, H, Sk, D))
    scale = D ** -0.5
    ref = np.asarray(J._flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        block_q=blocks[0], block_k=blocks[1], interpret=True))
    tq, tk, tv = _t(q, k, v)
    np.testing.assert_allclose(
        P.flash_attention_ref(tq, tk, tv, scale).numpy(), ref, atol=ATOL)
    # the wrapper on CPU tensors is the plain version, query-chunked too
    np.testing.assert_allclose(
        P.flash_attention_ref(tq, tk, tv, scale,
                              max_score_bytes=B * H * Sk * 4 * 7).numpy(),
        ref, atol=ATOL)
    np.testing.assert_allclose(
        P.flash_attention(tq, tk, tv, scale).numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("shape", [
    (40, 2, 22, 22, 12),
    (64, 3, 17, 30, 16),   # Sq != Sk
    (32, 4, 16, 64, 72),   # Hiera stage-2 entry: pooled q over a window
])
def test_small_seq_plain_matches_packed_interpret(shape):
    B, H, Sq, Sk, D = shape
    q, k, v = _inputs(1, (B, H, Sq, D), (B, H, Sk, D))
    scale = D ** -0.5
    ref = np.asarray(J._packed_small_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        interpret=True))
    tq, tk, tv = _t(q, k, v)
    np.testing.assert_allclose(
        P.small_seq_attention_ref(tq, tk, tv, scale).numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(
        P.small_seq_attention(tq, tk, tv, scale).numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("N,S,heads,d", [(40, 22, 4, 16), (10, 64, 2, 8),
                                         (16, 64, 2, 72)])
def test_tokenmajor_plain_matches_interpret(N, S, heads, d):
    C = heads * d
    q, k, v = _inputs(2, (N, S, C), (N, S, C))
    scale = d ** -0.5
    ref = np.asarray(J._packed_tokenmajor_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, scale,
        interpret=True))
    tq, tk, tv = _t(q, k, v)
    np.testing.assert_allclose(
        P.small_seq_attention_tokenmajor(tq, tk, tv, heads, scale).numpy(),
        ref, atol=ATOL)
    np.testing.assert_allclose(
        P.attention_tokenmajor(tq, tk, tv, heads).numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_xla_attention_d256(masked):
    """SAM2 memory attention (one 256-wide head; the iota kernel has no
    interpret path): self-attention unmasked, cross-attention to memory
    slots of which some are invalid and, for the second object, all. A
    bank with no valid key gives the uniform softmax of the -1e30 fill,
    finite, as in the JAX package."""
    q, k, v = _inputs(4, (2, 1, 64, 256), (2, 1, 200, 256))
    key_mask = None
    if masked:
        key_mask = np.random.default_rng(5).random((2, 200)) > 0.4
        key_mask[1] = False
    scale = 256 ** -0.5
    ref = np.asarray(J._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, False,
        None if key_mask is None else jnp.asarray(key_mask)))
    tq, tk, tv = _t(q, k, v)
    tm = None if key_mask is None else torch.from_numpy(key_mask)
    got = P.attention(tq, tk, tv, key_mask=tm).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if masked:
        np.testing.assert_allclose(got[1, 0], np.broadcast_to(
            v[1, 0].mean(0), (64, 256)), atol=ATOL)
    else:
        np.testing.assert_allclose(
            P.flash_attention(tq, tk, tv, scale).numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_plain_matches_xla_attention_d512(causal, masked):
    """The VAE mid-block shape class (one 512-wide head): the iota flash
    kernel has no interpret path, so `_xla_attention` is the reference."""
    q, k, v = _inputs(3, (2, 1, 200, 512), (2, 1, 200, 512))
    key_mask = None
    if masked:
        key_mask = np.ones((2, 200), bool)
        key_mask[0, 150:] = False
    scale = 512 ** -0.5
    ref = np.asarray(J._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
        None if key_mask is None else jnp.asarray(key_mask)))
    tq, tk, tv = _t(q, k, v)
    tm = None if key_mask is None else torch.from_numpy(key_mask)
    np.testing.assert_allclose(
        P.attention(tq, tk, tv, is_causal=causal, key_mask=tm).numpy(), ref,
        atol=ATOL)
    if not (causal or masked):
        np.testing.assert_allclose(
            P.flash_attention(tq, tk, tv, scale).numpy(), ref, atol=ATOL)


def test_cpu_wrappers_count_no_launch():
    q, k, v = _t(*_inputs(4, (2, 8, 22, 16), (2, 8, 22, 16)))
    P.reset_launch_counts()
    P.flash_attention(q, k, v, 0.25)
    P.small_seq_attention(q, k, v, 0.25)
    assert sum(P.LAUNCHES.values()) == 0


def test_wrappers_refuse_other_devices():
    q = torch.empty((1, 1, 32, 16), device="meta")
    with pytest.raises(ValueError):
        P.flash_attention(q, q, q, 0.25)
    with pytest.raises(ValueError):
        P.small_seq_attention(q, q, q, 0.25)


# ---------------------------------------------------------------------------
# dispatch: the JAX predicates decide, recorded by patching its kernels
# ---------------------------------------------------------------------------
class _Shape:
    """Shape-only stand-in for an array (the dispatch reads shapes)."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def reshape(self, *shape):
        return _Shape(shape)

    def transpose(self, *axes):
        return _Shape(self.shape[a] for a in axes)


def _jax_route(monkeypatch, on_tpu, call):
    seen = []

    def rec(name):
        def f(q, *a, **k):
            seen.append(name)
            return q
        return f

    monkeypatch.setattr(J, "_use_pallas", lambda: on_tpu)
    monkeypatch.setattr(J, "_flash_attention", rec("flash"))
    monkeypatch.setattr(J, "_packed_small_attention_tpu", rec("packed"))
    monkeypatch.setattr(J, "_packed_small_attention", rec("packed"))
    monkeypatch.setattr(J, "_packed_tokenmajor_tpu", rec("tokenmajor"))
    monkeypatch.setattr(J, "_xla_attention", rec("plain"))
    call()
    assert len(seen) == 1
    return seen[0]


ATTN_SHAPES = [  # (B, H, Sq, Sk, D), causal, masked
    ((22, 8, 8160, 8160, 40), False, False),   # UNet attn1, level 0
    ((22, 8, 8160, 77, 40), False, False),     # UNet attn2, level 0
    ((22, 8, 2040, 77, 80), False, False),     # UNet attn2, level 1
    ((22, 8, 510, 77, 160), False, False),     # UNet attn2, level 2
    ((22, 8, 510, 510, 160), False, False),    # UNet attn1, level 2
    ((22, 8, 135, 135, 160), False, False),    # mid block at 544x960
    ((8, 1, 8160, 8160, 512), False, False),   # VAE mid block
    ((4096, 8, 22, 22, 40), False, False),     # temporal, (B,H,S,D) form
    ((256, 4, 17, 30, 16), False, False),      # packed, Sq != Sk
    ((6, 2, 22, 22, 8), False, False),         # short, small batch
    ((1024, 1, 256, 256, 72), False, False),   # Hiera windows
    ((1024, 4, 16, 16, 72), False, False),     # S below the packed range
    # SAM2 at 1024x1024, 8-frame encode chunks and 2 objects
    ((8192, 4, 16, 64, 72), False, False),     # Hiera stage-2 entry
    ((1024, 4, 16, 64, 72), False, False),     # the same, one frame
    ((8192, 8, 4, 16, 72), False, False),      # Hiera stage-3 entry
    ((128, 8, 256, 256, 72), False, False),    # Hiera stage-3 windows
    ((8, 8, 4096, 4096, 72), False, False),    # Hiera global blocks
    ((128, 16, 64, 256, 72), False, False),    # Hiera stage-4 entry
    ((2, 1, 4096, 4096, 256), False, False),   # memory self-attention
    ((2, 1, 4096, 28736, 256), False, True),   # memory cross-attention
    ((2, 8, 22, 4096, 16), False, False),      # decoder token -> image
    ((2, 8, 4096, 22, 16), False, True),       # decoder image -> token
    ((2, 8, 22, 22, 32), False, True),         # decoder token self-attn
    ((2, 8, 600, 600, 40), True, False),       # causal
    ((2, 8, 600, 600, 40), False, True),       # key mask
]


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("shape,causal,masked", ATTN_SHAPES)
def test_attention_route_matches_jax(monkeypatch, shape, causal, masked,
                                     on_card):
    B, H, Sq, Sk, D = shape
    q, k = _Shape((B, H, Sq, D)), _Shape((B, H, Sk, D))
    key_mask = _Shape((B, Sk)) if masked else None
    want = _jax_route(monkeypatch, on_card, lambda: J.attention(
        q, k, k, is_causal=causal, key_mask=key_mask))
    assert P.attention_route(q.shape, k.shape, on_card, causal,
                             masked) == want


TM_SHAPES = [  # (N, S, C, heads)
    (8160, 22, 320, 8),    # temporal, level 0 at 544x960
    (135, 22, 1280, 8),    # temporal, level 3
    (4096, 22, 320, 8),    # 512x512: J = 5 does not divide N
    (30, 22, 64, 4),       # N / J < 8
    (22, 64, 1280, 8),     # mid-block spatial attention at 512x512
    (8, 4096, 32, 1),      # VAE mid block (long S)
    (64, 16, 64, 4),       # S below the packed range
    # Hiera at 1024x1024
    (8192, 64, 144, 2),    # stage 1, 8-frame chunk
    (1024, 64, 144, 2),    # stage 1, one frame
    (8192, 16, 288, 4),    # stage 2 (S = 16: plain)
    (128, 256, 576, 8),    # stage 3 windows (flash)
    (8, 4096, 576, 8),     # stage 3 global blocks (flash)
    (128, 64, 1152, 16),   # stage 4, 8-frame chunk
    (16, 64, 1152, 16),    # stage 4, one frame: N / J = 8, the edge
    (14, 64, 1152, 16),    # N / J = 7, just below it
]


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("N,S,C,heads", TM_SHAPES)
def test_tokenmajor_route_matches_jax(monkeypatch, N, S, C, heads, on_card):
    q = _Shape((N, S, C))
    want = _jax_route(monkeypatch, on_card,
                      lambda: J.attention_tokenmajor(q, q, q, heads))
    assert P.tokenmajor_route(q.shape, heads, on_card) == want
