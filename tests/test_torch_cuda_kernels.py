"""The port's CUDA kernels against their plain versions on the card, at
shapes the main path does not reach (ragged tiles, Sq != Sk, head dims
padded up to a built one, strided views). Marked `cuda`: they skip without
a CUDA device. This file imports nothing of JAX, so on a machine with a
card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from videovanish_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda
TOL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _close(got, ref):
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL * ref.abs().max().item(), err


def _each(cases, check):
    """check(*case) for every case; fails naming each case that failed.
    Edge cases of one kernel instance run as one test: the count of
    collected tests sets how pytest-xdist splits the suite among workers."""
    bad = []
    for case in cases:
        try:
            check(*case)
        except AssertionError as e:
            bad.append(f"{case}: {e}")
    assert not bad, "\n".join(bad)


def _flash_check(q, k, v):
    D = q.shape[-1]
    n = sum(A.LAUNCHES.values())
    got = A.flash_attention(q, k, v, D ** -0.5)
    assert sum(A.LAUNCHES.values()) == n + 1
    assert bool(torch.isfinite(got).all())
    _close(got, A.flash_attention_ref(q.float(), k.float(), v.float(),
                                      D ** -0.5))


def test_flash_matches_plain(gen):
    def check(B, H, Sq, Sk, D):
        _flash_check(_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                     _randn(gen, B, H, Sk, D))
    _each([(2, 3, 100, 150, 40), (1, 2, 600, 77, 40), (3, 2, 65, 64, 72),
           (2, 1, 1000, 1, 80), (1, 4, 17, 333, 152), (2, 2, 130, 200, 160),
           (1, 2, 70, 90, 504), (2, 1, 129, 257, 512),
           # the training step under a "model" split of 2 and 4: 8 / model
           # heads at the 40x40 latents' levels (self and text attention)
           (2, 4, 1600, 1600, 40), (2, 2, 1600, 77, 40),
           (2, 4, 400, 77, 80), (2, 2, 400, 400, 80),
           # Wan's DiT (12 heads of 128: self-attention, cross-attention
           # to 512 text rows) and its VAE's mid-block (one 384-wide head)
           (2, 12, 1300, 1300, 128), (2, 12, 1000, 512, 128),
           (1, 1, 6032, 6032, 384), (3, 1, 700, 500, 384)], check)


# the flash kernel's tile edges: 64 query rows per consumer warpgroup, 192
# per CTA at D = 40, 128 at D = 80/128/160, 64 at D = 384/512; key tiles of
# 128 (D <= 128) or 64 (D = 160, 384, 512)
def test_flash_query_tile_edges(gen):
    def check(D, Sq):
        B, H, Sk = (2, 3, 90) if D < 384 else (1, 1, 90)
        _flash_check(_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                     _randn(gen, B, H, Sk, D))
    _each([(D, Sq) for D in (40, 128, 160, 384, 512)
           for Sq in (1, 63, 64, 65, 127, 128, 129, 191, 192, 193)], check)


def test_flash_key_tile_edges(gen):
    def check(D, Sk):
        B, H, Sq = (1, 2, 150) if D < 384 else (1, 1, 70)
        _flash_check(_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                     _randn(gen, B, H, Sk, D))
    _each([(D, Sk) for D in (40, 80, 128, 384, 512)
           for Sk in (1, 2, 63, 64, 65, 100, 127, 128, 129, 257)], check)


def test_flash_last_head_of_token_major_storage(gen):
    """q/k/v are head splits of (B, S, H+1, D) storage with the extra head
    dropped, so the bytes past each head's D (and past the last head) hold
    other data: the kernel must read none of them."""
    def check(D):
        B, H, Sq, Sk = (2, 4, 200, 300) if D < 500 else (2, 1, 130, 200)

        def view(S):
            return _randn(gen, B, S, H + 1, D)[:, :, :H].permute(0, 2, 1, 3)
        _flash_check(view(Sq), view(Sk), view(Sk))
    _each([(D,) for D in (40, 72, 80, 128, 152, 160, 384, 504, 512)],
          check)


def test_flash_rows_far_below_the_rest(gen):
    """Rows whose scores all lie far below those of other rows (and one row
    far above): the per-row max keeps every exponent near 0, so the sums
    stay finite and nonzero."""
    def check(D):
        B, H, Sq, Sk = 1, 2, 140, 300
        u = torch.ones(D, device="cuda", dtype=torch.bfloat16)
        k = _randn(gen, B, H, Sk, D) + 4 * u
        q = _randn(gen, B, H, Sq, D)
        q[:, :, :5] -= 6 * u
        q[:, :, 7] += 6 * u
        _flash_check(q, k, _randn(gen, B, H, Sk, D))
    _each([(D,) for D in (40, 128, 160, 384, 512)], check)


def test_small_seq_matches_plain(gen):
    def check(B, H, Sq, Sk, D):
        q, k, v = (_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                   _randn(gen, B, H, Sk, D))
        got = A.small_seq_attention(q, k, v, D ** -0.5)
        _close(got, A.small_seq_attention_ref(q.float(), k.float(),
                                              v.float(), D ** -0.5))
    _each([(5, 3, 22, 22, 40), (7, 2, 17, 30, 48), (3, 4, 64, 64, 160),
           (9, 1, 33, 1, 80), (4, 2, 1, 64, 48), (2, 8, 64, 17, 152)],
          check)


def test_tokenmajor_matches_plain(gen):
    def check(N, S, heads, d):
        q, k, v = (_randn(gen, N, S, heads * d) for _ in range(3))
        got = A.small_seq_attention_tokenmajor(q, k, v, heads, d ** -0.5)

        def split(t):
            return t.view(N, S, heads, d).permute(0, 2, 1, 3).float()

        ref = A.small_seq_attention_ref(split(q), split(k), split(v),
                                        d ** -0.5)
        _close(got.view(N, S, heads, d).permute(0, 2, 1, 3), ref)
    _each([(40, 22, 8, 40), (10, 64, 2, 72)], check)


def _small_check(q, k, v):
    """small_seq_attention on (B, H, S, D) views: one launch, finite, within
    TOL of the plain version; returns the output."""
    D = q.shape[-1]
    n = sum(A.LAUNCHES.values())
    got = A.small_seq_attention(q, k, v, D ** -0.5)
    assert sum(A.LAUNCHES.values()) == n + 1
    assert bool(torch.isfinite(got).all())
    _close(got, A.small_seq_attention_ref(q.float(), k.float(), v.float(),
                                          D ** -0.5))
    return got


def _split(t, heads):
    N, S, C = t.shape
    return t.view(N, S, heads, C // heads).permute(0, 2, 1, 3)


# the kernel pads S to 16-row steps: 1, 2, 3 or 4 steps, each edge, with
# Sq = Sk and with Sk = 65 - Sq
def test_small_seq_length_edges(gen):
    B, H = 6, 3
    _each([(D, Sq, Sk) for D in (40, 160)
           for Sq in (1, 16, 17, 22, 31, 32, 33, 63, 64)
           for Sk in (Sq, 65 - Sq)],
          lambda D, Sq, Sk: _small_check(_randn(gen, B, H, Sq, D),
                                         _randn(gen, B, H, Sk, D),
                                         _randn(gen, B, H, Sk, D)))


# units are one sequence times up to 8 heads; one persistent CTA per SM:
# sequence counts below the CTA count, a count that leaves the last CTA
# short, and head counts that do not fill a unit
def test_small_seq_tokenmajor_counts(gen):
    def check(N, heads, d):
        S = 22
        q, k, v = (_randn(gen, N, S, heads * d) for _ in range(3))
        n = sum(A.LAUNCHES.values())
        got = A.small_seq_attention_tokenmajor(q, k, v, heads, d ** -0.5)
        assert sum(A.LAUNCHES.values()) == n + 1
        ref = A.small_seq_attention_ref(_split(q, heads).float(),
                                        _split(k, heads).float(),
                                        _split(v, heads).float(), d ** -0.5)
        _close(_split(got, heads), ref)
    _each([(1, 8, 40), (3, 8, 160), (135, 8, 160), (135, 8, 40), (7, 3, 40),
           (5, 1, 80), (301, 5, 72)], check)


def test_small_seq_last_head_of_token_major_storage(gen):
    """q/k/v are head splits of (N, S, H+1, D) storage with the extra head
    dropped, so the bytes past each head's D (and past the last head) hold
    other data: the kernel must read none of them, and must write nothing
    but the output's own heads."""
    N, H = 37, 4

    def check(S, D):
        def view():
            return _randn(gen, N, S, H + 1, D)[:, :, :H].permute(0, 2, 1, 3)
        q, k, v = view(), view(), view()
        out = torch.full((N, S, H + 1, D), 7.0, device="cuda",
                         dtype=torch.bfloat16)
        n = sum(A.LAUNCHES.values())
        A._small_seq(q, k, v, out[:, :, :H].permute(0, 2, 1, 3), D ** -0.5,
                     "bhsd")
        assert sum(A.LAUNCHES.values()) == n + 1
        _close(out[:, :, :H].permute(0, 2, 1, 3),
               A.small_seq_attention_ref(q.float(), k.float(), v.float(),
                                         D ** -0.5))
        assert bool((out[:, :, H] == 7.0).all())
    _each([(S, D) for S in (22, 64) for D in (40, 72, 80, 152, 160)], check)


def test_small_seq_head_dims_and_layouts(gen):
    B, H, S = 50, 8, 22

    def check(layout, D):
        if layout == "contiguous":
            q, k, v = (_randn(gen, B, H, S, D) for _ in range(3))
        else:
            q, k, v = (_split(_randn(gen, B, S, H * D), H) for _ in range(3))
        _small_check(q, k, v)
    _each([(layout, D) for layout in ("contiguous", "head_split")
           for D in (40, 72, 80, 152, 160)], check)


def test_small_seq_rows_far_below_the_rest(gen):
    """Rows whose scores all lie far below those of other rows (and one row
    far above): the per-row max keeps every exponent near 0."""
    def check(S, D):
        B, H = 9, 8
        u = torch.ones(D, device="cuda", dtype=torch.bfloat16)
        k = _randn(gen, B, H, S, D) + 4 * u
        q = _randn(gen, B, H, S, D)
        q[:, :, :5] -= 6 * u
        q[:, :, 7] += 6 * u
        _small_check(q, k, _randn(gen, B, H, S, D))
    _each([(S, D) for S in (22, 64) for D in (40, 160)], check)


def test_small_seq_is_deterministic(gen):
    def check(N, S, d):
        heads = 8
        q, k, v = (_randn(gen, N, S, heads * d) for _ in range(3))
        a = A.small_seq_attention_tokenmajor(q, k, v, heads, d ** -0.5)
        b = A.small_seq_attention_tokenmajor(q, k, v, heads, d ** -0.5)
        assert torch.equal(a, b)
    _each([(2040, 22, 80), (22, 64, 160)], check)


def test_kernels_refuse_bad_operands(gen):
    q = _randn(gen, 1, 2, 64, 40)
    with pytest.raises(TypeError):
        A.flash_attention(q.float(), q.float(), q.float(), 0.1)
    with pytest.raises(ValueError):
        A.flash_attention(q[..., :36], q[..., :36], q[..., :36], 0.1)
    wide = _randn(gen, 1, 2, 64, 192)
    with pytest.raises(ValueError):
        A.flash_attention(wide, wide, wide, 0.1)  # no build for D = 192
    long = _randn(gen, 1, 2, 65, 40)
    with pytest.raises(ValueError):
        A.small_seq_attention(long, long, long, 0.1)  # S above 64
    wide = _randn(gen, 1, 2, 22, 256)
    with pytest.raises(ValueError):
        A.small_seq_attention(wide, wide, wide, 0.1)  # no build for D = 256


# SAM2's flash instances: D = 16 (the mask decoder's token-to-image
# attention, 22 queries over 4096 image tokens; one consumer warpgroup,
# 64-row query tiles, 128-key tiles) and D = 256 (memory self-attention,
# one head; two warpgroups share 64 query rows, 64-key tiles; and memory
# cross-attention over the bank's valid keys, v slots of 4096 grid tokens
# then 4 tokens a pointer: 7 x 4096 + 64 when full, 4096 + 4 on the
# second frame)
def test_flash_sam2_query_tile_edges(gen):
    def check(D, Sq):
        B, H, Sk = (2, 8, 300) if D == 16 else (2, 1, 300)
        _flash_check(_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                     _randn(gen, B, H, Sk, D))
    _each([(D, Sq) for D in (16, 256)
           for Sq in (1, 22, 63, 64, 65, 129)], check)


def test_flash_sam2_key_tile_edges(gen):
    def check(D, Sk, B=None, H=1, Sq=100):
        if B is None:
            B, H, Sq = (2, 8, 22) if D == 16 else (1, 1, 100)
        _flash_check(_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                     _randn(gen, B, H, Sk, D))
    _each([(D, Sk) for D in (16, 256)
           for Sk in (1, 63, 64, 65, 127, 128, 129, 4097)]
          + [(256, 28736, 2, 1, 4096), (256, 4100, 2, 1, 4096)], check)


def test_flash_sam2_batch_heads(gen):
    def check(D, B, H):
        Sq, Sk = (22, 4096) if D == 16 else (256, 256)
        _flash_check(_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                     _randn(gen, B, H, Sk, D))
    _each([(D, B, H) for D in (16, 256)
           for B, H in ((1, 1), (2, 8), (40, 8), (3, 5))], check)


def test_flash_sam2_last_head_of_wider_storage(gen):
    """Head splits of (B, S, H+1, D) storage with the extra head dropped,
    as the decoder's (B, S, 8*16) projections are split: nothing past a
    head's D or past the last head is read."""
    def check(D):
        B, H, Sq, Sk = (2, 8, 22, 700) if D == 16 else (2, 1, 130, 300)

        def view(S):
            return _randn(gen, B, S, H + 1, D)[:, :, :H].permute(0, 2, 1, 3)
        _flash_check(view(Sq), view(Sk), view(Sk))
    _each([(16,), (256,)], check)


def test_flash_sam2_is_deterministic(gen):
    def check(B, H, Sq, Sk, D):
        q, k, v = (_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                   _randn(gen, B, H, Sk, D))
        a = A.flash_attention(q, k, v, D ** -0.5)
        b = A.flash_attention(q, k, v, D ** -0.5)
        assert torch.equal(a, b)
    _each([(2, 8, 22, 4096, 16), (2, 1, 4096, 4096, 256),
           (2, 1, 4096, 28736, 256), (2, 1, 4096, 4100, 256),
           (16, 16, 64, 256, 72)], check)


def test_flash_d72_hiera_stage4_entry(gen):
    """Hiera's stage-4 entry: 64 pooled queries over a 16x16 window of 256
    keys, 16 heads of 72 (padded to 80)."""
    def check(B):
        H, Sq, Sk, D = 16, 64, 256, 72
        _flash_check(_randn(gen, B, Sq, H, D).permute(0, 2, 1, 3),
                     _randn(gen, B, Sk, H, D).permute(0, 2, 1, 3),
                     _randn(gen, B, Sk, H, D).permute(0, 2, 1, 3))
    _each([(1,), (16,), (128,)], check)


def test_small_seq_hiera_qpool_shape(gen):
    """Hiera's stage-2 entry: 16 pooled queries over an 8x8 window of 64
    keys, 4 heads of 72, through the (B, H, S, D) small_seq route."""
    H, D = 4, 72
    _each([(16,), (1024,)], lambda N: _small_check(
        _split(_randn(gen, N, 16, H * D), H),
        _split(_randn(gen, N, 64, H * D), H),
        _split(_randn(gen, N, 64, H * D), H)))


# ---------------------------------------------------------------------------
# backward kernels: flash_attn_bwd and small_seq_attn_bwd through the
# wrappers' autograd Functions, against attention_backward_ref in f32 on the
# same bf16 inputs and the kernel's own forward output
# ---------------------------------------------------------------------------
def _bwd_launches():
    return sum(n for key, n in A.LAUNCHES.items() if "_bwd[" in key)


def _grads(fn, q, k, v, dout):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    out.backward(dout)
    return out.detach(), [t.grad for t in leaves]


def _bwd_check(fn, q, k, v, dout, heads=0):
    """The gradients of fn (a wrapper) at q, k, v for dout: one backward
    launch, each of dq, dk, dv within TOL of max|plain|, and a rerun
    bitwise. heads: token-major operands with that many heads. A gradient
    that vanishes in exact arithmetic (dq and dk over a single key, where
    dS = P (dP - rowsum(dO o O)) = 0) holds rounding noise only: its scale
    is floored at 1e-3 of the largest of the three."""
    d = q.shape[-1] // heads if heads else q.shape[-1]
    n = _bwd_launches()
    out, got = _grads(fn, q, k, v, dout)
    assert _bwd_launches() == n + 1

    def split(t):
        return _split(t, heads) if heads else t
    ref = A.attention_backward_ref(
        *(split(t).float() for t in (q, k, v, out, dout)), d ** -0.5)
    top = max(r.abs().max().item() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == (q.shape if heads else r.shape)
        assert bool(torch.isfinite(g).all())
        err = (split(g).float() - r).abs().max().item()
        assert err <= TOL * max(r.abs().max().item(), 1e-3 * top), err
    again = _grads(fn, q, k, v, dout)[1]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _storage_views(gen, B, H, Sq, Sk, D):
    """q, k, v, dO as head splits of (B, S, H+1, D) storage with the extra
    head dropped: nothing past a head's D or past the last head may be
    read."""
    def view(S):
        return _randn(gen, B, S, H + 1, D)[:, :, :H].permute(0, 2, 1, 3)
    return view(Sq), view(Sk), view(Sk), view(Sq)


def test_flash_bwd_matches_plain(gen):
    """flash_attn_bwd's edges: key tails of 1, 33, 127, 129 and 257 (the
    dK/dV pass's 128-key blocks, 64 at D = 160, and the dQ pass's 64-key
    steps), Sq = 1 and query tails (64-query steps, 32 at D = 160; the dQ
    pass's 128-query blocks), query blocks that wrap the 3-slot ring twice,
    D = 40/80/160, the last head of token-major storage, a dO whose D is
    not contiguous (copied into the kernel's layout), and the training
    shapes at the 4 and 2 heads of a "model" split."""
    def fn(q, k, v):
        return A.flash_attention(q, k, v, q.shape[-1] ** -0.5)

    def plain(B, H, Sq, Sk, D):
        _bwd_check(fn, _randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                   _randn(gen, B, H, Sk, D), _randn(gen, B, H, Sq, D))

    def storage(B, H, Sq, Sk, D):
        _bwd_check(fn, *_storage_views(gen, B, H, Sq, Sk, D))

    def strided_dout(B, H, Sq, Sk, D):
        dout = _randn(gen, B, H, D, Sq).transpose(-1, -2)
        _bwd_check(fn, _randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                   _randn(gen, B, H, Sk, D), dout)
    _each([(plain, 1, 2, 100, 100, 40), (plain, 2, 2, 70, 77, 80),
           (plain, 1, 2, 256, 256, 160), (plain, 1, 2, 64, 1, 40),
           (plain, 1, 2, 90, 33, 160), (plain, 2, 2, 1, 300, 80),
           (plain, 1, 1, 1, 77, 40), (plain, 1, 1, 130, 200, 40),
           (plain, 1, 2, 389, 127, 40), (plain, 2, 1, 200, 129, 160),
           (plain, 1, 2, 130, 257, 80), (plain, 2, 2, 1, 129, 160),
           (storage, 2, 3, 150, 77, 40), (storage, 1, 2, 65, 129, 160),
           (storage, 1, 2, 389, 257, 40),
           (strided_dout, 1, 2, 100, 77, 80),
           # the training step under a "model" split of 2 and 4
           (plain, 1, 4, 1600, 1600, 40), (plain, 1, 2, 1600, 77, 40),
           (plain, 2, 4, 400, 77, 80), (plain, 2, 2, 400, 400, 80)],
          lambda f, *shape: f(*shape))


def test_small_seq_bwd_matches_plain(gen):
    """small_seq_attn_bwd's edges: key tails of 1 and 33, Sq = 1, S = 22
    and 64 (at D = 160 a one-slot ring), both layouts, the last head of
    token-major storage, units of 4 and 2 heads with a head group cut by H,
    B*H large enough that every persistent CTA walks many units, a dO
    whose D is not contiguous, and the token-major rows of a "model"
    split."""
    def fn(q, k, v):
        return A.small_seq_attention(q, k, v, q.shape[-1] ** -0.5)

    def plain(B, H, Sq, Sk, D):
        _bwd_check(fn, _randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                   _randn(gen, B, H, Sk, D), _randn(gen, B, H, Sq, D))

    def tokenmajor(N, S, heads, d):
        def tm(q, k, v):
            return A.small_seq_attention_tokenmajor(q, k, v, heads,
                                                    d ** -0.5)
        _bwd_check(tm, *(_randn(gen, N, S, heads * d) for _ in range(4)),
                   heads=heads)

    def storage(B, H, Sq, Sk, D):
        _bwd_check(fn, *_storage_views(gen, B, H, Sq, Sk, D))

    def strided_dout(B, H, Sq, Sk, D):
        dout = _randn(gen, B, H, D, Sq).transpose(-1, -2)
        _bwd_check(fn, _randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
                   _randn(gen, B, H, Sk, D), dout)
    _each([(plain, 5, 3, 22, 22, 40), (plain, 7, 2, 17, 30, 80),
           (plain, 3, 4, 64, 64, 160), (plain, 9, 1, 33, 1, 80),
           (plain, 4, 2, 20, 33, 40), (plain, 4, 2, 1, 64, 160),
           (plain, 300, 3, 1, 1, 80), (plain, 150, 3, 64, 17, 160),
           (tokenmajor, 37, 22, 8, 40), (tokenmajor, 10, 64, 2, 160),
           (tokenmajor, 700, 22, 8, 40), (tokenmajor, 300, 22, 2, 160),
           (tokenmajor, 200, 22, 6, 80),
           (storage, 6, 4, 22, 22, 80), (storage, 3, 2, 64, 64, 160),
           (strided_dout, 5, 2, 22, 22, 40),
           # the motion modules under a "model" split of 2 and 4: rows of
           # 8 / model heads, a pitch of H / model * D
           (tokenmajor, 1600, 22, 4, 40), (tokenmajor, 1600, 22, 2, 40),
           (tokenmajor, 400, 22, 4, 80), (tokenmajor, 400, 22, 2, 80),
           (tokenmajor, 100, 22, 4, 160), (tokenmajor, 100, 22, 2, 160)],
          lambda f, *shape: f(*shape))
