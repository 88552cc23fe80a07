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


@pytest.mark.parametrize("B,H,Sq,Sk,D", [
    (2, 3, 100, 150, 40), (1, 2, 600, 77, 40), (3, 2, 65, 64, 72),
    (2, 1, 1000, 1, 80), (1, 4, 17, 333, 152), (2, 2, 130, 200, 160),
    (1, 2, 70, 90, 504), (2, 1, 129, 257, 512),
])
def test_flash_matches_plain(gen, B, H, Sq, Sk, D):
    q, k, v = (_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
               _randn(gen, B, H, Sk, D))
    n = sum(A.LAUNCHES.values())
    got = A.flash_attention(q, k, v, D ** -0.5)
    assert sum(A.LAUNCHES.values()) == n + 1
    _close(got, A.flash_attention_ref(q.float(), k.float(), v.float(),
                                      D ** -0.5))


@pytest.mark.parametrize("B,H,Sq,Sk,D", [
    (5, 3, 22, 22, 40), (7, 2, 17, 30, 48), (3, 4, 64, 64, 160),
    (9, 1, 33, 1, 80), (4, 2, 1, 64, 48), (2, 8, 64, 17, 152),
])
def test_small_seq_matches_plain(gen, B, H, Sq, Sk, D):
    q, k, v = (_randn(gen, B, H, Sq, D), _randn(gen, B, H, Sk, D),
               _randn(gen, B, H, Sk, D))
    got = A.small_seq_attention(q, k, v, D ** -0.5)
    _close(got, A.small_seq_attention_ref(q.float(), k.float(), v.float(),
                                          D ** -0.5))


@pytest.mark.parametrize("N,S,heads,d", [(40, 22, 8, 40), (10, 64, 2, 72)])
def test_tokenmajor_matches_plain(gen, N, S, heads, d):
    q, k, v = (_randn(gen, N, S, heads * d) for _ in range(3))
    got = A.small_seq_attention_tokenmajor(q, k, v, heads, d ** -0.5)

    def split(t):
        return t.view(N, S, heads, d).permute(0, 2, 1, 3).float()

    ref = A.small_seq_attention_ref(split(q), split(k), split(v), d ** -0.5)
    _close(got.view(N, S, heads, d).permute(0, 2, 1, 3), ref)


def test_kernels_refuse_bad_operands(gen):
    q = _randn(gen, 1, 2, 64, 40)
    with pytest.raises(TypeError):
        A.flash_attention(q.float(), q.float(), q.float(), 0.1)
    with pytest.raises(ValueError):
        A.flash_attention(q[..., :36], q[..., :36], q[..., :36], 0.1)
    wide = _randn(gen, 1, 2, 64, 256)
    with pytest.raises(ValueError):
        A.flash_attention(wide, wide, wide, 0.1)  # no build for D = 256
    long = _randn(gen, 1, 2, 65, 40)
    with pytest.raises(ValueError):
        A.small_seq_attention(long, long, long, 0.1)  # S above 64
