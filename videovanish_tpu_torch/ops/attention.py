"""Attention: hand-written Hopper kernels, their plain versions, and the
dispatch that picks between them.

Port of videovanish_tpu/ops/attention.py. The JAX package sends long
sequences to a Pallas flash kernel and short sequences with a large
batch*heads axis to a packed Pallas kernel when it runs on the TPU; here
the same predicates send them to CUDA kernels when the tensors lie on the
card:

  flash_attention            csrc/flash_attn.cu      (_flash_kernel_inline,
                                                      _flash_kernel_iota)
  small_seq_attention        csrc/small_seq_attn.cu  (_packed_kernel)
  small_seq_attention_tokenmajor   "                 (_packed_tokenmajor_kernel)

Each wrapper takes its kernel's plain PyTorch version when the tensors lie
on the CPU, and on a CUDA tensor launches the kernel or raises; it never
falls back. Every launch adds one to `LAUNCHES[<instance>]`.

Layout: (B, H, S, D). The kernels read q/k/v through strides (head dim
contiguous) and write their output into (B, S, H, D) storage, so callers
that split heads off a (B, S, H*D) projection need no transpose copies.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from videovanish_tpu_torch.ops import kernels

_LOG2E = 1.4426950408889634
_NEG_INF = -1e30

# kernel launches by instance, e.g. "flash_attn_fwd[D=40,Sq=8160,Sk=77]" or
# "small_seq_attn[tokenmajor,D=40,S=22]"
LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def plain_attention(q, k, v, scale, is_causal=False, key_mask=None,
                    max_score_bytes: int = 1 << 32):
    """Reference attention (`_xla_attention` semantics): f32 scores and
    softmax over (B, H, Sq, D) x (B, H, Sk, D), taken in query chunks so the
    f32 score tensor stays under `max_score_bytes`. key_mask: optional
    (B, Sk) bool, False keys are excluded."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    rows = max(1, max_score_bytes // max(1, B * H * Sk * 4))
    kf, vf = k.float(), v.float()
    out = []
    for i in range(0, Sq, rows):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i:i + rows].float(),
                         kf) * scale
        if is_causal:
            keep = torch.ones(s.shape[-2], Sk, dtype=torch.bool,
                              device=s.device).tril(Sk - Sq + i)
            s = s.masked_fill(~keep, _NEG_INF)
        if key_mask is not None:
            s = s.masked_fill(~key_mask[:, None, None, :], _NEG_INF)
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf))
    return (out[0] if len(out) == 1 else torch.cat(out, dim=2)).to(q.dtype)


# the plain versions of flash_attn_fwd and small_seq_attn: both kernels
# compute exactly this function
flash_attention_ref = plain_attention
small_seq_attention_ref = plain_attention


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _on_card(*ts) -> bool:
    """True when every tensor lies on a CUDA device, False when all lie on
    the CPU; anything else is refused."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"attention kernels take CPU or CUDA tensors, got {kinds}")


def _check_operands(q, k, v, out):
    if not (q.device == k.device == v.device == out.device):
        raise ValueError("q, k, v must lie on one device")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on the card, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be (B, H, S, D) with contiguous D")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides must be multiples of 8 "
                             "elements and the data 16-byte aligned")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if out.shape != q.shape:
        raise ValueError("output shape differs from q")
    if D % 8 or Sq < 1 or Sk < 1:
        raise ValueError(f"head dim must be a multiple of 8, got D={D}")


def _launch(fn, q, k, v, out, scale):
    B, H, Sq, D = q.shape
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Sq, k.shape[2], D, strides, float(scale) * _LOG2E,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def _bhsd_out(q):
    """(B, H, Sq, D) output view over (B, Sq, H, D) storage."""
    B, H, Sq, D = q.shape
    return torch.empty((B, Sq, H, D), dtype=q.dtype,
                       device=q.device).permute(0, 2, 1, 3)


def _padded(d: int) -> int:
    return -(-d // 16) * 16


def flash_attention(q, k, v, scale):
    """softmax(q k^T * scale) v over (B, H, Sq, D) x (B, H, Sk, D) with the
    flash_attn_fwd kernel (plain version on the CPU)."""
    if not _on_card(q, k, v):
        return flash_attention_ref(q, k, v, scale)
    lib = kernels.library("flash_attn")
    D = q.shape[-1]
    if not lib.vv_flash_supported(_padded(D)):
        raise ValueError(f"flash_attn_fwd is not built for head dim {D}")
    out = _bhsd_out(q)
    _check_operands(q, k, v, out)
    _launch(lib.vv_flash_attn_fwd, q, k, v, out, scale)
    LAUNCHES[f"flash_attn_fwd[D={D},Sq={q.shape[2]},Sk={k.shape[2]}]"] += 1
    return out


def _small_seq(q, k, v, out, scale, layout):
    lib = kernels.library("small_seq_attn")
    _check_operands(q, k, v, out)
    D, Sq, Sk = q.shape[-1], q.shape[2], k.shape[2]
    if not lib.vv_small_seq_supported(_padded(D), Sq, Sk):
        raise ValueError(f"small_seq_attn does not take D={D}, Sq={Sq}, "
                         f"Sk={Sk}")
    _launch(lib.vv_small_seq_attn, q, k, v, out, scale)
    LAUNCHES[f"small_seq_attn[{layout},D={D},S={Sq}]"] += 1
    return out


def small_seq_attention(q, k, v, scale):
    """Exact attention for short sequences over (B, H, S, D) input
    (17 <= S <= 64, Sq != Sk allowed) with the small_seq_attn kernel
    (plain version on the CPU)."""
    if not _on_card(q, k, v):
        return small_seq_attention_ref(q, k, v, scale)
    return _small_seq(q, k, v, _bhsd_out(q), scale, "bhsd")


def _split_heads(t, heads: int):
    """(N, S, heads*d) -> its (N, heads, S, d) view."""
    N, S, C = t.shape
    return t.view(N, S, heads, C // heads).permute(0, 2, 1, 3)


def small_seq_attention_tokenmajor(q, k, v, heads: int, scale):
    """Self-attention over token-major (N, S, C) q/k/v, C = heads*d, with
    the small_seq_attn kernel reading and writing the token-major layout in
    place (plain version on the CPU). Returns (N, S, C)."""
    N, S, C = q.shape

    def split(t):
        return _split_heads(t, heads)

    if not _on_card(q, k, v):
        out = small_seq_attention_ref(split(q), split(k), split(v), scale)
        return out.permute(0, 2, 1, 3).reshape(N, S, C)
    out = torch.empty((N, S, C), dtype=q.dtype, device=q.device)
    _small_seq(split(q), split(k), split(v), split(out), scale, "tokenmajor")
    return out


# ---------------------------------------------------------------------------
# dispatch (the JAX package's predicates; "on the TPU" becomes "on the card")
# ---------------------------------------------------------------------------
def attention_route(q_shape, k_shape, on_card: bool, is_causal: bool = False,
                    masked: bool = False) -> str:
    """Which path `attention` takes: "flash", "packed" or "plain".

    flash:  long KV (Sk >= 192) or long-query cross-attention (Sq >= 512 and
            Sk >= 64), on the card only (videovanish_tpu attention.py:540);
    packed: 17 <= max(Sq, Sk) <= 64 with B*H >= 1024 (:548).
    """
    B, H, Sq = q_shape[0], q_shape[1], q_shape[2]
    Sk = k_shape[2]
    if masked or is_causal:
        return "plain"
    if on_card and (Sk >= 192 or (Sq >= 512 and Sk >= 64)):
        return "flash"
    if 17 <= max(Sq, Sk) <= 64 and B * H >= 1024:
        return "packed"
    return "plain"


def tokenmajor_route(shape, heads: int, on_card: bool) -> str:
    """"tokenmajor" when the in-place token-major kernel applies
    (17 <= S <= 64, heads | C, J | N and N / J >= 8 with J = 128 // S;
    videovanish_tpu attention.py:448), else the route of the head-split
    `attention` call."""
    N, S, C = shape
    J = max(1, 128 // S)
    if (on_card and 17 <= S <= 64 and C % heads == 0 and N % J == 0
            and N // J >= 8):
        return "tokenmajor"
    d = C // heads
    return attention_route((N, heads, S, d), (N, heads, S, d), on_card)


def attention(q, k, v, scale: float | None = None, is_causal: bool = False,
              key_mask=None):
    """Multi-head attention over (B, H, S, D) tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    route = attention_route(q.shape, k.shape, _on_card(q, k, v), is_causal,
                            key_mask is not None)
    if route == "flash":
        return flash_attention(q, k, v, scale)
    if route == "packed":
        return small_seq_attention(q, k, v, scale)
    return plain_attention(q, k, v, scale, is_causal, key_mask)


def attention_tokenmajor(q, k, v, heads: int, scale: float | None = None):
    """Self-attention over token-major (N, S, C) q/k/v, C = heads*d."""
    N, S, C = q.shape
    d = C // heads
    if scale is None:
        scale = d ** -0.5
    if tokenmajor_route(q.shape, heads, _on_card(q, k, v)) == "tokenmajor":
        return small_seq_attention_tokenmajor(q, k, v, heads, scale)
    out = attention(_split_heads(q, heads), _split_heads(k, heads),
                    _split_heads(v, heads), scale=scale)
    return out.permute(0, 2, 1, 3).reshape(N, S, C)
