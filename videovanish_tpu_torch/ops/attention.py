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

Gradients. The Pallas kernels define no VJP; the JAX trainer differentiates
`_xla_attention` and `_packed_small_attention` instead. Here, when grad mode
is on and q, k or v requires grad, each wrapper goes through a
torch.autograd.Function whose backward is a hand-written kernel on the card
(csrc/flash_attn_bwd.cu, csrc/small_seq_attn_bwd.cu: what jax.vjp of those
XLA functions computes) and `attention_backward_ref` on the CPU. Without
grad the wrappers launch their forward kernel directly, as for inference.

Layout: (B, H, S, D). The kernels read q/k/v through strides (head dim
contiguous) and write their output into (B, S, H, D) storage, so callers
that split heads off a (B, S, H*D) projection need no transpose copies.

Tracing. While a torch profiler runs, `attention`, `attention_tokenmajor`
and the two backward entries each open one range around the whole call,
`vv.stage=attention:<route>:<B>x<H>x<Sq>x<Sk>x<D>` (`attention_bwd:` for
the backward entries). The route names what ran: "flash", "packed" or
"tokenmajor" for a kernel, "plain" for the plain version (every call on
the CPU). `utils/profiling` counts a kernel route's operations from the
name (4 B H Sq Sk D, backward 10x); the plain route's matmuls keep
torch's own count.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools

import torch

from videovanish_tpu_torch.ops import kernels
from videovanish_tpu_torch.utils.observability import (
    profiler_running, trace_annotation,
)

_LOG2E = 1.4426950408889634
_NEG_INF = -1e30

# kernel launches by instance, e.g. "flash_attn_fwd[D=40,Sq=8160,Sk=77]" or
# "small_seq_attn[tokenmajor,N=135,D=160,S=22]" (N: the sequence count)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _dims(q, k) -> tuple:
    """(B, H, Sq, Sk, D) of (B, H, S, D) q and k."""
    return (*q.shape[:3], k.shape[2], q.shape[3])


def _span(kind: str, route: str, dims):
    """The call's range (see the module's doc) while a profiler runs."""
    if not profiler_running():
        return contextlib.nullcontext()
    return trace_annotation(f"{kind}:{route}:{'x'.join(map(str, dims))}")


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


def attention_backward_ref(q, k, v, o, do, scale,
                           max_score_bytes: int = 1 << 32):
    """Closed-form gradient of `plain_attention` (no mask), in f32:
    P = softmax(scale q k^T), dV = P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(dO o O)), dQ = scale dS K, dK = scale dS^T Q.
    Taken in query chunks, as `plain_attention`, so the f32 scores stay
    under `max_score_bytes`; dK and dV accumulate over the chunks. Returns
    (dq, dk, dv) in the dtypes of q, k and v."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    rows = max(1, max_score_bytes // max(1, B * H * Sk * 4))
    kf, vf = k.float(), v.float()
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=v.device)
    dq = []
    for i in range(0, Sq, rows):
        qc, oc, dc = (t[:, :, i:i + rows].float() for t in (q, o, do))
        p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale,
                          dim=-1)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dc)
        dp = torch.einsum("bhqd,bhkd->bhqk", dc, vf)
        ds = p * (dp - (dc * oc).sum(-1, keepdim=True))
        dq.append(torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc) * scale
    dq = dq[0] if len(dq) == 1 else torch.cat(dq, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# the plain versions of flash_attn_fwd and small_seq_attn: both kernels
# compute exactly this function; flash_attn_bwd and small_seq_attn_bwd
# compute attention_backward_ref
flash_attention_ref = plain_attention
small_seq_attention_ref = plain_attention


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _on_card(*ts) -> bool:
    """True when every tensor lies on a CUDA device, False when all lie on
    the CPU; anything else is refused."""
    cuda = sum(t.is_cuda for t in ts)
    if cuda == len(ts):
        return True
    if cuda == 0 and all(t.is_cpu for t in ts):
        return False
    raise ValueError(f"attention kernels take CPU or CUDA tensors, got "
                     f"{sorted({t.device.type for t in ts})}")


# The checks and the launch below run on plain ints and make no views: at
# the smallest main-path shapes a call's host work is longer than its
# kernel (PERF.md, the kernel table's call and device times).
def _operand(t, name: str, heads: int = 0):
    """(data pointer, sequence, head and row strides) of a kernel operand:
    a bf16 (B, H, S, D) tensor, or with `heads` the (N, heads, S, d) split
    of a token-major (N, S, heads*d) one, without making the view. Refuses
    another dtype, a D that is not contiguous, strides that are not
    multiples of 8 elements and data that is not 16-byte aligned."""
    if t.dtype is not torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 on the card, got {t.dtype}")
    st = t.stride()
    if heads:
        st = ((st[0], t.shape[2] // heads, st[1], st[2]) if len(st) == 3
              else ())
    if len(st) != 4 or st[3] != 1:
        raise ValueError(f"{name} must be (B, H, S, D) with contiguous D")
    ptr = t.data_ptr()
    if st[0] % 8 or st[1] % 8 or st[2] % 8 or ptr % 16:
        raise ValueError(f"{name}: strides must be multiples of 8 "
                         "elements and the data 16-byte aligned")
    return ptr, st[0], st[1], st[2]


def _bhsd_dims(q, k, v, out):
    """(B, H, Sq, Sk, D) of (B, H, S, D) operands, checked against each
    other."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if out.shape != q.shape:
        raise ValueError("output shape differs from q")
    return B, H, Sq, Sk, D


def _run(fn, ops, dims, scale, *ts, extra=()) -> None:
    """Launch `fn` on the current stream of the tensors `ts`' card, with its
    operands given as `_operand` tuples (q, k, v and out; the backward's
    q, k, v, out, dout, dq, dk, dv), the pointers `extra` after them (the
    C functions take them in that order), dims (B, H, Sq, Sk, D), and
    scale * log2(e)."""
    dev = ts[0].get_device()
    if any(t.get_device() != dev for t in ts):
        raise ValueError("q, k, v must lie on one device")
    if dev != torch.cuda.current_device():
        # the kernels launch into the current device's context (a rank of
        # a mesh sets its own card with torch.cuda.set_device)
        raise ValueError(f"the tensors lie on cuda:{dev}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    B, H, Sq, Sk, D = dims
    if D % 8 or Sq < 1 or Sk < 1:
        raise ValueError(f"head dim must be a multiple of 8, got D={D}")
    strides = (ctypes.c_longlong * (3 * len(ops)))(
        *(s for op in ops for s in op[1:]))
    stream = torch._C._cuda_getCurrentRawStream(dev)
    args = (*(op[0] for op in ops), *extra, B, H, Sq, Sk, D, strides,
            float(scale) * _LOG2E, stream)
    rc = fn(*args)
    if rc != 0:  # a cudaError_t, or 1000 + the CUresult of a tensor map
        raise RuntimeError(f"{fn.__name__} failed: error {rc}")


def _launch(fn, q, k, v, out, scale, extra=()) -> None:
    """Launch `fn` (vv_flash_attn_fwd or vv_small_seq_attn) on bf16
    (B, H, S, D) q, k, v and out; `extra`: vv_flash_attn_fwd's lse
    pointer (None for none)."""
    ops = [_operand(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"),
                                       (out, "out"))]
    _run(fn, ops, _bhsd_dims(q, k, v, out), scale, q, k, v, out, extra=extra)


def _bhsd_out(q):
    """(B, H, Sq, D) output view over (B, Sq, H, D) storage."""
    B, H, Sq, D = q.shape
    return torch.empty_strided((B, H, Sq, D), (Sq * H * D, D, H * D, 1),
                               dtype=q.dtype, device=q.device)


def _padded(d: int) -> int:
    return -(-d // 16) * 16


# what each library was built for (its vv_*_supported), asked once a shape
@functools.lru_cache(maxsize=None)
def _flash_takes(dp: int) -> bool:
    return bool(kernels.library("flash_attn").vv_flash_supported(dp))


@functools.lru_cache(maxsize=None)
def _small_seq_takes(dp: int, sq: int, sk: int) -> bool:
    return bool(kernels.library("small_seq_attn").vv_small_seq_supported(
        dp, sq, sk))


@functools.lru_cache(maxsize=None)
def _flash_bwd_takes(dp: int) -> bool:
    return bool(kernels.library("flash_attn_bwd").vv_flash_bwd_supported(dp))


@functools.lru_cache(maxsize=None)
def _small_seq_bwd_takes(dp: int, sq: int, sk: int) -> bool:
    return bool(kernels.library("small_seq_attn_bwd")
                .vv_small_seq_bwd_supported(dp, sq, sk))


def _grad_wanted(q, k, v) -> bool:
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)


def _flash_forward(q, k, v, scale, with_lse: bool = False):
    """(out, lse) of the flash_attn_fwd kernel on CUDA q, k, v; lse is the
    f32 (B, H, Sq) log2-domain log-sum-exp flash_attn_bwd reads, or None."""
    D = q.shape[-1]
    if not _flash_takes(_padded(D)):
        raise ValueError(f"flash_attn_fwd is not built for head dim {D}")
    out = _bhsd_out(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if with_lse else None
    _launch(kernels.library("flash_attn").vv_flash_attn_fwd, q, k, v, out,
            scale, extra=(None if lse is None else lse.data_ptr(),))
    LAUNCHES[f"flash_attn_fwd[D={D},Sq={q.shape[2]},Sk={k.shape[2]}]"] += 1
    return out, lse


def _kernel_layout(t, heads: int = 0):
    """`t` (an incoming gradient) as the backward kernels read it: itself
    where `_operand` takes its strides, else a contiguous copy (a layout
    copy, not a fallback)."""
    try:
        _operand(t, "dout", heads)
        return t
    except ValueError:
        return t.contiguous()


def flash_attention_backward(q, k, v, out, dout, lse, scale):
    """(dq, dk, dv) of `flash_attention` at (q, k, v) with output `out` and
    its gradient `dout`: the flash_attn_bwd kernel on the card (lse from
    the forward), `attention_backward_ref` on the CPU."""
    on_card = _on_card(q, k, v, out, dout)
    with _span("attention_bwd", "flash" if on_card else "plain",
               _dims(q, k)):
        if not on_card:
            return attention_backward_ref(q, k, v, out, dout, scale)
        return _flash_backward(q, k, v, out, dout, lse, scale)


def _flash_backward(q, k, v, out, dout, lse, scale):
    D = q.shape[-1]
    if not _flash_bwd_takes(_padded(D)):
        raise ValueError(f"flash_attn_bwd is not built for head dim {D}")
    dout = _kernel_layout(dout)
    grads = [_bhsd_out(t) for t in (q, k, v)]
    ts = (q, k, v, out, dout, *grads)
    ops = [_operand(t, n) for t, n in zip(ts, ("q", "k", "v", "out", "dout",
                                               "dq", "dk", "dv"))]
    dims = _bhsd_dims(q, k, v, out)
    if dout.shape != out.shape:
        raise ValueError("dout's shape differs from the output's")
    B, H, Sq, Sk, _ = dims
    if lse is None or lse.shape != (B, H, Sq) or not lse.is_contiguous() \
            or lse.dtype is not torch.float32:
        raise ValueError("flash_attn_bwd needs the forward's f32 (B, H, Sq) "
                         "log-sum-exp")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _run(kernels.library("flash_attn_bwd").vv_flash_attn_bwd, ops, dims,
         scale, *ts, extra=(lse.data_ptr(), delta.data_ptr()))
    LAUNCHES[f"flash_attn_bwd[D={D},Sq={Sq},Sk={Sk}]"] += 1
    return tuple(grads)


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its gradient: flash_attn_fwd (with the row
    statistics) and flash_attn_bwd on the card, the plain versions on the
    CPU. Saves q, k, v, the output and the statistics."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if _on_card(q, k, v):
            out, lse = _flash_forward(q, k, v, scale, with_lse=True)
        else:  # grad mode is off here: the wrapper's direct path
            out, lse = flash_attention(q, k, v, scale), None
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, dout, lse, ctx.scale),
                None)


def flash_attention(q, k, v, scale):
    """softmax(q k^T * scale) v over (B, H, Sq, D) x (B, H, Sk, D) with the
    flash_attn_fwd kernel (plain version on the CPU); differentiable
    through flash_attn_bwd when q, k or v requires grad."""
    if _grad_wanted(q, k, v):
        return _FlashAttention.apply(q, k, v, scale)
    if not _on_card(q, k, v):
        return flash_attention_ref(q, k, v, scale)
    return _flash_forward(q, k, v, scale)[0]


def _small_seq(q, k, v, out, scale, layout: str, heads: int = 0):
    """small_seq_attn on bf16 (B, H, S, D) q, k, v and out, or with `heads`
    on token-major (N, S, heads*d) ones; the launch is counted under
    `layout`."""
    ops = [_operand(t, n, heads) for t, n in ((q, "q"), (k, "k"), (v, "v"),
                                              (out, "out"))]
    if heads:
        N, S, C = q.shape
        if k.shape != q.shape or v.shape != q.shape or out.shape != q.shape \
                or C % heads:
            raise ValueError(f"token-major q{tuple(q.shape)} "
                             f"k{tuple(k.shape)} v{tuple(v.shape)} "
                             f"out{tuple(out.shape)} with {heads} heads")
        dims = (N, heads, S, S, C // heads)
    else:
        dims = _bhsd_dims(q, k, v, out)
    B, _, Sq, Sk, D = dims
    if not _small_seq_takes(_padded(D), Sq, Sk):
        raise ValueError(f"small_seq_attn does not take D={D}, Sq={Sq}, "
                         f"Sk={Sk}")
    _run(kernels.library("small_seq_attn").vv_small_seq_attn, ops, dims,
         scale, q, k, v, out)
    LAUNCHES[f"small_seq_attn[{layout},N={B},D={D},S={Sq}]"] += 1
    return out


def _split_heads(t, heads: int):
    """(N, S, heads*d) -> its (N, heads, S, d) view."""
    N, S, C = t.shape
    return t.view(N, S, heads, C // heads).permute(0, 2, 1, 3)


def _merge_heads(t):
    """(N, heads, S, d) -> (N, S, heads*d)."""
    N, H, S, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(N, S, H * d)


def _small_seq_forward(q, k, v, scale, heads: int = 0):
    """small_seq_attn on CUDA (B, H, S, D) q, k, v, or with `heads` on
    token-major (N, S, heads*d) ones (output in the same layout)."""
    if heads:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return _small_seq(q, k, v, out, scale, "tokenmajor", heads)
    return _small_seq(q, k, v, _bhsd_out(q), scale, "bhsd")


def small_seq_attention_backward(q, k, v, out, dout, scale, heads: int = 0):
    """(dq, dk, dv) of `small_seq_attention` (or with `heads`, of
    `small_seq_attention_tokenmajor`, every tensor token-major (N, S, C))
    at (q, k, v) with output `out` and its gradient `dout`: the
    small_seq_attn_bwd kernel on the card, `attention_backward_ref` on the
    CPU."""
    on_card = _on_card(q, k, v, out, dout)
    route = ("tokenmajor" if heads else "packed") if on_card else "plain"
    dims = (q.shape[0], heads, q.shape[1], q.shape[1], q.shape[2] // heads) \
        if heads else _dims(q, k)
    with _span("attention_bwd", route, dims):
        if on_card:
            return _small_seq_backward(q, k, v, out, dout, scale, heads)
        if not heads:
            return attention_backward_ref(q, k, v, out, dout, scale)
        grads = attention_backward_ref(
            *(_split_heads(t, heads) for t in (q, k, v, out, dout)), scale)
        return tuple(_merge_heads(g) for g in grads)


def _small_seq_backward(q, k, v, out, dout, scale, heads: int):
    dout = _kernel_layout(dout, heads)
    if heads:
        N, S, C = q.shape
        if any(t.shape != q.shape for t in (k, v, out, dout)) or C % heads:
            raise ValueError(f"token-major q{tuple(q.shape)} "
                             f"k{tuple(k.shape)} v{tuple(v.shape)} with "
                             f"{heads} heads")
        dims = (N, heads, S, S, C // heads)
        grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
                 for _ in range(3)]
        layout = "tokenmajor"
    else:
        dims = _bhsd_dims(q, k, v, out)
        if dout.shape != out.shape:
            raise ValueError("dout's shape differs from the output's")
        grads = [_bhsd_out(t) for t in (q, k, v)]
        layout = "bhsd"
    B, _, Sq, Sk, D = dims
    if not _small_seq_bwd_takes(_padded(D), Sq, Sk):
        raise ValueError(f"small_seq_attn_bwd does not take D={D}, Sq={Sq}, "
                         f"Sk={Sk}")
    ts = (q, k, v, out, dout, *grads)
    ops = [_operand(t, n, heads) for t, n in zip(
        ts, ("q", "k", "v", "out", "dout", "dq", "dk", "dv"))]
    _run(kernels.library("small_seq_attn_bwd").vv_small_seq_attn_bwd, ops,
         dims, scale, *ts)
    LAUNCHES[f"small_seq_attn_bwd[{layout},N={B},D={D},S={Sq}]"] += 1
    return tuple(grads)


class _SmallSeqAttention(torch.autograd.Function):
    """small_seq_attention (heads = 0) or small_seq_attention_tokenmajor
    with its gradient: small_seq_attn and small_seq_attn_bwd on the card,
    the plain versions on the CPU. Saves q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, scale, heads):
        # grad mode is off here: the wrappers' direct paths
        out = small_seq_attention_tokenmajor(q, k, v, heads, scale) if heads \
            else small_seq_attention(q, k, v, scale)
        ctx.scale, ctx.heads = scale, heads
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*small_seq_attention_backward(q, k, v, out, dout, ctx.scale,
                                              ctx.heads), None, None)


def small_seq_attention(q, k, v, scale):
    """Exact attention for short sequences over (B, H, S, D) input
    (S <= 64, Sq != Sk allowed) with the small_seq_attn kernel
    (plain version on the CPU); differentiable through small_seq_attn_bwd
    when q, k or v requires grad."""
    if _grad_wanted(q, k, v):
        return _SmallSeqAttention.apply(q, k, v, scale, 0)
    if not _on_card(q, k, v):
        return small_seq_attention_ref(q, k, v, scale)
    return _small_seq_forward(q, k, v, scale)


def small_seq_attention_tokenmajor(q, k, v, heads: int, scale):
    """Self-attention over token-major (N, S, C) q/k/v, C = heads*d, with
    the small_seq_attn kernel reading and writing the token-major layout in
    place (plain version on the CPU). Returns (N, S, C); differentiable
    through small_seq_attn_bwd, whose gradients come back token-major."""
    if _grad_wanted(q, k, v):
        return _SmallSeqAttention.apply(q, k, v, scale, heads)
    if not _on_card(q, k, v):
        return _merge_heads(small_seq_attention_ref(
            *(_split_heads(t, heads) for t in (q, k, v)), scale))
    return _small_seq_forward(q, k, v, scale, heads)


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


def _attend(route: str, q, k, v, scale, is_causal=False, key_mask=None):
    if route == "flash":
        return flash_attention(q, k, v, scale)
    if route == "packed":
        return small_seq_attention(q, k, v, scale)
    return plain_attention(q, k, v, scale, is_causal, key_mask)


def attention(q, k, v, scale: float | None = None, is_causal: bool = False,
              key_mask=None):
    """Multi-head attention over (B, H, S, D) tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    on_card = _on_card(q, k, v)
    route = attention_route(q.shape, k.shape, on_card, is_causal,
                            key_mask is not None)
    with _span("attention", route if on_card else "plain", _dims(q, k)):
        return _attend(route, q, k, v, scale, is_causal, key_mask)


def attention_tokenmajor(q, k, v, heads: int, scale: float | None = None):
    """Self-attention over token-major (N, S, C) q/k/v, C = heads*d."""
    N, S, C = q.shape
    d = C // heads
    if scale is None:
        scale = d ** -0.5
    on_card = _on_card(q, k, v)
    route = tokenmajor_route(q.shape, heads, on_card)
    with _span("attention", route if on_card else "plain",
               (N, heads, S, S, d)):
        if route == "tokenmajor":
            return small_seq_attention_tokenmajor(q, k, v, heads, scale)
        out = _attend(route, _split_heads(q, heads), _split_heads(k, heads),
                      _split_heads(v, heads), scale)
        return out.permute(0, 2, 1, 3).reshape(N, S, C)
