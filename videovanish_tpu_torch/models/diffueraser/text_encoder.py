"""CLIP text encoder (SD1.5's conditioning), PyTorch.

Port of videovanish_tpu/models/diffueraser/text_encoder.py: the public
CLIP ViT-L/14 text tower (12 layers, 768 wide, 12 heads, causal
attention, quick-GELU) under transformers' CLIPTextModel key names, so a
published `text_encoder` state dict loads with `load_state_dict` (after
`convert.published_state_dict(state, "clip")` drops its position-id
buffer). LayerNorms and quick-GELU compute in f32 whatever the weights'
type; the causal attention takes the plain path (the JAX package sends it
to XLA), so the tower launches no hand-written kernel.

DiffuEraser conditions on the empty prompt, so inference needs only the
null-prompt embedding: `derive_null_text_emb` computes it once, when
`cli/convert.py --assemble diffueraser` bundles the weights.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from videovanish_tpu_torch.convert import published_state_dict
from videovanish_tpu_torch.models.diffueraser.blocks import LayerNorm
from videovanish_tpu_torch.models.diffueraser.tokenizer import null_text_ids
from videovanish_tpu_torch.ops.attention import attention


def _norm(ln: LayerNorm, x):
    return ln(x).to(x.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        B, S, C = x.shape

        def heads(t):
            return t.view(B, S, self.num_heads, -1).transpose(1, 2)
        out = attention(heads(self.q_proj(x)), heads(self.k_proj(x)),
                        heads(self.v_proj(x)), is_causal=True)
        return self.out_proj(out.transpose(1, 2).reshape(B, S, C))


class CLIPMLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        h = self.fc1(x).float()
        return self.fc2((h * torch.sigmoid(1.702 * h)).to(x.dtype))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.self_attn = CLIPAttention(width, num_heads)
        self.layer_norm1 = LayerNorm(width, eps=1e-5)
        self.mlp = CLIPMLP(width, width * mlp_ratio)
        self.layer_norm2 = LayerNorm(width, eps=1e-5)

    def forward(self, x):
        x = x + self.self_attn(_norm(self.layer_norm1, x))
        return x + self.mlp(_norm(self.layer_norm2, x))


class CLIPTextModel(nn.Module):
    """input_ids (B, S) -> (B, S, width) final hidden states, in the
    weights' type (what SD1.5 cross-attends to)."""

    def __init__(self, vocab_size: int = 49408, max_positions: int = 77,
                 width: int = 768, layers: int = 12, num_heads: int = 12):
        super().__init__()
        self.text_model = nn.Module()
        emb = self.text_model.embeddings = nn.Module()
        emb.token_embedding = nn.Embedding(vocab_size, width)
        emb.position_embedding = nn.Embedding(max_positions, width)
        self.text_model.encoder = nn.Module()
        self.text_model.encoder.layers = nn.ModuleList(
            CLIPEncoderLayer(width, num_heads) for _ in range(layers))
        self.text_model.final_layer_norm = LayerNorm(width, eps=1e-5)

    def forward(self, input_ids):
        tm = self.text_model
        tok = tm.embeddings.token_embedding(input_ids)
        pos = tm.embeddings.position_embedding.weight[:input_ids.shape[1]]
        x = tok + pos[None].to(tok.dtype)
        for layer in tm.encoder.layers:
            x = layer(x)
        return _norm(tm.final_layer_norm, x)


def clip_dims(state: dict) -> dict:
    """CLIPTextModel's size arguments, read off a state dict's shapes. CLIP's
    head dim is 64 at every published size, so the heads are width / 64."""
    vocab, width = state["text_model.embeddings.token_embedding.weight"].shape
    layers = 1 + max(int(k.split(".")[3]) for k in state
                     if k.startswith("text_model.encoder.layers."))
    positions = state["text_model.embeddings.position_embedding.weight"] \
        .shape[0]
    return {"vocab_size": int(vocab), "max_positions": int(positions),
            "width": int(width), "layers": layers,
            "num_heads": int(width) // 64}


@torch.inference_mode()
def derive_null_text_emb(state: dict, device="cuda"):
    """The empty prompt through the CLIP text tower with `state`'s weights
    (published or converted names) on `device`, in f32: (77, width) f32 on
    the CPU, DiffuEraser's `null_text_emb`. The ids are
    `tokenizer.null_text_ids` for the state's vocab size."""
    state = published_state_dict(state, "clip")
    dims = clip_dims(state)
    with torch.device("meta"):
        model = CLIPTextModel(**dims)
    model.to_empty(device=device).load_state_dict(state)
    model.float().eval()
    ids = null_text_ids(dims["max_positions"], dims["vocab_size"])
    ids = torch.from_numpy(ids).long()[None].to(device)
    return model(ids)[0].float().cpu()
