"""The port's CLIP text tower and tokenizer against the JAX package's, on
the CPU.

A tiny CLIP (2 layers, width 128, so 2 heads of CLIP's 64, vocab 300,
77 positions) with seeded weights in transformers' key names goes through
the JAX package's own converter (CLIP_RULES, CLIP_SPECIAL); the port's inverse
(`jax_params_to_state_dict(tree, "clip")`) must give the same state dict
back bitwise. The hidden states of both towers on the same ids agree within
1e-4 of max|JAX|, the causal mask is active in the port's, and
`derive_null_text_emb` matches the JAX one within the same limit.

The tokenizers run over the synthetic vocab and merges of
tests/test_tokenizer.py (both files, the same files): strings with
uppercase, runs of whitespace, contractions, digits, "²" and "Ⅻ" (numbers
that `\\d` misses), a decomposed "é", CJK and punctuation runs, and a
prompt cut at 77 ids give equal ids.
"""
import numpy as np
import torch

import jax.numpy as jnp
from test_tokenizer import vocab_files  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.core.convert import convert_state_dict
from videovanish_tpu.models.diffueraser.text_encoder import (
    CLIP_RULES, CLIP_SPECIAL,
)
from videovanish_tpu.models.diffueraser.text_encoder import (
    CLIPTextModel as JCLIPTextModel,
)
from videovanish_tpu.models.diffueraser.text_encoder import (
    derive_null_text_emb as j_derive_null_text_emb,
)
from videovanish_tpu.models.diffueraser.tokenizer import (
    CLIPTokenizer as JCLIPTokenizer,
)
from videovanish_tpu_torch.convert import jax_params_to_state_dict
from videovanish_tpu_torch.models.diffueraser.text_encoder import (
    CLIPTextModel, derive_null_text_emb,
)
from videovanish_tpu_torch.models.diffueraser.tokenizer import (
    CLIPTokenizer, null_text_ids,
)

DIMS = dict(vocab_size=300, max_positions=77, width=128, layers=2,
            num_heads=2)

TEXTS = [
    "A Photo of a CAT", "hello    world\t\n again", "don't STOP it's we'll "
    "they've I'm you're he'd", "the 4k 1920x1080 scan 123", "x² + Ⅻ",
    "cafe\u0301 and caf\u00e9", "中文 字幕 テスト",
    "wow!!! ...?! (a-b) {c}",
    "  ", "'s 'S'tis", "hello " * 60,
]


def seeded_clip_state(seed: int = 0, dims: dict = DIMS) -> dict:
    """transformers' key names; linears uniform in +-1/sqrt(fan_in),
    embeddings normal at 0.02, LayerNorms near 1 and 0, and the
    position-id buffer a published file carries."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = CLIPTextModel(**dims)
    out = {}
    for k, p in model.state_dict().items():
        shape = tuple(p.shape)
        if "embedding" in k:
            a = rng.standard_normal(shape) * 0.02
        elif "norm" in k:
            a = (k.endswith(".weight") + 0.1 * rng.standard_normal(shape))
        else:
            fan_in = shape[1] if len(shape) == 2 else \
                out[k[:-len("bias")] + "weight"].shape[1]
            a = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        out[k] = torch.from_numpy(a.astype(np.float32))
    out["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    return out


def test_text_tower_matches_jax(vocab_files):  # noqa: F811
    # the tokenizers on the same vocab files
    ours = CLIPTokenizer.from_files(*vocab_files)
    ref = JCLIPTokenizer.from_files(*vocab_files)
    for text in TEXTS:
        assert ours.tokenize(text) == ref.tokenize(text), text
        assert ours.encode(text) == ref.encode(text), text
        got = ours(text)
        assert got.dtype == np.int32 and got.shape == (77,)
        np.testing.assert_array_equal(got, ref(text), err_msg=text)
    assert len(ours.encode(TEXTS[-1])) > 77 and ours(TEXTS[-1])[-1] == \
        ours.eos_id
    np.testing.assert_array_equal(null_text_ids(), [49406] + [49407] * 76)
    np.testing.assert_array_equal(null_text_ids(5, 300), [298] + [299] * 4)

    # the weights carried across both ways
    state = seeded_clip_state()
    tree = convert_state_dict({k: v.numpy() for k, v in state.items()},
                              CLIP_RULES, CLIP_SPECIAL)
    back = jax_params_to_state_dict(tree, "clip")
    assert back.keys() == state.keys() - {"text_model.embeddings.position_ids"}
    for k, v in back.items():
        assert torch.equal(v, state[k]), k

    model = CLIPTextModel(**DIMS)
    model.load_state_dict(back)
    jmodel = JCLIPTextModel(**DIMS)
    ids = np.random.default_rng(1).integers(0, DIMS["vocab_size"], (2, 77))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    want = np.asarray(jmodel.apply({"params": tree},
                                   jnp.asarray(ids, jnp.int32)))
    limit = 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= limit
    # causal: a later token moves no earlier position
    ids2 = ids.copy()
    ids2[:, 40] = (ids2[:, 40] + 1) % DIMS["vocab_size"]
    with torch.no_grad():
        got2 = model(torch.from_numpy(ids2)).numpy()
    np.testing.assert_array_equal(got2[:, :40], got[:, :40])
    assert np.abs(got2[:, 40:] - got[:, 40:]).max() > 1e-3

    null = derive_null_text_emb(state, device="cpu")
    want = j_derive_null_text_emb(
        tree, width=DIMS["width"], layers=DIMS["layers"],
        num_heads=DIMS["num_heads"], vocab_size=DIMS["vocab_size"],
        max_positions=DIMS["max_positions"])
    assert null.dtype == torch.float32 and null.shape == (77, DIMS["width"])
    assert np.abs(null.numpy() - want).max() <= 1e-4 * np.abs(want).max()
