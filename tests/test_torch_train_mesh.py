"""The port's trainer on a ("data", "model") mesh (train/train_step.py,
parallel/sharding.py) against the JAX package's, f32 on the CPU.

1. The sharding rules: for every parameter of the tiny UNet and BrushNet,
   the port's split dim equals the JAX package's param_sharding_rules spec
   of the same parameter (through the converter's names, a Flax kernel's
   (in, out) being an nn.Linear's (out, in)); GEGLU's shard pairs its `h`
   and `gate` rows; an axis that does not divide a width or a head count
   raises.
2. The step: the tiny two-level config of tests/test_torch_train.py (B = 2
   clips of T = 3 frames, 16x16 latents) in the JAX trainer on a (2, 2)
   mesh of 4 virtual CPU devices, and in the port on gloo ranks at (2, 1)
   and (1, 2) in one 2-rank spawn and at (2, 2) in one 4-rank spawn, with
   JAX's t and noise. After one step from zero moments: the loss within
   1e-5 relative, AdamW's mu (0.1 g) and nu gathered whole within 1e-4 of
   each parameter's max. Under a "model" split remat (which recomputes
   the forward's all-reduces) gives the same step bitwise, and the
   replicated parameters and moments are bitwise equal across the model
   ranks after two steps;
   the generator path at (2, 1) equals one device with the same seed
   within the same bounds; a state saved at (1, 2) restores bitwise at
   (2, 1) and on one device.
"""
import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from test_torch_train import GRAD_TOL, _close_per_param, _jax_params, _port
from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.config import tiny_config
from videovanish_tpu.core.mesh import make_mesh
from videovanish_tpu.models.diffueraser.brushnet import BrushNetModel as JBrush
from videovanish_tpu.models.diffueraser.unet import UNetCondition as JUNet
from videovanish_tpu.parallel.sharding import param_sharding_rules
from videovanish_tpu.train.train_step import make_train_step as j_make_step
from videovanish_tpu_torch.convert import (
    jax_params_to_state_dict, jax_train_state_to_port,
)
from videovanish_tpu_torch.models.diffueraser.blocks import Attention
from videovanish_tpu_torch.models.diffueraser.brushnet import BrushNetModel
from videovanish_tpu_torch.models.diffueraser.unet import UNetCondition
from videovanish_tpu_torch.parallel import (
    ModelShard, join_shards, shard_module_, shard_tensor, split_dim,
)
from videovanish_tpu_torch.train import make_train_step, restore_train_state

B, T, H, W = 2, 3, 16, 16


def _dims():
    """(channels, layers, heads, context width) of the tiny config at two
    levels, as tests/test_torch_train.py trains it."""
    cfg = tiny_config().diffueraser
    return (cfg.block_out_channels[:2], cfg.layers_per_block,
            cfg.attention_head_dim, cfg.cross_attention_dim)


def _jax_models_and_params():
    ch, layers, heads, ctx = _dims()
    ju = JUNet(block_out_channels=ch, layers_per_block=layers,
               num_attention_heads=heads, cross_attention_dim=ctx)
    jbn = JBrush(block_out_channels=ch, layers_per_block=layers,
                 num_attention_heads=heads)
    t0 = jnp.zeros((B * T,), jnp.int32)
    txt0 = jnp.zeros((B * T, 77, ctx))
    params = {"unet": _jax_params(ju, (jnp.zeros((B * T, H, W, 4)), t0, txt0,
                                       T), seed=7),
              "brushnet": _jax_params(jbn, (jnp.zeros((B * T, H, W, 9)), t0,
                                            txt0, T), seed=8)}
    return ju, jbn, params


def test_sharding_rules_match_jax():
    _, _, params = _jax_models_and_params()
    mesh = make_mesh(jax.devices()[:4], model_parallel=2)
    ch, layers, heads, ctx = _dims()
    ports = {"unet": UNetCondition(4, 4, ch, layers, heads, ctx),
             "brushnet": BrushNetModel(9, ch, layers, heads, ctx)}
    split = 0
    for name, tree in params.items():
        specs = param_sharding_rules(tree, mesh)
        paths = jax.tree_util.tree_flatten_with_path(tree)[0]
        leaves = jax.tree_util.tree_leaves(specs)
        # each leaf filled with its index: the converter's key of the leaf
        # is where that index lands
        tagged = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [np.full(a.shape, i, np.float32)
             for i, (_, a) in enumerate(paths)])
        keys = {int(v.reshape(-1)[0]): k for k, v in
                jax_params_to_state_dict(tagged, name).items()}
        shapes = {k: p.shape for k, p in ports[name].named_parameters()}
        assert set(keys.values()) == set(shapes), name
        for i, ((path, a), sharding) in enumerate(zip(paths, leaves)):
            spec = tuple(sharding.spec)
            j = spec.index("model") if "model" in spec else None
            want = None if j is None else (1 - j if a.ndim == 2 else j)
            key = keys[i]
            assert split_dim(key, len(shapes[key])) == want, \
                (name, jax.tree_util.keystr(path), spec, key)
            split += want is not None
    assert split > 0

    # GEGLU: rank r's shard holds rank r's rows of h and of gate
    w = dict(ports["unet"].named_parameters())
    for key in [k for k in w if k.endswith("ff.net.0.proj.weight")] + \
            [k for k in w if k.endswith("ff.net.0.proj.bias")]:
        whole = w[key].detach()
        inner = whole.shape[0] // 2
        for size in (2, 4):
            per = inner // size
            shards = [shard_tensor(key, whole, r, size) for r in range(size)]
            for r, s in enumerate(shards):
                assert torch.equal(s[:per], whole[r * per:(r + 1) * per])
                assert torch.equal(s[per:], whole[inner + r * per:
                                                  inner + (r + 1) * per])
            assert torch.equal(join_shards(key, shards), whole)
    # an axis that divides neither a width nor a head count raises
    with pytest.raises(ValueError):
        shard_tensor("to_q.weight", torch.zeros(30, 8), 0, 4)
    attn = Attention(32, heads=6, head_dim=4)  # 24 wide, 6 heads
    with pytest.raises(ValueError):
        shard_module_(attn, ModelShard(None, 0, 4))


def test_train_step_on_mesh_matches_jax(tmp_path):
    ju, jbn, params = _jax_models_and_params()
    ch, layers, heads, ctx = _dims()
    rng = np.random.default_rng(3)
    batch_np = {"latents": rng.standard_normal((B, T, H, W, 4)),
                "masked_lat": rng.standard_normal((B, T, H, W, 4)),
                "mask_lat": rng.random((B, T, H, W, 1)) > 0.5,
                "text_emb": rng.standard_normal((B, 77, ctx))}
    batch_np = {k: v.astype(np.float32) for k, v in batch_np.items()}
    batch_p = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    # JAX's draws, as its loss_fn makes them from the step's key
    key = jax.random.PRNGKey(11)
    k_t, k_n = jax.random.split(key)
    t = torch.tensor(np.asarray(jax.random.randint(k_t, (B,), 0, 1000)))
    noise = torch.tensor(np.asarray(
        jax.random.normal(k_n, (B, T, H, W, 4), jnp.float32)))
    whole = _port(params)
    dims = (ch, layers, heads, ctx)

    def jax_step():
        """The JAX step on a (2, 2) mesh: loss and state, the global arrays
        gathered into the port's layout."""
        t0 = time.perf_counter()
        mesh = make_mesh(jax.devices()[:4], model_parallel=2)
        j_init, j_step = j_make_step(ju, jbn, mesh)
        js, loss = j_step(j_init(params), {k: jnp.asarray(v) for k, v in
                                           batch_np.items()}, key)
        print(f"JAX step on a (2, 2) mesh: {time.perf_counter() - t0:.1f} s")
        return float(loss), jax_train_state_to_port(js)

    # the JAX program compiles in a thread while the ranks run
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_result = pool.submit(jax_step)
        t0 = time.perf_counter()
        save = str(tmp_path / "state_1x2.pt")
        two = R.run_ranks(R.train_on_meshes, 2, tmp_path, dims, whole,
                          batch_p, t, noise, (1, 2), save, timeout=300.0)[0]
        four = R.run_ranks(R.train_on_meshes, 4, tmp_path, dims, whole,
                           batch_p, t, noise, (2,), timeout=300.0)[0]
        print(f"ranks: {time.perf_counter() - t0:.1f} s")
        loss_j, want = jax_result.result()

    def moments(res):
        return {slot: {m: {k: torch.from_numpy(v)
                           for k, v in res[slot][m].items()}
                       for m in res[slot]} for slot in ("mu", "nu")}

    results = {**{k: v for k, v in two.items() if isinstance(k, tuple)},
               **{k: v for k, v in four.items()}}
    assert set(results) == {(2, 1), (1, 2), (2, 2)}
    for shape, res in results.items():
        assert res["init_kept_shards"], shape
        assert abs(res["loss"] - loss_j) <= 1e-5 * abs(loss_j), \
            (shape, res["loss"], loss_j)
        got = moments(res)
        for slot in ("mu", "nu"):
            _close_per_param(got[slot], want.opt_state[slot],
                             f"{shape} {slot}", GRAD_TOL)
        if shape[1] > 1:
            assert res["remat_bitwise"], shape
            assert res["replicated_differ"] == [], (shape,
                                                    res["replicated_differ"])

    # the generator path at (2, 1) against one device, the same seed
    gen = two["generator"]
    assert abs(gen["mesh"]["loss"] - gen["single"]["loss"]) <= \
        1e-5 * abs(gen["single"]["loss"])
    got, ref = moments(gen["mesh"]), moments(gen["single"])
    for slot in ("mu", "nu"):
        _close_per_param(got[slot], ref[slot], f"generator {slot}", GRAD_TOL)

    # the (1, 2) state's file, restored at (2, 1) and on one device
    saved = two[(1, 2)]["saved"]
    shape, step, count, restored = two["restored"]
    assert shape == (2, 1) and step == 2 and count == 2
    unet, brushnet = (UNetCondition(4, 4, ch, layers, heads, ctx),
                      BrushNetModel(9, ch, layers, heads, ctx))
    init_fn, _ = make_train_step(unet, brushnet, None, device="cpu")
    one = restore_train_state(save, init_fn())
    assert (one.step, one.opt_state["count"]) == (2, 2)
    trees = {"params": one.params, "mu": one.opt_state["mu"],
             "nu": one.opt_state["nu"]}
    for slot, tree in trees.items():
        for m in tree:
            for k, v in tree[m].items():
                assert np.array_equal(v.detach().numpy(), saved[slot][m][k]), \
                    ("one device", slot, m, k)
                assert np.array_equal(restored[slot][m][k],
                                      saved[slot][m][k]), ("(2, 1)", slot,
                                                           m, k)
