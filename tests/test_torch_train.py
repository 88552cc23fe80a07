"""The port's training step (videovanish_tpu_torch.train) and the gradients
of its attention wrappers against the JAX package, f32 on the CPU.

1. Attention gradients: seeded q, k, v and dO through the port's kernel
   wrappers with requires_grad (on the CPU their autograd Function runs the
   plain forward and the closed-form plain backward) against jax.vjp of
   `_xla_attention` (flash-routed shapes) and `_packed_small_attention`
   (small_seq shapes), 1e-4 of max|JAX| per gradient; without grad the
   wrappers stay on their direct path.
2. The train step: the tiny UNet and BrushNet in both packages with the
   same weights, JAX's t and noise drawn the way its loss draws them; the
   loss within 1e-5 relative, each parameter's gradient within 1e-4 of its
   max|g|, AdamW's moments after a carried JAX state's next step; remat
   gives the same loss bitwise; a checkpoint round-trips bitwise.

The CUDA backward kernels run only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py hold them against the plain backward).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.config import tiny_config
from videovanish_tpu.core.mesh import make_mesh
from videovanish_tpu.models.diffueraser.brushnet import BrushNetModel as JBrush
from videovanish_tpu.models.diffueraser.unet import UNetCondition as JUNet
from videovanish_tpu.train.train_step import make_train_step as j_make_step
from videovanish_tpu_torch.convert import (
    jax_params_to_state_dict, jax_train_state_to_port,
)
from videovanish_tpu_torch.models.diffueraser.brushnet import BrushNetModel
from videovanish_tpu_torch.models.diffueraser.unet import UNetCondition
from videovanish_tpu_torch.ops import attention as P
from videovanish_tpu_torch.train import (
    make_train_step, restore_train_state, save_train_state,
)

# ops/__init__.py exports a function named `attention` over the module
J = importlib.import_module("videovanish_tpu.ops.attention")

GRAD_TOL = 1e-4  # of max|JAX|, per gradient


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _attention_case(kind, shape, rng):
    """(numpy q, k, v, dO, JAX function, port function) of one case."""
    if kind == "tokenmajor":
        N, S, heads, d = shape
        q, k, v, do = (_randn(rng, N, S, heads * d) for _ in range(4))
        scale = d ** -0.5

        def jax_fn(q, k, v):
            def split(t):
                return t.reshape(N, S, heads, d).transpose(0, 2, 1, 3)
            o = J._packed_small_attention(split(q), split(k), split(v), scale)
            return o.transpose(0, 2, 1, 3).reshape(N, S, heads * d)

        def port_fn(q, k, v):
            return P.small_seq_attention_tokenmajor(q, k, v, heads, scale)
        return q, k, v, do, jax_fn, port_fn
    B, H, Sq, Sk, D = shape
    q, do = _randn(rng, B, H, Sq, D), _randn(rng, B, H, Sq, D)
    k, v = _randn(rng, B, H, Sk, D), _randn(rng, B, H, Sk, D)
    scale = D ** -0.5
    if kind == "flash":
        def jax_fn(q, k, v):
            return J._xla_attention(q, k, v, scale)

        def port_fn(q, k, v):
            return P.flash_attention(q, k, v, scale)
    else:
        def jax_fn(q, k, v):
            return J._packed_small_attention(q, k, v, scale)

        def port_fn(q, k, v):
            return P.small_seq_attention(q, k, v, scale)
    return q, k, v, do, jax_fn, port_fn


def test_attention_gradients_match_jax_vjp():
    """Each wrapper's gradient (its autograd Function, plain on the CPU)
    against jax.vjp of the XLA function the JAX trainer differentiates;
    with no grad, the direct path and its old output bitwise."""
    cases = [
        # flash_attn_bwd's shapes: D = 40 with a key tail that is not a
        # multiple of 16, the Sk = 77 text cross-attention at D = 80, D = 160
        ("flash", (1, 2, 100, 100, 40)),
        ("flash", (1, 2, 70, 77, 80)),
        ("flash", (2, 1, 48, 33, 160)),
        # small_seq_attn_bwd's: S = 22 and 64, Sq != Sk, both layouts
        ("small_seq", (8, 2, 22, 22, 40)),
        ("small_seq", (4, 2, 17, 30, 80)),
        ("small_seq", (2, 2, 64, 64, 160)),
        ("tokenmajor", (6, 22, 2, 80)),
        ("tokenmajor", (3, 64, 2, 160)),
    ]
    rng = np.random.default_rng(0)
    for kind, shape in cases:
        q, k, v, do, jax_fn, port_fn = _attention_case(kind, shape, rng)
        out, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        got = port_fn(*ts)
        assert type(got.grad_fn).__name__.endswith("AttentionBackward"), \
            (kind, shape, got.grad_fn)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                                   atol=1e-5)
        got.backward(torch.from_numpy(do))
        for name, t, g in zip("qkv", ts, want):
            g = np.asarray(g)
            err = np.abs(t.grad.numpy() - g).max()
            assert err <= GRAD_TOL * np.abs(g).max(), \
                (kind, shape, f"d{name}", err, np.abs(g).max())
        if kind != "tokenmajor":
            # the plain backward in query chunks of 7 rows: dK and dV summed
            # over the chunks, dQ joined
            B, H, Sq, Sk, D = shape
            chunked = P.attention_backward_ref(
                *(t.detach() for t in ts), got.detach(), torch.from_numpy(do),
                D ** -0.5, max_score_bytes=B * H * Sk * 4 * 7)
            for name, c, g in zip("qkv", chunked, want):
                g = np.asarray(g)
                err = np.abs(c.numpy() - g).max()
                assert err <= GRAD_TOL * np.abs(g).max(), \
                    (kind, shape, f"chunked d{name}", err, np.abs(g).max())

        # inference: no grad, the direct path, bitwise what it returned
        # before (the plain version) whether or not the inputs require grad
        plain = [torch.from_numpy(x) for x in (q, k, v)]
        if kind == "tokenmajor":
            heads = shape[2]
            d = q.shape[-1] // heads
            split = [P._split_heads(t, heads) for t in plain]
            before = P.small_seq_attention_ref(*split, d ** -0.5) \
                .permute(0, 2, 1, 3).reshape(q.shape)
        else:
            before = P.plain_attention(*plain, shape[-1] ** -0.5)
        with torch.no_grad():
            direct = port_fn(*ts)
        assert direct.grad_fn is None
        assert torch.equal(direct, before)
        assert torch.equal(port_fn(*plain), before)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _jax_params(module, args, seed):
    """Random parameters for a flax module without running its init: shapes
    from eval_shape, kernels normal / sqrt(fan_in), biases and norm offsets
    normal * 0.1, norm scales 1 + normal * 0.1 (BrushNet's zero convs are
    not zero, so every parameter gets a gradient)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            return z / np.sqrt(np.prod(s.shape[:-1]))
        return 1.0 + 0.1 * z if leaf == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


def _adamw_update(grads, state):
    """The opt_state after optax.adamw's update (the JAX trainer's
    defaults) of `state` with `grads`, taken on the leaves raveled into one
    vector (the update is elementwise), so that it compiles as one small
    program."""
    leaves, tree = jax.tree_util.tree_flatten(state.params)
    sizes = np.cumsum([x.size for x in leaves])[:-1]

    def flat(t):  # numpy: no JAX program per leaf shape
        return np.concatenate([np.ravel(np.asarray(x))
                               for x in jax.tree_util.tree_leaves(t)])

    def unflat(v):
        return jax.tree_util.tree_unflatten(tree, [
            a.reshape(x.shape)
            for a, x in zip(np.split(np.asarray(v), sizes), leaves)])
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    tx = optax.adamw(1e-5, weight_decay=1e-2)
    opt = tuple(s._replace(count=adam.count, mu=flat(adam.mu),
                           nu=flat(adam.nu)) if hasattr(s, "mu") else s
                for s in tx.init(flat(state.params)))
    new = next(s for s in jax.jit(tx.update)(flat(grads), opt,
                                             flat(state.params))[1]
               if hasattr(s, "mu"))
    return (new._replace(mu=unflat(new.mu), nu=unflat(new.nu)),)


def _port(tree):
    return {"unet": jax_params_to_state_dict(tree["unet"], "unet"),
            "brushnet": jax_params_to_state_dict(tree["brushnet"],
                                                 "brushnet")}


NOISE = 1e-6  # of a model's largest |g|: a gradient zero in exact arithmetic


def _close_per_param(got: dict, want: dict, what: str, tol: float):
    """Every tensor of got[model][key] within tol * max|want| of want's.
    Where max|want| is below NOISE of the model's largest, the gradient is
    zero in exact arithmetic (at this width, a per-channel bias or time
    projection just ahead of a GroupNorm of one channel a group) and both
    hold rounding noise (about 1e-7 of the largest): got must be below
    NOISE of the largest too."""
    for name in ("unet", "brushnet"):
        assert set(got[name]) == set(want[name]), (what, name)
        top = max(float(w.abs().max()) for w in want[name].values())
        for key, w in want[name].items():
            w = w.numpy()
            g = got[name][key].detach().numpy()
            scale = np.abs(w).max()
            if scale < NOISE * top:
                assert np.abs(g).max() < NOISE * top, (what, name, key)
                continue
            err = np.abs(g - w).max()
            assert err <= tol * scale, (what, name, key, err, scale)


def test_train_step_matches_jax(tmp_path):
    """One JAX step_fn, the test's copy of its loss (value_and_grad, the
    same program for the second draws) and optax's AdamW update for the
    carried state's next step: the JAX programs this test compiles."""
    cfg = tiny_config().diffueraser
    # the tiny config's widths at two levels: every block kind of SD1.5's
    # four (cross-attention down, plain down, mid, plain up, cross-attention
    # up, a motion module in each) at about half the compile time
    ch, layers = cfg.block_out_channels[:2], cfg.layers_per_block
    heads, ctx = cfg.attention_head_dim, cfg.cross_attention_dim
    B, T, h, w = 1, 3, 16, 16
    rng = np.random.default_rng(3)
    batch_np = {"latents": _randn(rng, B, T, h, w, 4),
                "masked_lat": _randn(rng, B, T, h, w, 4),
                "mask_lat": (rng.random((B, T, h, w, 1)) > 0.5)
                .astype(np.float32),
                "text_emb": _randn(rng, B, 77, ctx)}
    batch_j = {k: jnp.asarray(v) for k, v in batch_np.items()}
    batch_p = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    ju = JUNet(block_out_channels=ch, layers_per_block=layers,
               num_attention_heads=heads, cross_attention_dim=ctx)
    jbn = JBrush(block_out_channels=ch, layers_per_block=layers,
                 num_attention_heads=heads)
    t0 = jnp.zeros((B * T,), jnp.int32)
    txt0 = jnp.zeros((B * T, 77, ctx))
    params = {"unet": _jax_params(ju, (jnp.zeros((B * T, h, w, 4)), t0, txt0,
                                       T), seed=7),
              "brushnet": _jax_params(jbn, (jnp.zeros((B * T, h, w, 9)), t0,
                                            txt0, T), seed=8)}

    # JAX's draws, as its loss_fn makes them from the step's key
    def draws(key):
        k_t, k_n = jax.random.split(key)
        t = jax.random.randint(k_t, (B,), 0, 1000)
        noise = jax.random.normal(k_n, (B, T, h, w, 4), jnp.float32)
        return t, noise

    # the test's copy of the JAX loss, on given draws
    def mirror_loss(p, t, noise):
        t_full = jnp.repeat(t, T)

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])
        from videovanish_tpu.models.diffueraser.scheduler import NoiseSchedule
        x_t = NoiseSchedule().add_noise(flat(batch_j["latents"]), flat(noise),
                                        t_full)
        bs = jnp.concatenate([x_t, flat(batch_j["masked_lat"]),
                              flat(batch_j["mask_lat"])], axis=-1)
        txt = jnp.repeat(batch_j["text_emb"], T, axis=0)
        bd, bm, bu = jbn.apply({"params": p["brushnet"]}, bs, t_full, txt, T)
        eps = ju.apply({"params": p["unet"]}, x_t, t_full, txt, T,
                       brushnet_down=bd, brushnet_mid=bm, brushnet_up=bu)
        return jnp.mean(jnp.square(eps.astype(jnp.float32) - flat(noise)))

    key1, key2 = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    t1, noise1 = draws(key1)
    value_and_grad = jax.jit(jax.value_and_grad(mirror_loss))
    loss_m, grads_j = value_and_grad(params, t1, noise1)
    loss_m = float(loss_m)

    mesh = make_mesh(jax.devices()[:1])
    j_init, j_step = j_make_step(ju, jbn, mesh)
    js1, loss_j = j_step(j_init(params), batch_j, key1)
    assert abs(float(loss_j) - loss_m) <= 1e-6 * abs(loss_m), \
        (float(loss_j), loss_m)
    # the next step's AdamW moments, as step_fn's optax update makes them
    t2, noise2 = draws(key2)
    _, grads2 = value_and_grad(jax.tree_util.tree_map(np.asarray,
                                                      js1.params), t2, noise2)
    js2 = js1._replace(opt_state=_adamw_update(grads2, js1))

    def models():
        return (UNetCondition(4, 4, ch, layers, heads, ctx),
                BrushNetModel(9, ch, layers, heads, ctx))

    def step_args(t, noise):
        return dict(t=torch.tensor(np.asarray(t)),
                    noise=torch.tensor(np.asarray(noise)))

    # the loss and every parameter's gradient
    unet, brushnet = models()
    init_fn, step_fn = make_train_step(unet, brushnet, None, device="cpu")
    state = init_fn(_port(params))
    state, loss_p = step_fn(state, batch_p, **step_args(t1, noise1))
    assert state.step == 1 and state.opt_state["count"] == 1
    assert abs(float(loss_p) - loss_m) <= 1e-5 * abs(loss_m), \
        (float(loss_p), loss_m)
    grads_p = {"unet": {k: p.grad for k, p in unet.named_parameters()},
               "brushnet": {k: p.grad for k, p in
                            brushnet.named_parameters()}}
    _close_per_param(grads_p, _port(grads_j), "grad", GRAD_TOL)

    # AdamW: a JAX state taken one step, carried over, one more step in both
    carried = jax_train_state_to_port(js1)
    assert carried.step == 1 and carried.opt_state["count"] == 1
    state, _ = step_fn(carried, batch_p, **step_args(t2, noise2))
    want = jax_train_state_to_port(js2)
    assert state.step == 2 and state.opt_state["count"] == 2
    for slot in ("mu", "nu"):
        _close_per_param(state.opt_state[slot], want.opt_state[slot], slot,
                         GRAD_TOL)

    # remat: the same loss, bitwise
    losses = []
    for remat in (False, True):
        u, bn = models()
        i_fn, s_fn = make_train_step(u, bn, None, remat=remat, device="cpu")
        losses.append(s_fn(i_fn(_port(params)), batch_p,
                           **step_args(t1, noise1))[1])
    assert torch.equal(losses[0], losses[1]), losses

    # checkpoint: save, step on, restore into the live state, bitwise
    path = str(tmp_path / "train_state.pt")
    save_train_state(path, state)
    saved = (state.step, state.opt_state["count"],
             {slot: {m: {k: v.clone() for k, v in tree[m].items()}
                     for m in tree}
              for slot, tree in (("params", state.params),
                                 ("mu", state.opt_state["mu"]),
                                 ("nu", state.opt_state["nu"]))})
    gen = torch.Generator().manual_seed(0)
    moved, _ = step_fn(state, batch_p, gen)
    restored = restore_train_state(path, moved)
    assert (restored.step, restored.opt_state["count"]) == saved[:2]
    for slot, tree in (("params", restored.params),
                       ("mu", restored.opt_state["mu"]),
                       ("nu", restored.opt_state["nu"])):
        for m in tree:
            for k, v in tree[m].items():
                assert torch.equal(v, saved[2][slot][m][k]), (slot, m, k)
    state, loss = step_fn(restored, batch_p, gen)
    assert state.step == 3 and torch.isfinite(loss)
