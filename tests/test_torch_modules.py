"""The port's DiffuEraser modules against their JAX counterparts at small
size, f32 on the CPU: the same seeded inputs and the same weights (JAX
parameters carried into the port by videovanish_tpu_torch.convert),
layouts transposed at the module boundary (JAX NHWC, port NCHW).
Tolerance 1e-4 abs per block, 2e-4 through a whole UNet or BrushNet, as
the JAX package's own oracle gates use."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from videovanish_tpu.models.diffueraser import blocks as jb
from videovanish_tpu.models.diffueraser import scheduler as jsched
from videovanish_tpu.models.diffueraser import temporal as jt
from videovanish_tpu.models.diffueraser.brushnet import BrushNetModel as JBrush
from videovanish_tpu.models.diffueraser.unet import UNetCondition as JUNet
from videovanish_tpu.models.diffueraser.vae import AutoencoderKL as JVAE
from videovanish_tpu_torch.convert import jax_params_to_state_dict
from videovanish_tpu_torch.models.diffueraser import blocks as pb
from videovanish_tpu_torch.models.diffueraser import scheduler as psched
from videovanish_tpu_torch.models.diffueraser import temporal as pt
from videovanish_tpu_torch.models.diffueraser.brushnet import BrushNetModel
from videovanish_tpu_torch.models.diffueraser.unet import UNetCondition
from videovanish_tpu_torch.models.diffueraser.vae import AutoencoderKL

# the UNet / BrushNet pair has two levels: the block kinds of SD1.5's four
# (cross-attention down, plain down, mid, plain up, cross-attention up, a
# motion module in each) at half the compile time of four levels
CH, LAYERS, HEADS, CTX = (32, 64), 1, 8, 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(module, *args, seed=0, method=None):
    """Random parameters for a flax module without running its init (the
    eager init of a UNet takes tens of seconds): shapes from eval_shape,
    kernels normal / sqrt(fan_in), biases and norm offsets normal * 0.1,
    norm scales 1 + normal * 0.1."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            return z / np.sqrt(np.prod(s.shape[:-1]))
        return 1.0 + 0.1 * z if leaf == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


def _load(module, params, model="unet"):
    """JAX params -> port module (1x1-conv kernels reshaped to the
    module's shapes where a block is converted outside its model)."""
    sd = jax_params_to_state_dict(_np_tree(params), model)
    want = module.state_dict()
    module.load_state_dict({k: v.reshape(want[k].shape) for k, v in sd.items()})
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.array([0, 3, 499, 999], np.int32)
    ref = np.asarray(jb.timestep_embedding(jnp.asarray(t), dim))
    got = pb.timestep_embedding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_resnet_block_with_time_embedding():
    x, temb = _randn(0, 2, 8, 8, 32), _randn(1, 2, 128)
    jm = jb.ResnetBlock2D(64)
    params = _init(jm, jnp.asarray(x), jnp.asarray(temb))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(temb)))
    pm = _load(pb.ResnetBlock2D(32, 64, 128), params)
    got = _nhwc(pm(_nchw(x), torch.from_numpy(temb)))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_transformer2d_with_context():
    x, ctx = _randn(2, 2, 6, 10, 64), _randn(3, 2, 77, 48)
    jm = jb.Transformer2D(8, 8)
    params = _init(jm, jnp.asarray(x), jnp.asarray(ctx), seed=1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(ctx)))
    pm = _load(pb.Transformer2D(64, 8, 8, 48), params)
    got = _nhwc(pm(_nchw(x), torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("t_frames,tokens", [(4, 6), (22, 16)])
def test_temporal_attention(t_frames, tokens):
    """(B*T, S, C) temporal self-attention; at T=22 with 128 sequences x 8
    heads both sides take the packed small-sequence path."""
    x = _randn(4, 2 * t_frames, tokens, 64)
    jm = jb.Attention(8, 8)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), t_frames=t_frames)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), t_frames=t_frames))
    pm = _load(pb.Attention(64, 8, 8), params["params"])
    got = pm(torch.from_numpy(x), t_frames=t_frames).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_motion_module():
    T = 22
    x = _randn(5, 2 * T, 4, 3, 64)
    jm = jt.MotionModule(8)
    params = _init(jm, jnp.asarray(x), T, seed=3)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), T))
    pm = _load(pt.MotionModule(64, 8), params)
    got = _nhwc(pm(_nchw(x), T))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_positional_embedding():
    np.testing.assert_allclose(
        pt.sinusoidal_positional_embedding(22, 64).numpy(),
        np.asarray(jt.sinusoidal_positional_embedding(22, 64)), atol=0)


@pytest.mark.parametrize("asym", [True, False])
def test_downsample(asym):
    x = _randn(6, 2, 9, 15, 16)
    jm = jb.Downsample2D(16, asymmetric_pad=asym)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = _nhwc(_load(pb.Downsample2D(16, asym), params["params"])(_nchw(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("out_hw", [None, (17, 30)])
def test_upsample(out_hw):
    x = _randn(7, 2, 9, 15, 16)
    jm = jb.Upsample2D(16)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), out_hw)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), out_hw))
    got = _nhwc(_load(pb.Upsample2D(16), params["params"])(_nchw(x), out_hw))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_vae_encode_decode():
    chans = (16, 32, 32, 32)
    x = np.clip(_randn(8, 2, 32, 40, 3, scale=0.5), -1, 1)
    jm = JVAE(chans, 2, 4)
    params = {**_init(jm, jnp.zeros((1, 4, 5, 4)), seed=6, method=jm.decode),
              **_init(jm, jnp.asarray(x), seed=7, method=jm.encode)}
    z = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                            method=jm.encode))
    rgb = np.asarray(jm.apply({"params": params}, jnp.asarray(z),
                              method=jm.decode))
    pm = _load(AutoencoderKL(chans, 2, 4), params, "vae")
    with torch.no_grad():
        pz = pm.encode(_nchw(x))
        np.testing.assert_allclose(_nhwc(pz), z, atol=1e-4)
        np.testing.assert_allclose(_nhwc(pm.decode(_nchw(z))), rgb, atol=1e-4)


@pytest.fixture(scope="module")
def unet_pair():
    """A tiny motion UNet + BrushNet in both frameworks (random weights,
    the BrushNet's zero convs included, so its features are not zero), and
    the JAX outputs: BrushNet features, the UNet's epsilon on x while
    recording the spatial attention ("attn_cache"), and its epsilon on a
    second input x2 replaying them. One compiled program each: eager flax
    runs op by op, much slower here."""
    T = 4
    x, x2 = _randn(10, T, 16, 16, 4), _randn(14, T, 16, 16, 4)
    bs = _randn(11, T, 16, 16, 9)
    ctx = _randn(12, T, 77, CTX)
    t = np.full((T,), 499, np.int32)
    ju = JUNet(block_out_channels=CH, layers_per_block=LAYERS,
               num_attention_heads=HEADS, cross_attention_dim=CTX)
    jbn = JBrush(block_out_channels=CH, layers_per_block=LAYERS,
                 num_attention_heads=HEADS)
    up = _init(ju, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), T,
               seed=7)
    bp = _init(jbn, jnp.asarray(bs), jnp.asarray(t), jnp.asarray(ctx), T,
               seed=8)
    feats = jax.jit(lambda p, *a: jbn.apply({"params": p}, *a, T))(
        bp, jnp.asarray(bs), jnp.asarray(t), jnp.asarray(ctx))

    def unet(variables, x, f, **kw):
        return ju.apply(variables, x, jnp.asarray(t), jnp.asarray(ctx), T,
                        brushnet_down=f[0], brushnet_mid=f[1],
                        brushnet_up=f[2], **kw)

    ref1, vars_ = jax.jit(lambda p, x, f: unet(
        {"params": p}, x, f, mutable=["attn_cache"]))(
        up, jnp.asarray(x), feats)
    ref2 = jax.jit(lambda v, x, f: unet(v, x, f))(
        {"params": up, "attn_cache": vars_["attn_cache"]}, jnp.asarray(x2),
        feats)
    return dict(
        T=T, x=x, x2=x2, bs=bs, ctx=ctx, t=t,
        feats=[np.asarray(a) for a in feats[0]] + [np.asarray(feats[1])]
        + [np.asarray(a) for a in feats[2]],
        n_down=len(feats[0]), ref1=np.asarray(ref1), ref2=np.asarray(ref2),
        pu=_load(UNetCondition(4, 4, CH, LAYERS, HEADS, CTX), up),
        pbn=_load(BrushNetModel(9, CH, LAYERS, HEADS, CTX), bp, "brushnet"))


@pytest.fixture(scope="module")
def port_brushnet_feats(unet_pair):
    u = unet_pair
    with torch.no_grad():
        return u["pbn"](_nchw(u["bs"]), torch.from_numpy(u["t"]),
                        torch.from_numpy(u["ctx"]))


def test_brushnet_features(unet_pair, port_brushnet_feats):
    pd, pm, pu = port_brushnet_feats
    got = list(pd) + [pm] + list(pu)
    assert len(got) == len(unet_pair["feats"])
    assert len(pd) == unet_pair["n_down"]
    for a, b in zip(got, unet_pair["feats"]):
        np.testing.assert_allclose(_nhwc(a), b, atol=2e-4)


def test_unet_with_brushnet_and_motion(unet_pair, port_brushnet_feats):
    u = unet_pair
    with torch.no_grad():
        got = _nhwc(u["pu"](_nchw(u["x"]), torch.from_numpy(u["t"]),
                            torch.from_numpy(u["ctx"]), u["T"],
                            *port_brushnet_feats))
    np.testing.assert_allclose(got, u["ref1"], atol=2e-4)


def test_spatial_attention_record_replay(unet_pair, port_brushnet_feats):
    """Record the Transformer2D attention outputs on x, replay them on x2:
    the port's AttentionCache gives the JAX "attn_cache" outputs."""
    u = unet_pair
    tt, tc, T = torch.from_numpy(u["t"]), torch.from_numpy(u["ctx"]), u["T"]
    cache = pb.AttentionCache()
    with torch.no_grad():
        got1 = _nhwc(u["pu"](_nchw(u["x"]), tt, tc, T, *port_brushnet_feats,
                             cache=cache))
        n_recorded = len(cache.outputs)
        cache.replay = True
        got2 = _nhwc(u["pu"](_nchw(u["x2"]), tt, tc, T, *port_brushnet_feats,
                             cache=cache))
        exact2 = _nhwc(u["pu"](_nchw(u["x2"]), tt, tc, T,
                               *port_brushnet_feats))
    # attn1 + attn2 of every Transformer2D: layers_per_block in each
    # cross-attention down level, one more in each up level, one in the mid
    n_transformers = (len(CH) - 1) * (2 * LAYERS + 1) + 1
    assert n_recorded == 2 * n_transformers
    np.testing.assert_allclose(got1, u["ref1"], atol=2e-4)
    np.testing.assert_allclose(got2, u["ref2"], atol=2e-4)
    assert np.abs(got2 - exact2).max() > 1e-3  # the replay is really used


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_pcm_timesteps(steps):
    np.testing.assert_array_equal(psched.pcm_timesteps(steps),
                                  jsched.pcm_timesteps(steps))


@pytest.mark.parametrize("t,t_next", [(999, 499), (499, -1), (759, 519)])
def test_consistency_step(t, t_next):
    js, ps = jsched.NoiseSchedule(), psched.NoiseSchedule()
    np.testing.assert_array_equal(ps.alphas_cumprod, js.alphas_cumprod)
    x, eps = _randn(15, 2, 8, 8, 4), _randn(16, 2, 8, 8, 4)
    ref = np.asarray(jsched.consistency_step(
        js, jnp.asarray(x), jnp.asarray(eps), jnp.int32(t), jnp.int32(t_next)))
    got = psched.consistency_step(ps, torch.from_numpy(x),
                                  torch.from_numpy(eps), t, t_next).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    noisy = ps.add_noise(torch.from_numpy(x), torch.from_numpy(eps), t)
    np.testing.assert_allclose(
        noisy.numpy(), np.asarray(js.add_noise(
            jnp.asarray(x), jnp.asarray(eps), jnp.full((2,), t))), atol=1e-6)
