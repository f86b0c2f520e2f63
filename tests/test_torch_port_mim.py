"""PyTorch port: the pieces of BEiT pretraining that hold no ViT, against the
JAX package: the masked codebook cross-entropy, the DALL-E pixel maps, the
two-view transform, both image tokenizers (the in-repo DiscreteVAE and the
DALL-E network), their state dicts and the dall_e pickle loader.

The transform takes its draws apart from its op: ``jax_two_view_draws``
makes, from a JAX key, the draws JAX's ``pretrain_two_view_batch`` takes
from it (``split(key, 3)`` into jitter, flip and crop; one crop key a
sample). The tokenizers are small (DiscreteVAE hidden 8, vocab 64, codebook
12, 2 layers on 32×32; dall_e n_hid 16, n_init 8, vocab 64), their JAX
params seeded numpy draws carried across by ``load_flax_params``.

Tolerances: the losses within 1e-6 relative; forwards rtol 2e-4 / atol 2e-5;
tokens, boxes and flips equal; resampled pixels within 1e-5 and
normalized ones within 1e-4, as tests/test_torch_port_train_augment.py
bounds them.
"""

import copy
import math
import os
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tests.test_torch_port_train_augment import (
    NORMALIZED_ATOL, RESAMPLE_ATOL, jax_color_jitter_draws, jax_rrc_draws,
)
from uncertainty_vit_tpu.models import dalle_vae as JDV
from uncertainty_vit_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from uncertainty_vit_tpu.ops import augment as JA
from uncertainty_vit_tpu.ops import losses as JL
from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.models import dalle_vae as TDV
from uncertainty_vit_tpu_torch.models import dvae as TD
from uncertainty_vit_tpu_torch.ops import augment as TA
from uncertainty_vit_tpu_torch.ops import losses as TL
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

FWD = dict(rtol=2e-4, atol=2e-5)
DVAE = dict(image_size=32, num_tokens=64, codebook_dim=12, num_layers=2, hidden_dim=8)
DALLE = dict(n_hid=16, vocab_size=64)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _numpy_params(shapes, seed, scale=1.0):
    """Seeded numpy values for every leaf of a JAX param tree: kernels at
    1/sqrt(fan_in), biases and embeddings at 0.2 (times ``scale``)."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (scale * rs.randn(*leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))
                    ).astype(np.float32)
        return (0.2 * scale * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# ---------------------------------------------------------------------------
# the loss and the pixel maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["some", "none"])
def test_masked_mim_cross_entropy_matches_jax(mask_kind):
    """The loss and the MLM accuracy over [B, N, V] logits; an all-zero
    mask divides by 1 (both are 0). The tokens are made so that a fifth of
    the masked positions' argmax is right."""
    rs = np.random.RandomState(0)
    logits = (3 * rs.randn(4, 9, 32)).astype(np.float32)
    tokens = rs.randint(0, 32, (4, 9))
    hit = rs.rand(4, 9) < 0.2
    tokens[hit] = logits.argmax(-1)[hit]
    mask = ((rs.rand(4, 9) < 0.5) if mask_kind == "some" else np.zeros((4, 9))).astype(np.float32)
    want_loss, want_acc = JL.masked_mim_cross_entropy(jnp.asarray(logits), jnp.asarray(tokens),
                                                      jnp.asarray(mask))
    loss, acc = TL.masked_mim_cross_entropy(_t(logits), _t(tokens), _t(mask))
    assert loss.shape == acc.shape == ()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(acc.item(), float(want_acc), rtol=1e-6)
    if mask_kind == "none":
        assert loss.item() == acc.item() == 0.0
    else:
        assert 0 < acc.item() < 1


def test_map_pixels_and_unmap_pixels_match_jax():
    x = np.random.RandomState(1).uniform(-0.2, 1.2, (3, 5, 5, 3)).astype(np.float32)
    assert TA.DALLE_LOGIT_LAPLACE_EPS == JA.DALLE_LOGIT_LAPLACE_EPS
    np.testing.assert_allclose(TA.map_pixels(_t(x)).numpy(), np.asarray(JA.map_pixels(x)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(TA.unmap_pixels(_t(x)).numpy(), np.asarray(JA.unmap_pixels(x)),
                               rtol=1e-6, atol=1e-7)
    inside = np.clip(x, 0, 1)
    np.testing.assert_allclose(TA.unmap_pixels(TA.map_pixels(_t(inside))).numpy(), inside,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the two-view transform
# ---------------------------------------------------------------------------

def jax_two_view_draws(key, b):
    """The port's draws of what JAX's pretrain_two_view_batch(key, ...)
    draws (JAX ops/augment.py:764-780): the jitter, one flip uniform a
    sample (bernoulli over (B, 1, 1, 1) and over (B,) read the same
    uniforms), one crop key a sample."""
    kj, kf, kc = jax.random.split(key, 3)
    return TA.TwoViewDraws(jax_color_jitter_draws(kj, b),
                           _t(jax.random.uniform(kf, (b,))), jax_rrc_draws(kc, b))


_jax_two_view = jax.jit(JA.pretrain_two_view_batch,
                        static_argnames=("out_size", "second_size",
                                         "imagenet_default_mean_and_std",
                                         "color_jitter_strength", "discrete_vae_type",
                                         "second_interpolation"))


@pytest.mark.parametrize("letterbox", [False, True], ids=["canvas", "letterbox"])
@pytest.mark.parametrize("vae_type", ["none", "dall-e", "customized"])
def test_two_view_transform_matches_jax(vae_type, letterbox):
    """Both views against JAX's on the JAX key's draws, for every tokenizer
    view's transform, on the whole canvas and on letterboxed extents; the
    second view bilinear for "none" (the other two bicubic)."""
    b = 6
    rs = np.random.RandomState(len(vae_type) + 10 * letterbox)
    u8 = rs.randint(0, 256, (b, 40, 48, 3)).astype(np.uint8)
    vhw = (np.stack([rs.randint(24, 41, b), rs.randint(20, 49, b)], 1).astype(np.int32)
           if letterbox else None)
    interp = "bilinear" if vae_type == "none" else "bicubic"
    key = jax.random.PRNGKey(5 + letterbox)
    kw = dict(out_size=32, second_size=16, discrete_vae_type=vae_type,
              second_interpolation=interp)
    want1, want2 = _jax_two_view(key, jnp.asarray(u8),
                                 valid_hw=None if vhw is None else jnp.asarray(vhw), **kw)
    got1, got2 = TA.pretrain_two_view_batch(
        jax_two_view_draws(key, b), torch.from_numpy(u8),
        valid_hw=None if vhw is None else torch.from_numpy(vhw), **kw)
    assert tuple(got1.shape) == (b, 32, 32, 3) and tuple(got2.shape) == (b, 16, 16, 3)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=0, atol=NORMALIZED_ATOL)
    second_atol = NORMALIZED_ATOL if vae_type == "customized" else RESAMPLE_ATOL
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=0, atol=second_atol)


@pytest.mark.parametrize("letterbox", [False, True], ids=["canvas", "letterbox"])
def test_two_views_come_from_one_box_and_one_flip(letterbox):
    """At second_size == out_size, bicubic, the tokenizer view ("none") is
    the student view before its normalization: one box and one flip a
    sample serve both. The transform built by make_pretrain_two_view is the
    draws then the op."""
    b = 5
    rs = np.random.RandomState(3)
    u8 = torch.from_numpy(rs.randint(0, 256, (b, 40, 40, 3)).astype(np.uint8))
    vhw = torch.from_numpy(np.full((b, 2), 30, np.int32)) if letterbox else None
    draws = TA.draw_pretrain_two_view(torch.Generator().manual_seed(1), b)
    first, second = TA.pretrain_two_view_batch(draws, u8, 24, 24, valid_hw=vhw)
    mean, std = torch.tensor(TA.IMAGENET_DEFAULT_MEAN), torch.tensor(TA.IMAGENET_DEFAULT_STD)
    torch.testing.assert_close(first * std + mean, second, rtol=0, atol=1e-6)
    fn = TA.make_pretrain_two_view(24, 12, discrete_vae_type="dall-e")
    a = fn(torch.Generator().manual_seed(1), u8, vhw)
    d = TA.pretrain_two_view_batch(draws, u8, 24, 12, discrete_vae_type="dall-e", valid_hw=vhw)
    assert torch.equal(a[0], d[0]) and torch.equal(a[1], d[1])
    assert float(a[1].min()) >= 0.1 - 1e-6 and float(a[1].max()) <= 0.9 + 1e-6
    with pytest.raises(ValueError, match="discrete_vae_type"):
        TA.pretrain_two_view_batch(draws, u8, 24, 12, discrete_vae_type="dalle")


# ---------------------------------------------------------------------------
# the in-repo DiscreteVAE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dvae_pair():
    x = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    jmodel = JDiscreteVAE(**DVAE)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _numpy_params(shapes, 1)
    model = C.load_flax_params(TD.DiscreteVAE(**DVAE, device="cpu"), params)
    return jmodel, {"params": params}, model, x


def test_dvae_encoder_and_tokens_match_jax(dvae_pair):
    jmodel, variables, model, x = dvae_pair
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), method=jmodel.encode_logits))
    got = model.encode_logits(torch.from_numpy(x))
    assert tuple(got.shape) == (3, 8, 8, 64)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    ids = model.get_codebook_indices(torch.from_numpy(x))
    jids = np.asarray(jmodel.apply(variables, jnp.asarray(x), method=jmodel.get_codebook_indices))
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (3, 64)
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert len(np.unique(jids)) > 4  # not one token everywhere


def test_dvae_decoder_matches_jax(dvae_pair):
    """decode_codes through the transposed convs (the pre-flipped JAX kernel
    carried back to torch's [in, out, kh, kw])."""
    jmodel, variables, model, _ = dvae_pair
    codes = np.random.RandomState(2).randint(0, 64, (3, 8, 8))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(codes), method=jmodel.decode_codes))
    got = model.decode_codes(torch.from_numpy(codes))
    assert tuple(got.shape) == (3, 32, 32, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)


@pytest.mark.parametrize("tau", [1.0, 0.3])
def test_dvae_training_forward_matches_jax(dvae_pair, tau):
    """The Gumbel-softmax forward given JAX's Gumbel draws of its key, at
    two temperatures, and its gradients; without noise the plain softmax."""
    jmodel, variables, model, x = dvae_pair
    rng = jax.random.PRNGKey(7)
    gumbel = np.asarray(jax.random.gumbel(rng, (3, 8, 8, 64), dtype=jnp.float32))

    def jloss(p):
        recon, logits = jmodel.apply({"params": p}, jnp.asarray(x), tau, rng)
        return jnp.mean((recon - x) ** 2) + 1e-2 * jnp.mean(logits ** 2), (recon, logits)

    (_, (want_recon, want_logits)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    model.zero_grad()
    recon, logits = model(torch.from_numpy(x), tau, torch.from_numpy(gumbel))
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(want_recon), **FWD)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **FWD)
    (torch.mean((recon - torch.from_numpy(x)) ** 2) + 1e-2 * torch.mean(logits ** 2)).backward()
    ref = C._tokenizer_state_dict(model, _np(jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    plain, _ = jmodel.apply(variables, jnp.asarray(x), tau)
    got, _ = model(torch.from_numpy(x), tau)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(plain), **FWD)


def test_gumbel_draws_follow_their_distribution():
    g = TD.draw_gumbel(torch.Generator().manual_seed(0), (200, 100))
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.02 and abs(float(g.std()) - math.pi / 6 ** 0.5) < 0.02
    assert torch.equal(g, TD.draw_gumbel(torch.Generator().manual_seed(0), (200, 100)))


class _TorchResBlock(torch.nn.Module):
    # modeling_discrete_vae.py:64-76
    def __init__(self, chan):
        super().__init__()
        self.net = torch.nn.Sequential(
            torch.nn.Conv2d(chan, chan, 3, padding=1), torch.nn.ReLU(),
            torch.nn.Conv2d(chan, chan, 3, padding=1), torch.nn.ReLU(),
            torch.nn.Conv2d(chan, chan, 1))


def _reference_dvae_state_dict():
    """A reference-layout DiscreteVAE (modeling_discrete_vae.py:104-122,
    as tests/test_dvae_import.py rebuilds it)."""
    torch.manual_seed(0)
    enc, dec = [], []
    enc_in, dec_in = 3, DVAE["codebook_dim"]
    for _ in range(DVAE["num_layers"]):
        enc += [torch.nn.Sequential(torch.nn.Conv2d(enc_in, 8, 4, 2, 1), torch.nn.ReLU()),
                _TorchResBlock(8)]
        dec += [torch.nn.Sequential(torch.nn.ConvTranspose2d(dec_in, 8, 4, 2, 1),
                                    torch.nn.ReLU()), _TorchResBlock(8)]
        enc_in = dec_in = 8
    ref = torch.nn.Module()
    ref.codebook = torch.nn.Embedding(DVAE["num_tokens"], DVAE["codebook_dim"])
    ref.encoder = torch.nn.Sequential(*enc, torch.nn.Conv2d(8, DVAE["num_tokens"], 1))
    ref.decoder = torch.nn.Sequential(*dec, torch.nn.Conv2d(8, 3, 1))
    return ref.state_dict()


def test_reference_dvae_state_dict_loads_strictly_and_inits_as_flax():
    """A reference DiscreteVAE state dict loads with strict=True; the port's
    own draws follow flax's inits (a conv's lecun_normal: std 1/sqrt(fan_in)
    truncated at 2 of its scale; the transposed convs U(±1/sqrt(16·in)); the
    codebook N(0, 1/dim); biases 0)."""
    sd = _reference_dvae_state_dict()
    model = TD.DiscreteVAE(**DVAE, device="cpu")
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    big = TD.DiscreteVAE(image_size=32, num_tokens=512, codebook_dim=64, num_layers=1,
                         hidden_dim=64, device="cpu", generator=torch.Generator().manual_seed(0))
    w = big.encoder[1].net[0].weight.detach()  # 64·9 fan-in
    assert abs(float(w.std()) * math.sqrt(576) - 1.0) < 0.03
    assert float(w.abs().max()) <= 2 / math.sqrt(576) / 0.8796 + 1e-6
    t = big.decoder[0][0].weight.detach()  # ConvTranspose2d [64, 64, 4, 4]
    bound = 1 / math.sqrt(64 * 16)
    assert float(t.abs().max()) <= bound and float(t.std()) == pytest.approx(bound / 3 ** 0.5,
                                                                             rel=0.03)
    cb = big.codebook.weight.detach()
    assert float(cb.std()) == pytest.approx(64 ** -0.5, rel=0.03)
    assert all(float(p.detach().abs().max()) == 0.0 for k, p in big.named_parameters()
               if k.endswith("bias"))


def test_tokenizer_precision_is_its_own():
    """Every forward of either tokenizer runs in float32 (TF32 off in cuDNN
    and cuBLAS) and leaves the process's TF32 flags as it found them, on or
    off, also when the forward raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    seen = []

    def record(*_):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))

    dvae = TD.DiscreteVAE(**DVAE, device="cpu")
    dalle = TDV.DalleVAE(32, 64, n_hid=16, n_init=8, device="cpu")
    for conv in (dvae.encoder[0], dvae.decoder[0], dalle.encoder.blocks.input,
                 dalle.decoder.blocks.input):
        conv.register_forward_hook(record)
    x = torch.rand(1, 32, 32, 3)
    try:
        for flag in (True, False):
            cudnn.allow_tf32 = matmul.allow_tf32 = flag
            seen.clear()
            with torch.no_grad():
                dvae.get_codebook_indices(x)
                dvae.encode_logits(x)
                dvae.decode_codes(torch.zeros(1, 8, 8, dtype=torch.long))
                dvae(x, 0.5)
                dalle.get_codebook_indices(x)
                dalle.get_codebook_probs(x)
                dalle.decode(torch.zeros(1, 16, dtype=torch.long))
                dalle(x)
            assert seen == [(False, False)] * 10
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (flag, flag)
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with pytest.raises(RuntimeError):
            dvae.encode_logits(torch.rand(1, 32, 32, 5))
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# the DALL-E network
# ---------------------------------------------------------------------------

def save_dalle_pickles(vae: torch.nn.Module, directory: str) -> tuple:
    """Write a ``models.dalle_vae.DalleVAE``'s encoder and decoder as
    OpenAI's pickles are laid out: ``encoder.pkl`` / ``decoder.pkl`` in
    ``directory``, each a pickled module object of the classes
    ``dall_e.encoder.Encoder`` (``EncoderBlock``), ``dall_e.decoder.Decoder``
    (``DecoderBlock``) and ``dall_e.utils.Conv2d``, here stand-ins registered
    for the write and removed after it (``sys.modules`` is left as it was).
    ``load_dalle_pickle_state_dict`` reads them back. Returns the two paths."""
    names = ("dall_e", "dall_e.utils", "dall_e.encoder", "dall_e.decoder")
    modules = {name: types.ModuleType(name) for name in names}

    def stand_in(module: str, name: str) -> type:
        cls = type(name, (torch.nn.Module,), {"__module__": module, "__qualname__": name})
        setattr(modules[module], name, cls)
        return cls

    conv = stand_in("dall_e.utils", "Conv2d")
    saved = {name: sys.modules.get(name) for name in names}
    paths = []
    try:
        sys.modules.update(modules)
        for part, top, block in (("encoder", "Encoder", "EncoderBlock"),
                                 ("decoder", "Decoder", "DecoderBlock")):
            top_cls, block_cls = stand_in(f"dall_e.{part}", top), stand_in(f"dall_e.{part}", block)
            obj = copy.deepcopy(getattr(vae, part)).cpu()
            for m in obj.modules():
                if isinstance(m, TDV.Conv2d):
                    m.__class__ = conv
                elif isinstance(m, TDV._Block):
                    m.__class__ = block_cls
            obj.__class__ = top_cls
            paths.append(os.path.join(directory, f"{part}.pkl"))
            torch.save(obj, paths[-1])
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
    return paths[0], paths[1]


class _SmallDalle(JDV.DalleVAE):
    """The JAX DalleVAE at n_hid 16 (its own builds the published 256)."""

    def setup(self):
        self.encoder = JDV.DalleEncoder(n_hid=16, vocab_size=self.vocab_size)
        self.decoder = JDV.DalleDecoder(n_init=8, n_hid=16, vocab_size=self.vocab_size)


@pytest.fixture(scope="module")
def dalle_pair():
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    xm = np.asarray(JA.map_pixels(x))
    jvae = _SmallDalle(image_size=32, vocab_size=64)
    shapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0), jnp.asarray(xm))["params"]
    params = _numpy_params(shapes, 3)
    vae = TDV.DalleVAE(32, 64, n_hid=16, n_init=8, device="cpu")
    C.load_flax_params(vae, params)
    return jvae, {"params": params}, vae, xm


def test_dalle_encoder_decoder_and_tokens_match_jax(dalle_pair):
    """The encoder's logits, the tokens, the probabilities, decode (the one
    hot, the decoder's mean planes, sigmoid, unmap_pixels) and the round
    trip against JAX's DalleVAE; the bare encoder and decoder too."""
    jvae, variables, vae, xm = dalle_pair
    x = torch.from_numpy(xm)
    logits = np.asarray(jvae.apply(variables, jnp.asarray(xm),
                                   method=lambda m, v: m.encoder(v)))
    np.testing.assert_allclose(vae.encoder(x).detach().numpy(), logits, **FWD)
    ids = vae.get_codebook_indices(x)
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (2, 16)
    np.testing.assert_array_equal(ids.numpy(), logits.argmax(-1).reshape(2, -1))
    probs = np.asarray(jvae.apply(variables, jnp.asarray(xm), method=jvae.get_codebook_probs))
    np.testing.assert_allclose(vae.get_codebook_probs(x).detach().numpy(), probs, **FWD)
    seq = np.random.RandomState(5).randint(0, 64, (2, 16))
    want = np.asarray(jvae.apply(variables, jnp.asarray(seq), method=jvae.decode))
    got = vae.decode(torch.from_numpy(seq))
    assert tuple(got.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)
    jidx, jrecon = jvae.apply(variables, jnp.asarray(xm))
    idx, recon = vae(x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(jrecon), **FWD)
    z = np.asarray(jax.nn.one_hot(jnp.asarray(seq.reshape(2, 4, 4)), 64))
    dec = np.asarray(jvae.apply(variables, jnp.asarray(z), method=lambda m, v: m.decoder(v)))
    np.testing.assert_allclose(vae.decoder(torch.from_numpy(z)).detach().numpy(), dec, **FWD)
    assert dec.shape == (2, 32, 32, 6)


def test_dalle_state_dict_names_are_dall_e_and_load_strictly():
    """The dall_e names of JAX _dalle_torch_key_for; a state dict under them
    loads with strict=True; a missing entry raises."""
    enc = TDV.DalleEncoder(**DALLE, device="cpu")
    dec = TDV.DalleDecoder(n_init=8, **DALLE, device="cpu")
    keys = set(enc.state_dict())
    assert {"blocks.input.w", "blocks.input.b", "blocks.output.conv.w",
            "blocks.group_1.block_1.res_path.conv_1.w",
            "blocks.group_2.block_1.id_path.w", "blocks.group_4.block_2.res_path.conv_4.b"} <= keys
    assert "blocks.group_1.block_1.id_path.w" not in keys  # 16 → 16: the identity
    assert len(keys) == 2 * (1 + 4 * 2 * 4 + 3 + 1)
    sd = {k: torch.randn_like(v) for k, v in enc.state_dict().items()}
    enc.load_state_dict(sd, strict=True)
    assert "blocks.group_4.block_2.res_path.conv_4.w" in dec.state_dict()
    del sd["blocks.input.w"]
    with pytest.raises(RuntimeError, match="blocks.input.w"):
        TDV.DalleEncoder(**DALLE, device="cpu").load_state_dict(sd, strict=True)
    w = TDV.DalleEncoder(n_hid=64, vocab_size=64, device="cpu",
                         generator=torch.Generator().manual_seed(0)
                         ).blocks.group_1.block_1.res_path.conv_2.w.detach()  # 16·9 fan-in
    assert abs(float(w.std()) * 12 - 1.0) < 0.05 and float(w.abs().max()) <= 2 / 12 / 0.8796


def test_nearest_upsample_equals_jax_image_resize():
    """The decoder's nearest 2× upsample (nn.Upsample) is jax.image.resize's
    "nearest" at exactly 2× (models/dalle_vae.py:140), bit for bit."""
    x = np.random.RandomState(6).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), "nearest"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                        mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dalle_pickles_round_trip_and_leave_sys_modules(tmp_path):
    """save_dalle_pickles writes module objects of dall_e.* classes;
    load_dalle_pickle_state_dict reads them without the package into state
    dicts equal to the network's, which load strictly. sys.modules is as it
    was after a write, a read, and a read that fails."""
    before = {k for k in sys.modules if k.startswith("dall_e")}
    vae = TDV.DalleVAE(32, 64, n_hid=16, n_init=8, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    enc_path, dec_path = save_dalle_pickles(vae, str(tmp_path))
    assert {k for k in sys.modules if k.startswith("dall_e")} == before
    for path, part in ((enc_path, vae.encoder), (dec_path, vae.decoder)):
        with open(path, "rb") as f:
            assert b"dall_e.utils" in f.read()
        sd = C.load_dalle_pickle_state_dict(path)
        assert sd.keys() == part.state_dict().keys()
        assert all(torch.equal(sd[k], v) for k, v in part.state_dict().items())
        fresh = TDV.DalleVAE(32, 64, n_hid=16, n_init=8, device="cpu")
        getattr(fresh, "encoder" if part is vae.encoder else "decoder").load_state_dict(
            sd, strict=True)
    assert {k for k in sys.modules if k.startswith("dall_e")} == before
    broken = tmp_path / "broken.pkl"
    broken.write_bytes(open(enc_path, "rb").read()[:100])
    with pytest.raises(Exception):
        C.load_dalle_pickle_state_dict(str(broken))
    assert {k for k in sys.modules if k.startswith("dall_e")} == before


def test_flax_inits_of_the_port():
    """core.init's flax defaults: lecun_normal's std is 1/sqrt(fan_in), its
    draws within ±2 of its scale; normal's std."""
    t = I.lecun_normal(100)(torch.empty(200, 100), torch.Generator().manual_seed(0))
    assert float(t.std()) == pytest.approx(0.1, rel=0.02)
    assert float(t.abs().max()) <= 2 * 0.1 / 0.87962566103423978 + 1e-6
    n = I.normal(0.5)(torch.empty(100, 100), torch.Generator().manual_seed(0))
    assert float(n.std()) == pytest.approx(0.5, rel=0.02)
