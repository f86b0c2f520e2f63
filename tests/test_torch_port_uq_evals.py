"""PyTorch port: the post-hoc evaluations (temperature scaling, the
last-layer Laplace posterior, the -C / -P harness and metrics, the
embedding dump) and the -C / -P / TinyImageNet-C data against the JAX
package, on seeded numpy inputs, in f32.

Eigenvectors are defined up to sign and, within ties, order, so the
Laplace fit is compared through its reconstructions Q diag(λ) Qᵀ and what
is invariant (the evidence, the chosen prior, the variances); the
predictives are compared on the JAX posterior's own factors, the mc link
on the JAX draws. Tolerances per test.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.data import datasets as JD
from uncertainty_vit_tpu.evals import calibration as JCAL
from uncertainty_vit_tpu.evals import laplace as JLA
from uncertainty_vit_tpu.evals import robustness as JR
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.utils import embeddings as JEMB
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.data import datasets as TD
from uncertainty_vit_tpu_torch.evals import calibration as CAL
from uncertainty_vit_tpu_torch.evals import laplace as LA
from uncertainty_vit_tpu_torch.evals import robustness as R
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from uncertainty_vit_tpu_torch.utils import embeddings as EMB


def _logits(seed, n=300, c=10, scale=4.0):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, c, size=n)
    logits = (scale * rs.randn(n, c)).astype(np.float32)
    logits[np.arange(n), labels] += scale  # better than chance, overconfident
    return logits, labels.astype(np.int64)


def _batches(arrays, bs):
    n = len(arrays[0])
    return [tuple(a[i:i + bs] for a in arrays) for i in range(0, n, bs)]


# ---------------------------------------------------------------------------
# temperature scaling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 4.0), (1, 0.3), (2, 12.0)])
def test_fit_temperature_matches_jax(seed, scale):
    """The same T* on the same logits (overconfident, underconfident and
    very sharp ones), to the last bit of the grid's float64 midpoint; the
    NLL at a temperature at rtol 1e-6."""
    logits, labels = _logits(seed, scale=scale)
    want = JCAL.fit_temperature(jnp.asarray(logits), jnp.asarray(labels))
    got = CAL.fit_temperature(logits, labels, device="cpu")
    assert got == want
    assert 0.05 < got < 20.0
    np.testing.assert_allclose(
        float(CAL.nll_at_temperature(torch.from_numpy(logits), torch.from_numpy(labels), 1.7)),
        float(JCAL.nll_at_temperature(jnp.asarray(logits), jnp.asarray(labels), 1.7)),
        rtol=1e-6)
    with pytest.raises(ValueError, match="empty"):
        CAL.fit_temperature(logits[:0], labels[:0], device="cpu")


@pytest.mark.parametrize("n,frac,seed", [(100, 0.1, 0), (7, 0.5, 3), (2, 0.9, 1), (1000, 0.33, 9)])
def test_heldout_split_equals_jax(n, frac, seed):
    fit, rep = CAL.heldout_split(n, frac, seed)
    jfit, jrep = JCAL.heldout_split(n, frac, seed)
    np.testing.assert_array_equal(fit, jfit)
    np.testing.assert_array_equal(rep, jrep)
    assert len(fit) >= 1 and len(rep) >= 1 and len(fit) + len(rep) == n
    for bad in ((n, 0.0), (n, 1.0), (1, 0.5)):
        with pytest.raises(ValueError):
            CAL.heldout_split(*bad)


@pytest.mark.parametrize("split", ["eval", "fit_batches", "heldout"])
def test_evaluate_temperature_scaled_matches_jax(split):
    """The result dict of both packages from the same forward outputs: T*
    equal, every metric within 1e-5, the held-out count equal."""
    logits, labels = _logits(3)
    fit_logits, fit_labels = _logits(4, n=120)
    kw = {"eval": {}, "heldout": dict(heldout_frac=0.2, heldout_seed=5)}.get(split, {})
    idx = np.arange(len(labels))

    def tfwd(i):
        return torch.from_numpy(table[np.asarray(i)])

    def jfwd(i):
        return jnp.asarray(table[np.asarray(i)])

    table = np.concatenate([logits, fit_logits])
    ev = _batches((idx, labels), 64)
    fit = (_batches((len(labels) + np.arange(120), fit_labels), 64)
           if split == "fit_batches" else None)
    want = JCAL.evaluate_temperature_scaled(jfwd, ev, fit_batches=fit, **kw)
    got = CAL.evaluate_temperature_scaled(tfwd, ev, fit_batches=fit, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert got["temperature"] == want["temperature"]
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, got[k], v)
    if split == "heldout":
        assert got["heldout_fit_samples"] == 60.0
    with pytest.raises(ValueError, match="not both"):
        CAL.evaluate_temperature_scaled(tfwd, ev, fit_batches=ev, heldout_frac=0.1, device="cpu")


# ---------------------------------------------------------------------------
# the last-layer Laplace posterior
# ---------------------------------------------------------------------------

def _laplace_data(seed=0, n=200, d=24, c=6, bs=50):
    rs = np.random.RandomState(seed)
    feats = rs.randn(n, d).astype(np.float32)
    weight = (rs.randn(c, d) / math.sqrt(d)).astype(np.float32)
    bias = (0.1 * rs.randn(c)).astype(np.float32)
    logits = (feats @ weight.T + bias).astype(np.float32)
    labels = rs.randint(0, c, size=n).astype(np.int64)
    batches = _batches((np.arange(n), labels), bs)
    return feats, weight, bias, logits, labels, batches


def _fits(seed=0, **kw):
    feats, weight, bias, logits, labels, batches = _laplace_data(seed, **kw)
    jla = JLA.fit_last_layer_laplace(
        lambda i: (jnp.asarray(logits[i]), jnp.asarray(feats[i])),
        {"kernel": jnp.asarray(weight.T), "bias": jnp.asarray(bias)}, batches)
    la = LA.fit_last_layer_laplace(
        lambda i: (torch.from_numpy(logits[i]), torch.from_numpy(feats[i])),
        {"weight": torch.from_numpy(weight), "bias": torch.from_numpy(bias)}, batches)
    return jla, la, feats, logits, labels


def _recon(q, lam):
    q, lam = np.asarray(q, np.float64), np.asarray(lam, np.float64)
    return q @ np.diag(lam) @ q.T


@pytest.mark.parametrize("n", [200, 12], ids=["n_above_d", "n_below_d"])
def test_laplace_factors_and_evidence_match_jax(n):
    """The factors' reconstructions Q diag(λ) Qᵀ at rtol 1e-4 of their
    largest entry, n, the log-likelihood and ‖θ*‖² at rtol 1e-5, the
    evidence over the grid at rtol 1e-4 and the same chosen prior
    precision. With fewer samples than features A is singular: its null
    eigenvalues are f32 noise of each eigensolver, so there the evidence at
    τ < 1e-3 is held at rtol 1e-3."""
    jla, la, _, _, _ = _fits(n=n, bs=5 if n < 50 else 50)
    for mine, theirs in ((_recon(la.q_a, la.a), _recon(jla.q_a, jla.a)),
                         (_recon(la.q_g, la.g), _recon(jla.q_g, jla.g))):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-4 * np.abs(theirs).max())
    assert la.n == jla.n == n and la.num_params == jla.num_params
    np.testing.assert_allclose(la.loglik, jla.loglik, rtol=1e-5)
    np.testing.assert_allclose(la.theta_sqnorm, jla.theta_sqnorm, rtol=1e-5)
    grid = np.logspace(-4.0, 4.0, 49)
    want = np.asarray([float(JLA.log_marginal_likelihood(jla, t)) for t in grid])
    got = LA.log_marginal_likelihood(la, torch.tensor(grid, dtype=torch.float32)).numpy()
    # a singular A's null eigenvalues come out as f32 noise (~1e-6, another
    # one for each eigensolver) and move log(g·a/N + τ) where τ is that small
    noisy = grid < 1e-3 if n < 25 else np.zeros(len(grid), bool)
    np.testing.assert_allclose(got[~noisy], want[~noisy], rtol=1e-4)
    np.testing.assert_allclose(got[noisy], want[noisy], rtol=1e-3)
    assert float(LA.log_marginal_likelihood(la, 0.5)) == pytest.approx(
        float(JLA.log_marginal_likelihood(jla, 0.5)), rel=1e-4)
    assert (LA.optimize_prior_precision(la).prior_precision
            == JLA.optimize_prior_precision(jla).prior_precision)
    with pytest.raises(ValueError, match="empty"):
        LA.fit_last_layer_laplace(lambda i: None, {"weight": torch.zeros(3, 4),
                                                   "bias": torch.zeros(3)}, [])


def _port_posterior(jla):
    """The port's KronLaplace holding the JAX posterior's own factors."""
    return LA.KronLaplace(
        q_a=torch.tensor(np.asarray(jla.q_a)), a=torch.tensor(np.asarray(jla.a)),
        q_g=torch.tensor(np.asarray(jla.q_g)), g=torch.tensor(np.asarray(jla.g)),
        n=jla.n, loglik=jla.loglik, theta_sqnorm=jla.theta_sqnorm,
        prior_precision=jla.prior_precision)


@pytest.mark.parametrize("link", ["probit", "mc"])
def test_laplace_predictive_matches_jax(link):
    """Log-probabilities on the JAX posterior's factors (the mc link fed the
    JAX draws) at rtol 1e-4; the functional variance from the port's own
    fit (another eigenbasis) at rtol 1e-4 of its largest value, through
    the basis-free diag Σ_f."""
    jla, la, feats, logits, _ = _fits(seed=1)
    jla = JLA.optimize_prior_precision(jla)
    la = LA.optimize_prior_precision(la)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JLA.predictive_log_probs(jla, jnp.asarray(logits), jnp.asarray(feats),
                                               link=link, mc_samples=16, rng=key))
    eps = None
    if link == "mc":
        eps = torch.tensor(np.asarray(jax.random.normal(key, (16,) + logits.shape)))
    got = LA.predictive_log_probs(_port_posterior(jla), torch.from_numpy(logits),
                                  torch.from_numpy(feats), link=link, eps=eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    diag = LA.functional_variance(la, torch.from_numpy(feats)) @ la.q_g.square().t()
    jdiag = np.asarray(JLA._functional_variance(jla, jnp.asarray(feats)) @ (jla.q_g ** 2).T)
    np.testing.assert_allclose(diag.numpy(), jdiag, rtol=0, atol=1e-4 * np.abs(jdiag).max())
    if link == "mc":
        with pytest.raises(ValueError, match="generator"):
            LA.predictive_log_probs(la, torch.from_numpy(logits), torch.from_numpy(feats), "mc")
        g = torch.Generator().manual_seed(0)
        a = LA.predictive_log_probs(la, torch.from_numpy(logits), torch.from_numpy(feats), "mc",
                                    generator=g)
        assert torch.isfinite(a).all() and torch.allclose(a.exp().sum(-1), torch.ones(200))


def test_evaluate_laplace_matches_jax():
    """The probit evaluation's result dict against the JAX one on the same
    posterior: every metric within 1e-5, the prior precision equal."""
    jla, _, feats, logits, labels = _fits(seed=2)
    jla = JLA.optimize_prior_precision(jla)
    batches = _batches((np.arange(len(labels)), labels), 64)
    want = JLA.evaluate_laplace(jla, lambda i: (jnp.asarray(logits[i]), jnp.asarray(feats[i])),
                                batches)
    got = LA.evaluate_laplace(
        _port_posterior(jla),
        lambda i: (torch.from_numpy(logits[np.asarray(i)]), torch.from_numpy(feats[np.asarray(i)])),
        batches)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, got[k], v)


# ---------------------------------------------------------------------------
# robustness harness and metrics
# ---------------------------------------------------------------------------

def test_evaluate_corruption_bookkeeping_matches_jax():
    """Per-distortion acc1 / ce, mCE and the mean accuracy from the same
    logits: equal dicts (every severity's batches of a distortion pooled)."""
    names = ("gaussian_noise", "frost", "pixelate")
    data = {n: _logits(i, n=90) for i, n in enumerate(names)}
    current = {}

    def factory(name):  # the forward reads the distortion being evaluated
        current["logits"] = data[name][0]
        return _batches((np.arange(90), data[name][1]), 32)

    want = JR.evaluate_corruption(lambda i: jnp.asarray(current["logits"][i]), factory, names)
    got = R.evaluate_corruption(lambda i: torch.from_numpy(current["logits"][i]), factory, names)
    assert got == want
    assert set(got["per_distortion"]) == set(names)


def test_process_p_frames_matches_jax():
    """32x32 uint8 frames → 224: within 1e-5 before the ×2−1 (the eval
    transform's bound, tests/test_torch_port_eval_transform.py), 2e-5
    after it."""
    frames = np.random.RandomState(1).randint(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(JR.process_p_frames(jnp.asarray(frames), 224))
    got = R.process_p_frames(torch.from_numpy(frames), 224).numpy()
    assert got.shape == want.shape == (6, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("noise", [False, True])
def test_flip_prob_and_ranking_dist_match_jax(noise):
    rs = np.random.RandomState(int(noise))
    preds = [rs.randint(0, 5, size=8) for _ in range(6)]
    ranks = [np.stack([JR._rankdata_ordinal_desc(f) for f in rs.randn(8, 100)])
             for _ in range(6)]
    assert R.flip_prob(preds, noise) == JR.flip_prob(preds, noise)
    for mode in ("top5", "zipf"):
        assert R.ranking_dist(ranks, noise, mode, 100) == JR.ranking_dist(ranks, noise, mode, 100)
    with pytest.raises(ValueError):
        R._dist(ranks[0][0], "other")
    from scipy.stats import rankdata

    x = rs.randn(100)
    np.testing.assert_array_equal(R._rankdata_ordinal_desc(x),
                                  rankdata(-x, method="ordinal").astype(np.uint16))


def test_evaluate_perturbation_matches_jax():
    """Two perturbations (one noise, compared with frame 0; one against the
    previous frame), 5 videos of 4 frames in batches of 2 videos, a fixed
    linear forward of the processed frames: equal flip probabilities and
    ranking distances."""
    rs = np.random.RandomState(3)
    vids = {n: rs.randint(0, 256, (5, 4, 32, 32, 3), dtype=np.uint8)
            for n in ("gaussian_noise", "brightness")}
    proj = (rs.randn(16 * 16 * 3, 10) / 16).astype(np.float32)

    def factory(name):
        return [vids[name][i:i + 2] for i in range(0, 5, 2)]

    want = JR.evaluate_perturbation(lambda x: x.reshape(len(x), -1) @ jnp.asarray(proj),
                                    factory, 10, perturbations=tuple(vids), frame_size=16)
    got = R.evaluate_perturbation(lambda x: x.reshape(len(x), -1) @ torch.from_numpy(proj),
                                  factory, 10, perturbations=tuple(vids), frame_size=16,
                                  device="cpu")
    assert got == want
    assert 0 < got["mean_flip_prob"] <= 1


# ---------------------------------------------------------------------------
# the embedding dump
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", ["linear", "het"])
def test_embedding_tsvs_match_jax(tmp_path, head):
    """The TSVs of a 2-deep width-64 model's pooled features: the labels
    equal, the features within 1e-5 (written at 6 decimals); the het model's
    head is not run. The PCA png is written where matplotlib imports, in
    both packages alike."""
    kw = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=1, num_classes=10,
              init_values=0.1, use_shared_rel_pos_bias=True, use_flash_attention=False,
              head_type=head, het_num_factors=3, het_test_mc_samples=10)
    rs = np.random.RandomState(0)
    images = rs.randn(10, 32, 32, 3).astype(np.float32)
    labels = np.arange(10) % 3
    jmodel = JViT(cfg=JConfig(**kw))
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images[:1])))
    model = C.load_flax_params(VisionTransformer(ViTConfig(**kw), device="cpu"),
                               jax.tree_util.tree_map(np.asarray, variables["params"]))
    batches = _batches((images, labels), 4)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JEMB.visualize_embedding(jmodel, variables, [(jnp.asarray(x), y) for x, y in batches], jdir,
                             max_items=9)
    assert EMB.visualize_embedding(model, [(torch.from_numpy(x), y) for x, y in batches], tdir,
                                   max_items=9) == tdir
    for name in ("embeddings.tsv", "embeddings_labels.tsv"):
        want, got = np.loadtxt(os.path.join(jdir, name)), np.loadtxt(os.path.join(tdir, name))
        assert got.shape == want.shape and got.shape[0] == 9
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if name == "embeddings.tsv" else 0)
    assert (os.path.exists(os.path.join(tdir, "embeddings_pca.png"))
            == os.path.exists(os.path.join(jdir, "embeddings_pca.png")))
    np.testing.assert_allclose(EMB.pca_2d(np.loadtxt(os.path.join(tdir, "embeddings.tsv"))),
                               JEMB.pca_2d(np.loadtxt(os.path.join(tdir, "embeddings.tsv"))))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_load_cifar_c_and_p_equal_jax(tmp_path):
    """A seeded CIFAR-C file of 2 severities and a CIFAR-P file: each
    severity's 10,000-row slice and the videos equal the JAX loaders'."""
    rs = np.random.RandomState(0)
    data = rs.randint(0, 256, (12000, 32, 32, 3), dtype=np.uint8)
    labels = rs.randint(0, 100, size=12000)
    np.save(tmp_path / "frost.npy", data)
    np.save(tmp_path / "labels.npy", labels)
    for s in (1, 2, 3):
        got, want = TD.load_cifar_c(str(tmp_path), "frost", s), JD.load_cifar_c(str(tmp_path),
                                                                                "frost", s)
        assert len(got) == len(want) == {1: 10000, 2: 2000, 3: 0}[s]
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
    vids = rs.randint(0, 256, (3, 5, 32, 32, 3), dtype=np.uint8)
    np.save(tmp_path / "tilt.npy", vids)
    np.testing.assert_array_equal(TD.load_cifar_p(str(tmp_path), "tilt"),
                                  JD.load_cifar_p(str(tmp_path), "tilt"))


def _tin_c_tree(root, wnids, rs):
    from PIL import Image

    for sev in (1, 2):
        for w in wnids[:-1]:  # the last class has no images at these severities
            d = root / "frost" / str(sev) / w
            d.mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rs.randint(0, 256, (40, 48, 3), dtype=np.uint8)).save(
                    d / f"{w}_{i}.JPEG", quality=90)


def test_tiny_imagenet_c_equals_jax(tmp_path):
    """The TinyImageNet-C tree: classes, samples and labels equal the JAX
    class's, and the decoded images at a decode size equal the JAX
    instance's once ``letterbox = False`` is set on it (the JAX class leaves
    it unset, so its own decode fails: ROADMAP.md §3). wnids.txt from the
    root, from --wnids_path, from a sibling clean tree, or an error."""
    rs = np.random.RandomState(0)
    wnids = ["n03", "n01", "n02"]
    root = tmp_path / "Tiny-ImageNet-C"
    _tin_c_tree(root, wnids, rs)
    (root / "wnids.txt").write_text("\n".join(wnids) + "\n")
    got = TD.TinyImageNetC(str(root), "frost", 2, decode_size=32)
    want = JD.TinyImageNetC(str(root), "frost", 2, decode_size=32)
    assert got.classes == want.classes == sorted(wnids) and got.letterbox is False
    assert got.samples == want.samples and len(got) == 4
    np.testing.assert_array_equal(got.labels, want.labels)
    with pytest.raises(RuntimeError, match="corrupt"):
        want[0]
    want.letterbox = False
    for i in range(len(got)):
        (img, label), (jimg, jlabel) = got[i], want[i]
        assert img.shape == (32, 32, 3) and label == jlabel
        np.testing.assert_array_equal(img, jimg)
    os.remove(root / "wnids.txt")
    with pytest.raises(FileNotFoundError, match="wnids_path"):
        TD.TinyImageNetC(str(root), "frost", 1)
    explicit = tmp_path / "w.txt"
    explicit.write_text("n01\nn02\n")
    assert TD.TinyImageNetC(str(root), "frost", 1, wnids_path=str(explicit)).classes == [
        "n01", "n02"]
    sib = tmp_path / "tiny-imagenet-200"
    sib.mkdir()
    (sib / "wnids.txt").write_text("\n".join(wnids))
    assert (TD.TinyImageNetC(str(root), "frost", 1).samples
            == JD.TinyImageNetC(str(root), "frost", 1).samples)
