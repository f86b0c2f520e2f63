"""The committed golden of a JAX-written checkpoint: tests/golden_torch_port/
orbax_vit64/ holds ``model.pth``, what tools/torch_port_orbax_to_pth.py makes
of a FinetuneState that the JAX package's ``save_checkpoint`` wrote; the JAX
model's eval logits on 16 seeded images in the drivers' compute dtype
(bfloat16), ``logits.npy``; and ``meta.json``: the config, the seeds and
the JAX, flax and orbax versions that wrote them. chip_smoke.py phase 27b
holds the port's forward on the card (K1 at head width 64) against those
logits.

The test regenerates the checkpoint from meta.json's seeds, converts it and
holds the committed file to it: the same tensors to the bit, the logits
within rtol 1e-5 (the same program on another host's CPU). Write the golden
anew with ``python tests/test_torch_port_orbax_golden.py --write``.
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_torch_port", "orbax_vit64")
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import torch_port_orbax_to_pth as TOOL  # noqa: E402
from uncertainty_vit_tpu_torch.utils.checkpoint import load_torch_state_dict  # noqa: E402

# one head of 64 (the attention kernels' head width) over 2 blocks
META = {
    "preset": "beit_test_patch16_32",
    "overrides": {"embed_dim": 64, "num_heads": 1, "depth": 2, "num_classes": 100,
                  "use_flash_attention": True, "use_shared_rel_pos_bias": True,
                  "use_abs_pos_emb": False, "init_values": 0.1},
    "dtype": "bfloat16", "seeds": {"init": 0, "redraw": 7, "images": 27}, "n_images": 16,
    "images": "np.random.RandomState(seeds.images).randint(0, 256, (n, 32, 32, 3)) / 255, "
              "then (x - 0.5) / 0.5 in float32 (the inception normalization)",
}


def golden_images(meta):
    rs = np.random.RandomState(meta["seeds"]["images"])
    x = rs.randint(0, 256, (meta["n_images"], 32, 32, 3)).astype(np.float32) / 255.0
    return ((x - 0.5) / 0.5).astype(np.float32)


def jax_checkpoint(meta, out_dir):
    """The FinetuneState that the JAX package saves for ``meta``, written
    under out_dir/checkpoint-0, and the JAX model's logits on the golden
    images. Returns (directory, logits)."""
    import orbax_states as S
    from uncertainty_vit_tpu.core.config import get_preset
    from uncertainty_vit_tpu.models.vit import VisionTransformer
    from uncertainty_vit_tpu.train import optim as JO
    from uncertainty_vit_tpu.train import schedules as JS
    from uncertainty_vit_tpu.train.engine_finetune import FinetuneState
    from uncertainty_vit_tpu.utils import checkpoint as JC

    cfg = get_preset(meta["preset"], **meta["overrides"])
    model = VisionTransformer(cfg=cfg, dtype=jnp.bfloat16)
    seeds = meta["seeds"]
    params = jax.jit(model.init)(jax.random.PRNGKey(seeds["init"]),
                                 jnp.zeros((2, 32, 32, 3)))["params"]
    params = S.redraw(params, seeds["redraw"])
    tx = JO.make_optimizer(params, JS.constant_schedule(1e-3))
    state = FinetuneState(params=params, opt_state=tx.init(params), step=jnp.asarray(0, jnp.int32))
    path = JC.save_checkpoint(out_dir, 0, state)
    logits = jax.jit(lambda p, x: model.apply({"params": p}, x, deterministic=True))(
        params, jnp.asarray(golden_images(meta)))
    return path, np.asarray(logits, np.float32)


def versions():
    import flax
    import orbax.checkpoint

    return {"jax": jax.__version__, "flax": flax.__version__,
            "orbax_checkpoint": orbax.checkpoint.__version__}


def write_golden():
    os.makedirs(GOLDEN, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        path, logits = jax_checkpoint(META, tmp)
        TOOL.main([path, os.path.join(GOLDEN, "model.pth"), "--family", "finetune"])
    np.save(os.path.join(GOLDEN, "logits.npy"), logits)
    with open(os.path.join(GOLDEN, "meta.json"), "w") as f:
        json.dump({**META, "versions": versions()}, f, indent=1)
        f.write("\n")


def test_golden_is_what_the_tool_makes_of_a_regenerated_checkpoint(tmp_path):
    with open(os.path.join(GOLDEN, "meta.json")) as f:
        meta = json.load(f)
    assert {k: meta[k] for k in META} == META
    path, logits = jax_checkpoint(meta, str(tmp_path))
    out = str(tmp_path / "model.pth")
    assert TOOL.main([path, out]) == 0
    got, want = load_torch_state_dict(os.path.join(GOLDEN, "model.pth")), load_torch_state_dict(out)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert v.dtype == torch.float32 and torch.equal(got[k], v), k
    committed = np.load(os.path.join(GOLDEN, "logits.npy"))
    assert committed.shape == (meta["n_images"], 100) and committed.dtype == np.float32
    np.testing.assert_allclose(logits, committed, rtol=1e-5, atol=1e-5 * np.abs(committed).max())
    total = sum(os.path.getsize(os.path.join(GOLDEN, n)) for n in os.listdir(GOLDEN))
    assert total <= 1 << 20, total


def test_port_forward_from_the_golden_gives_jax_logits():
    """Phase 27b's hold on the CPU (the attention kernel's plain version):
    the port's bf16 forward from model.pth against the committed JAX
    logits within 5e-2 of the largest logit (PERF.md §2's eval bound), the
    same argmax wherever the top two stand further apart than that."""
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer

    with open(os.path.join(GOLDEN, "meta.json")) as f:
        meta = json.load(f)
    model = VisionTransformer(get_preset(meta["preset"], **meta["overrides"]),
                              dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(load_torch_state_dict(os.path.join(GOLDEN, "model.pth")), strict=False)
    got = make_eval_forward(model)(torch.from_numpy(golden_images(meta))).float().numpy()
    want = np.load(os.path.join(GOLDEN, "logits.npy"))
    bound = 5e-2 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > bound
    assert clear.any() and np.array_equal(got.argmax(1)[clear], want.argmax(1)[clear])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_port_orbax_golden.py --write")
    sys.path.insert(0, os.path.join(REPO, "tests"))
    write_golden()
