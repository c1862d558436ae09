"""The port's contrastive trainer against the JAX package's, on the CPU, on
``DualEncoderConfig.tiny()`` weights bridged from a JAX init.

Tolerances, each stated where it is used: the step-0 gradients per leaf
within 1e-4 of the leaf's largest |g| (f32, the same function summed in
other orders through two towers); losses within 2e-6 (|loss| ~ 2); the
optimizer's updates and state within 1e-6 relative plus 1e-12 absolute of
optax's (the same f32 arithmetic; a bias correction or cosine may differ in
its last bit); metrics after a checkpoint swap within 2e-6. Parameters
after Adam updates are not compared element by element: Adam scales each
update to ~lr whatever |g|, so a gradient near zero whose last bits differ
may flip its update's sign; the restored parameters are compared EQUAL
before the next step instead."""

import json
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_embeddings_tpu.models import vision_encoder as jve
from multimodal_embeddings_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from multimodal_embeddings_tpu.models.weights import flatten_params
from multimodal_embeddings_tpu.training import contrastive as jtr
from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
from multimodal_embeddings_tpu_torch.models.vision_encoder import DualEncoderConfig
from multimodal_embeddings_tpu_torch.training import contrastive as ttr

torch.set_num_threads(2)

GRAD_RTOL = 1e-4
LOSS_ATOL = 2e-6
CONFIG = dict(warmup_steps=1, total_steps=50, learning_rate=1e-3)


def make_batch(rng, n, size, max_len):
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    ids, mask = ByteTokenizer().encode_batch([f"text {i}" for i in range(n)], max_len)
    return images, ids, mask


def _pair(seed=0, **config):
    """A JAX trainer and the port's on its weights (through the bridge)."""
    jt = jtr.ContrastiveTrainer(model_config=jve.DualEncoderConfig.tiny(),
                                trainer_config=jtr.TrainerConfig(**config), seed=seed)
    tt = ttr.ContrastiveTrainer(DualEncoderConfig.tiny(), ttr.TrainerConfig(**config),
                                device="cpu", params=flatten_params({"params": jt.params}))
    return jt, tt


@pytest.fixture(scope="module")
def batch():
    return make_batch(np.random.default_rng(0), 8, 64, 16)


def test_tokenizers_agree(batch):
    _, ids, mask = batch
    want_ids, want_mask = JaxByteTokenizer().encode_batch([f"text {i}" for i in range(8)], 16)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)


class TestClipLoss:
    def test_perfect_alignment_low_loss(self):
        emb = torch.eye(8, 16)
        loss_hi, _ = ttr.clip_loss(emb, emb, torch.tensor([100.0]))
        rng = np.random.default_rng(0)
        other = rng.normal(size=(8, 16)).astype(np.float32)
        other /= np.linalg.norm(other, axis=1, keepdims=True)
        loss_rand, _ = ttr.clip_loss(emb, torch.from_numpy(other), torch.tensor([100.0]))
        assert float(loss_hi) < 1e-3 < float(loss_rand)

    @pytest.mark.parametrize("tied", [False, True])
    def test_metrics_equal_jax(self, tied):
        """loss, accuracy (first-index argmax: ``tied`` gives rows of equal
        logits) and scale, against JAX's ``clip_loss``."""
        rng = np.random.default_rng(1)
        a, b = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        if tied:
            b[:] = b[0]
        scale = np.asarray([14.285714], np.float32)
        _, got = ttr.clip_loss(*(torch.from_numpy(x) for x in (a, b, scale)))
        _, want = jtr.clip_loss(*(jnp.asarray(x) for x in (a, b, scale)))
        for key in ("loss", "accuracy", "scale"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), atol=LOSS_ATOL,
                                       err_msg=key)


def test_step0_gradients_equal_jax(batch):
    """The port's global-batch gradient against ``jax.value_and_grad`` of
    JAX's loss on the same bridged weights, leaf by leaf, each within
    ``GRAD_RTOL`` of the leaf's largest |g|; the same leaf set."""
    jt, tt = _pair(**CONFIG)

    def loss_fn(params):
        img, txt, scale = jt.model.apply({"params": params}, *batch)
        return jtr.clip_loss(img, txt, scale)

    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(jt.params)
    want = flatten_params({"params": grads})
    metrics, got = tt.value_and_grad(*batch)
    assert set(got) == set(want)
    assert abs(metrics["loss"] - float(loss)) < LOSS_ATOL
    for key, ref in want.items():
        ref = np.asarray(ref)
        err = np.abs(got[key] - ref).max() / np.abs(ref).max()
        assert err < GRAD_RTOL, (key, err)


def test_three_losses_equal_jax(batch):
    """Three train steps on one batch: every step's metrics equal JAX's
    within ``LOSS_ATOL`` (the first update has learning rate 0, so steps 1
    and 2 read the same loss)."""
    jt, tt = _pair(**CONFIG)
    losses = []
    for _ in range(3):
        want, got = jt.train_step(*batch), tt.train_step(*batch)
        for key in ("loss", "accuracy", "scale"):
            assert abs(got[key] - want[key]) < LOSS_ATOL, (key, got, want)
        losses.append(got["loss"])
    assert losses[0] == losses[1] and losses[2] < losses[1]
    assert tt.step == jt.step == 3


# ---------------------------------------------------------------------------
# the optimizer against optax, given identical gradients
# ---------------------------------------------------------------------------


def _tree(rng, scale):
    return {"b": rng.normal(size=(3,)).astype(np.float32) * scale,
            "a": {"z": rng.normal(size=(4, 2)).astype(np.float32) * scale,
                  "logit_scale": rng.normal(size=(1,)).astype(np.float32) * scale}}


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_optimizer_updates_equal_optax(clip):
    """Five updates with warmup 2 of 10 (update count 0: learning rate 0;
    1: in the warmup; 2-4: past it, on the cosine), the clip ``active``
    (‖g‖ ≫ 1) or ``inactive`` (‖g‖ < 1): every update and the state after
    it equal to optax's, leaves in optax's order."""
    config = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=10)
    jtx = jtr.make_optimizer(jtr.TrainerConfig(**config))
    ttx = ttr.make_optimizer(ttr.TrainerConfig(**config))
    rng = np.random.default_rng(7)
    params = _tree(rng, 1.0)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jparams)
    tparams = [torch.from_numpy(x.copy()) for x in jax.tree.leaves(params)]
    tstate = ttx.init(tparams)
    scale = 10.0 if clip == "active" else 0.05
    for count in range(5):
        grads = _tree(rng, scale)
        norm = np.sqrt(sum(float((g * g).sum()) for g in jax.tree.leaves(grads)))
        assert (norm >= 1.0) == (clip == "active")
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        got, tstate = ttx.update([torch.from_numpy(g) for g in jax.tree.leaves(grads)],
                                 tstate, tparams)
        ttx.apply_updates(tparams, got)
        for g, w in zip(got, jax.tree.leaves(updates)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-12,
                                       err_msg=f"update {count}")
        if count == 0:
            assert all(float(np.abs(np.asarray(w)).max()) == 0 for w in jax.tree.leaves(updates))
        state_leaves = jax.tree.leaves(jstate)
        ours = [tstate.count, *tstate.mu, *tstate.nu, tstate.schedule_count]
        assert len(ours) == len(state_leaves)
        for g, w in zip(ours, state_leaves):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-12)
        for g, w in zip(tparams, jax.tree.leaves(jparams)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (1, 50), (0, 7), (3, 4)])
def test_schedule_equals_optax(warmup, total):
    ours = ttr.make_optimizer(ttr.TrainerConfig(warmup_steps=warmup, total_steps=total,
                                                learning_rate=3e-4))
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total)
    for count in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total,
                         total + 5} - {-1}):
        assert ours.schedule(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12)


def test_schedule_refuses_what_optax_refuses():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 5)
    with pytest.raises(ValueError, match="decay_steps"):
        ttr.make_optimizer(ttr.TrainerConfig(warmup_steps=5, total_steps=5))


# ---------------------------------------------------------------------------
# the trainer as JAX's tests hold it, and checkpoints both ways
# ---------------------------------------------------------------------------


class TestTrainer:
    @pytest.fixture(scope="class")
    def trainer(self):
        return ttr.ContrastiveTrainer(
            DualEncoderConfig.tiny(),
            ttr.TrainerConfig(warmup_steps=1, total_steps=50, learning_rate=1e-3),
            device="cpu",
        )

    def test_loss_decreases_on_repeated_batch(self, trainer):
        rng = np.random.default_rng(0)
        size = trainer.model_config.vision.image_size
        images, ids, mask = make_batch(rng, 8, size, trainer.model_config.text.max_len)
        first = trainer.train_step(images, ids, mask)["loss"]
        for _ in range(8):
            metrics = trainer.train_step(images, ids, mask)
        assert metrics["loss"] < first
        assert np.isfinite(metrics["loss"])

    def test_checkpoint_roundtrip(self, trainer, tmp_path):
        path = str(tmp_path / "trainer.npz")
        ttr.save_trainer_checkpoint(trainer, path)
        fresh = ttr.ContrastiveTrainer(DualEncoderConfig.tiny(),
                                       ttr.TrainerConfig(warmup_steps=1, total_steps=50),
                                       device="cpu", seed=123)
        ttr.restore_trainer_checkpoint(fresh, path)
        assert fresh.step == trainer.step
        for a, b in zip(trainer.params, fresh.params):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        rng = np.random.default_rng(1)
        metrics = fresh.train_step(*make_batch(rng, 4, 64, 16))
        assert np.isfinite(metrics["loss"])

    def test_num_params_equals_jax(self, trainer):
        jt = jtr.ContrastiveTrainer(model_config=jve.DualEncoderConfig.tiny(),
                                    trainer_config=jtr.TrainerConfig(**CONFIG))
        assert trainer.num_params() == jt.num_params()

    def test_restore_checks_shapes(self, trainer, tmp_path):
        path = str(tmp_path / "bad.npz")
        flat = trainer.checkpoint_leaves()
        flat["p3"] = np.zeros((2, 2), np.float32)
        np.savez(path, **flat)
        with pytest.raises(ValueError, match="shape mismatch restoring p3"):
            ttr.restore_trainer_checkpoint(trainer, path)


def test_checkpoint_keys_are_jax_leaf_order():
    """``p{i}`` / ``o{i}`` hold the JAX trainer's leaves, in its order and
    shapes (the state: Adam's count, μ, ν, the schedule's count)."""
    jt, tt = _pair(**CONFIG)
    flat = tt.checkpoint_leaves()
    params = jax.tree.leaves(jt.params)
    state = jax.tree.leaves(jt.opt_state)
    assert sorted(flat) == sorted([f"p{i}" for i in range(len(params))]
                                  + [f"o{i}" for i in range(len(state))] + ["step"])
    for i, leaf in enumerate(params):
        np.testing.assert_array_equal(flat[f"p{i}"], np.asarray(leaf))
    for i, leaf in enumerate(state):
        assert flat[f"o{i}"].shape == np.shape(leaf), i


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_interchange_with_jax(direction, batch, tmp_path):
    """Two steps on one side, its checkpoint restored into a fresh trainer of
    the other (another seed): its parameters EQUAL the writer's, and the
    next step on both gives metrics within ``LOSS_ATOL``."""
    path = str(tmp_path / "trainer.npz")
    jt, tt = _pair(**CONFIG)
    for _ in range(2):
        jt.train_step(*batch)
        tt.train_step(*batch)
    if direction == "jax_to_port":
        jtr.save_trainer_checkpoint(jt, path)
        writer = jt
        reader = ttr.ContrastiveTrainer(DualEncoderConfig.tiny(), ttr.TrainerConfig(**CONFIG),
                                        device="cpu", seed=9)
        ttr.restore_trainer_checkpoint(reader, path)
    else:
        ttr.save_trainer_checkpoint(tt, path)
        writer = tt
        reader = jtr.ContrastiveTrainer(model_config=jve.DualEncoderConfig.tiny(),
                                        trainer_config=jtr.TrainerConfig(**CONFIG), seed=9)
        jtr.restore_trainer_checkpoint(reader, path)
    assert reader.step == 2
    if direction == "jax_to_port":
        restored, saved = reader.jax_params(), flatten_params({"params": writer.params})
    else:
        restored, saved = flatten_params({"params": reader.params}), writer.jax_params()
    for key in saved:
        np.testing.assert_array_equal(np.asarray(restored[key]), np.asarray(saved[key]),
                                      err_msg=key)
    want, got = writer.train_step(*batch), reader.train_step(*batch)
    for key in ("loss", "accuracy", "scale"):
        assert abs(got[key] - want[key]) < LOSS_ATOL, (key, got, want)


def test_trainer_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.ContrastiveTrainer(DualEncoderConfig.tiny())


def test_dryrun_twin_passes_at_4():
    """``scripts/torch_dryrun_multichip.py 4``: 4 gloo ranks, the dp2×tp2
    trainer step, the 4-stage pipeline, the serving and parse checks; one
    summary line with the JAX dryrun's keys in its order
    (``MULTICHIP_r05.json``), each error under JAX's bound."""
    proc = subprocess.run([sys.executable, "scripts/torch_dryrun_multichip.py", "4"],
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh={'data': 2, 'model': 2}"), line
    assert "pp_stages=4" in line
    with open("MULTICHIP_r05.json") as f:
        jax_line = json.load(f)["tail"].splitlines()[0]
    pair = r"(\w+)=(\{[^}]*\}|\S+)"
    assert [k for k, _ in re.findall(pair, line)] == [k for k, _ in re.findall(pair, jax_line)]
    got = dict(re.findall(pair, line))
    assert got["serving_dp_pages"] == got["dp_parse_pages"] == "4"
    assert got["hybrid_mesh"] == "{'data': 2, 'model': 2}"
    assert got["dp_parse_token_equal"] == "True"
    assert float(got["mme5_tp_max_err"]) < 2e-5 and float(got["dp_tp_split_max_err"]) < 1e-4
