"""The port's mesh of ranks (``core/mesh.py``), its sharding rules
(``parallel/sharding.py``) and the trainer over them, against the
single-process trainer and the JAX package's rules and errors.

The multi-rank cases run in ONE spawn of 4 gloo ranks for the module (a
module-scoped fixture; the ranks import torch and the port only, one
intra-op thread each): the dp2×tp2 trainer, dp4, and the hybrid mesh of 2
simulated hosts × 2 ranks with tp = 2. Each rank computes the global
batch's loss; its gradient must equal the single-process gradient of the
same global batch, leaf by leaf, within 5e-4 of the leaf's largest |g|
(f32; the towers' sums split over ranks and re-added in other orders:
the largest reading 1.2e-4, on the tensor-parallel meshes), and must not be
the data-axis size times it."""

import numpy as np
import pytest
import torch

from multimodal_embeddings_tpu.config import MeshConfig as JaxMeshConfig
from multimodal_embeddings_tpu.parallel import sharding as jsharding
from multimodal_embeddings_tpu_torch.config import MeshConfig
from multimodal_embeddings_tpu_torch.core import mesh as tmesh
from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
from multimodal_embeddings_tpu_torch.models.vision_encoder import DualEncoder, DualEncoderConfig
from multimodal_embeddings_tpu_torch.parallel import dryrun
from multimodal_embeddings_tpu_torch.parallel import sharding as tsharding
from multimodal_embeddings_tpu_torch.training.contrastive import ContrastiveTrainer, TrainerConfig

GRAD_RTOL = 5e-4
CONFIG = TrainerConfig(warmup_steps=1, total_steps=50, learning_rate=1e-3)
SHAPES = {"dp2xtp2": ((2, 2), None), "dp4": ((4, 1), None),
          "hybrid": ((-1, 2), [[0, 1], [2, 3]])}


def _batch():
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32)
    ids, mask = ByteTokenizer().encode_batch([f"text {i}" for i in range(8)], 16)
    return images, ids, mask


@pytest.fixture(scope="module")
def single():
    """The single-process trainer (seed 1) and its gradient, metrics and
    step on the global batch."""
    trainer = ContrastiveTrainer(DualEncoderConfig.tiny(), CONFIG, device="cpu", seed=1)
    params = trainer.jax_params()
    metrics, grads = trainer.value_and_grad(*_batch())
    step = trainer.train_step(*_batch())
    return {"params": params, "metrics": metrics, "grads": grads, "step": step,
            "leaves": trainer.checkpoint_leaves(), "num_params": trainer.num_params()}


@pytest.fixture(scope="module")
def ranks(single):
    """Every multi-rank case in one spawn of 4 gloo ranks: rank 0's results
    by case name."""
    cases = [("trainer_case", dict(model_config=DualEncoderConfig.tiny(), trainer_config=CONFIG,
                                   shape=shape, batch=_batch(), params=single["params"],
                                   host_groups=hosts))
             for shape, hosts in SHAPES.values()]
    results = tmesh.launch(dryrun.run_cases, 4, cases, device="cpu", timeout=300)
    for r in results[1:]:  # every rank saw the same global loss
        assert [c["metrics"] for c in r] == [c["metrics"] for c in results[0]]
    return dict(zip(SHAPES, results[0]))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_gradient_equals_the_single_process_gradient(case, ranks, single):
    got, want = ranks[case], single
    assert got["metrics"] == pytest.approx(want["metrics"], abs=2e-6)
    assert set(got["grads"]) == set(want["grads"])
    for key, ref in want["grads"].items():
        scale = np.abs(ref).max()
        err = np.abs(got["grads"][key] - ref).max() / scale
        assert err < GRAD_RTOL, (case, key, err)
    # not the data-axis size times it (all-gather's backward sums over ranks)
    data = 4 if case == "dp4" else 2
    key = "params/vision/block0/mlp/fc1/kernel"
    ratio = np.abs(got["grads"][key]).sum() / np.abs(want["grads"][key]).sum()
    assert abs(ratio - 1) < 1e-3 and abs(ratio - data) > 0.5


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_train_step_and_its_state_equal_the_single_process(case, ranks, single):
    """One step (learning rate 0 at update count 0): the same metrics, the
    parameters EQUAL, Adam's moments (gathered whole) within the gradient's
    tolerance, the counts; and the whole model's parameter count."""
    got, want = ranks[case], single
    assert got["step"] == pytest.approx(want["step"], abs=2e-6)
    assert got["num_params"] == want["num_params"]
    assert sorted(got["leaves"]) == sorted(want["leaves"])
    for key, ref in want["leaves"].items():
        if key.startswith("p") or ref.ndim == 0:
            np.testing.assert_array_equal(got["leaves"][key], ref, err_msg=key)
        else:
            scale = max(np.abs(ref).max(), 1e-30)
            assert np.abs(got["leaves"][key] - ref).max() / scale < GRAD_RTOL, key


def test_mesh_layouts(ranks):
    assert ranks["dp2xtp2"]["ranks"] == [[0, 1], [2, 3]]
    assert ranks["dp4"]["ranks"] == [[0], [1], [2], [3]]
    # hybrid: the tp pairs within a host, the data rows host-major
    assert ranks["hybrid"]["ranks"] == [[0, 1], [2, 3]]


def test_hybrid_mesh_needs_its_ranks_in_the_world():
    """The hybrid layout of 2 hosts × 4 ranks (JAX's test's) is laid out
    only in a world that holds those ranks; a single process is a world of
    one host."""
    with pytest.raises(ValueError, match="outside a world of 1"):
        tmesh.make_hybrid_mesh(MeshConfig(shape=(-1, 2)),
                               host_groups=[[0, 1, 2, 3], [4, 5, 6, 7]])
    assert tmesh.host_groups_of_world() == [[0]]
    assert tmesh.make_hybrid_mesh().shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("shape", [(-1, 3), (2, 5)])
def test_hybrid_mesh_rejects_cross_host_tp(shape):
    hosts = [list(range(4)), list(range(4, 8))]
    with pytest.raises(ValueError, match="must divide"):
        tmesh.make_hybrid_mesh(MeshConfig(shape=shape), host_groups=hosts)


def test_hybrid_mesh_errors_equal_jax():
    from multimodal_embeddings_tpu.core.mesh import make_hybrid_mesh as jax_hybrid

    hosts = [[0, 1], [2, 3, 4]]
    for make, cfg in ((tmesh.make_hybrid_mesh, MeshConfig), (jax_hybrid, JaxMeshConfig)):
        with pytest.raises(ValueError, match="equal device counts"):
            make(cfg(shape=(-1, 1)), host_groups=hosts)
    with pytest.raises(ValueError, match="data size must be -1 or 4"):
        tmesh.make_hybrid_mesh(MeshConfig(shape=(3, 1)), host_groups=[[0, 1], [2, 3]])


def test_make_mesh_single_process():
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == (0, 0)
    with pytest.raises(ValueError, match="model axis size must be >= 1"):
        tmesh.make_mesh(MeshConfig(shape=(-1, 0)))
    with pytest.raises(ValueError, match="not divisible by model=2"):
        tmesh.make_mesh(MeshConfig(shape=(-1, 2)), devices=[0, 1, 2])
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(tmesh.shard_batch(mesh, x), x)
    assert tmesh.data_sharding(mesh, 3).spec == ("data", None, None)
    assert tmesh.replicated(mesh).spec == ()
    assert tmesh.pad_to_multiple(13, 8) == 16


def test_dtype_policy():
    import dataclasses

    from multimodal_embeddings_tpu.core.mesh import DTypePolicy as JaxDTypePolicy

    policy = tmesh.DTypePolicy()
    assert policy.compute == torch.bfloat16 and policy.param == torch.float32
    assert dataclasses.asdict(policy) == dataclasses.asdict(JaxDTypePolicy())


def test_launch_reports_a_failing_rank():
    """A rank that raises ends ``launch`` with an error naming it, and no
    rank is left running."""
    with pytest.raises(RuntimeError, match="exited with code 1 and no result"):
        tmesh.launch(dryrun.run_cases, 2, [("no_such_case", {})], device="cpu", timeout=120)


def test_logical_axis_rules_equal_jax():
    assert tsharding.LOGICAL_AXIS_RULES == jsharding.LOGICAL_AXIS_RULES


def test_logical_axes_of_the_dual_encoder_equal_jax():
    """Every annotated kernel of the dual encoder: the port's axes (read
    off its name and ``kernel_shape``) are those of the JAX init's
    ``LogicallyPartitioned`` metadata, and every model-sharded one leads
    its group."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from multimodal_embeddings_tpu.models.vision_encoder import DualEncoder as JaxDualEncoder
    from multimodal_embeddings_tpu.models.vision_encoder import (
        DualEncoderConfig as JaxDualEncoderConfig,
    )

    jmodel = JaxDualEncoder(JaxDualEncoderConfig.tiny())
    variables = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 16), jnp.int32),
        jnp.ones((1, 16), jnp.int32)))
    specs = nn.get_partition_spec(variables)["params"]
    model = DualEncoder(DualEncoderConfig.tiny())
    checked = 0
    for name, m in model.named_modules():
        axes = tsharding.logical_axes(name, m)
        if axes is None:
            continue
        node = specs
        for part in name.split("."):
            node = node[part]
        spec = node["embedding" if name.endswith("tok_embed") else "kernel"]
        assert tuple(spec) == axes, name
        if tsharding.MODEL_AXIS in tsharding.mesh_axes(axes) and not name.endswith("tok_embed"):
            assert tsharding.weight_shard_dim(m, axes) in (0, 1)
        checked += 1
    assert checked == 2 * 2 * 6 + 2 + 1  # per block q,k,v,o,fc1,fc2; 2 proj; tok_embed


def test_shard_variables_with_one_model_rank_changes_nothing():
    model = DualEncoder(DualEncoderConfig.tiny())
    before = {n: p for n, p in model.named_parameters()}
    tsharding.shard_variables(model, tmesh.make_mesh())
    assert {n: p for n, p in model.named_parameters()} == before
    assert set(tsharding.param_shard_dims(model).values()) == {None}
    assert tsharding.unbox(before) is before
