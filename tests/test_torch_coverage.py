"""The port covers the JAX package's public surface.

Both packages are parsed with ``ast`` (neither is imported). For every
module of ``multimodal_embeddings_tpu/``, its twin of the same path in
``multimodal_embeddings_tpu_torch/`` must hold:

- every public top-level function, class and constant;
- every public method of a public class (a flax module's ``__call__`` is the
  port's ``forward``; methods are looked up through the module's own base
  classes);
- every argument of a function, method or constructor that both packages
  have (a dataclass's or flax module's fields are its constructor's
  arguments).

The one exception is an entry in ``LEFT_OUT`` (keyed by module, each with
its reason) or in ``RENAMED`` (the port's name, which must exist). Every
entry must name something the JAX module has and the port lacks, so the
table cannot outlive a port. Keys: ``name`` for a top-level name,
``Class.method`` for a method, ``name(arg)`` / ``Class.method(arg)`` for an
argument, ``Class(arg)`` for a constructor's argument.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "multimodal_embeddings_tpu"
PORT_PKG = REPO / "multimodal_embeddings_tpu_torch"
JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))

# the reasons, each cited where ROADMAP.md "Queue 3" records the divergence
FLAX = "a flax/JAX program helper with no PyTorch counterpart"
SETUP = "flax's setup(); a torch module builds its submodules in __init__"
DTYPE = "a torch module takes its dtype from .to(dtype)"
VARIABLES = ("a flax variables tree passed into a JAX program; the port's modules hold "
             "their parameters (ROADMAP Queue 3, 'Checkpoints')")
TRAIN = ("BatchNorm's batch-statistics switch; the port folds each BatchNorm into its "
         "conv, inference only (ROADMAP Queue 3, 'A partly mapped ConvBnAct raises')")
S2D = ("the space-to-depth stem, not ported (ROADMAP item 6a, "
       "tests/test_torch_config.py::LEFT_OUT)")
TILING = ("a TPU tiling or VMEM choice; the port's kernels plan their own launch "
          "(ROADMAP Queue 3, 'The TPU tiling arguments are not ported')")
INTERPRET = ("Pallas interpret mode, the JAX kernels' CPU route; the port's CPU route is "
             "the plain version, taken for a CPU tensor")
GATE = ("a TPU VMEM gate of the Pallas route (ROADMAP Queue 3, 'The port's Attention "
        "takes BLF and proj-BHLD at every length')")
PROGRAM = ("shapes the jitted XLA program (constants, layouts); eager PyTorch builds no "
           "program (pipeline/fused.py's docstring)")
AXES = ("a flax logical axis name on parameter annotations; the port's rules are "
        "parallel/sharding.py's LOGICAL_AXIS_RULES and parameter paths")
ORBAX = "Orbax is a JAX-only checkpoint format (ROADMAP Queue 3, 'Checkpoints')"
JAXPR = "walks a jaxpr (ROADMAP Queue 3, 'No jaxpr walkers')"

LEFT_OUT = {
    "analysis/activations.py": {
        "trace_flax_module": "flax's capture_intermediates; the port's trace_module uses "
                             "forward hooks (ROADMAP Queue 3, 'Activation traces')",
        "qwen_trace(variables)": VARIABLES,
    },
    "analysis/doc_parser.py": {
        "DocumentParser(variables)": VARIABLES,
        "logger": "defined and never used in the JAX module",
    },
    "cli/__init__.py": {
        "apply_env_platform": "sets JAX's platform from the environment (ROADMAP Queue 1)",
    },
    "config.py": {"DetectorConfig(s2d_stem)": S2D},
    "kernels/conv.py": {
        "ROWS": TILING, "conv3x3_nchw(rows)": TILING, "conv3x3_s2_nchw(rows)": TILING,
        "conv3x3_nchw(interpret)": INTERPRET, "conv3x3_s2_nchw(interpret)": INTERPRET,
    },
    "kernels/encoder_attention.py": {
        "NEG_INF": "the TPU kernel's score for a masked key; the port leaves masked keys "
                   "out of the sum, which gives the same output",
        "blf_supported": GATE, "blf_packed_supported": GATE,
        "encoder_attention(heads_per_block)": TILING, "encoder_attention(row_block)": TILING,
        "encoder_attention_blf(heads_per_block)": TILING,
        "encoder_attention_blf(scratch)": "selects the TPU kernel's scratch-buffer twin "
                                          "(same math); K1 has one form",
        "encoder_attention_blf_packed(heads_per_block)": TILING,
        "encoder_attention_blhd(heads_per_block)": TILING,
        "encoder_attention(interpret)": INTERPRET, "encoder_attention_blf(interpret)": INTERPRET,
        "encoder_attention_blf_packed(interpret)": INTERPRET,
        "encoder_attention_blhd(interpret)": INTERPRET,
        "encoder_attention_padded(interpret)": INTERPRET,
    },
    "kernels/flash_attention.py": {
        "DEFAULT_BLOCK_Q": TILING, "DEFAULT_BLOCK_K": TILING,
        "flash_attention(block_q)": TILING, "flash_attention(block_k)": TILING,
        "flash_attention_v2(block_q)": TILING, "flash_attention_v2(block_k)": TILING,
        "flash_attention(interpret)": INTERPRET, "flash_attention_v2(interpret)": INTERPRET,
    },
    "kernels/ln_matmul.py": {
        "ln_matmul(block_m)": TILING, "ln_matmul(block_n)": TILING,
        "ln_matmul(interpret)": INTERPRET,
    },
    "kernels/ln_stats.py": {
        "ln_stats(method)": "the TPU reduction's form (MMTPU_LN_STATS_METHOD is not read, "
                            "ROADMAP Queue 3)",
        "ln_stats(interpret)": INTERPRET,
    },
    "kernels/quantization.py": {
        "pick_blocks": TILING, "int8_matmul(block_m)": TILING, "int8_matmul(block_n)": TILING,
        "int8_matmul(block_k)": TILING,
        "int8_apply(use_kernel)": "the port takes the kernel on the card and the plain "
                                  "version on the CPU (ROADMAP Queue 3)",
        "int8_matmul(interpret)": INTERPRET, "stochastic_round_quantize(interpret)": INTERPRET,
    },
    "kernels/quantization_int4.py": {
        "pick_blocks4": TILING, "int4_matmul(block_m)": TILING, "int4_matmul(block_n)": TILING,
        "int4_matmul(groups_per_step)": TILING,
        "int4_apply(use_kernel)": "the port takes the kernel on the card and the plain "
                                  "version on the CPU (ROADMAP Queue 3)",
        "int4_matmul(interpret)": INTERPRET,
    },
    "models/embedder.py": {"deterministic_init_multi": FLAX},
    "models/layers.py": {
        **{f"{c}(dtype)": DTYPE for c in (
            "ConvBnAct", "Bottleneck", "C2f", "CIB", "CRMBottleneck", "G2L_CRM", "SCDown",
            "SPPF", "PSAAttention", "PSA")},
        **{f"{c}.forward(train)": TRAIN for c in (
            "ConvBnAct", "Bottleneck", "C2f", "CIB", "CRMBottleneck", "G2L_CRM", "SCDown",
            "SPPF", "PSAAttention", "PSA")},
        "ConvBnAct(s2d)": S2D,
        "CRMBottleneck(nchw_io)": "the JAX stage route's layout flag; the port is NCHW "
                                  "throughout and kernel=True is that route",
    },
    "models/mme5.py": {
        "MmE5Embedder.setup": SETUP,
        "MllamaVisionEncoder.forward(all_tiles_real)": "a static hint for the XLA program; "
                                                       "the port's tile_mask=None says it",
    },
    "models/quantized.py": {
        "synthetic_int8_init(example_args)": "inputs for jax.eval_shape; the port fills a "
                                             "built module",
    },
    "models/qwen_pp.py": {"pp_greedy_generate(variables)": VARIABLES},
    "models/qwen_serve.py": {"continuous_generate(variables)": VARIABLES},
    "models/qwen_vl.py": {"QwenVLModel.setup": SETUP, "greedy_generate(variables)": VARIABLES},
    "models/transformer.py": {
        **{name: AXES for name in ("EMBED", "HEADS", "KV_HEADS", "HEAD_DIM", "MLP", "VOCAB")},
        "np_prod": "a helper of the flax initializers' fan computation",
        "Attention(max_len)": "the length of a precomputed RoPE table; the port computes the "
                              "table at the call's length",
        "LlamaBlock(max_len)": "the length of a precomputed RoPE table; the port computes the "
                               "table at the call's length",
        **{f"{c}.forward(kv_lengths)": "no JAX model passes it (ROADMAP Queue 3, 'The TPU "
                                       "tiling arguments are not ported')"
           for c in ("Attention", "EncoderBlock", "GatedEncoderBlock")},
    },
    "models/vision_encoder.py": {
        "ViTower(dtype)": DTYPE, "TextTower(dtype)": DTYPE, "DualEncoder(dtype)": DTYPE,
        "DualEncoder.setup": SETUP,
    },
    "models/weights.py": {
        "init_on_host": FLAX, "deterministic_init": FLAX, "flatten_params": FLAX,
        "unflatten_params": FLAX, "unfreeze_tree": FLAX,
        "save_checkpoint_orbax": ORBAX, "load_checkpoint_orbax": ORBAX,
        "load_checkpoint(target_variables)": "the port returns the flat dict and its bridge "
                                             "checks the keys (ROADMAP Queue 3, "
                                             "'Checkpoints')",
        "load_torch_state_dict(target_variables)": VARIABLES,
    },
    "models/yolo.py": {
        **{f"{c}(dtype)": DTYPE for c in ("Backbone", "PANNeck", "DetectHead", "DocLayoutYOLO")},
        **{f"{c}.forward(train)": TRAIN
           for c in ("Backbone", "PANNeck", "DetectHead", "DocLayoutYOLO")},
        "Backbone(s2d_stem)": S2D, "DocLayoutYOLO(s2d_stem)": S2D,
    },
    "ops/image.py": {"crop_and_resize_mxu(chunk)": TILING},
    "parallel/sharding.py": {
        "logical_to_mesh_sharding": "builds jax.sharding objects; the port cuts parameters "
                                    "in shard_variables",
    },
    "pipeline/fused.py": {
        "build_fused_detect_fn(closure_weights)": PROGRAM,
        "build_fused_page_fn(closure_weights)": PROGRAM,
        "build_fused_page_fn(auto_layouts)": PROGRAM,
        "build_split_page_fn(closure_weights)": PROGRAM,
        "build_split_page_fn(embed_closure)": PROGRAM,
    },
    "utils/flops.py": {"jaxpr_matmul_conv_flops": JAXPR, "fn_matmul_conv_flops": JAXPR},
    "utils/trace_analysis.py": {
        "aggregate_xla_ops": "reads XLA op events; the port's aggregate_kernels reads the "
                             "CUDA kernels of a torch.profiler trace",
    },
}

# the port's name for a JAX name or argument
RENAMED = {
    "models/layers.py": {
        **{f"{c}(out_channels)": f"{c}(c_out)" for c in (
            "ConvBnAct", "Bottleneck", "C2f", "CIB", "G2L_CRM", "SCDown", "SPPF", "PSA")},
        "CRMBottleneck(out_channels)": "CRMBottleneck(c)",
        "CRMBottleneck(pallas)": "CRMBottleneck(kernel)",
    },
    "models/quantized.py": {
        "Int8DenseGeneral": "Int8Dense", "Int8DenseGeneral.forward": "Int8Dense.forward",
        "Int4DenseGeneral": "Int4Dense", "Int4DenseGeneral.forward": "Int4Dense.forward",
        "quantize_dense_tree(src_params)": "quantize_dense_tree(src)",
        "quantize_dense_tree(target_struct)": "quantize_dense_tree(target)",
        "synthetic_int8_init(model)": "synthetic_int8_init(module)",
        "param_bytes(params)": "param_bytes(module)",
    },
    "models/qwen_vl.py": {"QwenBlock.forward(position)": "QwenBlock.forward(index)"},
    "models/transformer.py": {
        "rope_frequencies(max_len)": "rope_frequencies(length)",
        "RMSNorm(epsilon)": "RMSNorm(eps)", "FastLayerNorm(epsilon)": "FastLayerNorm(eps)",
        "SwiGLU(hidden_dim)": "SwiGLU(hidden)", "GeluMLP(hidden_dim)": "GeluMLP(hidden)",
    },
    "models/weights.py": {
        "save_checkpoint(variables)": "save_checkpoint(module)",
        "save_checkpoint_safetensors(variables)": "save_checkpoint_safetensors(module)",
    },
    "parallel/sharding.py": {"shard_variables(variables)": "shard_variables(module)"},
    "utils/trace_analysis.py": {"print_report(trace_dir)": "print_report(trace_path)"},
}


def _args(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _surface(path: pathlib.Path) -> dict:
    """``{key: args or None}`` of a module's public surface: top-level
    names, public methods of public classes (``__call__`` as ``forward``,
    inherited ones from the module's own classes), with their arguments."""
    tree = ast.parse(path.read_text())
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    out = {}

    def constructor(cls, seen=()):
        """The constructor's arguments: dataclass/flax fields and
        ``__init__``'s, else those of the module's own base classes."""
        args = [n.target.id for n in cls.body
                if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]
        for node in cls.body:
            if isinstance(node, ast.FunctionDef) and node.name == "__init__":
                args += _args(node)
        for base in cls.bases:
            if not args and isinstance(base, ast.Name) and base.id in classes \
                    and base.id not in seen:
                args = constructor(classes[base.id], seen + (cls.name,))
        return args

    def methods(cls, seen=()):
        found = {}
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes and base.id not in seen:
                found.update(methods(classes[base.id], seen + (cls.name,)))
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = "forward" if node.name == "__call__" else node.name
                if not name.startswith("_"):
                    found[name] = _args(node)
        return found

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _args(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = constructor(node)
            if not node.name.startswith("_"):
                for name, args in methods(node).items():
                    out[f"{node.name}.{name}"] = args
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = None
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = None
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _missing(module: str) -> set:
    """The JAX module's public keys (names, methods, arguments) that its
    port twin lacks."""
    port_path = PORT_PKG / module
    if not port_path.exists():
        return {"<module>"}
    want, have = _surface(JAX_PKG / module), _surface(port_path)
    missing = set()
    for key, args in want.items():
        if key not in have:
            missing.add(key)
        elif args is not None and have[key] is not None:
            missing.update(f"{key}({a})" for a in args if a not in have[key])
    return missing


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_covers_the_jax_module(module):
    left_out, renamed = LEFT_OUT.get(module, {}), RENAMED.get(module, {})
    missing = _missing(module)
    unexplained = sorted(missing - set(left_out) - set(renamed))
    assert not unexplained, f"{module}: not in the port and not in LEFT_OUT: {unexplained}"
    stale = sorted((set(left_out) | set(renamed)) - missing)
    assert not stale, f"{module}: LEFT_OUT/RENAMED entries the port has or JAX lacks: {stale}"
    for key, reason in left_out.items():
        assert isinstance(reason, str) and reason.strip(), f"{module}: {key} has no reason"
    have = _surface(PORT_PKG / module)
    for key, port_key in renamed.items():
        name, _, arg = port_key.partition("(")
        assert name in have, f"{module}: {key} renamed to {port_key}, which is missing"
        if arg:
            assert arg.rstrip(")") in have[name], f"{module}: no {port_key}"


def test_tables_name_jax_modules():
    assert set(LEFT_OUT) | set(RENAMED) <= set(JAX_MODULES)
