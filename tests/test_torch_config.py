"""The port's engine configs against the JAX package's: every port field is
the JAX field of the same name, type and default, and the JAX fields the
port leaves out are exactly the ones it has no path for."""

import dataclasses

import pytest

from multimodal_embeddings_tpu import config as jconfig
from multimodal_embeddings_tpu_torch import config as tconfig

LEFT_OUT = {
    # the JAX space-to-depth stem: exact, and no faster on an H100 than the
    # port's one stem (scripts/torch_stem_bench.py)
    "DetectorConfig": {"s2d_stem"},
    "EmbedderConfig": set(),
    "OrientationConfig": set(),
    "EdgeFilterConfig": set(),
    "CombineConfig": set(),
    "MedianWidthConfig": set(),
    "ColumnConfig": set(),
    "StoreConfig": set(),
    "AnalysisConfig": set(),
    "MeshConfig": set(),
}


def _fields(cls):
    return {f.name: f for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", sorted(LEFT_OUT))
def test_port_fields_match_the_jax_fields(name):
    port, ref = _fields(getattr(tconfig, name)), _fields(getattr(jconfig, name))
    assert set(ref) - set(port) == LEFT_OUT[name]
    assert set(port) <= set(ref)
    for field_name, field in port.items():
        want = ref[field_name]
        assert str(field.type) == str(want.type), field_name
        assert field.default == want.default, field_name


@pytest.mark.parametrize("name", sorted(LEFT_OUT))
def test_port_defaults_build_the_jax_defaults(name):
    """A port config carried across field by field is the JAX default config."""
    port = getattr(tconfig, name)()
    ref = getattr(jconfig, name)(**dataclasses.asdict(port))
    assert ref == getattr(jconfig, name)()
    assert getattr(tconfig, name).__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["ID_TO_NAMES", "NAMES_TO_ID", "REGION_TYPES_TO_PROCESS"])
def test_taxonomy_equals_jax(name):
    assert getattr(tconfig, name) == getattr(jconfig, name)
    assert type(getattr(tconfig, name)) is type(getattr(jconfig, name))


def test_device_letterbox_default():
    assert tconfig.DetectorConfig().device_letterbox is jconfig.DetectorConfig().device_letterbox


@pytest.mark.parametrize("size", ["tiny", "base"])
def test_dual_encoder_sizes_equal_jax(size):
    """``DualEncoderConfig.tiny()`` (``serve --embedder_size tiny``) and
    ``base()``, field by field."""
    from multimodal_embeddings_tpu.models import vision_encoder as jve
    from multimodal_embeddings_tpu_torch.models import vision_encoder as tve

    got, want = getattr(tve.DualEncoderConfig, size)(), getattr(jve.DualEncoderConfig, size)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
