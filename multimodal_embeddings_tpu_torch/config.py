"""Engine and stage configuration: ``DetectorConfig``, ``EmbedderConfig``
and the numbered chain's stage configs of
``multimodal_embeddings_tpu/config.py``, with its
class taxonomy (``ID_TO_NAMES``, ``NAMES_TO_ID``) and the region classes the
embedder takes (``REGION_TYPES_TO_PROCESS``), copied so that the port and
its runs import nothing of the JAX package.

Each field here is the JAX field of the same name with the same default
(``tests/test_torch_config.py`` holds the two together). ``pallas_convs``
and ``pallas_mode`` select the GL-CRM stages' route through the 3×3 conv
kernel (K5, ``kernels/conv.py``); ``device_letterbox`` makes the
detector's multigrid host API letterbox the views on the device
(``models/detector.py``). The one field left out is the space-to-depth
stem (``s2d_stem``): it evaluates the stem conv by an exact rewrite that
feeds the TPU's matrix unit better, gives the same outputs, and on an H100
is no faster than the one stem the port keeps (``nn.Conv2d``; timed by
``scripts/torch_stem_bench.py``). The stage configs of the numbered chain
(``OrientationConfig``, ``EdgeFilterConfig``, ``CombineConfig``,
``MedianWidthConfig``, ``ColumnConfig``) and the store's and the
analysis passes' settings (``StoreConfig``, ``AnalysisConfig``) are copied
whole, and so is ``MeshConfig``, the (data, model) layout of the ranks
that ``core/mesh.py`` lays out over ``torch.distributed``.

``PipelineConfig`` gathers the ten configs with JAX's JSON round trip
(``from_json``, ``to_json``), copied as it is: ``to_json`` writes the
tuple fields (``DetectorConfig.grid_configs``, ``MeshConfig.shape``) as
lists and ``from_json`` keeps them so, so a loaded config is not ``==`` to
the default; a JAX file's ``s2d_stem`` is dropped on load. ``hf_token``,
``NUM_CLASSES`` and ``IMAGE_EXTENSIONS`` are JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Tuple

# Class taxonomy (reference: 1_doclayout_bboxes.py:67-78)
ID_TO_NAMES = {
    0: "title",
    1: "plain_text",
    2: "abandon",
    3: "figure",
    4: "figure_caption",
    5: "table",
    6: "table_caption",
    7: "table_footnote",
    8: "isolate_formula",
    9: "formula_caption",
}
NAMES_TO_ID = {v: k for k, v in ID_TO_NAMES.items()}
NUM_CLASSES = len(ID_TO_NAMES)

# Region classes forwarded to the embedder
# (reference: deprecated_package/config.py:67-74)
REGION_TYPES_TO_PROCESS = (
    "title",
    "plain_text",
    "figure",
    "figure_caption",
    "table",
    "table_caption",
)

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".webp", ".tiff", ".tif", ".bmp")


@dataclasses.dataclass(frozen=True)
class OrientationConfig:
    """Stage-0 deskew settings (reference: 0_orientation.py:326-388)."""

    sensitivity_threshold: float = 0.5  # degrees; below this → copy unchanged
    advanced_detection: bool = True  # Hough-based skew path
    # Hough skew-detection parameters (reference: 0_orientation.py:143-167)
    gaussian_kernel: int = 5
    adaptive_block_size: int = 11
    adaptive_c: float = 2.0
    canny_low: float = 50.0
    canny_high: float = 150.0
    hough_threshold: int = 100
    hough_max_gap: int = 10
    max_abs_angle: float = 45.0  # reject steeper lines
    max_angle_std: float = 10.0  # reject noisy estimates


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Stage-1 DocLayout-YOLO settings (reference: 1_doclayout_bboxes.py:684-701,
    deprecated_package/config.py:62-64)."""

    image_size: int = 1024
    conf_threshold: float = 0.1
    iou_threshold: float = 0.45  # class-agnostic NMS after predict
    grid_configs: Tuple[Tuple[int, int], ...] = ((2, 2), (3, 3), (4, 4))
    overlap_percentage: float = 20.0
    max_detections: int = 300  # static padding bound per view
    # Architecture scale ("m" matches doclayout_yolo_docstructbench)
    variant: str = "m"
    weights_path: Optional[str] = None  # safetensors / torch .pt to load
    # DocLayout-YOLO GL-CRM backbone blocks (the DocStructBench checkpoint
    # is this architecture, not base v10 — arXiv 2410.12628)
    glcrm: bool = True
    # Route GL-CRM inner 3x3 convs with <= this many channels through the
    # hand-written 3x3 conv kernel (kernels/conv.py, K5); 0 = library convs.
    # The JAX package's measured-win widths are 48 and 96.
    pallas_convs: int = 0
    # Where the kernel route starts: "stage" runs the whole G2L_CRM stage on
    # it (cv1, cv2 and the gates as channel products), "block" only each
    # bottleneck's two 3x3s (cv1/cv2 stay library convs).
    pallas_mode: str = "stage"
    # The multigrid host API (models/detector.py::detect_page_multigrid):
    # letterbox all views on the device (matmul resize) instead of one host
    # resize per view
    device_letterbox: bool = True


@dataclasses.dataclass(frozen=True)
class EdgeFilterConfig:
    """Stage-2 settings (reference: 2_edge_box_filter.py:44-90)."""

    threshold: int = 10  # px distance from an internal edge


@dataclasses.dataclass(frozen=True)
class CombineConfig:
    """Stage-3 settings (reference: 3_combine_grids.py:403-411)."""

    iou_threshold: float = 0.5
    viz_alpha: float = 0.3


@dataclasses.dataclass(frozen=True)
class MedianWidthConfig:
    """Stage-4 settings (reference: 4_extract_median_widths.py:227-233)."""

    min_margin_percent: float = 0.2


@dataclasses.dataclass(frozen=True)
class ColumnConfig:
    """Stage-5 settings (reference: 5_detect_column_centers.py:91-224)."""

    min_confidence: float = 0.3
    density_bins: int = 1000  # resolution = page_width // density_bins px/bin
    min_width_ratio: float = 0.33
    max_width_ratio: float = 2.0
    peak_height_frac: float = 0.2
    peak_prominence_frac: float = 0.05


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    """Embedding model settings (reference: deprecated_package/config.py:51-58,
    embedder.py:36-254)."""

    model_name: str = "intfloat/mmE5-mllama-11b-instruct"
    # "mme5" = Mllama-architecture parity path; "siglip" = fast ViT dual encoder
    family: str = "siglip"
    batch_size: int = 16  # whole-image batch (config.py:51)
    region_batch_size: int = 48  # region-crop batch (config.py:52)
    max_image_dim: int = 8000  # LANCZOS cap (config.py:18)
    image_size: int = 448  # encoder input resolution (Mllama tile size: 560)
    embed_dim: int = 768
    dtype: str = "bfloat16"
    weights_path: Optional[str] = None
    prompt: str = "<|image|><|begin_of_text|> Represent the given image."
    # weight-only quantized storage for the mme5 family
    # (models/quantized.py, models/mme5.py::split_quantize): False |
    # True/"int8" | "int4" | "int8-mixed" | "int4-mixed" (the mixed forms:
    # bf16 vision tower, int8 or int4 text stack)
    quantize: Any = False


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Embedding store settings (reference: deprecated_package/db_operations.py:17-61).

    The reference uses ChromaDB-over-hnswlib (cosine, M=32, ef=200); the
    port's store is exact (one matmul and top-k on the collection's device,
    ``store/embedding_store.py``), so those parameters are retained only as
    metadata.
    """

    path: str = "db"
    collection_name: str = "newspaper_image_embeddings"
    space: str = "cosine"
    hnsw_m: int = 32  # recorded for parity; store is exact
    hnsw_ef_construction: int = 200
    hnsw_ef: int = 200


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Similarity/clustering settings (reference: deprecated_package/config.py:77-79,
    weighted_region_clustering.py:97-254,452-574)."""

    region_compare_top_n: int = 10
    region_similarity_threshold: float = 0.3
    weight_by_area: bool = True
    cluster_min_k: int = 2
    cluster_max_k: int = 10
    pair_region_limit: int = 10  # first-10-regions budget (ref :199)
    pair_top_k: int = 10  # top-10 matches per pair (ref :207-212)
    pair_accept_threshold: float = 0.1  # distance <= 1 - 0.1 accepted (ref :151,223)
    prefix_skip_fraction: float = 0.2  # same-publication filename prefix skip


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The (data, model) layout of the ranks (``core/mesh.py::make_mesh``):
    the batch over ``data``, tensor parallelism over ``model``."""

    data_axis: str = "data"
    model_axis: str = "model"
    # (-1, 1) → all ranks on the data axis; set model>1 for tensor parallelism
    shape: Tuple[int, int] = (-1, 1)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    orientation: OrientationConfig = dataclasses.field(default_factory=OrientationConfig)
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    edge_filter: EdgeFilterConfig = dataclasses.field(default_factory=EdgeFilterConfig)
    combine: CombineConfig = dataclasses.field(default_factory=CombineConfig)
    median_width: MedianWidthConfig = dataclasses.field(default_factory=MedianWidthConfig)
    columns: ColumnConfig = dataclasses.field(default_factory=ColumnConfig)
    embedder: EmbedderConfig = dataclasses.field(default_factory=EmbedderConfig)
    store: StoreConfig = dataclasses.field(default_factory=StoreConfig)
    analysis: AnalysisConfig = dataclasses.field(default_factory=AnalysisConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # Emit JSON byte-identically to the reference writers (float64 host math).
    bit_exact_json: bool = True

    @classmethod
    def from_json(cls, path: str) -> "PipelineConfig":
        with open(path, "r") as f:
            raw = json.load(f)
        return _dataclass_from_dict(cls, raw)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


def _dataclass_from_dict(cls, raw):
    if not dataclasses.is_dataclass(cls):
        return raw
    # `from __future__ import annotations` stringifies field.type — resolve
    # real types via get_type_hints so nested dataclasses rehydrate.
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    for field in dataclasses.fields(cls):
        if field.name in raw:
            value = raw[field.name]
            ftype = hints.get(field.name, field.type)
            if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
                value = _dataclass_from_dict(ftype, value)
            kwargs[field.name] = value
    return cls(**kwargs)


def hf_token() -> Optional[str]:
    """HF token from env or HF_TOKEN.txt (reference: config.py:36-37)."""
    token = os.environ.get("HF_TOKEN")
    if token:
        return token
    if os.path.exists("HF_TOKEN.txt"):
        with open("HF_TOKEN.txt") as f:
            return f.read().strip()
    return None
