"""Content-hash-cached stage-graph runner.

Port of ``multimodal_embeddings_tpu/pipeline/runner.py`` (``fingerprint``,
``Stage``, ``PipelineRunner._save`` and ``run`` are copies;
``tests/test_torch_pipeline.py`` holds the sources equal). Two differences:
the cache file is ``.mmtpu_torch_pipeline_cache.json``, so that the port
never takes a stage the JAX chain ran in the same folder for up to date;
and the package keeps no ``try``, so an unreadable file is skipped and an
unreadable cache read as empty by ``contextlib.suppress``, with JAX's
results. ``numbered_pipeline_stages`` builds the chain on ``device``, and
stages 0 and 1 keep the device in their config: their outputs depend on it.

The reference resumes work with six independent id-list progress files
(``progress_tracker.py``) that go stale when inputs or parameters change.
This runner supersedes them for the numbered pipeline: each stage declares
its input folders and the config values that affect its output; a stage is
skipped only when the *fingerprint* of those inputs (file names, sizes,
mtimes) and config matches the recorded run and the outputs still exist.
Change a threshold or an input file and exactly the affected suffix of the
graph re-runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.utils.profiling import StageTimer

logger = get_logger("runner")

# the port's own cache file: the JAX chain's is .mmtpu_pipeline_cache.json
CACHE_FILE = ".mmtpu_torch_pipeline_cache.json"


def folder_fingerprint(path: str) -> List:
    """Stable listing of (relpath, size, mtime_ns) for every file under
    ``path`` (empty if missing)."""
    entries = []
    if os.path.isdir(path):
        for root, _, files in os.walk(path):
            for file in sorted(files):
                full = os.path.join(root, file)
                st = None
                with contextlib.suppress(OSError):
                    st = os.stat(full)
                if st is None:
                    continue
                entries.append(
                    (os.path.relpath(full, path), st.st_size, st.st_mtime_ns)
                )
    entries.sort()
    return entries


def fingerprint(inputs: Sequence[str], config: Dict[str, Any]) -> str:
    payload = {
        "inputs": {p: folder_fingerprint(p) for p in inputs},
        "config": config,
    }
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass
class Stage:
    name: str
    run: Callable[[], Any]
    inputs: List[str]
    outputs: List[str]
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)


class PipelineRunner:
    """Runs a linear stage graph with fingerprint-keyed skipping."""

    def __init__(self, cache_path: str = CACHE_FILE):
        self.cache_path = cache_path
        self.timer = StageTimer()
        self._cache: Dict[str, str] = {}
        if os.path.exists(cache_path):
            with contextlib.suppress(Exception):
                with open(cache_path) as f:
                    self._cache = json.load(f)

    def _save(self) -> None:
        tmp = self.cache_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._cache, f, indent=2)
        os.replace(tmp, self.cache_path)

    def run(self, stages: Sequence[Stage], force: bool = False) -> Dict[str, str]:
        """Execute stages in order; returns {stage: 'ran'|'skipped'}."""
        results: Dict[str, str] = {}
        for stage in stages:
            fp = fingerprint(stage.inputs, stage.config)
            outputs_exist = all(os.path.exists(p) for p in stage.outputs)
            if not force and outputs_exist and self._cache.get(stage.name) == fp:
                logger.info("stage %s: up to date, skipping", stage.name)
                results[stage.name] = "skipped"
                continue
            logger.info("stage %s: running", stage.name)
            with self.timer.stage(stage.name):
                stage.run()
            # fingerprint AFTER running so downstream sees produced files
            self._cache[stage.name] = fingerprint(stage.inputs, stage.config)
            self._save()
            results[stage.name] = "ran"
        self.timer.log_summary()
        return results


def numbered_pipeline_stages(
    input_folder: str,
    detector_factory: Optional[Callable] = None,
    sensitivity: float = 0.5,
    edge_threshold: int = 10,
    iou_threshold: float = 0.5,
    min_margin_percent: float = 0.2,
    min_confidence: float = 0.3,
    imgsz: int = 1024,
    variant: str = "m",
    grid_configs: str = "2x2,3x3,4x4",
    require_images: bool = True,
    device="cuda",
) -> List[Stage]:
    """The reference's six-stage chain (run.sh folder names) as a cached
    graph, all in one process; stages 0 and 1 on ``device``."""
    from multimodal_embeddings_tpu_torch.cli.detect import parse_grid_configs
    from multimodal_embeddings_tpu_torch.config import DetectorConfig
    from multimodal_embeddings_tpu_torch.io.images import get_image_paths
    from multimodal_embeddings_tpu_torch.pipeline import (
        run_columns_stage,
        run_combine_stage,
        run_edge_filter_stage,
        run_median_stage,
    )
    from multimodal_embeddings_tpu_torch.pipeline.detect import run_detect_stage
    from multimodal_embeddings_tpu_torch.pipeline.orientation import (
        batch_correct_orientation,
    )

    def stage0():
        paths = get_image_paths(input_folder)
        batch_correct_orientation(
            paths, "0_oriented_images", sensitivity_threshold=sensitivity, device=device
        )

    def stage1():
        config = DetectorConfig(
            image_size=imgsz,
            variant=variant,
            grid_configs=parse_grid_configs(grid_configs),
        )
        detector = detector_factory() if detector_factory else None
        run_detect_stage(
            "0_oriented_images",
            "1_doclayout_parsed",
            config=config,
            detector=detector,
            device=device,
        )

    return [
        Stage(
            "orientation",
            stage0,
            inputs=[input_folder],
            outputs=["0_oriented_images"],
            config={"sensitivity": sensitivity, "device": str(device)},
        ),
        Stage(
            "detect",
            stage1,
            inputs=["0_oriented_images"],
            outputs=["1_doclayout_parsed"],
            config={
                "imgsz": imgsz,
                "variant": variant,
                "grids": grid_configs,
                "device": str(device),
            },
        ),
        Stage(
            "edge_filter",
            lambda: run_edge_filter_stage(
                "1_doclayout_parsed", "2_edge_box_filtered", threshold=edge_threshold
            ),
            inputs=["1_doclayout_parsed"],
            outputs=["2_edge_box_filtered"],
            config={"threshold": edge_threshold},
        ),
        Stage(
            "combine",
            lambda: run_combine_stage(
                "2_edge_box_filtered", "3_combined_bboxes", iou_threshold=iou_threshold
            ),
            inputs=["2_edge_box_filtered"],
            outputs=["3_combined_bboxes"],
            config={"iou": iou_threshold},
        ),
        Stage(
            "medians",
            lambda: run_median_stage(
                "3_combined_bboxes",
                "4_medians_extracted",
                min_margin_percent=min_margin_percent,
                require_image=require_images,
            ),
            inputs=["3_combined_bboxes"],
            outputs=["4_medians_extracted"],
            config={"margin": min_margin_percent},
        ),
        Stage(
            "columns",
            lambda: run_columns_stage(
                "3_combined_bboxes",
                "4_medians_extracted",
                "5_column_detection",
                min_confidence=min_confidence,
            ),
            inputs=["3_combined_bboxes", "4_medians_extracted"],
            outputs=["5_column_detection"],
            config={"min_confidence": min_confidence},
        ),
    ]
