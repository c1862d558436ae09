"""Multi-grid tiling geometry — a verbatim copy of ``GridCell``,
``grid_cells``, ``translate_boxes`` and ``translate_boxes_np`` from
``multimodal_embeddings_tpu/ops/grid.py``, whose package imports JAX.

Reproduces the cell-coordinate float math of ``split_image_into_grid``
(``1_doclayout_bboxes.py:366-444``): cells are ``width/cols`` × ``height/rows``
base tiles extended by ``overlap%`` of the base tile *only on internal edges*,
clamped to the page. Coordinates are float64 (the non-terminating decimals in
the combined goldens, e.g. ``1997.423014...``, come from this division) while
pixel slicing truncates with ``int()``.

Box translation back to page coordinates adds the float cell origin
(``translate_coordinates_to_original``, ``1_doclayout_bboxes.py:484-511``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One tile of a rows×cols overlap grid. ``row``/``col`` are 1-indexed
    (reference naming convention, ``1_doclayout_bboxes.py:440-441``)."""

    x_start: float
    y_start: float
    x_end: float
    y_end: float
    row: int
    col: int

    @property
    def slice_bounds(self) -> tuple[int, int, int, int]:
        """Integer pixel bounds for array slicing (``int()`` truncation,
        reference ``1_doclayout_bboxes.py:424-427``)."""
        return (
            int(self.x_start),
            int(self.y_start),
            int(self.x_end),
            int(self.y_end),
        )

    @property
    def coordinates(self) -> dict:
        """The ``cell_coordinates`` JSON object."""
        return {
            "x_start": self.x_start,
            "y_start": self.y_start,
            "x_end": self.x_end,
            "y_end": self.y_end,
        }


def grid_cells(
    width: int, height: int, rows: int, cols: int, overlap_percentage: float
) -> List[GridCell]:
    """Cell layout for a rows×cols grid with internal-edge overlap."""
    base_w = width / cols
    base_h = height / rows
    overlap_x = base_w * (overlap_percentage / 100)
    overlap_y = base_h * (overlap_percentage / 100)

    cells = []
    for row in range(rows):
        for col in range(cols):
            x_start = col * base_w
            if col > 0:
                x_start -= overlap_x
            y_start = row * base_h
            if row > 0:
                y_start -= overlap_y
            x_end = (col + 1) * base_w
            if col < cols - 1:
                x_end += overlap_x
            y_end = (row + 1) * base_h
            if row < rows - 1:
                y_end += overlap_y

            cells.append(
                GridCell(
                    x_start=max(0, x_start),
                    y_start=max(0, y_start),
                    x_end=min(width, x_end),
                    y_end=min(height, y_end),
                    row=row + 1,
                    col=col + 1,
                )
            )
    return cells


def translate_boxes(boxes, cell: GridCell):
    """Shift cell-local boxes into page coordinates (float64, exact)."""
    out = []
    for box in boxes:
        x_min, y_min, x_max, y_max = box
        out.append(
            [
                x_min + cell.x_start,
                y_min + cell.y_start,
                x_max + cell.x_start,
                y_max + cell.y_start,
            ]
        )
    return out


def translate_boxes_np(boxes: np.ndarray, origins: np.ndarray) -> np.ndarray:
    """Vectorized translation: ``boxes (..., N, 4)`` + per-view origins
    ``(..., 2)`` → page coordinates. Used by the batched TPU detect path where
    all grid views of a page run as one padded batch."""
    offsets = np.concatenate([origins, origins], axis=-1)  # (..., 4) = x,y,x,y
    return boxes + offsets[..., None, :]
