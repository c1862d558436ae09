"""The page program's driver: the serving CLI's path for one page
(``pipeline/fused.py::build_fused_page_fn``, letterboxed views, the top
``regions`` crops embedded in one call), fed as ``cli/serve.py`` feeds it.

Set-up draws the detector's and the ViT tower's weights on the card from the
seed, fits the detector's class head on one page with the plain reference
(a random head ties every score near 0.5), hands both sides the same state,
builds the program and runs the cell's own shapes once. The window is a
closed loop of one client: each page is padded into its shape bucket on the
host, uploaded, and dispatched before the previous page's results are
fetched to the host. The check runs the plain reference in float32 over a
sample of the window's pages drawn from the seed and judges the program's
boxes, scores, classes and region embeddings.
"""

from __future__ import annotations

import math
import os
import tempfile
import time

import numpy as np
import torch

from benchlib.common import (Clock, RunResult, count_flops, fill_from_seed, init_stds,
                             quantile, span)
from benchlib.roofline import attention_work, bound_s
from benchlib.trace import from_profiler
from reference import page_ref as ref

CONV_BN_GAIN = 1.0 / math.sqrt(1.0 + 1e-3)  # LeCun gain of a conv with folded BatchNorm
# a pair of live regions of one class overlapping by more than the cross-view
# NMS's IoU by this much is a duplicate: the program's own IoU of the same
# boxes may differ from this one in the last bits
DUP_MARGIN = 1e-3


def ref_cfg(config: dict) -> dict:
    d = config["detector"]
    return {"imgsz": d["imgsz"], "grids": [tuple(g) for g in d["grids"]],
            "overlap": d["overlap"], "max_det": d["max_det"], "conf": d["conf"],
            "view_iou": d["view_iou"], "combine_iou": d["combine_iou"], "cap": d["cap"],
            "edge_filter": d["edge_filter"], "regions": config["regions"]}


def reference_models(config: dict, device):
    """The plain reference's detector and ViT tower, parameters uninitialised
    on ``device`` in float32."""
    d, v = config["detector"], config["vision"]
    with torch.device("meta"):
        det = ref.DocLayoutYOLO(d["num_classes"], d["variant"])
        vit = ref.ViTower(v["image_size"], v["patch_size"], v["width"], v["layers"],
                          v["heads"], v["mlp_ratio"], config["embed_dim"])
    return det.to_empty(device=device).eval(), vit.to_empty(device=device).eval()


def draw_weights(det, vit, seed: int, device) -> None:
    """Both towers' weights from the seed, on the device: convolutions
    LeCun-normal (folded BatchNorm at its initial statistics), matrices and
    positions N(0, 0.02), biases 0, norm scales 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    det_leaves = init_stds(det, lambda name: CONV_BN_GAIN if name.endswith(".conv") else 1.0)
    fill_from_seed(det_leaves + init_stds(vit), gen, device)


@torch.no_grad()
def fit_class_head(det, page: torch.Tensor, cfg: dict, fit: dict, n_views: int = 0,
                   chunk: int = 6) -> None:
    """Refits the class head's output convs on ``page``'s first ``n_views``
    views (0: all) with the reference: each level's rows lose their
    component along the mean of the conv's input over the views; then class
    ``c``'s logits over all anchors are scaled to a spread of
    ``logit_std`` and shifted so that its k-th best anchor (k =
    ``view_boxes[c]`` per view) lands on the confidence threshold; a class
    left out scores no box. The fitted head is a weight handed to both
    sides, so the fit may run in TF32."""
    views, _, _ = ref.views_and_affine(page, cfg)
    views = views[:n_views] if n_views else views
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        _fit(det, views, cfg, fit, chunk)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _fit(det, views, cfg, fit, chunk):
    head = det.head
    convs = [getattr(head, f"cls{i}_out") for i in range(head.levels)]
    sums = {i: 0.0 for i in range(len(convs))}
    counts = {i: 0 for i in range(len(convs))}

    def hook(i):
        def record(module, args, out):
            x = args[0].float()
            sums[i] = sums[i] + x.sum((0, 2, 3))
            counts[i] += x.shape[0] * x.shape[2] * x.shape[3]
        return record

    hooks = [c.register_forward_hook(hook(i)) for i, c in enumerate(convs)]
    for i in range(0, views.shape[0], chunk):
        det(views[i:i + chunk])
    for h in hooks:
        h.remove()
    for i, conv in enumerate(convs):
        w, m = conv.weight[:, :, 0, 0], sums[i] / counts[i]
        conv.weight.copy_((w - torch.outer(w @ m, m) / (m @ m))[:, :, None, None])
        conv.bias.zero_()
    z = torch.cat([torch.cat([c.flatten(1, 2) for _, c in det(views[i:i + chunk])], 1)
                   for i in range(0, views.shape[0], chunk)]).float()
    low = math.log(cfg["conf"] / (1 - cfg["conf"]))
    for c in range(z.shape[-1]):
        k = fit["view_boxes"].get(str(c), 0) * views.shape[0]
        if k:
            zc = z[..., c].flatten()
            a = fit["logit_std"] / zc.std().item()
            b = low - a * zc.topk(k).values[-1].item()
        else:
            a, b = 0.0, 2 * low
        for conv in convs:
            conv.weight[c] *= a
            conv.bias[c] = b


def build_program(config: dict, workload: dict, device, det_state, vit_state):
    """The program's page function at the cell's bucket, its detector and
    ViT tower holding the benchmark's weights."""
    from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.vision_encoder import (DualEncoderConfig,
                                                                       TextConfig,
                                                                       VisionConfig)
    from multimodal_embeddings_tpu_torch.pipeline.fused import build_fused_page_fn

    d, v, t = config["detector"], config["vision"], config["text"]
    dtype = getattr(torch, config["dtype"])
    detector = LayoutDetector(
        DetectorConfig(image_size=d["imgsz"], variant=d["variant"], glcrm=d["glcrm"],
                       grid_configs=tuple(tuple(g) for g in d["grids"]),
                       overlap_percentage=d["overlap"], conf_threshold=d["conf"],
                       iou_threshold=d["view_iou"], max_detections=d["max_det"]),
        num_classes=d["num_classes"], dtype=dtype, device=device)
    model_config = DualEncoderConfig(
        vision=VisionConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                            width=v["width"], layers=v["layers"], heads=v["heads"],
                            mlp_ratio=v["mlp_ratio"]),
        text=TextConfig(vocab_size=t["vocab_size"], max_len=t["max_len"], width=t["width"],
                        layers=t["layers"], heads=t["heads"], mlp_ratio=t["mlp_ratio"]),
        embed_dim=config["embed_dim"])
    embedder = MultimodalEmbedder(EmbedderConfig(family="siglip", dtype=config["dtype"],
                                                 image_size=v["image_size"],
                                                 embed_dim=config["embed_dim"]),
                                  model_config=model_config, device=device)
    with torch.no_grad():
        detector.model.load_state_dict(det_state)
        embedder.model.vision.load_state_dict(vit_state)
    fn = build_fused_page_fn(detector, embedder, tuple(workload["bucket"]),
                             num_regions=config["regions"], letterbox=d["letterbox"],
                             edge_filter=d["edge_filter"])
    return fn, (detector, embedder)


def pad_to(page: np.ndarray, bucket) -> np.ndarray:
    """The page padded (bottom and right, zeros) into its shape bucket, as
    the serving CLI's ``_prepare`` does."""
    out = np.zeros((*bucket, 3), np.uint8)
    out[: page.shape[0], : page.shape[1]] = page
    return out


def fetch(result):
    """The page's results on the host, as the serving CLI's ``_finalize``
    fetches them."""
    return (result.boxes.cpu(), result.scores.cpu(), result.classes.cpu(),
            result.valid.cpu(), result.embeddings.cpu())


class Session:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.cfg = ref_cfg(cell.config)
        self.program = None

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        config, workload = self.cell.config, self.cell.workload
        clock = Clock(self.sync)
        self.pages = self.cell.generator().make(self.cell.traffic, self.seed)
        self.padded = [pad_to(p, workload["bucket"]) for p in self.pages.pool]
        clock("pages")
        self.ref_det, self.ref_vit = reference_models(config, self.device)
        draw_weights(self.ref_det, self.ref_vit, self.seed, self.device)
        clock("weights")
        page0 = torch.from_numpy(self.padded[0]).to(self.device)
        fit_class_head(self.ref_det, page0, self.cfg, config["head_fit"],
                       config["head_fit"].get("views", 0))
        clock("head_fit")
        self.program, self.models = build_program(
            config, workload, self.device, self.ref_det.state_dict(), self.ref_vit.state_dict())
        clock("program")
        for i in range(workload.get("warmup_pages", 2)):
            fetch(self.program(torch.from_numpy(self.padded[i]).to(self.device)))
            clock(f"warmup{i}")
        self.setup_notes = clock.notes

    def page_flops(self) -> dict:
        """Operations of one page over the reference's shapes: the detector
        at one view times the views, the tower at one crop times the
        regions, counted on the meta device."""
        d, v = self.cell.config["detector"], self.cell.config["vision"]
        det, vit = reference_models(self.cell.config, "meta")
        n_views = len(ref.grid_bounds(100, 100, self.cfg["grids"], self.cfg["overlap"]))
        det_flops = count_flops(det, torch.empty(1, d["imgsz"], d["imgsz"], 3, device="meta"))
        vit_flops = count_flops(vit, torch.empty(1, v["image_size"], v["image_size"], 3,
                                                 device="meta"))
        tokens = (v["image_size"] // v["patch_size"]) ** 2
        head = v["width"] // v["heads"]
        vit_k1 = attention_work(self.cfg["regions"], v["heads"], tokens, tokens, head, head)
        psa, side = det.backbone.psa.attn, d["imgsz"] // 32
        psa_k1 = attention_work(n_views, psa.nh, side * side, side * side, psa.kd, psa.hd)
        return {"flops_per_page": det_flops * n_views + vit_flops * self.cfg["regions"],
                "views": n_views,
                "k1_bound_s_per_page": v["layers"] * bound_s(*vit_k1) + bound_s(*psa_k1)}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the window -----------------------------------------------------

    def run(self, seconds: float, trace: bool) -> RunResult:
        from multimodal_embeddings_tpu_torch.pipeline.fused import PageResult

        res = RunResult()
        fn, dev = self.program, self.device
        cuda = dev.type == "cuda"
        trace_from = self.cell.workload.get("trace_skip", 2)
        trace_to = trace_from + self.cell.workload.get("trace_pages", 8)
        events, prof = [], None
        self.done = []  # (pool index, fetched results)
        lat = []
        pending = None
        i = 0
        t0 = time.perf_counter()
        while True:
            if trace and i in (trace_from, trace_to):
                if pending is not None:
                    self._complete(pending, lat)
                    pending = None
                self.sync()
                if i == trace_from:
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if cuda:
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=acts)
                    prof.start()
                    t_prof = time.perf_counter()
                else:
                    prof.stop()
                    res.work["pages_traced"] = trace_to - trace_from
                    res.work["traced_s"] = time.perf_counter() - t_prof
            if time.perf_counter() - t0 >= seconds and (not trace or i > trace_to):
                break
            idx = int(self.pages.order[i % len(self.pages.order)])
            tracing = prof is not None and trace_from <= i < trace_to
            t_dispatch = time.perf_counter()
            with span("page.upload", tracing):
                page = torch.from_numpy(self.padded[idx]).to(dev)
            if trace:
                with span("page.detect", tracing):
                    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else []
                    e and e[0].record()
                    boxes, scores, classes, valid, crops = fn.detect(page)
                    e and e[1].record()
                with span("page.embed", tracing):
                    emb = fn.embed(crops)
                    e and e[2].record()
                events.append(e)
                result = PageResult(boxes, scores, classes, valid, emb)
            else:
                result = fn(page)
            if pending is not None:
                with span("page.fetch", tracing):
                    self._complete(pending, lat)
            pending = (idx, t_dispatch, result)
            i += 1
        if pending is not None:
            self._complete(pending, lat)
        wall = time.perf_counter() - t0
        self.sync()
        res.work.update(self.page_flops())
        res.attempted = i
        res.failed = i - len(self.done)
        res.end_to_end = {"pages_per_s": len(self.done) / wall,
                          "page_ms_p95": quantile(lat, 0.95) * 1e3}
        res.notes = {**self.setup_notes, "pages": len(self.done), "window_s": wall,
                     "page_ms_p50": quantile(lat, 0.5) * 1e3}
        if trace:
            if cuda:
                res.spans = {"detect_ms": [a.elapsed_time(b) for a, b, _ in events],
                             "embed_ms": [b.elapsed_time(c) for _, b, c in events]}
            res.trace = from_profiler(prof, os.path.join(tempfile.gettempdir(),
                                                         "perfbench_traces", self.cell.name))
        return res

    def _complete(self, pending, lat) -> None:
        idx, t_dispatch, result = pending
        out = fetch(result)
        lat.append(time.perf_counter() - t_dispatch)
        self.done.append((idx, out))

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        self.program = self.models = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------

    def sample(self):
        n = min(self.cell.workload["check_pages"], len(self.done))
        rng = np.random.default_rng([self.seed, 2])
        return [self.done[j] for j in sorted(rng.choice(len(self.done), n, replace=False))]

    def check(self):
        readings = [self.judge(idx, out) for idx, out in self.sample()]
        limits = self.cell.workload["limits"]
        self.check_notes = {f"reading.{k}": max(r[k] for r in readings)
                            for k in readings[0] if k not in limits}
        return [(name, max(r[name] for r in readings), limits[name]) for name in limits]

    @torch.no_grad()
    def reference_candidates(self, page):
        return ref.detect_candidates(self.ref_det, page, self.cfg)

    @torch.no_grad()
    def judge(self, idx: int, out) -> dict:
        """The program's answers for pool page ``idx`` against the
        reference's: every live region's box must be an anchor the reference
        finds (same class; ``box_1miou`` = 1 − its best IoU), with its score
        (``score_gap``), and its embedding the reference tower's of the same
        box (``embed_1mcos``); ``select_miss`` is the share of the
        reference's own selection that the program's misses (IoU < 0.5 or
        another class). Exact: ``live_count_gap``, the program's live
        regions against the size of the reference's own selection, and
        ``dup_pairs``, pairs of live regions of one class that the
        class-aware cross-view NMS would have merged."""
        page = torch.from_numpy(self.padded[idx]).to(self.device)
        boxes, scores, classes, valid, emb = (x.to(self.device) for x in out)
        cand_b, cand_s, cand_c, bounds = self.reference_candidates(page)
        sel_b, sel_s, sel_c = ref.select_regions(cand_b, cand_s, cand_c, bounds,
                                                 page.shape[:2], self.cfg)
        cand_b, cand_s, cand_c = cand_b.reshape(-1, 4), cand_s.reshape(-1), cand_c.reshape(-1)
        live = valid.nonzero().flatten()
        box_gap, score_gap = 0.0, 0.0
        for j in live.tolist():
            same = (cand_c == classes[j].long()).nonzero().flatten()
            if len(same) == 0:
                box_gap, score_gap = 1.0, 1.0
                continue
            ious = ref.iou(boxes[j:j + 1].float(), cand_b[same])[0]
            best = float(ious.max())
            box_gap = max(box_gap, 1.0 - best)
            # anchors of one box (to 0.01 of the best IoU) may differ in score
            near = same[ious >= best - 0.01]
            score_gap = max(score_gap, float((cand_s[near] - scores[j]).abs().min()))
        crops = ref.crop_resize(page, boxes[live].float(), self.cell.config["vision"]["image_size"])
        ref_emb = torch.cat([self.ref_vit(c / 255.0) for c in crops.split(16)])
        cos = (ref_emb * emb[live].float()).sum(-1)
        miss = 1.0
        if len(sel_b):
            ious = ref.iou(sel_b, boxes[live].float())
            hit = (ious >= 0.5) & (sel_c[:, None].long() == classes[live][None, :].long())
            miss = 1.0 - float(hit.any(1).float().mean())
        n_live = len(live)
        live_b, live_c = boxes[live].float(), classes[live].long()
        over = ref.iou(live_b, live_b) > self.cfg["combine_iou"] + DUP_MARGIN
        dup = int((over & (live_c[:, None] == live_c[None, :])).triu(1).sum())
        return {"embed_1mcos": float((1 - cos).max()) if n_live else 1.0,
                "box_1miou": box_gap if n_live else 1.0,
                "score_gap": score_gap if n_live else 1.0,
                "select_miss": miss,
                "live_count_gap": float(abs(n_live - len(sel_b))),
                "dup_pairs": float(dup)}

    # -- the control ----------------------------------------------------

    @torch.no_grad()
    def control_outputs(self, idx: int):
        """The reference in the program's place at float8 e4m3: the page's
        selection and region embeddings, as the program would return
        them."""
        ref.set_precision("fp8")
        try:
            page = torch.from_numpy(self.padded[idx]).to(self.device)
            cand_b, cand_s, cand_c, bounds = ref.detect_candidates(self.ref_det, page, self.cfg)
            b, s, c = ref.select_regions(cand_b, cand_s, cand_c, bounds, page.shape[:2],
                                         self.cfg)
            k = self.cfg["regions"]
            crops = ref.crop_resize(page, b, self.cell.config["vision"]["image_size"])
            e = torch.cat([self.ref_vit(x / 255.0) for x in crops.split(16)])
        finally:
            ref.set_precision("float32")
        pad = k - len(b)
        valid = torch.arange(k, device=b.device) < len(b)
        return (torch.cat([b, b.new_zeros(pad, 4)]), torch.cat([s, s.new_zeros(pad)]),
                torch.cat([c, c.new_zeros(pad)]).int(), valid,
                torch.cat([e, e.new_zeros(pad, e.shape[1])]))

    def control_readings(self, n: int) -> dict:
        """The program's numbers and the control's on the first ``n`` pages
        of the seed's order, each the largest over the pages."""
        picks = [int(i) for i in self.pages.order[:n]]
        program = [self.judge(i, self.program_outputs(i)) for i in picks]
        self.release()
        control = [self.judge(i, self.control_outputs(i)) for i in picks]
        return {side: {k: max(r[k] for r in rs) for k in rs[0]}
                for side, rs in (("program", program), ("control", control))}

    def program_outputs(self, idx: int):
        """The program's answers for pool page ``idx`` (outside a window)."""
        return fetch(self.program(torch.from_numpy(self.padded[idx]).to(self.device)))
