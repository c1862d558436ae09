"""A run with its timed path broken underneath comes out not correct: the
harness is driven whole at a tiny size on the CPU (its look for a card
skipped), once sound and once with an answer or a token altered where the
program produces it. The control, the reference at float8 put in the
program's place, reads above the program at the tiny size too; at the
cell's own size it is run on the card (``-m card``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from benchlib.cells import HERE, ROOT


def run_cell(cell, capsys, trace=0, seed=11):
    import run

    rc = run.main(["--workload", cell.name, "--seed", str(seed), "--seconds", "1",
                   "--trace", str(trace)], device="cpu", cell=cell)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def broken_page(monkeypatch, alter):
    from drivers import page

    build = page.build_program

    def faulty(*args, **kwargs):
        fn, models = build(*args, **kwargs)

        def wrapped(x):
            return alter(fn(x))

        wrapped.detect, wrapped.embed = fn.detect, fn.embed
        return wrapped, models

    monkeypatch.setattr(page, "build_program", faulty)


def test_page_run_sound_is_correct(capsys):
    out = run_cell(tiny.tiny_cell(), capsys)
    assert out["correct"] and list(out)[-1] == "checks" and out["attempted"] > 0


@pytest.mark.parametrize("fault", ["embedding", "box", "score", "half_valid"])
def test_page_answer_altered_is_not_correct(fault, capsys, monkeypatch):
    def alter(r):
        if fault == "half_valid":  # half of the regions left out
            valid = r.valid.clone()
            valid[valid.shape[0] // 2:] = False
            return r._replace(valid=valid)
        if fault == "embedding":
            e = r.embeddings.clone()
            e[0] = torch.roll(e[0], 1)
            return r._replace(embeddings=e)
        if fault == "box":
            return r._replace(boxes=r.boxes + torch.tensor([6.0, 0.0, 6.0, 0.0]))
        return r._replace(scores=(r.scores - 0.5).clamp_min(0.0))

    broken_page(monkeypatch, alter)
    out = run_cell(tiny.tiny_cell(), capsys)
    assert not out["correct"], out["checks"]


def test_page_nms_skipped_is_not_correct(capsys, monkeypatch):
    """The cross-view NMS skipped: the strongest candidates kept as they
    are, duplicates across views and all."""
    from multimodal_embeddings_tpu_torch.pipeline import fused

    def no_nms(boxes, scores, classes, valid, iou_threshold=0.45, class_aware=False):
        order = torch.sort(scores, descending=True, stable=True)[1]
        return valid[order], order

    monkeypatch.setattr(fused, "nms_padded", no_nms)
    # at the tiny size most boxes cross a cell's edge, and four regions are
    # too few to hold two views of one box
    cell = tiny.tiny_cell()
    cell.config["detector"]["edge_filter"] = False
    cell.config["regions"] = 8
    cell.workload["check_pages"] = 50
    out = run_cell(cell, capsys)
    assert not out["correct"], out["checks"]
    assert out["checks"]["dup_pairs"]["value"] > 0, out["checks"]


def plant_parse_fault(monkeypatch, model, fault):
    """Plants ``fault`` in the parse program's built ``model``: the vision
    tower's output zeroed; each decode step's cache writes lost (the step
    returns the state it was given); or, at every splice, the new page's
    caches swapped with the next row's. Returns a function that takes it
    out again."""
    from multimodal_embeddings_tpu_torch.models import qwen_serve

    if fault == "vision_zeroed":
        return model.vision.register_forward_hook(lambda m, a, out: torch.zeros_like(out)).remove
    if fault == "state_unchanged":
        step = model.decode_step

        def frozen(token_ids, caches, position, mrope_delta=None):
            scratch = [(k.clone(), v.clone()) for k, v in caches]
            return step(token_ids, scratch, position, mrope_delta)[0], caches

        model.decode_step = frozen
        return lambda: model.__dict__.pop("decode_step")
    assert fault == "cache_swapped"
    build = qwen_serve.build_continuous_fns

    def swapping(model, batch, *args, **kwargs):
        fns = list(build(model, batch, *args, **kwargs))
        splice = fns[1]

        def splice_row(state, row, *rest):
            state, first = splice(state, row, *rest)
            other = (row + 1) % batch
            with torch.inference_mode():
                for k, v in state["caches"]:
                    k[[row, other]] = k[[other, row]]
                    v[[row, other]] = v[[other, row]]
            return state, first

        fns[1] = splice_row
        return tuple(fns)

    monkeypatch.setattr(qwen_serve, "build_continuous_fns", swapping)
    return lambda: monkeypatch.setattr(qwen_serve, "build_continuous_fns", build)


def broken_parse(monkeypatch, fault):
    from drivers import parse

    build = parse.build_program

    def faulty(*args, **kwargs):
        model = build(*args, **kwargs)
        plant_parse_fault(monkeypatch, model, fault)
        return model

    monkeypatch.setattr(parse, "build_program", faulty)


def test_parse_run_sound_is_correct(capsys):
    assert run_cell(tiny.tiny_cell("qwen25vl_32b_int4.parse_short"), capsys)["correct"]


@pytest.mark.parametrize("fault", ["token", "half_left_out", "vision_zeroed",
                                   "state_unchanged", "cache_swapped"])
def test_parse_fault_is_not_correct(fault, capsys, monkeypatch):
    """At the cell's own limits: a served token altered where the decoder
    hands it out, half of the pages never returned, the vision tower's
    output zeroed, a decode step that leaves its state unchanged, and each
    new page's caches swapped with another row's."""
    from multimodal_embeddings_tpu_torch.models import qwen_serve

    cell = tiny.tiny_cell("qwen25vl_32b_int4.parse_short")
    if fault in ("vision_zeroed", "state_unchanged", "cache_swapped"):
        broken_parse(monkeypatch, fault)
    else:
        generate = qwen_serve.continuous_generate

        def altered(*args, **kwargs):
            outs = generate(*args, **kwargs)
            if fault == "half_left_out":
                return [o if i % 2 else None for i, o in enumerate(outs)]
            for o in outs:  # every page's second token, where the decoder emits it
                o[1] = (o[1] + 1) % cell.config["text"]["vocab_size"]
            return outs

        monkeypatch.setattr(qwen_serve, "continuous_generate", altered)
    out = run_cell(cell, capsys)
    assert not out["correct"], out["checks"]


def shared_round_cell():
    """The parse cell at the tiny size with 24 pages drawn from 4 over 4
    rows: on seed 346182297 a page's image recurs with a shorter stop in an
    admission step where a row of another page feeds the same tokens."""
    cell = tiny.tiny_cell("qwen25vl_32b_int4.parse_short")
    cell.traffic = dict(cell.traffic, queue_len=24, pool=4)
    cell.workload = dict(cell.workload, rows=4, check_pages=6)
    return cell


@pytest.mark.parametrize("fault", [None, "cache_swapped"])
def test_parse_splice_check_tells_rows_admitted_together_apart(fault, capsys, monkeypatch):
    """Rows admitted in one step that feed the same tokens are told apart
    by the cache they hold: the sound program reads no splice mismatch,
    and each new page's caches swapped with another row's read one."""
    if fault:
        broken_parse(monkeypatch, fault)
    out = run_cell(shared_round_cell(), capsys, seed=346182297)
    assert out["correct"] == (fault is None), out["checks"]
    assert (out["checks"]["splice_mismatch"]["value"] > 0) == bool(fault), out["checks"]


def test_traced_runs_report_the_per_layer_metrics(capsys):
    out = run_cell(tiny.tiny_cell("qwen25vl_32b_int4.parse_short"), capsys, trace=1)
    assert {"step_ms.parse", "splice_ms.parse", "mfu_pct.parse"} <= set(out["metrics"])
    assert "breakdown" in out and "busy_s" in out["device"]


@pytest.mark.parametrize("name", ["vitb16_doclayout_m.stream", "qwen25vl_32b_int4.parse_short"])
def test_control_reads_above_the_program(name):
    import control

    rows = [control.readings(tiny.tiny_cell(name), s, 2, device="cpu") for s in (3, 4, 5)]
    key = "embed_1mcos" if "stream" in name else "logit_gap"
    assert max(r["control"][key] for r in rows) > 10 * max(r["program"][key] for r in rows) \
        or max(r["program"][key] for r in rows) == 0 < max(r["control"][key] for r in rows)


def test_no_card_no_result(tmp_path):
    """Without a card, or in a directory holding only BENCHMARK.json and the
    benchmark's files, a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("_cache"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "vitb16_doclayout_m.stream", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.card
@pytest.mark.parametrize("name", ["vitb16_doclayout_m.stream", "qwen25vl_32b_int4.parse_short"])
def test_control_fails_at_the_cells_size(card, name):
    """On three seeds at the cell's own size, the program's readings keep
    within every limit and the control's break at least one."""
    import control
    from benchlib.cells import load_cell

    cell = load_cell(name)
    limits = cell.workload["limits"]
    pages = cell.workload.get("control_queue", cell.workload["check_pages"])
    for seed in (7001, 7002, 7003):
        r = control.readings(cell, seed, pages, device=card)
        assert all(r["program"][k] <= v for k, v in limits.items()), r
        assert any(r["control"][k] > v for k, v in limits.items() if k in r["control"]), r


def fault_readings(cell, device, faults, monkeypatch):
    """One session of the parse cell; for each fault (None: sound) a
    recorded call over the queue's first ``control_queue`` pages, judged as
    a run judges its sample. Yields (fault, readings, limits broken)."""
    from drivers import parse

    limits = cell.workload["limits"]
    session = parse.Session(cell, 7101, device)
    session.setup()
    for fault in faults:
        undo = plant_parse_fault(monkeypatch, session.model, fault) if fault else None
        session.recorded_call(cell.workload["control_queue"])
        if undo:
            undo()
        r = session.judge(session.sample())
        yield fault, r, [k for k, v in limits.items() if r[k] > v]


def test_parse_faults_in_one_session(monkeypatch):
    """The card test's loop at the tiny size: faults planted and taken out
    again between recorded calls of one session."""
    cell = tiny.tiny_cell("qwen25vl_32b_int4.parse_short")
    for fault, r, broken in fault_readings(cell, "cpu", (None, "vision_zeroed", "state_unchanged",
                                                         "cache_swapped", None), monkeypatch):
        assert bool(broken) == bool(fault), (fault, broken, r)


@pytest.mark.card
def test_parse_faults_at_the_cells_size(card, monkeypatch):
    """At the cell's own size and rows: the sound program keeps within
    every limit, and each planted fault breaks at least one. Prints each
    reading as a JSON line."""
    from benchlib.cells import load_cell

    cell = load_cell("qwen25vl_32b_int4.parse_short")
    for fault, r, broken in fault_readings(cell, card, (None, "vision_zeroed", "state_unchanged",
                                                        "cache_swapped"), monkeypatch):
        print(json.dumps({"fault": fault, "broken": broken, **r}), flush=True)
        assert bool(broken) == bool(fault), (fault, broken, r)
