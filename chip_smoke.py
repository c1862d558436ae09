#!/usr/bin/env python3
"""Drive the PyTorch port's page programs once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: name and power limit (``nvidia-smi``), torch and CUDA
   versions; both TF32 flags are set off and printed;
2. the build: the encoder-attention kernel (K1), the int8 weight matmul
   (K2), the int4 weight matmul (K3), flash attention (K4), the 3×3 conv
   (K5), the fused LayerNorm→matmul (K6), the LayerNorm statistics (K7)
   and stochastic-rounding quantization (K8), each compiled by its own
   ``nvcc`` for ``sm_90a`` from ``multimodal_embeddings_tpu_torch/csrc``,
   all started together; each kernel's registers, stack and spills as
   ``ptxas`` reports them. K4's ``nvcc`` takes the longest, so the run
   waits for the others only and runs phases 4 to 8d, which do not call
   K4, while it builds; phases 3, 3a and 6 follow phase 8d. Every phase's
   header carries the seconds since the start;
3. K1 against its plain PyTorch version at the ViT page's shapes — ViT
   ``(48, 784, 768)`` H=12 in bf16 and f32, PSA ``(30, 1024, 576)``
   4×(36|36|72) in bf16 — errors against stated tolerances, the median
   time of each, of ``scaled_dot_product_attention`` on the same inputs (a
   yardstick the port never calls), of K4 (v1) on the same inputs beside
   the bf16 ViT shape, and the bound; edge shapes in bf16 and f32 (L = 1,
   17, 77, 130; D = 40 / DV = 56 as column slices of wider rows; packed
   kd = 20 / dv = 24 and kd = 19, whose k is only 8- or 2-byte aligned;
   DV = 128 at D = 64 and 128);
3a. the last four ports against their plain versions, bf16 with one f32
   shape each and ragged edges, with median times, bounds and library
   yardsticks: K1's BHLD form (``(48, 12, 784, 64)`` permuted views of the
   ViT projections, the PSA probe's ``(30, 4, 1024, 64|128)``, bf16 and
   f32 edges); K4 on its
   K/V-resident schedule (``flash_attention_v2``) at the attention
   candidates' shapes ``(48, 784, 12, 64)``, ``(8, 1608, 16, 80)`` with
   1601 valid keys and ``(2, 6432, 16, 80)`` with 6404, the causal GQA
   ``(1, 2560, 40/8, 128)`` and K4's edge cases, K4 (v1) timed beside it
   and every v2 output EQUAL to v1's on the same inputs, bit for bit;
   K5's stride-2 form (``conv3x3_s2_nchw``) at the detector's stride-2
   positions at variant m (``(30, 3, 1024²)``→48 on the ``cp.async`` path,
   ``(30, 48, 512²)``→96 and ``(30, 96, 256²)``→192 on clusters of 2 and
   4), one f32 shape and ragged edges (H = W = 2; C = 3 and 20), each bf16
   launch's plan printed; K8 (``stochastic_round_quantize``)
   on the mmE5-11B gate/up weight ``(4096, 14336)`` f32, the Qwen-32B gate
   ``(5120, 27648)`` bf16 and a rank-3 ``(4096, 32, 128)``, its int8
   values EQUAL to the plain version's on the same draws;
4. the full-width ViT page: DocLayout-YOLO-m with GL-CRM over 30 views at
   1024 px and a ViT-B/16 at 448 over the top 48 regions, bf16, random
   weights from seed 0, on 3 synthetic 2200×1700 pages after one warm-up
   page; output shapes, finiteness, unit-norm embeddings, and K1's launch
   counts (12 per embed call, 1 per detect call);
5. the card against the CPU for the ViT: two of the page's crops embedded
   by the same tower in f32 on the CPU, cosine ≥ 0.999;
4a. K5, K6, K7 and K1's BLHD wrapper against their plain versions at the
   kernel-route page's and tower's shapes (K5 (30, 48, 256²) and
   (30, 96, 128²) at dilations 2 and 1; K6 (37632, 768)×(768, 2304 | 3072)
   and (12864, 1280)×(1280, 5120); K7 (48, 784, 768) and (8, 1608, 1280);
   BLHD (48, 784, 12, 64) off a strided qkv slab), bf16, one f32 shape each
   and ragged edge shapes (K1-BLHD's in bf16 and f32); errors against
   stated tolerances, median times, bounds and library yardsticks. K5's
   edges reach every form its plan chooses, in bf16 and f32 (H and W off
   the tile, H = W = 1 at d = 2, clusters of 3 and of 5 in two groups at
   Cout 100 and 440, channel chunks at C = 192, polyphase tiles at d = 24,
   the ``cp.async`` path at C = 20 and on an x 2 bytes off alignment);
   each bf16 launch's plan (path, tile, phase, cluster, groups, chunks,
   stages, shared bytes, grid) is printed; K5's sum over the page's 12
   launches must not exceed ``F.conv2d`` + ``F.silu``'s. K6: every case's
   form (wgmma, mma.sync, f32) held to the launcher's, the three path
   shapes on the wgmma form and equal bit for bit twice, with the device
   time per call of 20 calls back to back beside each median; the wgmma
   form's edges (M = 1, 63, 129, 300; N = 48, 200, 1040; K = 136, 1280,
   3000; runs that start mid row block; more units than CTAs), each plan
   printed; ``ptxas`` registers and spills (none in the wgmma form) and
   the ``HGMMA`` (> 0) and ``I2F``/``I2FP`` (0) counts from ``cuobjdump
   -sass``. K7: the path shapes equal bit for bit twice, each timed as the
   device time per call back to back over copies larger than the L2 (the
   figure held against the bound), back to back on one x, and as a median
   of single launches, and ``torch.var_mean`` the same ways; edges (rows not
   a multiple of a block, one block, the Qwen vision shape, an x one
   element off alignment, D = 12, rows of 8 to 64 KB), each twice; registers
   and spills (none) from ``ptxas``, or from ``cuobjdump -res-usage`` when
   the library was built earlier;
4b. the ViT page on the kernel routes: the same detector and ViT weights
   (seed 0) with ``DetectorConfig(pallas_convs=96, pallas_mode="stage")``,
   ``VisionConfig(fuse_ln=True)``, ``MMTPU_LN_STATS=1`` and
   ``MMTPU_ENC_ATTN_BLHD=1``; 1 warm-up and 3 timed pages; exact launch
   counts per page (K5 12, K6 24, K1-BLHD 12, K7 1, K1 packed 1, K1 blf 0);
   a profile of one page; against phase 4's default route on the same page
   the detector's raw head maps (cosine ≥ 0.999 per level) and the
   embeddings of the same 48 crops (≥ 0.999); two crops against the same
   fused ViT in f32 on the CPU (≥ 0.999);
4c. the ViT page on the proj-BHLD route (``MMTPU_ENC_ATTN_BLF=0``): phase
   4's weights and pages, 1 warm-up and 3 timed pages; exact launch counts
   per page (K1 BHLD 12, K1 packed 1, K1 blf 0); the embeddings of phase
   4's last 48 crops against phase 4's (cosine ≥ 0.999);
6. K1 with the Mllama key prefix against its plain version:
   ``(8, 1608, 16, 80)`` with 1601 valid keys in bf16 and f32 (K4 v1 on
   the same bf16 inputs beside it), and ``valid_len`` ∈ {1, L−1, L} at
   L ∈ {17, 130, 1608} in bf16 and f32;
7. K2 against its plain version at the mmE5-11B text stack's five shapes
   in bf16, one f32 shape and ragged shapes, with the bf16 cuBLAS time of
   ``x @ W_bf16`` and ``torch._weight_int8pack_mm`` ("none" where the card's
   torch has no CUDA kernel for it) beside it as context (neither is the
   same function); the form each case took, the Python rule held to the
   launcher's, all five text shapes on the wgmma form, gate,up and k,v
   EQUAL bit for bit over two calls; the wgmma form's edges (M = 5, 129
   and 600, N = 48 and 1040, K = 200 and 20488, more tiles than CTAs, tiles
   cut across CTAs, 256-row tiles) and an x 8 bytes off that takes the
   ``mma.sync`` form; each wgmma launch's stream-K plan; from ``ptxas``
   each kernel's registers and spills (none in the wgmma form) and from
   ``cuobjdump -sass`` its ``I2F``/``I2FP`` (none) and ``HGMMA`` (> 0)
   counts; beside each timed median (one call from an idle card, the host's
   time per call included), the device time per call of 20 back-to-back
   calls; then the shapes the mmE5 storage forms add (the int8 tower's
   (12864, 1280)×(1280, 1280 | 5120) and (12864, 5120)×(5120, 1280); the
   text stack at ``text_chunk=16``, M = 1024, and its cross k,v at M =
   25616), each on the wgmma form, EQUAL over two calls, timed beside the
   bound and cuBLAS bf16 ``x @ W``;
8. the full-width mmE5 page: the same detector, then mmE5-Mllama-11B
   ``int8-mixed`` (bf16 vision tower, int8 text stack) at full width and
   depth over 48 crops at 560 px in chunks of 8, random weights from seed 0
   drawn on the card; 1 warm-up and 2 timed pages; shapes, finiteness,
   unit norms and launch counts per page (K1 with the prefix 240, K2 1680,
   K1 packed 1); the detect/vision/text split, peak memory, parameter
   bytes, and a ``torch.profiler`` breakdown of one page;
8b. phase 8's model and pages with ``text_chunk=16`` (the tower at 8 crops
   a call, the text stack at 16 over the concatenated states): ms per page
   beside phase 8's, launches per page (K2 840, K1 with the prefix 240, K1
   packed 1), each region against the coupled path on the same crops
   (cosine ≥ 0.999; the minimum and the largest difference printed);
8c. phase 8's model on 4-tile crops: 8 regions (48 cut to 8 for time)
   cropped at 1120 px and fed as their (2, 2) canvas, 2 crops a call, one
   warm-up and one timed page; launches (K2 1120, K1 with the prefix 0: the
   tower's attention is masked, on ``sdpa``'s plain path as in JAX, K1
   packed 1), unit norms, peak memory, and ``build_fused_page_fn(
   embed_tiles=4, embed_chunk=2)`` against the split form (cosine ≥ 0.999);
8d. the engine's host API on phase 8's model at ``batch_size=2``:
   ``get_image_embeddings`` on a 560×560 array, a 1120×560 array, a
   2200×1700 synthetic page (1, 2 and 4 tiles) and a missing path (None),
   launches (K2 280 per batch of 2, every other kernel 0: each image is a
   tile stack with a tile mask, on the tower's masked path),
   4096-wide unit-norm finite vectors, the 560×560 one against
   ``encode_image`` of its one preprocessed tile (cosine ≥ 0.999), and
   ``get_text_embeddings`` on one string and two (unit norms); ms per image
   and per text;
8a. the mmE5-11B vision tower of phase 8 (its weights reused, not drawn
   again) with ``fuse_ln="mlp"`` and ``MMTPU_LN_STATS=1``, one chunk of 8
   crops at 560: ms per chunk, launch counts per chunk (K6 32, K7 49, K1
   with the prefix 40), and the tower output's cosine against phase 8's
   default route on the same chunk (≥ 0.999 per crop);
9. the card against the CPU for mmE5: the 11B widths at reduced depth,
   for each of ``int8-mixed``, ``int8``, ``int4`` and ``int4-mixed``,
   built on the CPU in f32 from one float tree drawn from a seed on the
   card (quantized at load for each storage), carried to the card in bf16
   through the weight bridge; two of the page's crops, cosine ≥ 0.999;
14. the full-width mmE5-11B page on ``mme5_11b_int4()``, ``int4-mixed``
   and ``mme5_11b_int8()``, one model at a time (each freed before the
   next), as phase 8 runs it: 1 warm-up and 2 timed pages, launch counts
   per page (int4: K3 3120, int4-mixed: K3 1680, int8: K2 3120; K1 with
   the prefix 240 and K1 packed 1 on each), ms per page, the detect /
   vision / text split, peak memory, parameter bytes, a ``torch.profiler``
   breakdown of one int4 page;
15. a float checkpoint quantized at load: phase 9's float tree at the 11B
   widths and reduced depth, loaded into an int4 and
   an int8 model with the CPU and with the card as the target; the int8 and
   uint8 values and the scales EQUAL between the two builds, and two crops
   embedded on the card against the CPU build (cosine ≥ 0.999);
10. K4 against its plain version: the Qwen vision shape ``(1, 4960, 16,
    80)`` and the causal GQA text shape ``(1, 2560, 40/8, 128)`` in bf16,
    timed beside SDPA and the bound, and edge cases (L = 1, 127, 129,
    4960; lengths 1, L−1, L; Dk ≠ Dv; causal; f32), then the edges of the
    bf16 kernel's forms: an operand on the ``cp.async`` path (a base 8
    bytes off, a 2-byte row stride), query tiles not a multiple of v2's
    cluster, causal at L = 129 and 4960, lengths 1, L−1 and L in one batch,
    GQA 40/8 at Dk = Dv = 128; each bf16 launch's plan (path per operand,
    stages, v2's cluster C and clusters per head S) is printed, and at every
    edge v2's output is EQUAL to v1's, bit for bit;
11. K3 against its plain version at the Qwen2.5-VL-32B decoder's shapes
    (M = 1 and M = 1535; ``lm_head`` at M = 1), ragged and single-group
    shapes, bf16 and f32; decode shapes timed back to back over weight
    copies larger than L2, cuBLAS bf16 ``x @ W`` beside as context; the
    GEMV form's edges in bf16 and f32 (M = 1-4, N = 1030 and 40, one group
    of 100 packed rows, shares crossing tiles, K = 8, a ``packed`` 8 bytes
    off 16-byte alignment, groups wider than the kernel's x window, one with
    tiles cut across CTAs), each GEMV launch's plan printed, two calls
    EQUAL bit for bit at decode gate,up, ``lm_head`` and prefill gate,up;
    the M > 4 wgmma form's edges in bf16 and f32 (M = 5 and 129, N = 48 and
    1040, G = 64, 256 and one group of 512, more tiles than CTAs) and a
    ``packed`` 8 bytes off that takes the ``mma.sync`` form; the decode
    shapes at M = 8 (phase 12b's rows: q,o, k,v, gate,up, down, ``lm_head``),
    each on the wgmma form, EQUAL over two calls, timed back to back over
    weight copies larger than L2 beside the bound and cuBLAS bf16
    ``x @ W``, and their sum per decode step; the mmE5 int4
    shapes (the tower's three at M = 12864, the text stack's at M = 512,
    cross k,v at 12808), each on the wgmma form, EQUAL over two calls, timed
    beside the bound and cuBLAS bf16 ``x @ W``; the form each
    case took, the Python rule held to the launcher's, and all four
    prefill shapes on the wgmma form; from the machine code
    (``cuobjdump -sass``, "not available" without the tool) each kernel's
    int-to-float conversions (``I2F``/``I2FP``, none in the GEMV or the
    wgmma form) and ``HGMMA`` count (> 0 in the wgmma form), and from
    ``ptxas`` each kernel's registers and spills (none);
12. the full-width Qwen2.5-VL-32B int4 page parse at native resolution:
    the model built on the card from seed 0, a 2200×1700 synthetic page
    smart-resized to 1120×868 (4960 patches, a 1535-token prompt); one
    warm-up page through ``DocumentParser.parse`` at 16 new tokens, then 2
    timed pages of prefill + 64 steps of the fixed-length loop; prefill ms, ms per step,
    s per page, peak memory; launch counts (K4 4 per page, K3 449 per
    prefill and per step, K1 and K2 none); finite logits; the early-exit
    loop with EOS forced at step 32 equal to the fixed loop; profiles of
    the prefill and of 8 decode steps;
12b. continuous batching at full width on phase 12's model, its norm
    scales set to 1 and its biases to 0 (the seeded 0.02 makes every page
    emit one token; at 1 and 0 the tokens are decisive): 16 pages of
    its size (pixels from seed 12, one bucket), 64 new tokens each, stops
    cycling over 8, 16, ..., 64, through ``continuous_generate`` with 8
    rows and chunks of 32, in both chunk forms (early exit, fixed), and as
    the reference in waves of 8 through ``build_generate_fns(prefill_chunk=1,
    early_stop=True)`` under the same stops: every page's tokens EQUAL to
    the waves', bit for bit, in both forms, with the pages' tokens pairwise
    different and at least 2 distinct tokens per page over the run; exact
    launch counts (K4 4 per page, K3 449 per prefill and per decode step,
    the waves' steps the sum over waves of the largest stop, nothing else);
    a step with the rows at 8 depths EQUAL, row by row, to steps with every
    row at one depth; peak memory
    under the parameters plus the decoder's caches (twice them for the
    waves) plus 3 GiB; pages/hour, decode steps, chunks, ``splice_s`` and ms
    per step at B = 8 of each; then ``DocumentParser.parse_continuous`` on
    9 page files at 16 new tokens (one refill): 9 results in input order,
    tokens EQUAL to ``continuous_generate``'s on the same inputs, K3 449 per
    prefill and per decode step of that run;
13. the card against the CPU for Qwen: the 32B widths at 1 vision (a
    full-attention one) and 1 text layer, the weights drawn from a seed on
    the card, f32 on the CPU with the plain
    kernels, bf16 on the card, same weights and page; last-position logit
    cosine ≥ 0.999;
16. the serving CLI at full width on its defaults (``cli.serve``:
    DocLayout-YOLOv10-m at 1024 px over the page and its 2×2, 3×3, 4×4
    grids, letterboxed; the top 48 regions at 448 px; ViT-B/16 bf16; a
    whole-page embedding per page; the store): a folder of 4 synthetic
    2200×1700 pages (bucket (2400, 1800)), one 1500×1150 (bucket (1600,
    1200)) and a corrupt ``.png``, after a warm-up run on one page of each
    bucket. ``main()`` pipelined: 5 pages ingested, the corrupt one logged
    once and skipped, K1 packed 1 and K1 BLF 24 per page exactly;
    ``--no_prefetch`` into a second store: the same launches, the same ids
    and embeddings EQUAL bit for bit, a second run attempts only the
    corrupt page; ms per page and pages/s of both, the served page's detect
    / embed / whole-page-embedding split, a profile of one page, peak
    memory; the card's bf16 ``letterbox_views_matmul`` against the CPU's
    f32 on the served page within one uint8 step; the store filled with
    seeded unit rows to 100,000 × 768 f32 on the card, 64 queries at k = 10
    (ms per batch, ``masked_topk``'s device time), ids equal to the native
    host ``cosine_topk`` but where two similarities lie within 1e-5 (the
    count printed); an ``index="hnsw"`` collection over the first 4,000 rows
    (cut from 10,000 for time: the native build is single-threaded), build
    seconds and recall@10 against exact; ``--embedder_family mme5
    --quantize`` (int8-mixed, 11B) on 2 of the pages: exact K1-prefix and K2
    counts, unit-norm finite embeddings.

17. the numbered chain (``run.sh`` stages 0-5) through
    ``cli.pipeline.main([..., "--device", "cuda"])`` on its defaults
    (DocLayout-YOLOv10-m, 1024 px, grids ``2x2,3x3,4x4``, bf16, random
    weights from seed 0, each class's head logits mapped once by an affine
    fit on one page's views so that a view keeps about as many boxes of
    each class as ``STAGE_VIEW_BOXES`` says, most of them plain_text, and
    stages 4-5 find widths and columns) over four synthetic 2200×1700 text
    pages, three
    rotated by −2.5, 2.0 and 5.0 degrees and one clean, after a warm-up
    chain on one page: each skew estimate within 0.3° of −angle (the clean
    page: None or within 0.3° of 0), the card's estimates EQUAL to the CPU's
    f32 ones and to a second card run, each rotated page within one uint8
    step of the CPU's rotation of the same page by the same angle, K1 packed
    exactly once per page and no other kernel, the stage-1 tree's layout,
    a cached rerun that skips all six stages and changes no byte, and a
    forced rerun of stages 2-5 whose JSON is byte-identical, plain_text
    boxes and a median width on every page and column centres on at least
    one; ms per page of
    each stage, stage 0 split into decode / estimate / rotation / encode and
    stage 1 into decode / detect / write, stage-1 pages/s with prefetch (the
    chain's) and without (a profiled ``prefetch=False`` run over the first
    two oriented pages, which gives stage 1's device idle share) and peak
    memory.
18. the integrated workflow through ``cli.workflow.main([..., "--device",
    "cuda", "--run_cross_compare", "--run_region_compare", "--run_demo",
    "--demo_image", page 0, "--trace_dir", ...])`` on its defaults
    (DocLayout-YOLOv10-m at 1024 px through ``detect_regions``, one view a
    page; ViT-B/16 at 448; the store on the card) over six synthetic
    2200×1700 pages named for two publications (seeds 50-55, three rotated
    by −2.5, 2.0 and 4.0 degrees), in a temporary working directory, after
    a warm-up workflow over one page, with the class head fitted on page
    0's one view (``WORKFLOW_VIEW_BOXES``): K1 packed exactly once per page
    and K1 BLF 12 per ViT call, no other kernel; every page in the store
    with regions; the card's ``compute_similarity_matrix`` against the
    CPU's f32 one on the store's regions snapped to 2⁻¹¹ (within 1e-5,
    symmetric, unit diagonal), ``cluster_pages`` labels equal but where two
    merges lie within 1e-5; the output tree (``weighted_clustering/``
    without plots where matplotlib is missing, ``cross_compare/`` a page per
    image, ``region_compare/index.html``, ``testout/query_results.txt``
    with its four sections, a Chrome trace); a second ``--stage all`` run
    launches nothing and adds no row; ms per page of each stage, seconds of
    the three reports, peak memory, the trace's device busy time; then the
    clustering pass at archive scale (1,000 pages × 48 unit regions × 768,
    Q = k = 10, exact similarities in multiples of 1/64): device ms (CUDA
    events, median of 5) beside its bound, peak memory, the first 100
    pages' sums against the CPU's f32 run within 1e-5 of the largest.
19. the checkpoint and parity tooling: (a) ``cli.parity acts-dump --family
    detector`` (DocLayout-YOLOv10-m GL-CRM at 1024 px, seed 0) on the card
    and on the CPU in f32; the card's dump equal to an in-process trace of
    the same detector, whose output is EQUAL to the plain forward's and
    whose K1 packed launches are exactly 1 with and without hooks;
    ``acts-compare`` CPU against card at ``PARITY_RTOL`` / ``PARITY_ATOL``
    with the worst layer printed; (c) that detector exported as an
    ultralytics state dict (unfolded identity BatchNorm) and loaded through
    ``doclayout_key_map`` into a detector of other seeded weights, and saved
    by ``save_checkpoint_safetensors`` and loaded by
    ``DetectorConfig.weights_path``: detections on a 2200×1700 page EQUAL to
    the source's; (d) ``cli.parity boxes`` over 2 pages through
    ``detect_regions`` (one view, the class head fitted), card bf16 against
    CPU f32: precision, recall, mean matched IoU ≥ 0.99; ``cli.parity
    embeddings`` over a card store and a CPU store of the same 8 crops
    (ViT-B/16 at 448 through the host API): min cosine ≥ 0.999; (e) a
    ``utils/profiling.py::trace`` of one ViT page read by
    ``utils/trace_analysis.py``: category sums equal to the kernel total
    within 0.1%, K1 13 launches; (b) mmE5-11B bf16 at full width (the
    engine's default storage, seeded weights): every layer finite, the
    names those of the tiny config's dump with indices generalised, the
    output EQUAL to the plain forward's, launches equal with and without
    hooks; the 11B widths at reduced depth on ``int8-mixed`` (K1, K2), card
    bf16 against CPU f32, the tower at ``PARITY_ATOL`` and the text stack
    at ``PARITY_TEXT_ATOL``, worst layers printed.

20. training and the parallelism core: (a) K1's gradient: its two wrapped
    forms (``encoder_attention_blf``, ``encoder_attention(bhld_inputs=True)``)
    at ViT-B ``(32, 784, 768)``, H = 12, in f32 and bf16, the
    ``KernelAttention`` backward's dQ/dK/dV against autograd of the plain
    version (f32 within ``TRAIN_F32_GRAD_RTOL`` of the largest |g|; bf16 no
    farther from the f32 gradient than ``TRAIN_BF16_GRAD_FACTOR`` times the
    plain bf16 autograd's), forward, backward and plain ms, SDPA forward +
    backward as context; every wrapper without a backward called under grad
    with an input that requires one: each raises, naming itself, and launches
    nothing; (b) ``ContrastiveTrainer`` at ``DualEncoderConfig.base()``
    (ViT-B/16 at 448, the 6×512 text tower, vocab 32,000), f32 with TF32
    off, a global batch of 32 seeded pairs, mesh (1, 1) over a one-rank NCCL
    group: every gradient leaf finite and non-zero, K1 BLF exactly 12
    launches a step, mesh (1, 1) EQUAL to ``mesh=None``, the card's step-1
    gradient against the CPU trainer's on the same weights at the base
    widths and 2 ViT and 1 text layers (per leaf within
    ``TRAIN_CARD_CPU_RTOL`` of its largest |g|), 5 steps on the batch with
    the loss falling, step ms and peak memory; (c) ``pp_greedy_generate(
    n_stages=1)`` at the Qwen2.5-VL-32B int4 widths with 4 of 64 decoder
    layers (reduced depth), 2 rows of a 2048-token prompt and 8 new tokens: tokens
    EQUAL to ``greedy_generate`` on the same model, K3 261 and K4 4
    launches.
21. The scale-out serving and parse: (a) ``build_fused_batch_fn(mesh=None)``
    at the headline config (v10-m, 30 letterboxed views, ViT-B/16
    ``DualEncoderConfig.base()``, 48 regions; the class head fitted on page
    0 as in phase 17) on 4 pages of 2200×1700, each page held against
    ``build_fused_page_fn`` (boxes matched one to one within a class at
    IoU ≥ 0.99, their embeddings' cosine ≥ 0.999, at least
    ``BATCH_MATCH_MIN`` of a page's boxes so matched; precision, recall and
    mean matched IoU at 0.5 printed), ms per page batched and single, peak memory; K1 packed
    1 and K1 BLF 12 for the batch; (b) ``build_split_batch_fn(mesh=None)``
    at the mmE5-11B widths, ``int8-mixed``, ``reduced_mme5``'s depth, on 2
    pages against ``build_split_page_fn`` with the same gates, the launches
    of one page per batch call; (c) on a one-rank NCCL world, mesh (1, 1):
    both batch functions EQUAL to ``mesh=None``; ``Collection.set_mesh`` at
    100,000 × 768, 64 queries, k = 10, ids and distances EQUAL to the
    unsharded ``masked_topk`` with a planted tie in row order;
    ``MultimodalEmbedder(mesh=)`` mme5 bf16 at the 11B widths and reduced
    depth EQUAL to ``mesh=None`` (single-tile crops: K1 prefix one a tower
    layer; the host API on 2 images); ``DocumentParser(dp_mesh=)`` and
    ``DocumentParser(pp_mesh=make_pp_mesh(1), pp_stages=1)`` at the
    Qwen2.5-VL-32B int4 widths, 4 of 64 decoder layers, 2 native-resolution
    pages, 8 new tokens: text EQUAL to ``parse_batch``'s, K3 and K4 exact;
    (d) ``cli.serve`` and ``cli.parse`` with ``--data_parallel 2`` on one
    card exit with JAX's words.
22. Serve-vs-exact detection parity: (a) K1's wrappers
    (``encoder_attention_blf``, ``_blf_packed``, ``encoder_attention`` in
    both layouts) at a non-default ``sm_scale``, and
    ``encoder_attention_padded``, against their plain versions with K1's
    per-output bf16 gate; (b) ``scripts/torch_serve_parity.py`` and
    ``scripts/torch_knife_edge_probe.py`` at ``--full`` (v10-m at 1024 px,
    grids 2×2, 3×3 and 4×4, ``SERVE_PARITY_PAGES`` pages of 2200×1700, 48
    regions, bf16, the class head fitted on page 0 as in phase 17; the
    exact chain run once for both): the six serve variants' precision,
    recall_topk, mean matched IoU and seconds, the exact chain's seconds,
    the knife-edge experiments; every number finite and in [0, 1]; K1 packed
    exactly once per detector call (11 calls a page) and no other kernel;
    the ``return_candidates`` tap through the device ``nms_padded`` EQUAL to
    the plain call's regions on every page. The values are measured, not
    gated.

Every page phase (4, 4b, 4c, 8, 8a, 8b, 8c, 8d, 12, 12b, 14, 16, 17, 18, 21, 22) sets the launch
counts of all 14 kernel wrappers to 0 just before its timed run and holds
them to exact values just after.

It prints the card line and one JSON line of per-kernel results, then, as
the last line, ``{"ok": true, "device": {...}}``. Exits non-zero without a
CUDA device.

    python3 chip_smoke.py --k5

runs phase 1, K5's build and K5's checks of phases 4a and 3a only (a
minute on the card), and prints no result line.

    python3 chip_smoke.py --k2

runs phase 1, K2's build and phase 7 only (the mmE5 storage shapes
included), and prints no result line.

    python3 chip_smoke.py --k3

runs phase 1, K3's build and phase 11 only (the mmE5 int4 shapes
included), and prints no result line.

    python3 chip_smoke.py --qwen

runs phase 1, K3's and K4's builds and phases 11, 12 and 12b only, and
prints no result line.

    python3 chip_smoke.py --serve

runs phase 1, K1's and K2's builds and phase 16 only, and prints no result
line.

    python3 chip_smoke.py --stages

runs phase 1, K1's build and phase 17 only, then prints the card line and
the last line.

    python3 chip_smoke.py --workflow

runs phase 1, K1's build and phase 18 only, then prints the card line and
the last line.

    python3 chip_smoke.py --parity

runs phase 1, K1's and K2's builds and phase 19 only, then prints the card
line and the last line.

    python3 chip_smoke.py --train

runs phase 1, K1's, K3's and K4's builds and phase 20 only, then prints
the card line and the last line.

    python3 chip_smoke.py --scaleout

runs phase 1, K1's to K4's builds and phase 21 only, then prints the card
line and the last line.

    python3 chip_smoke.py --serve_parity

runs phase 1, K1's build and phase 22 only, then prints the card line and
the last line.

    python3 chip_smoke.py --k6

runs phase 1, K6's build and K6's part of phase 4a only, and prints no
result line.

    python3 chip_smoke.py --k7

runs phase 1, K7's build and K7's part of phase 4a only, and prints no
result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

# stated tolerances for K1 against its plain version on the card. Both sum
# in f32 in different orders, so a bf16 output may round to the neighbouring
# value: 2 bf16 steps at the output's own magnitude, and a mean that stays
# near zero (H100 runs of the CUDA-core K1 read 1 step and a mean of
# 1.7e-9). Skipping the bf16 rounding of e, or truncating the output, moves
# 40-50% of the ViT shape's outputs, a mean of 7e-5 to 1.3e-4. f32 differs
# only by order.
MAX_BF16_STEPS, ATOL_BF16_MEAN = 2.0, 1e-6
ATOL_F32_MAX = 1e-5
# The bf16 K1 sums q·k on the tensor cores, not in the sequential-FMA order
# of the plain version's f32 product (which the CUDA-core K1 repeated bit
# for bit), so a score may differ in its last bit and a p next to a bf16
# rounding boundary may round the other way: that moves its output by up to
# 2^-8·p·|v|/denom, many steps where the outputs cancel to near zero. So
# each bf16 output may also differ by 2^-7 of its attention-weighted mean
# |v| (the plain version on |v|), as K4's gate allows; the mean gate above
# is unchanged and still catches a systematic fault.
K1_FLIP_SHARE = 2.0**-7
# K2 against its plain version: both sum K products in f32 in different
# orders, and each sum is within K·2^-24·Σ|x·q| of the exact one, so an
# output may differ by twice that (times |scale|) plus, in bf16, 2 steps of
# its own rounding. Outputs that cancel to near zero make a bound in steps
# alone meaningless (H100 readings: up to 1468 steps at |y| ~ 1e-6). The
# mean error must stay under 5% of the mean bf16 step: rounding flips are
# rare, truncation would move half the outputs.
K2_MEAN_STEP_SHARE = 0.05
COSINE_MIN = 0.999  # BASELINE.json's embedding-parity target
PAGE_HW = (2200, 1700)
NUM_REGIONS = 48
TIMED_PAGES = 3
MME5_CHUNK = 8
MME5_TIMED_PAGES = 2
MME5_TEXT_CHUNK = 16  # phase 8b: the text stack at 16 crops a pass
# phase 8c: 4-tile crops. The tower attends over 4 x 1608 keys on the masked
# plain path (~5-8 GB of scores per crop and layer), so 2 crops a call, and 8
# regions instead of 48 for time only
MME5_TILES4_REGIONS, MME5_TILES4_CHUNK = 8, 2
MME5_API_BATCH = 2  # phase 8d: each image is a 4-tile stack; 16 would not fit
# phase 17: the rotation of each synthetic page (degrees; 0 = clean) and the
# skew estimator's gate, the JAX test's bound
STAGE_ANGLES = (-2.5, 2.0, 5.0, 0.0)
STAGE_PROFILED_PAGES = 2  # phase 17's profiled sequential stage 1
STAGE_ANGLE_TOL = 0.3
# phase 17: a random head gives every anchor of a class nearly one score,
# so each view keeps max_detections boxes or none, of whatever class that
# score favours. fit_head refits the class head's output convs on one
# page's 30 views: the k-th best anchor of a class (k below per view, on
# average over the views) lands on conf_threshold and the best on a score
# of 0.9; a class left out scores no box. Counted before NMS; a trained
# detector keeps tens of boxes on a newspaper page, most of them plain_text.
STAGE_VIEW_BOXES = {"plain_text": 48, "title": 6, "abandon": 4, "figure": 3,
                    "figure_caption": 2}
STAGE_BEST_SCORE = 0.9
STAGE_FOLDERS = ("0_oriented_images", "1_doclayout_parsed", "2_edge_box_filtered",
                 "3_combined_bboxes", "4_medians_extracted", "5_column_detection")
# phase 18: the workflow's pages (publication, rotation in degrees), seeds
# 50-55; two publications, so that cross_compare's 20% filename-prefix skip
# has pairs to skip
WORKFLOW_PAGES = (("gazette", 0.0), ("gazette", -2.5), ("gazette", 0.0),
                  ("tribune", 2.0), ("tribune", 0.0), ("tribune", 4.0))
# phase 18: the class head fitted on page 0's one 1024 px view (detect_regions
# runs the whole page only), so that a page keeps tens of regions of the
# embedded types (fit_head)
WORKFLOW_VIEW_BOXES = {"plain_text": 48, "title": 12, "abandon": 4, "figure": 3,
                       "figure_caption": 2}
WORKFLOW_VIT_LAYERS = 12  # DualEncoderConfig.base(): ViT-B/16
WORKFLOW_QUERY_SECTIONS = ("=== img_query_pages ===", "=== img_query_regions ===",
                           "=== txt_query_pages ===", "=== txt_query_regions ===")
# the card's similarity matrix against the CPU's f32 one: sums of up to Q·k
# products in other orders, normalised by the largest
WORKFLOW_SIM_TOL = 1e-5
# phase 18: the clustering pass at archive scale: N pages of R unit regions
# in D dimensions (20 seeded topics, so that pairs clear the 0.1 accept
# threshold), the first Q regions of each page as queries, top k
ARCHIVE_PAGES, ARCHIVE_REGIONS, ARCHIVE_DIM = 1_000, 48, 768
ARCHIVE_QUERIES, ARCHIVE_K, ARCHIVE_TOPICS = 10, 10, 20
ARCHIVE_CHECKED = 100  # pages whose block is held against the CPU's run
# H100 SXM datasheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


START = time.perf_counter()


def phase(title: str) -> None:
    """The phase's header with the seconds since the script started, on
    standard output and, shortened, on standard error (whose tail is what
    remains of a run stopped at its time limit)."""
    t = time.perf_counter() - START
    print(f"== {title} [t = {t:.1f} s]", flush=True)
    print(f"chip_smoke: t = {t:.1f} s: {title[:60]}", file=sys.stderr, flush=True)


def kernel_counters(k1, k2, k3, k4, k5, k6, k7) -> dict:
    """Every kernel wrapper's launch counter (``.launches``), by the name of
    its entry in the kernels line."""
    return {
        "encoder_attention_blf": k1.encoder_attention_blf,
        "encoder_attention_blf_packed": k1.encoder_attention_blf_packed,
        "encoder_attention": k1.encoder_attention,
        "encoder_attention (bhld)": k1.encoder_attention.bhld,
        "encoder_attention_blhd": k1.encoder_attention_blhd,
        "int8_matmul": k2.int8_matmul,
        "stochastic_round_quantize": k2._sr_quantize_2d,
        "int4_matmul": k3.int4_matmul,
        "flash_attention": k4.flash_attention,
        "flash_attention_v2": k4.flash_attention_v2,
        "conv3x3_nchw": k5.conv3x3_nchw,
        "conv3x3_s2_nchw": k5.conv3x3_s2_nchw,
        "ln_matmul": k6.ln_matmul,
        "ln_stats": k7.ln_stats,
    }


def zero(counters: dict) -> None:
    for wrapper in counters.values():
        wrapper.launches = 0


def counts(counters: dict) -> dict:
    return {name: wrapper.launches for name, wrapper in counters.items()}


def only(counters: dict, nonzero: dict) -> dict:
    """The launch counts a run must show: ``nonzero``, and 0 for every other
    kernel."""
    return dict.fromkeys(counters, 0) | nonzero


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(calls, reps: int = 5) -> float:
    """Device time per call of ``calls`` run back to back: the card sleeps
    while the host enqueues them, so the wrappers' host time is not timed
    (``median_ms`` times one call from an idle card, host time included)."""
    import torch

    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for call in calls:
        call()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(int((2 * host + 1e-3) * 2e9))  # cycles at <= 2 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for call in calls:
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """The least time the card could take: max(flops / peak rate of the
    type, bytes / HBM rate), in ms, and which of the two bounds it."""
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, l, n, d, dv, dtype) -> tuple:
    """K1's work over ``n`` valid keys: QK and PV products; q and o over L
    rows, k and v over the n keys read, each once. The function's work,
    counted once: the bf16 kernel's two passes run the QK product twice
    (1.5× the tensor-core work at D = DV), which the bound leaves out."""
    import torch

    elem = torch.finfo(dtype).bits // 8
    flops = 2.0 * b * h * l * n * (d + dv)
    nbytes = elem * b * h * (l * d + n * d + n * dv + l * dv)
    return bound_ms(flops, nbytes, dtype)


def bf16_step(want):
    """The bf16 step at ``|want|`` (8 significant bits: the step in
    ``[2^(e−1), 2^e)`` is ``2^(e−8)``)."""
    import torch

    want = want.float()
    _, exp = torch.frexp(want.abs().clamp_min(2.0**-126))
    return torch.ldexp(torch.ones_like(want), exp - 8)


def bf16_steps(got, want) -> float:
    """Largest ``|got − want|`` in bf16 steps at ``|want|``."""
    return ((got.float() - want.float()).abs() / bf16_step(want)).max().item()


def card() -> str:
    import torch

    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def build(*modules, later=()):
    """Build every kernel library, one ``nvcc`` per source, all at once:
    ``modules`` are (label, kernel module) pairs. Waits for all but the
    labels in ``later``, whose builds run on in the background; returns a
    function that waits for those and prints their reports. A kernel called
    before its build ends waits for it (``_build.load`` holds a lock per
    source)."""
    phase("2. build (one nvcc per source, started together)")
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(modules))
    futures = [(label, pool.submit(module.build_info)) for label, module in modules]
    pool.shutdown(wait=False)

    def report(label, info):
        print(f"{label} library {info.path.name}: nvcc {info.seconds:.1f} s")
        for line in info.log.splitlines():
            if "Compiling entry function" in line:
                print("  " + line.strip().split("'")[1])  # the kernel's mangled name
            elif "C7519" in line:
                continue  # counted below: ptxas placed a wgmma fence of its own
            elif "registers" in line or "spill" in line or "Performance Loss" in line:
                print("    " + line.strip())
        fences = info.log.count("C7519")
        if fences:
            print(f"  ptxas inserted {fences} warpgroup.arrive fences (C7519) before wgmma")

    for label, future in futures:
        if label not in later:
            report(label, future.result())
    print(f"build wall time {time.perf_counter() - t0:.1f} s"
          + (f" ({', '.join(later)} still building)" if later else ""))

    def finish():
        for label, future in futures:
            if label in later:
                report(label, future.result())
        print(f"build of {', '.join(later)} done {time.perf_counter() - t0:.1f} s after "
              "the builds started")

    return finish


def k1_bf16_gate(name, got, want, weighted) -> tuple:
    """K1's per-output bf16 gate (MAX_BF16_STEPS steps at |o| plus
    K1_FLIP_SHARE of the attention-weighted mean |v|); returns the largest
    error over its bound and a note of how far the outputs went."""
    import torch

    err = (got.float() - want.float()).abs()
    steps = bf16_step(want)
    allowed = MAX_BF16_STEPS * steps + K1_FLIP_SHARE * weighted.float()
    ratio = (err / allowed).max().item()
    over = int((err > MAX_BF16_STEPS * steps).sum())
    check(ratio <= 1.0, f"{name}: error {ratio:.3g}× its bound ({over} outputs past "
                        f"{MAX_BF16_STEPS:g} bf16 steps)")
    return ratio, (f"{(err / steps).max().item():g} bf16 steps; {over} of {err.numel()} "
                   f"outputs past {MAX_BF16_STEPS:g} steps, err/allowed {ratio:.3f}")


def abs_v(plain, q, k, v, *args, **kwargs):
    """The plain version on (q, k, |v|) in f32: each output's
    attention-weighted mean |v|."""
    return lambda: plain(q.float(), k.float(), v.float().abs(), *args, **kwargs)


def packed_abs_v(qkv, heads, key_dim):
    """A packed per-head [q|k|v] slab in f32 with its v columns made |v|."""
    x = qkv.float().clone()
    per_head = x.view(*x.shape[:2], heads, -1)
    per_head[..., 2 * key_dim :] = per_head[..., 2 * key_dim :].abs()
    return x


def compare_attention(name, kernel, plain, library, dtype, bound, weighted=None,
                      k4=None) -> dict:
    """K1 against its plain version (errors, gates, median times; bf16 needs
    ``weighted``, the plain version on |v|), the library call's median time,
    the bound, and with ``k4`` the median time of K4 (v1) on the same inputs
    as context."""
    import torch

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    if dtype == torch.bfloat16:
        steps_note = f" ({k1_bf16_gate(name, got, want, weighted())[1]})"
        check(mean_err <= ATOL_BF16_MEAN, f"{name}: mean err {mean_err} > {ATOL_BF16_MEAN}")
    else:
        check(max_err <= ATOL_F32_MAX, f"{name}: max err {max_err} > {ATOL_F32_MAX}")
        steps_note = ""
    ms, plain_ms, library_ms = median_ms(kernel), median_ms(plain), median_ms(library)
    b_ms, b_by = bound
    out = {"max_abs_err": max_err, "mean_abs_err": mean_err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
           "bound_by": b_by}
    note = ""
    if k4 is not None:
        out["flash_attention_v1_ms_context"] = median_ms(k4)
        note = f" [context: K4 v1 on the same inputs {out['flash_attention_v1_ms_context']:.3f} ms]"
    print(f"{name}: max_abs_err {max_err:.3e}{steps_note} mean_abs_err {mean_err:.3e} "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms sdpa {library_ms:.3f} ms "
          f"bound {b_ms:.4f} ms ({b_by}){note}", flush=True)
    return out


def edge_gate(name, cases) -> None:
    """K1's edge shapes against the plain version: ``cases`` are (kernel,
    plain, plain on |v|) triples of one dtype. f32 within ATOL_F32_MAX;
    bf16 within K1's per-output gate (the mean gate needs the main shapes'
    millions of outputs: one rounding flip among a few hundred outputs
    would fail it on its own)."""
    import torch

    worst, notes = 0.0, []
    for kernel, plain, weighted in cases:
        got, want = kernel(), plain()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{name}: {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        if got.dtype == torch.bfloat16:
            notes.append(k1_bf16_gate(name, got, want, weighted()))
        else:
            worst = max(worst, (got - want).abs().max().item())
    if got.dtype == torch.bfloat16:
        print(f"{name} bf16, {len(notes)} cases: worst {max(notes)[1]}")
    else:
        print(f"{name} f32: max_abs_err {worst:.3e}")
        check(worst <= ATOL_F32_MAX, f"{name}: max err {worst} > {ATOL_F32_MAX}")


def kernel_checks(k1, k4) -> dict:
    """K1 against the plain version at the ViT page's shapes."""
    import torch
    import torch.nn.functional as F

    phase("3. K1 against its plain version (ViT page shapes)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    results = {}

    def heads(x, h):  # (B, L, H·D) → (B, H, L, D) view
        b, l, f = x.shape
        return x.view(b, l, h, f // h).transpose(1, 2)

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (
            torch.randn((48, 784, 768), generator=gen, device=dev).to(dtype)
            for _ in range(3)
        )
        results[("vit", dtype)] = compare_attention(
            f"vit (48,784,768) H=12 {dtype}",
            lambda: k1.encoder_attention_blf(q, k, v, heads=12),
            lambda: k1.encoder_attention_blf_reference(q, k, v, heads=12),
            lambda: F.scaled_dot_product_attention(heads(q, 12), heads(k, 12), heads(v, 12)),
            dtype, attention_bound(48, 12, 784, 784, 64, 64, dtype),
            weighted=abs_v(k1.encoder_attention_blf_reference, q, k, v, heads=12),
            k4=(lambda: k4.flash_attention(*(t.view(48, 784, 12, 64) for t in (q, k, v))))
            if dtype == torch.bfloat16 else None,
        )
    qkv = torch.randn((30, 1024, 576), generator=gen, device=dev).to(torch.bfloat16)
    per_head = qkv.view(30, 1024, 4, 144).transpose(1, 2)
    results["psa"] = compare_attention(
        "psa (30,1024,576) 4x(36|36|72) bf16",
        lambda: k1.encoder_attention_blf_packed(qkv, 4, 36, 72),
        lambda: k1.encoder_attention_blf_packed_reference(qkv, 4, 36, 72),
        lambda: F.scaled_dot_product_attention(
            per_head[..., :36], per_head[..., 36:72], per_head[..., 72:]
        ),
        torch.bfloat16, attention_bound(30, 4, 1024, 1024, 36, 72, torch.bfloat16),
        weighted=lambda: k1.encoder_attention_blf_packed_reference(
            packed_abs_v(qkv, 4, 36), 4, 36, 72),
    )

    # edges the main path does not reach: ragged query tiles (the bf16
    # kernel's 128 rows, the f32 kernel's 16) and key tiles (64), a single
    # key, Dv != D, head dims padded to 16 (D = 40 → 48, DV = 56 → 64; kd =
    # 20, dv = 24 → 32), operands that are column slices of wider rows, the
    # packed k at 8-byte and 2-byte offsets (kd = 20 and 19), DV = 128 with
    # D = 64 and 128; bf16 (the kernel every page runs) and f32
    def edge_cases(l, dtype):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        wide = randn(2, l, 3 * 40 * 2 + 3 * 56)
        qkv = (wide[..., :120], wide[..., 120:240], wide[..., 240:])
        yield (lambda t=qkv: k1.encoder_attention_blf(*t, heads=3),
               lambda t=qkv: k1.encoder_attention_blf_reference(*t, heads=3),
               abs_v(k1.encoder_attention_blf_reference, *qkv, heads=3))
        for kd, dv in ((20, 24), (19, 24)):
            packed = (randn(2, l, 2 * (2 * kd + dv)), 2, kd, dv)
            yield (lambda a=packed: k1.encoder_attention_blf_packed(*a),
                   lambda a=packed: k1.encoder_attention_blf_packed_reference(*a),
                   lambda a=packed: k1.encoder_attention_blf_packed_reference(
                       packed_abs_v(a[0], 2, a[2]), *a[1:]))
        for d in (64, 128):
            qkv = (randn(2, l, 2 * d), randn(2, l, 2 * d), randn(2, l, 2 * 128))
            yield (lambda t=qkv: k1.encoder_attention_blf(*t, heads=2),
                   lambda t=qkv: k1.encoder_attention_blf_reference(*t, heads=2),
                   abs_v(k1.encoder_attention_blf_reference, *qkv, heads=2))

    for dtype in (torch.bfloat16, torch.float32):
        edge_gate("edge shapes (L = 1, 17, 77, 130; strided; Dv != D; packed kd 20 and 19; "
                  "DV = 128)",
                  [case for l in (1, 17, 77, 130) for case in edge_cases(l, dtype)])
    return results


def check_page(res, embed_dim) -> None:
    import torch

    shapes = [tuple(t.shape) for t in res]
    want = [(NUM_REGIONS, 4), (NUM_REGIONS,), (NUM_REGIONS,), (NUM_REGIONS,),
            (NUM_REGIONS, embed_dim)]
    check(shapes == want, f"output shapes {shapes} != {want}")
    check(res.valid.dtype == torch.bool and res.classes.dtype == torch.int32,
          "valid/classes dtypes")
    for name in ("boxes", "scores", "embeddings"):
        check(bool(torch.isfinite(getattr(res, name)).all()), f"non-finite {name}")
    norms = res.embeddings.norm(dim=-1)
    check(bool(((norms - 1).abs() < 1e-3).all()), f"embedding norms {norms}")
    check(bool(((res.classes >= 0) & (res.classes < 10)).all()), "class ids")
    b = res.boxes[res.valid]
    check(bool((b[:, 0] <= b[:, 2]).all() and (b[:, 1] <= b[:, 3]).all()),
          "box corners out of order")


def make_detector():
    import torch

    from multimodal_embeddings_tpu_torch.config import DetectorConfig
    from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector

    return LayoutDetector(
        DetectorConfig(image_size=1024, variant="m"),
        dtype=torch.bfloat16, device="cuda", seed=0,
    )


def make_pages(n):
    import torch

    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    return [torch.from_numpy(make_page(*PAGE_HW, seed=i)).to("cuda") for i in range(n)]


def full_slice(counters):
    """The ViT page program at full width; returns the launch counts, one
    page's crops and embeddings, and the model config."""
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.vision_encoder import (
        DualEncoderConfig,
        VisionConfig,
    )
    from multimodal_embeddings_tpu_torch.pipeline.fused import build_split_page_fn

    phase("4. full-width ViT page program")
    t0 = time.perf_counter()
    detector = make_detector()
    model_config = DualEncoderConfig(
        vision=VisionConfig(448, 16, 768, 12, 12), embed_dim=768
    )
    embedder = MultimodalEmbedder(
        EmbedderConfig(family="siglip", dtype="bfloat16"),
        model_config=model_config, device="cuda", seed=0,
    )
    fn = build_split_page_fn(
        detector, embedder, PAGE_HW, num_regions=NUM_REGIONS, embed_chunk=NUM_REGIONS
    )
    pages = make_pages(1 + TIMED_PAGES)
    torch.cuda.synchronize()
    print(f"set-up (random init, upload): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fn(pages[0])
    torch.cuda.synchronize()
    print(f"warm-up page: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    page_ms, results = [], []
    for page in pages[1:]:
        t0 = time.perf_counter()
        res = fn(page)
        torch.cuda.synchronize()
        page_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    launches = counts(counters)
    peak = torch.cuda.max_memory_allocated()

    want = only(counters, {"encoder_attention_blf": model_config.vision.layers * TIMED_PAGES,
                           "encoder_attention_blf_packed": TIMED_PAGES})
    check(launches == want, f"launches {launches} != {want}")
    for res in results:
        check_page(res, 768)
    print(f"ms/page {statistics.mean(page_ms):.1f} (pages: "
          + ", ".join(f"{t:.1f}" for t in page_ms) + ")")
    print(f"valid regions per page: {[int(r.valid.sum()) for r in results]}")
    print(f"K1 launches: vit {launches['encoder_attention_blf']} psa "
          f"{launches['encoder_attention_blf_packed']} over {TIMED_PAGES} pages")
    print(f"peak device memory: {peak / 2**30:.2f} GiB")

    # the two halves of the same path, timed apart
    det_ms, emb_ms = [], []
    for page in pages[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *_, crops = fn.detect(page)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        embs = fn.embed(crops)
        torch.cuda.synchronize()
        det_ms.append((t1 - t0) * 1e3)
        emb_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"detect+crop {statistics.mean(det_ms):.1f} ms/page, "
          f"embed {statistics.mean(emb_ms):.1f} ms/page")
    return launches, crops, embs, model_config, detector, embedder


def card_vs_cpu(crops, embs, model_config) -> None:
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder

    phase("5. ViT: card (bf16) against the CPU (f32, plain attention)")
    cpu = MultimodalEmbedder(
        EmbedderConfig(family="siglip", dtype="float32"),
        model_config=model_config, device="cpu", seed=0,
    )
    ref = cpu.encode_image(crops[:2].float().cpu())
    got = embs[:2].float().cpu()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    print(f"cosine card vs cpu: {[round(c, 6) for c in cos.tolist()]}")
    check(bool((cos >= COSINE_MIN).all()), f"cosine {cos.tolist()} < {COSINE_MIN}")


def masked_checks(k1, k4) -> dict:
    """K1 with the key prefix against its plain version."""
    import torch
    import torch.nn.functional as F

    phase("6. K1 with the key prefix against its plain version (Mllama shapes)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    results = {}
    b, l, h, d, n = MME5_CHUNK, 1608, 16, 80, 1601
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (
            torch.randn((b, l, h, d), generator=gen, device=dev).to(dtype) for _ in range(3)
        )
        results[dtype] = compare_attention(
            f"mllama ({b},{l},{h},{d}) valid {n} {dtype}",
            lambda: k1.encoder_attention(q, k, v, valid_len=n),
            lambda: k1.encoder_attention_reference(q, k, v, n),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2)[:, :, :n], v.transpose(1, 2)[:, :, :n]
            ),
            dtype, attention_bound(b, h, l, n, d, d, dtype),
            weighted=abs_v(k1.encoder_attention_reference, q, k, v, n),
            k4=(lambda: k4.flash_attention(q, k, v, lengths=torch.full(
                (b,), n, dtype=torch.int32, device=dev)))
            if dtype == torch.bfloat16 else None,
        )
    # valid_len at its edges (one key, a last key tile of one key, all
    # keys), Dv != D, operands that are column slices of wider rows
    def edge_cases(dtype):
        for l in (17, 130, 1608):
            for n in (1, l - 1, l):
                wide = torch.randn((2, l, 3 * (40 + 40 + 56)), generator=gen,
                                   device=dev).to(dtype)
                qkv = (wide[..., :120].view(2, l, 3, 40), wide[..., 120:240].view(2, l, 3, 40),
                       wide[..., 240:].view(2, l, 3, 56))
                yield (lambda t=qkv, n=n: k1.encoder_attention(*t, valid_len=n),
                       lambda t=qkv, n=n: k1.encoder_attention_reference(*t, n),
                       abs_v(k1.encoder_attention_reference, *qkv, n))

    for dtype in (torch.bfloat16, torch.float32):
        edge_gate("edge prefixes (valid_len 1, L-1, L at L = 17, 130, 1608; strided; Dv != D)",
                  list(edge_cases(dtype)))
    return results


# (M, K, N) of the mmE5-11B text stack at 8 crops × 64 prompt tokens, and
# how often each runs per embed chunk (32 Llama + 8 cross-attention layers)
K2_SHAPES = {
    "q,o (512,4096)x(4096,4096)": ((512, 4096, 4096), 80),
    "k,v (512,4096)x(4096,1024)": ((512, 4096, 1024), 64),
    "gate,up (512,4096)x(4096,14336)": ((512, 4096, 14336), 80),
    "down (512,14336)x(14336,4096)": ((512, 14336, 4096), 40),
    "cross k,v (12808,4096)x(4096,1024)": ((12808, 4096, 1024), 16),
}
K2_HEADLINE = "gate,up (512,4096)x(4096,14336)"
# (M, K, N) the mmE5-11B storage forms add: the int8 tower at 8 crops x 1608
# tokens (q, k, v, o, fc1, fc2 in each of its 40 layers), and the text stack
# at text_chunk=16 (16 crops x 64 tokens; cross k,v over 16 x 1601 vision
# tokens)
K2_MME5_SHAPES = {
    "tower q,k,v,o (12864,1280)x(1280,1280)": (12864, 1280, 1280),
    "tower fc1 (12864,1280)x(1280,5120)": (12864, 1280, 5120),
    "tower fc2 (12864,5120)x(5120,1280)": (12864, 5120, 1280),
    "text_chunk=16 q,o (1024,4096)x(4096,4096)": (1024, 4096, 4096),
    "text_chunk=16 k,v (1024,4096)x(4096,1024)": (1024, 4096, 1024),
    "text_chunk=16 gate,up (1024,4096)x(4096,14336)": (1024, 4096, 14336),
    "text_chunk=16 down (1024,14336)x(14336,4096)": (1024, 14336, 4096),
    "text_chunk=16 cross k,v (25616,4096)x(4096,1024)": (25616, 4096, 1024),
}
# each tower layer's projections: q, k, v, o at the first shape, fc1, fc2
TOWER_COUNTS = {"q,k,v,o": 4, "fc1": 1, "fc2": 1}


def tower_chunk_ms(results) -> float:
    """One 8-crop tower chunk's projections (40 layers) from the medians at
    the tower shapes in ``results``."""
    return 40 * sum(results[name]["ms"] * count for part, count in TOWER_COUNTS.items()
                    for name in results if name.startswith(f"tower {part} "))


# (M, K, N, byte offset of x, what) of the wgmma form's edges, and one
# shape the rule sends to the mma.sync form
K2_WGMMA_EDGES = (
    (5, 1024, 256, 0, "M = 5: TMA zero-fills 123 of the tile's rows"),
    (129, 512, 384, 0, "M = 129: a second M tile of one row"),
    (300, 512, 48, 0, "N = 48 < 128: the pair's second tile past N"),
    (200, 1024, 1040, 0, "N = 1040: a last N tile of 16 columns"),
    (64, 200, 256, 0, "K = 200: a last chunk of 72 rows"),
    (1200, 512, 4736, 0, "370 tiles, more than the card's CTAs"),
    (256, 2048, 512, 0, "8 tiles over 16 chunks, each cut across CTAs"),
    (600, 20488, 1040, 0, "256-row tiles: M = 600, N = 1040, a last chunk of 8 rows, "
     "tiles cut across CTAs"),
    (64, 1024, 256, 8, "x 8 bytes off: the mma.sync form"),
)


def int8_library(x, q, scale):
    """``torch._weight_int8pack_mm`` on these operands, as library context:
    it takes the weight as (N, K) and bf16 scales, so its rounding is not
    K2's. None where the card's torch has no CUDA kernel for it."""
    import torch

    wt, sb = q.t().contiguous(), scale.to(torch.bfloat16)
    try:
        torch._weight_int8pack_mm(x, wt, sb)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        print(f"  torch._weight_int8pack_mm: none on this card ({str(e).splitlines()[0][:120]})")
        return None
    ms = median_ms(lambda: torch._weight_int8pack_mm(x, wt, sb))
    del wt, sb
    return ms


def int8_checks(k2) -> dict:
    """K2 against its plain version at the text stack's shapes."""
    import torch

    phase("7. K2 against its plain version (mmE5-11B text shapes)")
    for tile_m, chunk in k2._WG_CHUNK.items():
        consts = k2.wgmma_constants(tile_m)
        print(f"K2 wgmma form: tile {consts[0]}x{consts[1]}, chunk {consts[2]} rows, "
              f"cluster {consts[3]}, {consts[4]} stages; "
              f"{k2.wgmma_resident(tile_m)} resident CTAs")
        check(consts[:4] == (tile_m, k2._WG_TILE_N, chunk, k2._WG_CLUSTER),
              f"the plan's constants differ from the kernel's {consts}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")

    def run(name, m, k, n, dtype, timed, offset=0, same_bits=False, cut=False, library=True):
        buf = torch.randn((m * k + offset // 2,), generator=gen, device=dev).to(dtype)
        x = buf[offset // 2:].view(m, k)
        q = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        scale = (torch.rand((n,), generator=gen, device=dev) + 0.5) * (0.02 / 127)
        form, launcher = k2.form_for(x, q, scale), k2.launcher_form(x, q, scale)
        check(form == launcher, f"{name}: the Python rule says {form}, the launcher {launcher}")
        got = k2.int8_matmul(x, q, scale)
        if same_bits:  # deterministic: a second call gives the same bits
            check(torch.equal(got, k2.int8_matmul(x, q, scale)), f"{name}: two calls differ")
        plan_note = ""
        if form == "wgmma":
            plan = k2.plan_for(x, q)
            check(plan.cut_groups() > 0 or not cut, f"{name}: no tile is cut across CTAs")
            sizes = [b - a for a, b in map(plan.share, range(plan.sets))]
            plan_note = (f" plan: {plan.mt}x{plan.nt} tiles of {plan.tile_m} rows, "
                         f"{plan.groups} groups x {plan.nchunks} chunks in {plan.seqs} "
                         f"sequence(s) over {plan.clusters} clusters ({min(sizes)}-{max(sizes)} "
                         f"units), {plan.cut_groups()} groups cut")
        want = k2.int8_matmul_reference(x, q, scale)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == (m, n), f"{name}: {got.dtype} {got.shape}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = (got.float() - want.float()).abs()
        order = 2 * k * 2.0**-24 * (x.float().abs() @ q.float().abs()) * scale.abs()
        allowed = order + (MAX_BF16_STEPS * bf16_step(want) if dtype == torch.bfloat16 else 0)
        ratio = (err / allowed).max().item()
        check(ratio <= 1.0, f"{name}: error {ratio:.3g}× its bound")
        max_err, mean_err = err.max().item(), err.mean().item()
        note = ""
        if dtype == torch.bfloat16:
            share = mean_err / bf16_step(want).mean().item()
            check(share <= K2_MEAN_STEP_SHARE,
                  f"{name}: mean err {share:.3g} of a bf16 step > {K2_MEAN_STEP_SHARE}")
            note = f" mean/step {share:.2e}"
        out = {"max_abs_err": max_err, "mean_abs_err": mean_err, "bound_share": ratio,
               "form": form, "tile_m": plan.tile_m if form == "wgmma" else None}
        line = (f"{name} {str(dtype).split('.')[-1]} [{form}"
                f"{', bit-equal twice' if same_bits else ''}]: max_abs_err {max_err:.3e} "
                f"mean_abs_err {mean_err:.3e}{note} err/allowed {ratio:.3f}{plan_note}")
        if timed:
            w = q.to(dtype)
            out["ms"] = median_ms(lambda: k2.int8_matmul(x, q, scale))
            out["device_ms"] = device_ms([lambda: k2.int8_matmul(x, q, scale)] * 20)
            out["plain_ms"] = median_ms(lambda: k2.int8_matmul_reference(x, q, scale), runs=10)
            out["cublas_ms"] = median_ms(lambda: x @ w)
            del w
            out["library_ms"] = (int8_library(x, q, scale)
                                 if dtype == torch.bfloat16 and library else None)
            out["bound_ms"], out["bound_by"] = bound_ms(
                2.0 * m * k * n,
                m * k * x.element_size() + k * n + 4 * n + m * n * x.element_size(),
                dtype,
            )
            lib = out["library_ms"]
            line += (f" kernel {out['ms']:.4f} ms (back to back {out['device_ms']:.4f}) "
                     f"plain {out['plain_ms']:.4f} ms "
                     f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}) "
                     f"[context: cuBLAS bf16 x@W {out['cublas_ms']:.4f} ms; "
                     f"torch._weight_int8pack_mm {'none' if lib is None else f'{lib:.4f} ms'}]")
        print(line, flush=True)
        return out

    results = {}
    for name, ((m, k, n), _) in K2_SHAPES.items():
        results[name] = run(name, m, k, n, torch.bfloat16, timed=True,
                            same_bits=name.startswith(("gate,up", "k,v")))
        check(results[name]["form"] == "wgmma", f"{name}: took the {results[name]['form']} form")
    results["f32"] = run("k,v f32 (512,4096)x(4096,1024)", 512, 4096, 1024,
                         torch.float32, timed=True)
    for m, k, n in ((37, 200, 136), (1, 8, 16), (130, 72, 200), (300, 1000, 1030)):
        for dtype in (torch.bfloat16, torch.float32):
            run(f"ragged ({m},{k})x({k},{n})", m, k, n, dtype, timed=False)
    for m, k, n, offset, what in K2_WGMMA_EDGES:
        out = run(f"wgmma edge ({m},{k})x({k},{n}) x +{offset} B: {what}", m, k, n,
                  torch.bfloat16, timed=False, offset=offset, cut="cut" in what)
        check(out["form"] == ("mma_sync" if offset else "wgmma"),
              f"wgmma edge {what}: took the {out['form']} form")
        check(("256-row" in what) == (out["tile_m"] == 256),
              f"wgmma edge {what}: tiles of {out['tile_m']} rows")
    for name, (m, k, n) in K2_MME5_SHAPES.items():
        results[name] = run(name, m, k, n, torch.bfloat16, timed=True, same_bits=True,
                            library=False)
        check(results[name]["form"] == "wgmma", f"{name}: took the {results[name]['form']} form")
    kernel_sass("K2", k2.build_info(), wgmma="int8_mm_wgmma")
    print(f"K2 per int8 tower chunk (240 launches at M = 12864) from these medians: "
          f"{tower_chunk_ms(results):.2f} ms")

    def per_chunk(key):
        return sum(results[s][key] * count for s, (_, count) in K2_SHAPES.items())

    print(f"K2 per embed chunk (280 launches) from these medians: {per_chunk('ms'):.2f} ms "
          f"(back to back {per_chunk('device_ms'):.2f} ms; bound {per_chunk('bound_ms'):.2f} ms)")
    return results


# profile_run's families: trace_analysis' categories, the rest as other
PROFILE_FAMILIES = ("K1 enc_attn", "K2 int8_mm", "K3 int4", "K4 flash", "K5 conv3x3",
                    "K6 ln_mm", "K7 ln_stats", "GEMM (cuBLAS)", "conv (cuDNN)", "other")


def profile_run(label: str, run) -> None:
    """Device time of ``run()`` by kernel family: a ``torch.profiler``
    Chrome trace (``utils/profiling.py::trace``) read by
    ``utils/trace_analysis.py``."""
    import tempfile

    import torch

    from multimodal_embeddings_tpu_torch.utils import profiling, trace_analysis

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as trace:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        stats = trace_analysis.aggregate_kernels(trace.path)
    families = dict.fromkeys(PROFILE_FAMILIES, 0.0)
    counts = dict.fromkeys(PROFILE_FAMILIES, 0)
    for stat in stats:
        fam = stat.category if stat.category in families else "other"
        families[fam] += stat.total_us / 1e3
        counts[fam] += stat.count
    busy = sum(families.values())
    print(f"profiled {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(kernel time summed), idle {100 * (1 - busy / wall):.1f}%")
    for fam, t in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"  {fam}: {t:.1f} ms over {counts[fam]} launches ({100 * t / busy:.1f}%)")
    print("  largest kernels:")
    for stat in stats[:8]:
        print(f"    {stat.total_us / 1e3:9.1f} ms {stat.count:6d}x {stat.name[:100]}")


def mme5_launches(config, chunks: int, text_passes: int, prefix: bool = True) -> dict:
    """The launches of one mmE5 page of ``chunks`` vision chunks and
    ``text_passes`` text passes, derived from the modules: each text pass
    runs 7 projections in each of the text layers (q, k, v, o and gate, up,
    down in a Llama layer; q, k, v, o on the cross layers' two inputs and
    gate, up, down), each vision chunk 6 (q, k, v, o, fc1, fc2) in each of
    the tower's local and global layers and, on the key-prefix route, K1
    once per tower layer; the detect half runs K1 packed once. The
    projector stays float."""
    from multimodal_embeddings_tpu_torch.models.mme5 import split_quantize

    vision_q, text_q = split_quantize(config.quantize)
    v, t = config.vision, config.text
    want = {"encoder_attention_blf_packed": 1}
    if prefix:
        want["encoder_attention"] = (v.layers + v.global_layers) * chunks
    for q, n in ((text_q, 7 * t.layers * text_passes),
                 (vision_q, 6 * (v.layers + v.global_layers) * chunks)):
        if q:
            name = "int4_matmul" if q == "int4" else "int8_matmul"
            want[name] = want.get(name, 0) + n
    return want


def mme5_page(counters, detector, config, title: str, profile: bool = True):
    """One mmE5-11B storage's page at full width (48 crops at 560 px in
    chunks of 8, random weights from seed 0 drawn on the card); returns its
    launches per page, the last page's crops and embeddings, the embedder,
    its pages and the mean ms per page."""
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.mllama_processor import IMAGE_MEAN, IMAGE_STD
    from multimodal_embeddings_tpu_torch.models.quantized import param_bytes
    from multimodal_embeddings_tpu_torch.pipeline.fused import build_split_page_fn

    phase(title)
    t0 = time.perf_counter()
    embedder = MultimodalEmbedder(
        EmbedderConfig(family="mme5", dtype="bfloat16", quantize=config.quantize),
        model_config=config, device="cuda", seed=0,
    )
    fn = build_split_page_fn(
        detector, embedder, PAGE_HW, num_regions=NUM_REGIONS, embed_chunk=MME5_CHUNK
    )
    pages = make_pages(1 + MME5_TIMED_PAGES)
    torch.cuda.synchronize()
    nbytes = param_bytes(embedder.model)
    print(f"set-up (random init on the card): {time.perf_counter() - t0:.1f} s; "
          f"quantize={config.quantize!r}; embedder parameters {nbytes / 1e9:.3f} GB "
          f"({nbytes} bytes)")

    t0 = time.perf_counter()
    fn(pages[0])
    torch.cuda.synchronize()
    print(f"warm-up page: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    page_ms, results = [], []
    for page in pages[1:]:
        t0 = time.perf_counter()
        res = fn(page)
        torch.cuda.synchronize()
        page_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    launches = counts(counters)
    peak = torch.cuda.max_memory_allocated()
    chunks = NUM_REGIONS // MME5_CHUNK
    per_page = mme5_launches(config, chunks, chunks)
    want = only(counters, {k: c * MME5_TIMED_PAGES for k, c in per_page.items()})
    check(launches == want, f"launches {launches} != {want}")
    for res in results:
        check_page(res, config.text.hidden)
    print(f"ms/page {statistics.mean(page_ms):.1f} (pages: "
          + ", ".join(f"{x:.1f}" for x in page_ms) + ")")
    print(f"valid regions per page: {[int(r.valid.sum()) for r in results]}")
    print(f"launches per page: " + ", ".join(
        f"{k} {c // MME5_TIMED_PAGES}" for k, c in launches.items() if c))
    print(f"peak device memory: {peak / 2**30:.2f} GiB")

    # the three stages of the same path, timed apart
    mean = torch.tensor(IMAGE_MEAN, device="cuda")
    std = torch.tensor(IMAGE_STD, device="cuda")
    model = embedder.model
    det_ms, vis_ms, txt_ms = [], [], []
    with torch.inference_mode():
        for page in pages[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *_, crops = fn.detect(page)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            states = [
                model.encode_vision((crops[i : i + MME5_CHUNK] - mean.to(crops.dtype))
                                    / std.to(crops.dtype))
                for i in range(0, NUM_REGIONS, MME5_CHUNK)
            ]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ids = embedder.prompt_ids.expand(MME5_CHUNK, -1)
            mask = embedder.prompt_mask.expand(MME5_CHUNK, -1)
            embs = torch.cat([model.embed_from_vision(ids, mask, *s) for s in states])
            torch.cuda.synchronize()
            det_ms.append((t1 - t0) * 1e3)
            vis_ms.append((t2 - t1) * 1e3)
            txt_ms.append((time.perf_counter() - t2) * 1e3)
    print(f"detect+crop {statistics.mean(det_ms):.1f} ms/page, vision tower "
          f"{statistics.mean(vis_ms):.1f} ms/page, text stack {statistics.mean(txt_ms):.1f} "
          f"ms/page")
    if profile:
        profile_run("page", lambda: fn(pages[-1]))
    launches = {k: c // MME5_TIMED_PAGES for k, c in launches.items()}
    return launches, crops, embs, embedder, pages, statistics.mean(page_ms)


def mme5_text_chunk_page(counters, detector, embedder, pages, coupled_ms) -> dict:
    """Phase 8's model and pages with the text stack decoupled: the vision
    tower at 8 crops a call, the text stack at ``MME5_TEXT_CHUNK``."""
    import torch

    from multimodal_embeddings_tpu_torch.pipeline.fused import build_split_page_fn

    phase(f"8b. phase 8's mmE5 page with text_chunk={MME5_TEXT_CHUNK}")
    fn = build_split_page_fn(detector, embedder, PAGE_HW, num_regions=NUM_REGIONS,
                             embed_chunk=MME5_CHUNK, text_chunk=MME5_TEXT_CHUNK)
    coupled = build_split_page_fn(detector, embedder, PAGE_HW, num_regions=NUM_REGIONS,
                                  embed_chunk=MME5_CHUNK)
    fn(pages[0])
    torch.cuda.synchronize()
    zero(counters)
    page_ms, results = [], []
    for page in pages[1:]:
        t0 = time.perf_counter()
        results.append(fn(page))
        torch.cuda.synchronize()
        page_ms.append((time.perf_counter() - t0) * 1e3)
    launches = counts(counters)
    per_page = mme5_launches(embedder.model_config, NUM_REGIONS // MME5_CHUNK,
                             NUM_REGIONS // MME5_TEXT_CHUNK)
    want = only(counters, {k: c * MME5_TIMED_PAGES for k, c in per_page.items()})
    check(launches == want, f"launches {launches} != {want}")
    for res in results:
        check_page(res, embedder.model_config.text.hidden)
    *_, crops = fn.detect(pages[-1])
    got, ref = fn.embed(crops), coupled.embed(crops)
    cos = cosines(got, ref)
    print(f"ms/page {statistics.mean(page_ms):.1f} (pages: "
          + ", ".join(f"{x:.1f}" for x in page_ms) + f"); phase 8's coupled page "
          f"{coupled_ms:.1f} in this run")
    print(f"launches per page: " + ", ".join(
        f"{k} {c // MME5_TIMED_PAGES}" for k, c in launches.items() if c))
    print(f"each region against the coupled path on the same crops: cosine min "
          f"{cos.min().item():.6f}, largest difference "
          f"{(got - ref).abs().max().item():.3e}")
    check(bool((cos >= COSINE_MIN).all()), f"text_chunk cosine {cos.min()} < {COSINE_MIN}")
    return {k: c // MME5_TIMED_PAGES for k, c in launches.items()}


def mme5_tiles4_page(counters, detector, embedder) -> dict:
    """Phase 8's model on 4-tile crops: ``MME5_TILES4_REGIONS`` regions
    cropped at 1120 px, each fed as its (2, 2) canvas, ``MME5_TILES4_CHUNK``
    crops a call."""
    import torch

    from multimodal_embeddings_tpu_torch.pipeline.fused import (
        build_fused_page_fn,
        build_split_page_fn,
    )

    n, chunk = MME5_TILES4_REGIONS, MME5_TILES4_CHUNK
    phase(f"8c. phase 8's mmE5 model on 4-tile crops: {n} regions at "
          f"{2 * embedder.image_size} px, "
          f"embed_chunk={chunk}")
    fn = build_split_page_fn(detector, embedder, PAGE_HW, num_regions=n, embed_chunk=chunk,
                             embed_tiles=4)
    pages = make_pages(2)
    t0 = time.perf_counter()
    fn(pages[0])
    torch.cuda.synchronize()
    print(f"warm-up page: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    t0 = time.perf_counter()
    res = fn(pages[1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = counts(counters)
    peak = torch.cuda.max_memory_allocated()
    want = only(counters, mme5_launches(embedder.model_config, n // chunk, n // chunk,
                                        prefix=False))
    check(launches == want, f"launches {launches} != {want}")
    emb = res.embeddings
    hidden = embedder.model_config.text.hidden
    check(tuple(emb.shape) == (n, hidden), f"embeddings {tuple(emb.shape)}")
    check(bool(torch.isfinite(emb).all()), "non-finite embeddings")
    norms = emb.norm(dim=-1)
    check(bool(((norms - 1).abs() < 1e-3).all()), f"embedding norms {norms}")
    fused = build_fused_page_fn(detector, embedder, PAGE_HW, num_regions=n, embed_chunk=chunk,
                                embed_tiles=4)(pages[1]).embeddings
    cos = cosines(fused, emb)
    print(f"ms/page {ms:.1f} ({n} regions); launches per page: " + ", ".join(
        f"{k} {c}" for k, c in launches.items() if c))
    print(f"peak device memory: {peak / 2**30:.2f} GiB")
    print(f"build_fused_page_fn(embed_tiles=4, embed_chunk={chunk}) against the split form, "
          f"same page: cosine min {cos.min().item():.6f}")
    check(bool((cos >= COSINE_MIN).all()), f"fused vs split cosine {cos.min()}")
    return launches


def mme5_engine_api(counters, embedder) -> dict:
    """Phase 8's model through the host API: ``get_image_embeddings`` at
    batch size ``MME5_API_BATCH`` on images of 1, 2 and 4 tiles and a path
    that does not exist, and ``get_text_embeddings``."""
    import tempfile

    import numpy as np
    import torch

    from multimodal_embeddings_tpu_torch.models.mllama_processor import preprocess_image
    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    phase(f"8d. the engine's host API on phase 8's model (batch_size={MME5_API_BATCH})")
    rng = np.random.default_rng(0)
    size = embedder.image_size
    square = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    tall = rng.integers(0, 256, size=(2 * size, size, 3), dtype=np.uint8)
    page = make_page(*PAGE_HW, seed=0)
    tiles = [preprocess_image(im, embedder.max_tiles, embedder.image_size).num_tiles
             for im in (square, tall, page)]
    check(tiles == [1, 2, 4], f"tiles per image {tiles}")
    with tempfile.TemporaryDirectory() as tmp:
        images = [square, tall, page, os.path.join(tmp, "missing.png")]
        embedder.get_image_embeddings(images[:1], batch_size=MME5_API_BATCH)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero(counters)
        t0 = time.perf_counter()
        embs = embedder.get_image_embeddings(images, batch_size=MME5_API_BATCH)
        torch.cuda.synchronize()
        image_ms = (time.perf_counter() - t0) * 1e3 / 3
        launches = counts(counters)
    peak = torch.cuda.max_memory_allocated()
    # the text stack once per batch of images; the tower's attention masked
    want = mme5_launches(embedder.model_config, 0, -(-3 // MME5_API_BATCH), prefix=False)
    del want["encoder_attention_blf_packed"]  # no detect half
    check(launches == only(counters, want), f"launches {launches} != {want}")
    check(embs[3] is None, "the missing path has an embedding")
    vecs = np.array(embs[:3])
    hidden = embedder.model_config.text.hidden
    check(vecs.shape == (3, hidden), f"embeddings {vecs.shape}")
    check(bool(np.isfinite(vecs).all()), "non-finite embeddings")
    norms = np.linalg.norm(vecs, axis=-1)
    check(bool((np.abs(norms - 1) < 1e-3).all()), f"embedding norms {norms}")
    one = torch.from_numpy(preprocess_image(square, embedder.max_tiles,
                                            embedder.image_size).tiles[:1]).cuda()
    single = embedder.encode_image(one).cpu()  # one tile, K1 with the key prefix
    cos = cosines(torch.from_numpy(vecs[:1]), single)
    t0 = time.perf_counter()
    text_one = embedder.get_text_embeddings("a scanned newspaper page")
    texts = embedder.get_text_embeddings(["the front page", "a photograph with a caption"])
    torch.cuda.synchronize()
    text_ms = (time.perf_counter() - t0) * 1e3 / 3
    tnorms = np.linalg.norm(np.array([text_one] + texts), axis=-1)
    check(len(text_one) == hidden and len(texts) == 2, "text embedding shapes")
    check(bool((np.abs(tnorms - 1) < 1e-3).all()), f"text embedding norms {tnorms}")
    print(f"get_image_embeddings: {image_ms:.1f} ms per image (3 images of 1, 2 and 4 tiles "
          f"and a missing path, batches of {MME5_API_BATCH}); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches: " + ", ".join(
              f"{k} {c}" for k, c in launches.items() if c))
    print(f"the {size}x{size} image against encode_image of its one preprocessed tile: cosine "
          f"{cos.item():.6f}; get_text_embeddings {text_ms:.1f} ms per text")
    check(cos.item() >= COSINE_MIN, f"one-tile cosine {cos.item()} < {COSINE_MIN}")
    return launches


def mme5_storage_pages(counters, detector) -> dict:
    """Phase 14: the full-width page on each further storage, one model at
    a time; returns the launches per page by storage."""
    import gc

    import torch

    from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig

    out = {}
    for label, config in (("int4", MllamaConfig.mme5_11b_int4()),
                          ("int4-mixed", dataclasses.replace(MllamaConfig.mme5_11b(),
                                                             quantize="int4-mixed")),
                          ("int8", MllamaConfig.mme5_11b_int8())):
        launches, *_, embedder, _, _ = mme5_page(
            counters, detector, config, f"14. full-width mmE5-11B {label} page program",
            profile=label == "int4")
        out[label] = launches
        del embedder
        gc.collect()
        torch.cuda.empty_cache()
    return out


def reduced_mme5(config):
    """The 11B widths at 2 local + 1 global tower layers and 2 text layers
    (one Llama, one cross-attention)."""
    return dataclasses.replace(
        config,
        vision=dataclasses.replace(config.vision, layers=2, global_layers=1,
                                   intermediate_layers=(0, 1)),
        text=dataclasses.replace(config.text, layers=2, cross_attn_layers=(1,)),
    )


def normalised(crops):
    import torch

    from multimodal_embeddings_tpu_torch.models.mllama_processor import IMAGE_MEAN, IMAGE_STD

    mean = torch.tensor(IMAGE_MEAN, device=crops.device, dtype=crops.dtype)
    std = torch.tensor(IMAGE_STD, device=crops.device, dtype=crops.dtype)
    return (crops - mean) / std


def mme5_card_vs_cpu(crops, config) -> dict:
    """Phase 9: each storage at the 11B widths and reduced depth, built on
    the CPU in f32 from one float tree (drawn once from a seed on the card:
    2-3 s on an H100, 36 s on its machine's CPU; quantized at load
    for each storage) and carried to the card in bf16 through the bridge;
    two crops, card against CPU. Returns the float tree, which phase 15
    loads again."""
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.weights import export_jax_params

    phase("9. mmE5: card (bf16) against the CPU (f32, plain kernels), per storage")
    t0 = time.perf_counter()
    source = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32"),
                                model_config=reduced_mme5(dataclasses.replace(
                                    config, quantize=False)),
                                device="cuda", seed=0)
    flat = export_jax_params(source.model)
    del source
    gc_cuda()
    print(f"float tree: {len(flat)} leaves, {sum(v.nbytes for v in flat.values()) / 1e9:.2f} "
          f"GB f32 ({time.perf_counter() - t0:.1f} s)")
    two = crops[:2]
    for quantize in ("int8-mixed", True, "int4", "int4-mixed"):
        reduced = reduced_mme5(dataclasses.replace(config, quantize=quantize))
        t0 = time.perf_counter()
        cpu = MultimodalEmbedder(
            EmbedderConfig(family="mme5", dtype="float32", quantize=quantize),
            model_config=reduced, device="cpu", params=flat,
        )
        gpu = MultimodalEmbedder(
            EmbedderConfig(family="mme5", dtype="bfloat16", quantize=quantize),
            model_config=reduced, device="cuda", params=export_jax_params(cpu.model),
        )
        got = gpu.encode_image(normalised(two))
        ref = cpu.encode_image(normalised(two.float().cpu()))
        cos = torch.nn.functional.cosine_similarity(got.float().cpu(), ref, dim=-1)
        print(f"quantize={quantize!r}: set-up (CPU f32 build from the float tree, bridge to "
              f"the card in bf16) {time.perf_counter() - t0:.1f} s; cosine card vs cpu: "
              f"{[round(c, 6) for c in cos.tolist()]}")
        check(bool((cos >= COSINE_MIN).all()), f"{quantize!r}: cosine {cos.tolist()} "
              f"< {COSINE_MIN}")
        del cpu, gpu
    return flat


def mme5_float_checkpoint(crops, config, flat) -> None:
    """Phase 15: phase 9's float tree at the 11B widths and reduced depth,
    loaded into an int4 and an int8 model with the CPU and with the card as
    the target (quantized at load on each)."""
    import torch

    from multimodal_embeddings_tpu_torch.config import EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder

    phase("15. a float checkpoint quantized at load: card against CPU")
    float_config = reduced_mme5(dataclasses.replace(config, quantize=False))
    print(f"phase 9's float tree: {len(flat)} leaves, "
          f"{sum(v.nbytes for v in flat.values()) / 1e9:.2f} GB f32")
    two = crops[:2]
    for quantize in ("int4", "int8"):
        cfg = dataclasses.replace(float_config, quantize=quantize)
        t0 = time.perf_counter()
        cpu = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32",
                                                quantize=quantize),
                                 model_config=cfg, device="cpu", params=flat)
        t1 = time.perf_counter()
        gpu = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="bfloat16",
                                                quantize=quantize),
                                 model_config=cfg, device="cuda", params=flat)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        gpu_params = dict(gpu.model.named_parameters())
        stored = [(name, p) for name, p in cpu.model.named_parameters()
                  if not p.is_floating_point() or name.endswith("kernel_scale")]
        check(any(not p.is_floating_point() for _, p in stored), f"{quantize}: nothing quantized")
        unequal = [name for name, p in stored if not torch.equal(p, gpu_params[name].cpu())]
        check(not unequal, f"{quantize}: card and CPU quantized differently at {unequal[:5]}")
        got = gpu.encode_image(normalised(two))
        ref = cpu.encode_image(normalised(two.float().cpu()))
        cos = torch.nn.functional.cosine_similarity(got.float().cpu(), ref, dim=-1)
        print(f"{quantize}: {len(stored)} quantized leaves (values and scales) EQUAL between "
              f"the card's and the CPU's build (CPU build {t1 - t0:.1f} s, card build "
              f"{t2 - t1:.1f} s); cosine card vs cpu {[round(c, 6) for c in cos.tolist()]}")
        check(bool((cos >= COSINE_MIN).all()), f"{quantize}: cosine {cos.tolist()}")
        del cpu, gpu, gpu_params


# K4 against its plain version: both round p to bf16 against the same
# per-128-key running max, but their f32 scores differ in the last bits
# (other summation orders), so a p near a rounding boundary may round to
# the neighbouring bf16 value, moving the output by up to 2^-8·p·|v|/sum.
# Where a few keys dominate a row and their values cancel, that is many
# steps of the output's own magnitude (H100 readings: 1 step at L <= 127,
# up to 88,272 steps at |o| ~ 1e-5 at the causal text shape). So the gate
# is, per output, 2 bf16 steps at |o| plus 2^-7 of the attention-weighted
# mean of |v| (every p of the row flipping at once would move it 2^-8 of
# that), and a mean error under 5% of the mean bf16 step: flips are rare,
# a systematic fault (a whole-row max, an unrounded p in PV, a wrong row)
# moves a large share of the outputs by a step or more.
K4_MEAN_STEP_SHARE = 0.05
QWEN_VISION_ATTN = (1, 4960, 16, 16, 80, 80)  # B, L, H, KVH, Dk, Dv
QWEN_TEXT_ATTN = (1, 2560, 40, 8, 128, 128)


def flash_bound(b, l, h, kvh, dk, dv, lengths, causal, dtype) -> tuple:
    """K4's work for this run's data: QK and PV over the keys each query
    row attends (below its length, and at or before it when causal); q and
    o over the H query heads, k and v over the KVH heads, each once."""
    import torch

    elem = torch.finfo(dtype).bits // 8
    pairs = 0
    for n in lengths:
        pairs += sum(min(n, i + 1) for i in range(l)) if causal else l * n
    flops = 2.0 * h * pairs * (dk + dv)
    nbytes = elem * b * l * (h * dk + kvh * dk + kvh * dv + h * dv)
    return bound_ms(flops, nbytes, dtype)


def flash_compare(k4, name, q, k, v, lengths, causal, timed, v2=False) -> dict:
    """K4 (``v2``: on its K/V-resident schedule) against its plain version
    on the same inputs, and with ``v2`` EQUAL to K4 v1 bit for bit; with
    ``timed``, the kernel's, the plain version's and SDPA's median times and
    the bound, and with ``v2`` K4 v1's time."""
    import torch
    import torch.nn.functional as F

    kernel = k4.flash_attention_v2 if v2 else k4.flash_attention
    got = kernel(q, k, v, lengths=lengths, causal=causal)
    want = k4.flash_attention_reference(q, k, v, lengths, causal)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == q.dtype, f"{name}: {got.shape} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got.float() - want.float()).abs()
    out = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item()}
    note = ""
    if q.dtype == torch.bfloat16:
        plan = k4.plan_for(q, k, v, v2=v2)
        print(f"  plan {name}: paths {'/'.join(plan.paths)} stages {plan.stages} "
              f"C {plan.cluster} S {plan.splits} ({plan.smem} B shared)")
    if v2:
        v1_out = k4.flash_attention(q, k, v, lengths=lengths, causal=causal)
        torch.cuda.synchronize()
        differ = int((got != v1_out).sum())
        check(differ == 0, f"{name}: {differ} outputs of v2 differ from v1's")
        note += " (v2 == v1 bit for bit)"
    if q.dtype == torch.bfloat16:
        weighted = k4.flash_attention_reference(q, k, v.abs(), lengths, causal).float()
        allowed = MAX_BF16_STEPS * bf16_step(want) + 2.0**-7 * weighted
        ratio = (err / allowed).max().item()
        share = out["mean_abs_err"] / bf16_step(want).mean().item()
        check(ratio <= 1.0, f"{name}: error {ratio:.3g}x its bound")
        check(share <= K4_MEAN_STEP_SHARE,
              f"{name}: mean err {share:.3g} of a bf16 step > {K4_MEAN_STEP_SHARE}")
        note = (f" ({bf16_steps(got, want):g} bf16 steps at |o|, err/allowed {ratio:.3f}, "
                f"mean/step {share:.2e})") + note
    else:
        check(out["max_abs_err"] <= ATOL_F32_MAX,
              f"{name}: max err {out['max_abs_err']} > {ATOL_F32_MAX}")
    line = f"{name}: max_abs_err {out['max_abs_err']:.3e}{note}"
    if timed:
        b, l, h, dk = q.shape
        kvh, dv = k.shape[2], v.shape[3]
        lens = [l] * b if lengths is None else [min(int(n), l) for n in lengths.tolist()]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if lengths is not None:
            mask = (torch.arange(l, device=q.device)[None, :] < lengths[:, None])[:, None, None]
        out["ms"] = median_ms(lambda: kernel(q, k, v, lengths=lengths, causal=causal))
        if v2:
            out["v1_ms"] = median_ms(
                lambda: k4.flash_attention(q, k, v, lengths=lengths, causal=causal))
        out["plain_ms"] = median_ms(
            lambda: k4.flash_attention_reference(q, k, v, lengths, causal), runs=5)
        out["library_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal, enable_gqa=kvh != h))
        out["bound_ms"], out["bound_by"] = flash_bound(b, l, h, kvh, dk, dv, lens, causal,
                                                       q.dtype)
        line += (f" kernel {out['ms']:.4f} ms plain {out['plain_ms']:.3f} ms "
                 f"sdpa {out['library_ms']:.4f} ms bound {out['bound_ms']:.4f} ms "
                 f"({out['bound_by']})")
        if v2:
            line += f" [K4 v1 {out['v1_ms']:.4f} ms]"
    print(line, flush=True)
    return out


def flash_checks(k4) -> dict:
    """K4 against its plain version at the Qwen shapes and edge cases."""
    import torch

    phase("10. K4 flash attention against its plain version (Qwen shapes)")
    gen = torch.Generator(device="cuda").manual_seed(10)
    dev = torch.device("cuda")

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    results = {}
    b, l, h, kvh, dk, dv = QWEN_VISION_ATTN
    # q and k are the rotated tensors, v a strided slice of the fused qkv
    qkv = randn(b, l, 3, h, dk)
    results["vision"] = flash_compare(
        k4, f"vision ({b},{l},{h},{dk}) bf16", randn(b, l, h, dk), randn(b, l, h, dk),
        qkv[:, :, 2], None, False, timed=True)
    b, l, h, kvh, dk, dv = QWEN_TEXT_ATTN
    results["text"] = flash_compare(
        k4, f"text causal ({b},{l},{h}/{kvh},{dk}) bf16", randn(b, l, h, dk),
        randn(b, l, kvh, dk), randn(b, l, kvh, dv), None, True, timed=True)
    # edges: ragged L against the 64-row and 128-key tiles, lengths 1, L-1
    # and L, Dk != Dv, GQA, causal, f32
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for l in (1, 127, 129, 4960):
        for causal in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                lens = sorted({1, max(1, l - 1), l})
                lengths = torch.tensor([lens[i % len(lens)] for i in range(2)],
                                       dtype=torch.int32, device=dev)
                res = flash_compare(
                    k4, f"edge L={l} causal={causal} lengths={lengths.tolist()} "
                        f"Dk=40 Dv=56 4/2 heads {str(dtype).split('.')[-1]}",
                    randn(2, l, 4, 40, dtype=dtype), randn(2, l, 2, 40, dtype=dtype),
                    randn(2, l, 2, 56, dtype=dtype), lengths, causal, timed=False)
                worst[dtype] = max(worst[dtype], res["max_abs_err"])
                if l == 4960 and dtype == torch.float32:
                    break  # one f32 pass at 4960 is enough (the f32 form is for checks)
    print(f"edge cases: max_abs_err bf16 {worst[torch.bfloat16]:.3e} "
          f"f32 {worst[torch.float32]:.3e}")
    flash_form_edges(k4, randn)
    return results


def flash_form_edges(k4, randn) -> None:
    """The edges of K4's bf16 forms, each through v1 and v2 (v2 EQUAL to v1):
    operands TMA cannot take, query tiles not a multiple of v2's cluster,
    causal at L = 129 and 4960, lengths 1, L−1 and L, GQA 40/8 at 128."""
    import torch

    def offset(*shape, elems):  # a view whose base is `elems` bf16 past an allocation
        return randn(math.prod(shape) + elems)[elems:].view(shape)

    def lengths(*n):
        return torch.tensor(n, dtype=torch.int32, device="cuda")

    cases = [
        ("cp.async q (base 8 bytes off)", offset(2, 300, 4, 64, elems=4), randn(2, 300, 4, 64),
         randn(2, 300, 4, 64), None, False),
        ("cp.async v (2-byte row stride)", randn(2, 300, 4, 80), randn(2, 300, 2, 80),
         randn(2, 300, 2, 81)[..., :80], lengths(299, 150), True),
        ("cp.async k and v (4-byte base)", randn(1, 257, 2, 40), offset(1, 257, 2, 40, elems=2),
         offset(1, 257, 2, 56, elems=2), None, False),
        ("9 query tiles (1,1100,2,80)", randn(1, 1100, 2, 80), randn(1, 1100, 2, 80),
         randn(1, 1100, 2, 80), None, False),
        ("causal L=129 GQA 4/2", randn(2, 129, 4, 80), randn(2, 129, 2, 80),
         randn(2, 129, 2, 80), None, True),
        ("causal L=4960 (1,4960,16,80)", randn(1, 4960, 16, 80), randn(1, 4960, 16, 80),
         randn(1, 4960, 16, 80), None, True),
        ("lengths 1, L-1, L (3,700,2,64)", randn(3, 700, 2, 64), randn(3, 700, 2, 64),
         randn(3, 700, 2, 64), lengths(1, 699, 700), False),
        ("lengths 1, L-1, L causal (3,700,2,64)", randn(3, 700, 2, 64), randn(3, 700, 2, 64),
         randn(3, 700, 2, 64), lengths(1, 699, 700), True),
        ("GQA 40/8 Dk=Dv=128 (1,1000,40/8)", randn(1, 1000, 40, 128), randn(1, 1000, 8, 128),
         randn(1, 1000, 8, 128), lengths(999), False),
    ]
    for name, q, k, v, lens, causal in cases:
        flash_compare(k4, f"form edge {name}", q, k, v, lens, causal, timed=False)
        flash_compare(k4, f"form edge v2 {name}", q, k, v, lens, causal, timed=False, v2=True)
    plan = k4.plan_for(*cases[3][1:4], v2=True)
    check(-(-1100 // 128) % (plan.cluster * plan.splits) != 0,
          f"the 9-tile edge runs {plan.cluster}x{plan.splits} CTAs per head: not ragged")


# (M, K, N) of the Qwen2.5-VL-32B decoder: per layer q, o (5120, 5120),
# k, v (5120, 1024), gate, up (5120, 27648), down (27648, 5120); lm_head
# (5120, 152064) on the last position only. M = 1 per decode step, M = 1535
# for the prefill.
K3_SHAPES = {
    "q,o": (5120, 5120, 2), "k,v": (5120, 1024, 2), "gate,up": (5120, 27648, 2),
    "down": (27648, 5120, 1),
}
K3_PREFILL_M = 1535
# phase 12b's decoder rows: the continuous decode step runs every projection
# and the lm_head at M = 8, which takes K3's wgmma form (the GEMV takes M <= 4)
K3_DECODE_ROWS = 8
# (M, K, N) the mmE5-11B int4 forms add, all with groups of 128: the int4
# tower at 8 crops x 1608 tokens, and the text stack at 8 crops x 64 tokens
# (cross k,v over 8 x 1601 vision tokens)
K3_MME5_SHAPES = {
    "tower q,k,v,o (12864,1280)x(1280,1280)": (12864, 1280, 1280),
    "tower fc1 (12864,1280)x(1280,5120)": (12864, 1280, 5120),
    "tower fc2 (12864,5120)x(5120,1280)": (12864, 5120, 1280),
    "text q,o (512,4096)x(4096,4096)": (512, 4096, 4096),
    "text k,v (512,4096)x(4096,1024)": (512, 4096, 1024),
    "text gate,up (512,4096)x(4096,14336)": (512, 4096, 14336),
    "text down (512,14336)x(14336,4096)": (512, 14336, 4096),
    "text cross k,v (12808,4096)x(4096,1024)": (12808, 4096, 1024),
}
K3_HEADLINE = "decode gate,up (1,5120)x(5120,27648)"
# (M, K, N, n_groups, byte offset of packed, what) of the GEMV form's edges
K3_GEMV_EDGES = (
    (1, 5120, 1024, 40, 0, "M = 1"),
    (2, 5120, 1024, 40, 0, "M = 2"),
    (3, 5120, 1024, 40, 0, "M = 3"),
    (4, 5120, 1024, 40, 0, "M = 4"),
    (1, 5120, 1030, 40, 0, "N not a multiple of 16"),
    (3, 2048, 40, 16, 0, "N < 128"),
    (2, 200, 520, 1, 0, "one group of 100 packed rows"),
    (1, 16384, 16384, 128, 0, "shares cross tiles and cut them at group boundaries"),
    (1, 8, 16, 1, 0, "K so small that most row slices get no rows"),
    (4, 1024, 768, 8, 8, "packed 8 bytes off 16-byte alignment: element loads"),
    # groups wider than the kernel's x window (1,024 packed rows at M = 1, 512
    # at M = 2, 256 at M = 3-4): a group's rows are flushed and x restaged
    # mid-group
    (4, 2048, 520, 1, 0, "a group of 1,024 packed rows at M = 4"),
    (2, 4096, 256, 1, 0, "a group of 2,048 packed rows at M = 2"),
    (1, 8192, 300, 2, 0, "groups of 2,048 packed rows at M = 1"),
    (1, 20480, 300, 5, 0, "groups of 2,048 packed rows at M = 1, tiles cut across CTAs"),
)


# (M, K, N, n_groups, byte offset of packed, what) of the wgmma form's edges,
# and one shape the rule sends to the mma.sync form
K3_WGMMA_EDGES = (
    (5, 1024, 256, 8, 0, "M = 5: TMA zero-fills 123 of the tile's rows"),
    (129, 512, 384, 4, 0, "M = 129: a second M tile of one row"),
    (200, 1024, 1040, 8, 0, "N = 1040: a last N tile of 16 columns"),
    (300, 512, 48, 4, 0, "N = 48 < 128"),
    (64, 640, 256, 10, 0, "G = 64: chunks of 64 rows"),
    (300, 1024, 256, 4, 0, "G = 256: two chunks per group"),
    (150, 512, 256, 1, 0, "one group of 512 rows: four chunks"),
    (1200, 512, 4736, 4, 0, "370 tiles on persistent CTAs"),
    (64, 1024, 256, 8, 8, "packed 8 bytes off: the mma.sync form"),
)


def _short(name: str) -> str:
    """A kernel's mangled name cut to its function name and template
    arguments."""
    import re

    m = re.search(
        r"((?:int[48]|ln)_(?:mm_wgmma|mm_bf16|mm_f32|mm|gemv|stats)_kernel)(?:I(.*?)EEv)?", name)
    if m is None:
        return name
    args = (m.group(2) or "").replace("13__nv_bfloat16", "bf16").replace("Li", "")
    return f"{m.group(1)}<{args.replace('E', ',')}>" if args else m.group(1)


def kernel_sass(label: str, info, wgmma: str, gemv: str = "") -> None:
    """For every kernel of one library (``info``: its ``BuildInfo``):
    ``ptxas``'s registers and spills (from the build's report), and from the
    machine code (``cuobjdump -sass``, whose whole listing is written beside
    the built library, as ``<library>.sass``) the int-to-float conversions
    (``I2F``, ``I2FP``) and the warpgroup products (``HGMMA``). The kernels
    whose names hold ``wgmma`` (or ``gemv``, where given) have no conversion
    and spill nothing; the ``wgmma`` ones have HGMMA."""
    import re
    import shutil

    def no_conv(name):
        return wgmma in name or bool(gemv and gemv in name)

    for block in info.log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        spills = f"{spill.group(1)}/{spill.group(2)}" if spill else "?"
        print(f"  ptxas {_short(name)}: {regs.group(1) if regs else '?'} registers, "
              f"spill stores/loads {spills} bytes")
        if no_conv(name):
            check(spills == "0/0", f"{_short(name)} spills {spills} bytes")
    if not info.log:
        print("  ptxas report: not available (the library was built earlier)")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        print(f"{label} I2F/I2FP and HGMMA counts: not available (no cuobjdump)")
        return
    proc = subprocess.run([tool, "-sass", str(info.path)], capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"{label} I2F/I2FP and HGMMA counts: not available (cuobjdump {proc.returncode})")
        return
    info.path.with_suffix(".sass").write_text(proc.stdout)
    wgmma_seen = False
    for body in proc.stdout.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        conv = sum(op in ("I2F", "I2FP") for op in ops)
        hgmma = sum(op == "HGMMA" for op in ops)
        print(f"  {_short(name)}: {len(ops)} instructions, I2F/I2FP {conv}, HGMMA {hgmma}")
        if wgmma in name:
            wgmma_seen = True
            check(hgmma > 0 and conv == 0, f"{_short(name)}: HGMMA {hgmma}, I2F/I2FP {conv}")
        elif no_conv(name):
            check(conv == 0, f"{_short(name)}: I2F/I2FP {conv}")
    check(wgmma_seen, f"no wgmma-form kernel in {label}'s machine code")


def int4_checks(k3) -> dict:
    """K3 against its plain version at the 32B decoder's shapes."""
    import torch

    phase("11. K3 int4 matmul against its plain version (Qwen2.5-VL-32B shapes)")
    kernel_sass("K3", k3.build_info(), wgmma="wgmma", gemv="gemv")
    gen = torch.Generator(device="cuda").manual_seed(11)
    dev = torch.device("cuda")

    def operands(m, k, n, n_groups, dtype, offset=0):
        """``packed`` is a view ``offset`` bytes into a larger buffer."""
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        buf = torch.randint(0, 256, (k // 2 * n + offset,), generator=gen, device=dev,
                            dtype=torch.uint8)
        packed = buf[offset:].view(k // 2, n)
        scale = torch.randn((n_groups, n), generator=gen, device=dev) * 0.02
        return x, packed, scale

    def run(name, m, k, n, n_groups, dtype, timed, offset=0, same_bits=False, cut=False):
        x, packed, scale = operands(m, k, n, n_groups, dtype, offset)
        form, launcher = k3.form_for(x, packed, scale), k3.launcher_form(x, packed, scale)
        check(form == launcher, f"{name}: the Python rule says {form}, the launcher {launcher}")
        got = k3.int4_matmul(x, packed, scale)
        if same_bits:  # deterministic: a second call gives the same bits
            again = k3.int4_matmul(x, packed, scale)
            check(torch.equal(got, again), f"{name}: two calls differ")
        if m <= 4:
            plan = k3.plan_for(x, packed, scale)
            check(plan.cut_tiles() > 0 or not cut, f"{name}: no tile is cut across CTAs")
            sizes = [b - a for a, b in map(plan.share, range(plan.grid))]
            print(f"  GEMV plan: x rows {plan.mt}, {plan.tiles} tiles x {plan.n_groups} groups = "
                  f"{plan.units} units over {plan.grid} CTAs ({min(sizes)}-{max(sizes)} each), "
                  f"{plan.cut_tiles()} tiles cut" + (", bit-equal twice" if same_bits else ""))
        want = k3.int4_matmul_reference(x, packed, scale)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == (m, n), f"{name}: {got.dtype} {got.shape}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = (got.float() - want.float()).abs()
        w_abs = k3.dequantize_int4(k3.Q4Tensor(packed, scale), torch.float32).abs_()
        order = 2 * k * 2.0**-24 * (x.to(torch.bfloat16).float().abs() @ w_abs)
        del w_abs
        allowed = order + (MAX_BF16_STEPS * bf16_step(want) if dtype == torch.bfloat16 else 0)
        ratio = (err / allowed).max().item()
        check(ratio <= 1.0, f"{name}: error {ratio:.3g}x its bound")
        out = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
               "bound_share": ratio, "form": form}
        note = ""
        if dtype == torch.bfloat16:
            share = out["mean_abs_err"] / bf16_step(want).mean().item()
            check(share <= K2_MEAN_STEP_SHARE,
                  f"{name}: mean err {share:.3g} of a bf16 step > {K2_MEAN_STEP_SHARE}")
            note = f" mean/step {share:.2e}"
        line = (f"{name} {str(dtype).split('.')[-1]} [{form}"
                f"{', bit-equal twice' if same_bits and m > 4 else ''}]: "
                f"max_abs_err {out['max_abs_err']:.3e} "
                f"mean_abs_err {out['mean_abs_err']:.3e}{note} err/allowed {ratio:.3f}")
        if timed:
            w = k3.dequantize_int4(k3.Q4Tensor(packed, scale), dtype)
            if m <= K3_DECODE_ROWS:
                # device time of back-to-back launches over weight copies
                # totalling more than the 50 MB L2, as the decode step
                # streams 449 weights cold
                wbytes = packed.numel() + scale.numel() * 4
                copies = [(packed, scale)] + [
                    (packed.clone(), scale.clone())
                    for _ in range(-(-128 * 2**20 // wbytes) - 1)
                ]
                calls = [lambda p=p, s=s: k3.int4_matmul(x, p, s) for p, s in copies]
                out["ms"] = device_ms(calls * max(1, 64 // len(calls)))
                out["host_ms"] = median_ms(lambda: k3.int4_matmul(x, packed, scale))
                del copies, calls
            else:
                out["ms"] = median_ms(lambda: k3.int4_matmul(x, packed, scale))
            out["plain_ms"] = median_ms(lambda: k3.int4_matmul_reference(x, packed, scale),
                                        runs=5, warmup=1)
            out["cublas_ms"] = (device_ms([lambda: x @ w] * 32) if m <= K3_DECODE_ROWS
                                else median_ms(lambda: x @ w))
            del w
            out["bound_ms"], out["bound_by"] = bound_ms(
                2.0 * m * k * n,
                m * k * x.element_size() + k * n // 2 + 4 * n_groups * n
                + m * n * x.element_size(),
                torch.bfloat16,
            )
            line += (f" kernel {out['ms']:.4f} ms plain {out['plain_ms']:.3f} ms "
                     f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}) "
                     f"[context: cuBLAS bf16 x@W {out['cublas_ms']:.4f} ms]")
            if "host_ms" in out:
                line += f" one call from an idle card {out['host_ms']:.4f} ms"
        print(line, flush=True)
        return out

    results = {}
    for m in (1, K3_PREFILL_M):
        for label, (k, n, _) in K3_SHAPES.items():
            name = f"{'decode' if m == 1 else 'prefill'} {label} ({m},{k})x({k},{n})"
            results[name] = run(name, m, k, n, k // 128, torch.bfloat16, timed=True,
                                same_bits=label == "gate,up")
            if m > 4:
                check(results[name]["form"] == "wgmma", f"{name}: took the {results[name]['form']} form")
    name = "decode lm_head (1,5120)x(5120,152064)"
    results[name] = run(name, 1, 5120, 152064, 40, torch.bfloat16, timed=True,
                        same_bits=True)
    # the continuous decoder's step at B = 8 rows (phase 12b)
    rows = K3_DECODE_ROWS
    m8 = {}
    for label, (k, n, _) in (*K3_SHAPES.items(), ("lm_head", (5120, 152064, 1))):
        m8[label] = run(f"decode B={rows} {label} ({rows},{k})x({k},{n})", rows, k, n, k // 128,
                        torch.bfloat16, timed=True, same_bits=True)
        check(m8[label]["form"] == "wgmma", f"decode B={rows} {label}: took the "
              f"{m8[label]['form']} form")
    results["decode_m8"] = m8
    results["f32"] = run("f32 k,v (1535,5120)x(5120,1024)", K3_PREFILL_M, 5120, 1024, 40,
                         torch.float32, timed=True)
    for m, k, n, groups in ((37, 200, 136, 1), (1, 8, 16, 1), (130, 72, 200, 1),
                            (300, 1024, 1030, 8), (5, 384, 40, 3), (9, 256, 24, 2),
                            (3, 5120, 1030, 40), (2, 2048, 520, 16)):
        for dtype in (torch.bfloat16, torch.float32):
            run(f"ragged ({m},{k})x({k},{n}) {groups} group(s)", m, k, n, groups, dtype,
                timed=False)
    for m, k, n, groups, offset, what in K3_WGMMA_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            out = run(f"wgmma edge ({m},{k})x({k},{n}) {groups} group(s) packed +{offset} B: {what}",
                      m, k, n, groups, dtype, timed=False, offset=offset)
            check(out["form"] == ("mma_sync" if offset else "wgmma"),
                  f"wgmma edge {what}: took the {out['form']} form")
    for m, k, n, groups, offset, what in K3_GEMV_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            run(f"GEMV edge ({m},{k})x({k},{n}) {groups} group(s) packed +{offset} B: {what}",
                m, k, n, groups, dtype, timed=False, offset=offset, cut="cut" in what)
    mme5 = {}
    for label, (m, k, n) in K3_MME5_SHAPES.items():
        mme5[label] = run(f"mmE5 {label}", m, k, n, k // 128, torch.bfloat16, timed=True,
                          same_bits=True)
        check(mme5[label]["form"] == "wgmma", f"mmE5 {label}: took the {mme5[label]['form']} form")
    results["mme5"] = mme5
    print(f"K3 per int4 tower chunk (240 launches at M = 12864) from these medians: "
          f"{tower_chunk_ms(mme5):.2f} ms")
    step = sum(results[f"decode {lab} (1,{k})x({k},{n})"]["ms"] * cnt
               for lab, (k, n, cnt) in K3_SHAPES.items()) * 64
    step += results[name]["ms"]
    bound = sum(results[f"decode {lab} (1,{k})x({k},{n})"]["bound_ms"] * cnt
                for lab, (k, n, cnt) in K3_SHAPES.items()) * 64 + results[name]["bound_ms"]
    pre = sum(results[f"prefill {lab} ({K3_PREFILL_M},{k})x({k},{n})"]["ms"] * cnt
              for lab, (k, n, cnt) in K3_SHAPES.items()) * 64
    print(f"K3 per decode step (449 launches) from these medians: {step:.2f} ms "
          f"(bound {bound:.2f} ms); per prefill (448 launches at M={K3_PREFILL_M}, "
          f"lm_head apart): {pre:.1f} ms")
    step8, bound8, cublas8 = (
        sum(m8[lab][key] * cnt for lab, (_, _, cnt) in K3_SHAPES.items()) * 64
        + m8["lm_head"][key] for key in ("ms", "bound_ms", "cublas_ms"))
    print(f"K3 per decode step at B = {rows} (449 launches, the wgmma form) from these "
          f"device times: {step8:.2f} ms (bound {bound8:.2f} ms; cuBLAS bf16 x@W on the "
          f"dequantised weights {cublas8:.2f} ms)")
    return results


QWEN_PAGE_HW = PAGE_HW  # a 2200x1700 page, smart-resized to 1120x868
QWEN_MAX_PIXELS = 1280 * 28 * 28  # the notebook's native-resolution budget
QWEN_NEW_TOKENS = 64
QWEN_TIMED_PAGES = 2
QWEN_WARMUP_TOKENS = 16
QWEN_FORCE_EOS_AT = 32
QWEN_PEAK_LIMIT = 30 * 2**30


def qwen_inputs(parser, tmpdir: str):
    """Synthetic pages as PNG files (the user surface takes paths), and the
    first page's model input through the parser's own sizing, resize and
    prompt: (paths, ids (1, L), pixels (1, H, W, 3), (input_w, input_h))."""
    from PIL import Image

    from multimodal_embeddings_tpu_torch.analysis.doc_parser import preprocess_page
    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    paths = []
    for i in range(1 + QWEN_TIMED_PAGES):
        path = f"{tmpdir}/page{i}.png"
        Image.fromarray(make_page(*QWEN_PAGE_HW, seed=i)).save(path)
        paths.append(path)
    image = Image.open(paths[1]).convert("RGB")
    size = parser._input_size(image)
    pixels = preprocess_page(image, *size)
    ids = parser._prompt_ids(*size, QWEN_NEW_TOKENS)
    return paths, ids, pixels, size


def qwen_page(kernels: dict):
    """The Qwen2.5-VL-32B int4 page parse at full width and depth; returns
    the launch counts of the timed pages, the first timed page's prompt and
    pixels, the config, and the model and parser (phase 12b reuses them)."""
    import tempfile

    import torch
    from PIL import Image

    from multimodal_embeddings_tpu_torch.analysis.doc_parser import (
        DocumentParser,
        clean_and_format_html,
        extract_bbox_elements,
        preprocess_page,
    )
    from multimodal_embeddings_tpu_torch.models.quantized import param_bytes
    from multimodal_embeddings_tpu_torch.models.qwen_vl import QwenVLConfig, build_generate_fns
    from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
    from multimodal_embeddings_tpu_torch.models.weights import build_qwen

    phase("12. full-width Qwen2.5-VL-32B int4 page parse (native resolution)")
    config = QwenVLConfig.qwen25_vl_32b_int4()
    t0 = time.perf_counter()
    model = build_qwen(config, torch.bfloat16, "cuda", seed=0)
    torch.cuda.synchronize()
    nbytes = param_bytes(model)
    print(f"build on the card: {time.perf_counter() - t0:.1f} s; parameters "
          f"{nbytes / 1e9:.3f} GB ({nbytes} bytes)")
    parser = DocumentParser(model, ByteTokenizer(), dynamic_resolution=True,
                            max_pixels=QWEN_MAX_PIXELS, device="cuda")
    with tempfile.TemporaryDirectory() as tmpdir:
        paths, ids, pixels, (in_w, in_h) = qwen_inputs(parser, tmpdir)
        prompt_len = ids.shape[1]
        n_pad = int((ids == config.image_pad_id).sum())
        print(f"page {QWEN_PAGE_HW[0]}x{QWEN_PAGE_HW[1]} -> model input {in_h}x{in_w}, "
              f"{(in_h // 14) * (in_w // 14)} patches, prompt {prompt_len} tokens "
              f"({n_pad} image pads)")

        # warm-up: the user entry point, DocumentParser.parse (early-exit
        # loop), at QWEN_WARMUP_TOKENS: every decode step runs the same code
        t0 = time.perf_counter()
        html, h0, w0 = parser.parse(paths[0], max_new_tokens=QWEN_WARMUP_TOKENS)
        torch.cuda.synchronize()
        check((h0, w0) == (in_h, in_w), f"warm-up input size {(h0, w0)}")
        print(f"warm-up parse() at {QWEN_WARMUP_TOKENS} new tokens: "
              f"{time.perf_counter() - t0:.1f} s, {len(html)} characters "
              f"of HTML, {len(extract_bbox_elements(html))} bbox elements, "
              f"{len(clean_and_format_html(html))} characters cleaned")

        prefill, decode = build_generate_fns(model, prompt_len, QWEN_NEW_TOKENS,
                                             early_stop=False)
        dev = next(model.parameters()).device
        torch.cuda.reset_peak_memory_stats()
        for wrapper in kernels.values():
            wrapper.launches = 0
        pre_ms, step_ms, page_s, tokens = [], [], [], []
        for path in paths[1:]:
            t0 = time.perf_counter()
            image = Image.open(path).convert("RGB")
            size = parser._input_size(image)
            px = torch.from_numpy(preprocess_page(image, *size)).to(dev)
            tok = torch.from_numpy(parser._prompt_ids(*size, QWEN_NEW_TOKENS)).long().to(dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            last, caches, delta = prefill(tok, px)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            check(bool(torch.isfinite(last).all()), "non-finite prefill logits")
            out = decode(last, caches, delta)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            html = parser.decode_tokens(out[0].cpu().numpy())
            extract_bbox_elements(html)
            clean_and_format_html(html)
            page_s.append(time.perf_counter() - t0)
            pre_ms.append((t2 - t1) * 1e3)
            step_ms.append((t3 - t2) * 1e3 / QWEN_NEW_TOKENS)
            tokens.append(out.cpu())
            del caches
        launches = {name: w.launches for name, w in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
    layers = config.text.layers
    want = only(kernels, {
        "flash_attention": len(config.vision.fullatt_block_indexes) * QWEN_TIMED_PAGES,
        "int4_matmul": (7 * layers + 1) * (1 + QWEN_NEW_TOKENS) * QWEN_TIMED_PAGES,
    })
    check(launches == want, f"launches {launches} != {want}")
    check(peak < QWEN_PEAK_LIMIT, f"peak memory {peak / 2**30:.2f} GiB")
    print(f"prefill ms {statistics.mean(pre_ms):.1f} (pages: "
          + ", ".join(f"{x:.1f}" for x in pre_ms) + ")")
    print(f"decode ms/step {statistics.mean(step_ms):.2f} over {QWEN_NEW_TOKENS} steps "
          f"(pages: " + ", ".join(f"{x:.2f}" for x in step_ms) + ")")
    print(f"s/page {statistics.mean(page_s):.2f} (pages: "
          + ", ".join(f"{x:.2f}" for x in page_s) + ")")
    print(f"launches over {QWEN_TIMED_PAGES} pages: K4 {launches['flash_attention']}, "
          f"K3 {launches['int4_matmul']}, K1 {launches['encoder_attention']} + "
          f"{launches['encoder_attention_blf']} + {launches['encoder_attention_blf_packed']}, "
          f"K2 {launches['int8_matmul']}")
    print(f"peak device memory: {peak / 2**30:.2f} GiB")
    print(f"tokens of page 1 (first 16): {tokens[0][0, :16].tolist()}")

    # early exit with EOS forced at one step gives the fixed loop's tokens
    tok = torch.from_numpy(ids).long().to(dev)
    px = torch.from_numpy(pixels).to(dev)
    force = torch.tensor([QWEN_FORCE_EOS_AT], dtype=torch.int32, device=dev)
    _, decode_early = build_generate_fns(model, prompt_len, QWEN_NEW_TOKENS, early_stop=True)
    t0 = time.perf_counter()
    early = decode_early(*prefill(tok, px), force).cpu()
    torch.cuda.synchronize()
    early_s = time.perf_counter() - t0
    fixed = decode(*prefill(tok, px), force).cpu()
    check(torch.equal(early, fixed), "early_stop tokens differ from the fixed loop's")
    check(torch.equal(fixed[:, :QWEN_FORCE_EOS_AT], tokens[0][:, :QWEN_FORCE_EOS_AT]),
          "forced-EOS tokens differ from the unforced page's before the stop")
    check(bool((fixed[:, QWEN_FORCE_EOS_AT:] == config.eos_id).all()), "EOS not pinned")
    print(f"early_stop with EOS forced at step {QWEN_FORCE_EOS_AT}: tokens equal to the "
          f"fixed loop's; {early_s:.2f} s")

    cache = []
    profile_run("prefill", lambda: cache.append(prefill(tok, px)))
    _, steps = build_generate_fns(model, prompt_len, 8, early_stop=False)
    profile_run("8 decode steps", lambda: steps(*cache.pop()))
    return launches, ids, pixels, config, model, parser


# phase 12b: P pages of phase 12's size through B rows in chunks of C steps,
# every page 64 new tokens with its stop cycling over 8, 16, ..., 64;
# parse_continuous on 9 page files at 16 new tokens (8 rows: one refill)
QWEN_CONT_PAGES = 16
QWEN_CONT_BATCH = 8
QWEN_CONT_CHUNK = 32
QWEN_CONT_STOPS = tuple(range(8, QWEN_NEW_TOKENS + 1, 8))
QWEN_CONT_PARSE_PAGES = 9
QWEN_CONT_PARSE_TOKENS = 16
# peak memory: the parameters, the decoder's caches (B rows; the waves hold a
# wave's per-page caches and their concatenation, 2 x that), plus 3 GiB for a
# one-page prefill (phase 12 reads ~1.9 GiB) and the decode step
QWEN_CONT_HEADROOM = 3 * 2**30


def qwen_continuous(counters: dict, model, parser, ids, pixels, config) -> dict:
    """Continuous batching at full width on phase 12's model, its norm
    scales set to 1 and its biases to 0 so that the tokens are decisive:
    both chunk forms of ``continuous_generate`` against waves of B pages
    through ``build_generate_fns(prefill_chunk=1, early_stop=True)`` under
    the same stops, tokens EQUAL page by page; exact launch counts; peak
    memory; then ``DocumentParser.parse_continuous`` on page files. Returns
    the launch counts of each run."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from multimodal_embeddings_tpu_torch.analysis.doc_parser import preprocess_page
    from multimodal_embeddings_tpu_torch.models.quantized import param_bytes
    from multimodal_embeddings_tpu_torch.models.qwen_serve import continuous_generate
    from multimodal_embeddings_tpu_torch.models.qwen_vl import build_generate_fns
    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    phase(f"12b. continuous batching at full width: {QWEN_CONT_PAGES} pages through "
          f"{QWEN_CONT_BATCH} rows, chunks of {QWEN_CONT_CHUNK}")
    t_phase = time.perf_counter()
    n, rows, max_new = QWEN_CONT_PAGES, QWEN_CONT_BATCH, QWEN_NEW_TOKENS
    dev = next(model.parameters()).device
    text = config.text
    prompt_len = ids.shape[1]
    per_pass = 7 * text.layers + 1  # K3 launches per prefill and per decode step
    k4_per_page = len(config.vision.fullatt_block_indexes)
    cache_len = min(text.max_len, -(-(prompt_len + max_new) // 128) * 128)
    cache_bytes = text.layers * 2 * rows * cache_len * text.kv_heads * text.head_dim * 2
    params = param_bytes(model)
    # the seeded 1-D leaves (0.02) make every page emit one token until its
    # stop, which would hide a splice into the wrong row: norm scales 1 and
    # biases 0 make each page's tokens its own
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0 if name.endswith("scale") else 0.0)
    rng = np.random.default_rng(12)
    pages = []
    for _ in range(n):
        # the prompt's last 16 tokens are drawn per page too, below the
        # special ids: with the pixels, they make each page's tokens its own
        page_ids = ids[0].copy()
        page_ids[-16:] = rng.integers(6, min(text.vocab_size, 4096), size=16)
        pages.append((page_ids, rng.standard_normal(pixels.shape[1:], dtype=np.float32)))
    stops = [QWEN_CONT_STOPS[i % len(QWEN_CONT_STOPS)] for i in range(n)]
    print(f"pages: {n} x {pixels.shape[1]}x{pixels.shape[2]} pixels and the prompt's last 16 "
          f"tokens from seed 12, prompt "
          f"{prompt_len} tokens, {max_new} new tokens, stops {stops}; the decoder's caches "
          f"{cache_bytes / 2**30:.2f} GiB ({cache_len} slots x {rows} rows)")

    def begin():
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero(counters)
        return time.perf_counter()

    runs, launches = {}, {}
    for label, early in (("continuous, early-exit chunks", True),
                         ("continuous, fixed chunks", False)):
        stats = {}
        t0 = begin()
        outs = continuous_generate(model, pages, batch=rows, max_new_tokens=max_new,
                                   chunk=QWEN_CONT_CHUNK, stops=stops, stats=stats,
                                   early_exit=early)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(counters)
        peak = torch.cuda.max_memory_allocated()
        want = only(counters, {"flash_attention": k4_per_page * n,
                               "int4_matmul": per_pass * (n + stats["decode_steps"])})
        check(got == want, f"{label}: launches {got} != {want}")
        limit = params + cache_bytes + QWEN_CONT_HEADROOM
        check(peak < limit, f"{label}: peak {peak / 2**30:.2f} GiB >= {limit / 2**30:.2f}")
        check(len(outs) == n and all(o.shape == (max_new,) for o in outs),
              f"{label}: outputs")
        runs[label] = dict(outs=outs, wall=wall, steps=stats["decode_steps"],
                           chunks=stats["chunks"], splice_s=stats["splice_s"], peak=peak)
        launches[label] = got

    # the reference: waves of B pages, each page prefilled alone
    prefill, decode = build_generate_fns(model, prompt_len, max_new, early_stop=True,
                                         prefill_chunk=1)
    wave_outs, prefill_s, decode_s = [], 0.0, 0.0
    t0 = begin()
    for w in range(0, n, rows):
        tok = torch.from_numpy(np.stack([p[0] for p in pages[w : w + rows]])).long().to(dev)
        px = torch.from_numpy(np.stack([p[1] for p in pages[w : w + rows]])).to(dev)
        force = torch.tensor(stops[w : w + rows], dtype=torch.int32, device=dev)
        t1 = time.perf_counter()
        last, caches, delta = prefill(tok, px)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = decode(last, caches, delta, force)
        wave_outs.extend(out.cpu().numpy())
        decode_s += time.perf_counter() - t2
        prefill_s += t2 - t1
        del last
        if w + rows < n:  # the last wave's caches serve the logit check below
            del caches
    wall = time.perf_counter() - t0
    got = counts(counters)
    peak = torch.cuda.max_memory_allocated()
    # each wave decodes until its largest stop (or max_new)
    wave_steps = sum(min(max(stops[w : w + rows]), max_new) for w in range(0, n, rows))
    want = only(counters, {"flash_attention": k4_per_page * n,
                           "int4_matmul": per_pass * (n + wave_steps)})
    check(got == want, f"waves: launches {got} != {want}")
    limit = params + 2 * cache_bytes + QWEN_CONT_HEADROOM
    check(peak < limit, f"waves: peak {peak / 2**30:.2f} GiB >= {limit / 2**30:.2f}")
    launches["waves"] = got
    for label, run in runs.items():
        for i, (a, b) in enumerate(zip(run["outs"], wave_outs)):
            check(np.array_equal(a, b), f"{label}: page {i} (stop {stops[i]}) differs from "
                  f"the waves' tokens: first at {int(np.argmax(a != b))}")
    # the tokens are decisive: pages differ pairwise before their stops, and
    # the run emits at least 2 distinct tokens per page
    emitted = np.unique(np.concatenate(wave_outs))
    distinct = len(emitted[emitted != config.eos_id])
    heads = {tuple(o[: min(stops)].tolist()) for o in wave_outs}
    check(len(heads) == n, f"only {len(heads)} of {n} pages differ in their first "
          f"{min(stops)} tokens")
    check(distinct >= 2 * n, f"{distinct} distinct tokens besides EOS (< {2 * n})")
    print(f"tokens: every page of both continuous forms EQUAL to the waves', bit for bit "
          f"(page 0 first 8: {wave_outs[0][:8].tolist()}; EOS from each page's stop on; "
          f"the {n} pages pairwise different in their first {min(stops)} tokens; {distinct} "
          f"distinct tokens besides EOS)")
    # a row's logits do not depend on the other rows' depths: one step with
    # the rows at 8 different depths ((B,) position) against steps with every
    # row at one depth (0-d position), each from the last wave's caches, row
    # by row, bit for bit
    gap = (cache_len - 1 - prompt_len) // (rows - 1)
    depths = prompt_len + gap * torch.arange(rows, dtype=torch.int32, device=dev)
    tok = (torch.arange(rows, device=dev)[:, None] * 997 + 11) % text.vocab_size
    with torch.inference_mode():
        state = [(k.clone(), v.clone()) for k, v in caches]
        per_row, _ = model.decode_step(tok, state, depths, delta)
        for r in range(rows):
            state = [(k.clone(), v.clone()) for k, v in caches]
            one, _ = model.decode_step(tok, state, depths[r], delta)
            check(torch.equal(per_row[r], one[r]), f"row {r} at depth {int(depths[r])}: the "
                  "per-row step's logits differ from the one-depth step's")
        del state
    del caches
    print(f"logits: a step with the {rows} rows at depths {prompt_len} + {gap}r EQUAL, row "
          "by row, to steps with every row at that row's depth")

    ideal = -(-sum(min(s, max_new) for s in stops) // rows)
    for label, run in runs.items():
        step_ms = (run["wall"] - run["splice_s"]) * 1e3 / run["steps"]
        run["step_ms"] = step_ms
        print(f"{label}: {n * 3600 / run['wall']:.1f} pages/hour ({run['wall']:.2f} s), "
              f"decode steps {run['steps']} (rows' ideal {ideal}), chunks {run['chunks']}, "
              f"splice_s {run['splice_s']:.2f} (the {n} prefills and splices), "
              f"{step_ms:.2f} ms per decode step at B = {rows} (wall less splices), "
              f"peak {run['peak'] / 2**30:.2f} GiB")
    print(f"waves of {rows} (early exit, prefill_chunk=1): {n * 3600 / wall:.1f} pages/hour "
          f"({wall:.2f} s), decode steps {wave_steps}, chunks -, splice_s - (prefills "
          f"{prefill_s:.2f} s), {decode_s * 1e3 / wave_steps:.2f} ms per decode step at "
          f"B = {rows}, peak {peak / 2**30:.2f} GiB")
    print("launches: " + "; ".join(f"{label}: K3 {got['int4_matmul']}, K4 "
                                     f"{got['flash_attention']}" for label, got in
                                     launches.items()))
    result = {label: {"pages_per_hour": n * 3600 / run["wall"], "wall_s": run["wall"],
                      "decode_steps": run["steps"], "chunks": run["chunks"],
                      "splice_s": run["splice_s"], "step_ms": run["step_ms"]}
              for label, run in runs.items()}
    result["waves"] = {"pages_per_hour": n * 3600 / wall, "wall_s": wall,
                       "decode_steps": wave_steps, "step_ms": decode_s * 1e3 / wave_steps}

    # the user surface: parse_continuous on page files, one refill
    with tempfile.TemporaryDirectory() as tmpdir:
        paths = []
        for i in range(QWEN_CONT_PARSE_PAGES):
            paths.append(f"{tmpdir}/cont{i}.png")
            Image.fromarray(make_page(*QWEN_PAGE_HW, seed=100 + i)).save(paths[-1])
        seen = []
        parser.decode_tokens = lambda toks: seen.append(np.array(toks)) or ""
        t0 = begin()
        res = parser.parse_continuous(paths, max_new_tokens=QWEN_CONT_PARSE_TOKENS,
                                      batch=rows, chunk=QWEN_CONT_CHUNK)
        torch.cuda.synchronize()
        parse_s = time.perf_counter() - t0
        del parser.decode_tokens
        got = counts(counters)
        size = parser._input_size(Image.open(paths[0]))
        check(len(res) == QWEN_CONT_PARSE_PAGES and len(seen) == QWEN_CONT_PARSE_PAGES
              and all(r == ("", size[1], size[0]) for r in res), f"parse_continuous: {res}")
        ids16 = parser._prompt_ids(*size, QWEN_CONT_PARSE_TOKENS)
        ref_pages = [(ids16[0], preprocess_page(Image.open(p).convert("RGB"), *size)[0])
                     for p in paths]
        stats = {}
        ref = continuous_generate(model, ref_pages, batch=rows,
                                  max_new_tokens=QWEN_CONT_PARSE_TOKENS,
                                  chunk=QWEN_CONT_CHUNK, stats=stats)
    for i, (a, b) in enumerate(zip(seen, ref)):
        check(np.array_equal(a, b), f"parse_continuous page {i}: tokens differ from "
              "continuous_generate's on the same inputs")
    # parse_continuous runs continuous_generate's schedule on these pages
    want = only(counters, {
        "flash_attention": k4_per_page * QWEN_CONT_PARSE_PAGES,
        "int4_matmul": per_pass * (QWEN_CONT_PARSE_PAGES + stats["decode_steps"])})
    check(got == want, f"parse_continuous: launches {got} != {want}")
    print(f"parse_continuous: {QWEN_CONT_PARSE_PAGES} page files at {QWEN_CONT_PARSE_TOKENS} "
          f"new tokens, {rows} rows: {QWEN_CONT_PARSE_PAGES} results in input order, "
          f"{size[0]}x{size[1]}, tokens EQUAL to continuous_generate's; {parse_s:.2f} s, "
          f"K3 {got['int4_matmul']} ({QWEN_CONT_PARSE_PAGES} prefills and "
          f"{stats['decode_steps']} decode steps), K4 {got['flash_attention']}")
    print(f"phase 12b: {time.perf_counter() - t_phase:.1f} s")
    return launches, result


# phase 13's depth: the last vision block full-attention, the others
# windowed; the CPU's f32 prefill of the page is most of the phase's time
QWEN_CPU_VISION_LAYERS, QWEN_CPU_TEXT_LAYERS = 1, 1


def qwen_card_vs_cpu(ids, pixels, config) -> None:
    """Prefill logits of the 32B widths at reduced depth: the card in bf16
    against the CPU in f32 with the plain kernels, same weights."""
    import torch

    from multimodal_embeddings_tpu_torch.models.weights import build_qwen, export_jax_params

    phase("13. Qwen2.5-VL-32B int4: card (bf16) against the CPU (f32, plain kernels)")
    reduced = dataclasses.replace(
        config,
        vision=dataclasses.replace(config.vision, layers=QWEN_CPU_VISION_LAYERS,
                                   fullatt_block_indexes=(QWEN_CPU_VISION_LAYERS - 1,)),
        text=dataclasses.replace(config.text, layers=QWEN_CPU_TEXT_LAYERS),
    )
    t0 = time.perf_counter()
    # the weights drawn from a seed on the card (an H100 machine's CPU took
    # 33 s to draw them), then loaded into the CPU's f32 model and the card's
    # bf16 one
    flat = export_jax_params(build_qwen(reduced, torch.float32, "cuda", seed=0))
    gc_cuda()
    cpu = build_qwen(reduced, torch.float32, "cpu", params=flat)
    gpu = build_qwen(reduced, torch.bfloat16, "cuda", params=flat)
    del flat
    print(f"set-up (weights drawn on the card, loaded into the CPU's f32 model and the "
          f"card's bf16 one): {time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        t0 = time.perf_counter()
        want, _, _ = cpu(torch.from_numpy(ids).long(), torch.from_numpy(pixels),
                         cache_len=ids.shape[1], last_only=True)
        cpu_s = time.perf_counter() - t0
        dev = next(gpu.parameters()).device
        got, _, _ = gpu(torch.from_numpy(ids).long().to(dev), torch.from_numpy(pixels).to(dev),
                        cache_len=ids.shape[1], last_only=True)
    got = got[:, -1].float().cpu()
    want = want[:, -1]
    check(bool(torch.isfinite(got).all()), "non-finite card logits")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    print(f"last-position logits, cosine card vs cpu: {[round(c, 6) for c in cos.tolist()]} "
          f"(CPU prefill {cpu_s:.1f} s)")
    check(bool((cos >= COSINE_MIN).all()), f"cosine {cos.tolist()} < {COSINE_MIN}")


# --- the page programs' opt-in kernel routes (K5, K6, K7, K1-BLHD) ----------

# (N, C, H, W, dilation) of the GL-CRM stages' 3x3s at variant m, 30 views of
# 1024 px, and K5's launches per page at each: c2f_2 (2 bottlenecks) and
# c2f_3 (4), a dilated cv1 and a plain cv2 in each
K5_SHAPES = {
    "c2f_2 cv1 (30,48,256,256) d=2": ((30, 48, 256, 256, 2), 2),
    "c2f_2 cv2 (30,48,256,256) d=1": ((30, 48, 256, 256, 1), 2),
    "c2f_3 cv1 (30,96,128,128) d=2": ((30, 96, 128, 128, 2), 4),
    "c2f_3 cv2 (30,96,128,128) d=1": ((30, 96, 128, 128, 1), 4),
}
K5_HEADLINE = "c2f_2 cv1 (30,48,256,256) d=2"
# K5's time at a page shape against F.conv2d + F.silu's, by C: at most equal
# at C = 48, at most 1.25x at C = 96
K5_LIBRARY_FACTOR = {48: 1.0, 96: 1.25}
# (N, C, H, W, dilation, Cout, x 2 bytes off alignment) of K5's edge cases:
# ragged tiles on the cp.async path (C 20) and on TMA, H = W = 1 at d = 2,
# clusters of 3 (Cout 100, 56 -> 2) and 5 in two groups (Cout 440), channel
# chunks (C 192), polyphase tiles (d 24), a misaligned base
K5_EDGES = (
    (2, 20, 13, 17, 1, 20, False), (3, 48, 7, 9, 4, 40, False), (1, 8, 5, 3, 2, 56, False),
    (2, 96, 11, 6, 2, 100, False), (2, 48, 37, 21, 2, 48, False), (1, 48, 1, 1, 2, 48, False),
    (2, 48, 19, 23, 1, 100, False), (1, 48, 18, 20, 2, 440, False),
    (2, 192, 20, 36, 2, 48, False), (1, 48, 60, 52, 24, 48, False),
    (2, 48, 21, 19, 2, 96, True),
)
# (M, K, N, bias) of K6: the ViT page's ln1 -> [Wq|Wk|Wv] and ln2 -> fc1 over
# 48 crops x 784 patches, and the mmE5 tower's ln2 -> fc1 over 8 crops x 1608
K6_SHAPES = {
    "vit qkv (37632,768)x(768,2304)": (37632, 768, 2304, False),
    "vit fc1 (37632,768)x(768,3072) +bias": (37632, 768, 3072, True),
    "mllama fc1 (12864,1280)x(1280,5120) +bias": (12864, 1280, 5120, True),
}
K6_HEADLINE = "vit fc1 (37632,768)x(768,3072) +bias"
# (M, K, N, bias, byte offset of x, what) of K6's wgmma form's edges, and
# shapes the rule sends to the mma.sync form
K6_WGMMA_EDGES = (
    (1, 768, 256, True, 0, "M = 1: TMA zero-fills 127 rows of the block"),
    (63, 768, 512, False, 0, "M = 63: one block, two N tiles"),
    (129, 256, 256, True, 0, "M = 129: a second row block of one row"),
    (300, 512, 48, False, 0, "N = 48 < 256: one N tile of 48 columns"),
    (300, 512, 200, True, 0, "N = 200: one N tile of 200 columns"),
    (300, 1280, 1040, True, 0, "N = 1040: a last N tile of 16 columns, K = 1280"),
    (200, 136, 512, True, 0, "K = 136: a last chunk of 8 columns"),
    (300, 3000, 512, True, 0, "K = 3000: statistics looped over memory, 3 stages"),
    (4096, 768, 768, False, 0, "96 units, one per CTA: runs that start mid row block"),
    (8192, 768, 2304, True, 0, "576 units, more than CTAs: runs of 4-5 units that start "
     "mid row block and cross into the next"),
    (64, 768, 256, True, 8, "x 8 bytes off: the mma.sync form"),
    (50, 100, 64, True, 0, "K = 100 (K % 8 != 0): the mma.sync form"),
)
K7_SHAPES = {
    "vit final_ln (48,784,768) bf16": ((48, 784, 768), "bfloat16"),
    "mllama local (8,1608,1280) bf16": ((8, 1608, 1280), "bfloat16"),
    "mllama global (8,1608,1280) f32": ((8, 1608, 1280), "float32"),
}
K7_HEADLINE = "mllama local (8,1608,1280) bf16"
# K7 against its plain version: both take f32 sums of D <= 1280 values in
# different orders; the mean may differ by 1e-5 of the row's rms and rstd by
# 1e-5 of itself (a sum taken in bf16, or a two-pass variance, moves them by
# 1e-3 and more)
K7_RTOL = 1e-5
# (shape, x's offset in elements, what) of K7's edges, each in bf16 and f32
K7_EDGES = (
    ((5, 1001, 768), 0, "rows not a multiple of a block's 8"),
    ((1, 8, 768), 0, "one block"),
    ((1, 4960, 1280), 0, "the Qwen vision tower's LayerNorm"),
    ((4, 100, 768), 1, "x off 16-byte alignment: element loads"),
    ((2, 40, 12), 0, "D = 12: 24 bytes a bf16 row, element loads"),
    ((1, 8, 4096), 0, "rows of 8 and 16 KB"),
    ((1, 8, 16384), 0, "rows of 32 and 64 KB"),
)
ROUTE_SWITCHES = {"MMTPU_LN_STATS": "1", "MMTPU_ENC_ATTN_BLHD": "1"}


@contextlib.contextmanager
def switches(env: dict):
    """Set the JAX package's opt-in kernel variables for the block, then
    restore them."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def gate(name, got, want, allowed, dtype) -> dict:
    """Every ``|got − want|`` within ``allowed``; in bf16 the mean error
    under 5% of the mean bf16 step (rounding flips are rare, a systematic
    fault moves a large share of the outputs)."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got.float() - want.float()).abs()
    ratio = (err / allowed).max().item()
    check(ratio <= 1.0, f"{name}: error {ratio:.3g}x its bound")
    out = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "bound_share": ratio}
    if dtype == torch.bfloat16:
        out["mean_step_share"] = out["mean_abs_err"] / bf16_step(want).mean().item()
        check(out["mean_step_share"] <= K2_MEAN_STEP_SHARE,
              f"{name}: mean err {out['mean_step_share']:.3g} of a bf16 step")
    return out


def conv_case(k5, gen, name, n, c, h, w, d, dtype, cout=None, strided=False, timed=False,
              stride=1, misaligned=False):
    """K5 against its plain version on channels-last x (``strided``: x is
    the upper channel half of a channels-last tensor twice as wide, as the
    CSP stage hands it on; ``misaligned``: x starts 2 bytes past a 16-byte
    boundary, its strides aligned); ``stride=2``: its stride-2 form (``d``
    unused). A bf16 launch prints its plan. Tolerance per output:
    2·9C·2⁻²⁴·Σ|x·w| (f32 sums in different orders, ×1.1 for SiLU's slope)
    plus, in bf16, 2 steps of its rounding."""
    import torch
    import torch.nn.functional as F

    cout = cout or c
    dev = torch.device("cuda")
    wide = torch.randn((n, 2 * c if strided else c, h, w), generator=gen, device=dev)
    x = wide.to(dtype).contiguous(memory_format=torch.channels_last)[:, -c:]
    if misaligned:
        flat = torch.empty(x.numel() + 8, device=dev, dtype=dtype)
        x = flat[1:1 + x.numel()].as_strided(x.shape, (h * w * c, 1, w * c, c)).copy_(x)
    wt = (torch.randn((cout, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5).to(dtype)
    bias = torch.randn((cout,), generator=gen, device=dev) * 0.5
    if dtype == torch.bfloat16:
        out_hw = (h, w) if stride == 1 else (h // 2, w // 2)
        plan = k5.plan_for(x, cout, stride, d if stride == 1 else 1, out_hw)
        print(f"  plan {name}: {plan.path}{f' {plan.width} B' if plan.width else ''} tile "
              f"{plan.tile[0]}x{plan.tile[1]} phase {plan.phase} cluster {plan.cluster} groups "
              f"{plan.groups} chunks {plan.nchunks}x{plan.pc} stages {plan.stages} "
              f"({plan.smem} B shared) grid {plan.grid[0]}x{plan.grid[1]}")
    if stride == 1:
        def kernel():
            return k5.conv3x3_nchw(x, wt, bias, act="silu", dilation=d)

        def plain():
            return k5.conv3x3_reference(x, wt, bias, "silu", d)

        def library_conv(t, weight, b=None):
            return F.conv2d(t, weight, b, padding=d, dilation=d)
    else:  # lax SAME at even H and W: 0 rows on top/left, 1 on bottom/right
        def kernel():
            return k5.conv3x3_s2_nchw(x, wt, bias, act="silu")

        def plain():
            return k5.conv3x3_s2_reference(x, wt, bias, "silu")

        def library_conv(t, weight, b=None):
            return F.conv2d(F.pad(t, (0, 1, 0, 1)), weight, b, stride=2)
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    check(got.is_contiguous(memory_format=torch.channels_last), f"{name}: not channels-last")
    oh, ow = got.shape[2:]
    mag = library_conv(x.float().abs(), wt.float().abs())
    allowed = 1.1 * 2 * 9 * c * 2.0**-24 * mag + 1e-30
    if dtype == torch.bfloat16:
        allowed = allowed + MAX_BF16_STEPS * bf16_step(want)
    else:
        allowed = allowed + 4 * 2.0**-24 * want.abs()  # the SiLU's own f32 roundings
    out = gate(name, got, want, allowed, dtype)
    del mag, allowed
    line = (f"{name} {str(dtype).split('.')[-1]}: max_abs_err {out['max_abs_err']:.3e} "
            f"err/allowed {out['bound_share']:.3f}")
    if timed:
        bl = bias.to(dtype)
        out["ms"] = median_ms(kernel)
        out["plain_ms"] = median_ms(plain, runs=10)
        out["library_ms"] = median_ms(lambda: F.silu(library_conv(x, wt, bl)))
        elem = x.element_size()
        out["bound_ms"], out["bound_by"] = bound_ms(
            2.0 * n * oh * ow * cout * 9 * c,
            elem * (n * h * w * c + n * oh * ow * cout + cout * c * 9) + 4 * cout, dtype)
        line += (f" kernel {out['ms']:.4f} ms plain {out['plain_ms']:.3f} ms "
                 f"F.conv2d+F.silu {out['library_ms']:.4f} ms bound {out['bound_ms']:.4f} ms "
                 f"({out['bound_by']})")
    print(line, flush=True)
    return out


def ln_matmul_case(k6, gen, name, m, k, n, with_bias, dtype, timed=False, offset=0,
                   same_bits=False):
    """K6 against its plain version (``offset``: x starts that many bytes
    past an allocation; ``same_bits``: a second call must give the same
    bits). The form is held to the launcher's choice, and a wgmma launch
    prints its plan. Tolerance per output: the summation bound
    2·K·2⁻²⁴·Σ|xn·w|, one bf16 step of one normalised input of the row times
    its weight (statistics that differ in the last f32 bit may round an
    input the other way), and, in bf16, 2 steps of the product's rounding
    and 2 of the output's (with a bias it rounds twice)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    buf = torch.empty((m * k + offset // 2,), device=dev, dtype=dtype)
    x = buf[offset // 2:].view(m, k)
    x.copy_((torch.randn((m, k), generator=gen, device=dev) * 1.5 + 0.3).to(dtype))
    gamma = torch.rand((k,), generator=gen, device=dev) + 0.5
    beta = torch.randn((k,), generator=gen, device=dev) * 0.2
    w = (torch.randn((k, n), generator=gen, device=dev) / k**0.5).to(dtype)
    bias = (torch.randn((n,), generator=gen, device=dev) * 0.5).to(dtype) if with_bias else None
    form, launcher = k6.form_for(x, w, bias), k6.launcher_form(x, w, bias)
    check(form == launcher, f"{name}: the Python rule says {form}, the launcher {launcher}")
    plan_note = ""
    if form == "wgmma":
        plan = k6.plan_for(x, w)
        runs = [plan.share(j) for j in range(plan.grid)]
        passes = [plan.stats_passes(j) for j in range(plan.grid)]
        mid = sum(u0 % plan.nt != 0 for u0, _ in runs)
        plan_note = (f" plan: {plan.mb}x{plan.nt} units of 128x256 over {plan.grid} CTAs "
                     f"({min(u1 - u0 for u0, u1 in runs)}-{max(u1 - u0 for u0, u1 in runs)} "
                     f"units, {min(passes)}-{max(passes)} statistics passes, {mid} runs "
                     f"starting mid row block), {plan.nchunks} chunks, {plan.stages} stages, "
                     f"{plan.smem} B shared")
    got = k6.ln_matmul(x, gamma, beta, w, bias=bias)
    if same_bits:  # no split-K: a second call gives the same bits
        check(torch.equal(got, k6.ln_matmul(x, gamma, beta, w, bias=bias)),
              f"{name}: two calls differ")
    want = k6.ln_matmul_reference(x, gamma, beta, w, bias)
    torch.cuda.synchronize()
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    xn = (xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-6) * gamma + beta).to(dtype)
    del xf, xc
    wabs = w.float().abs()
    allowed = 2 * k * 2.0**-24 * (xn.float().abs() @ wabs)
    if dtype == torch.bfloat16:
        allowed += torch.outer(bf16_step(xn).amax(-1), wabs.amax(0))
        pre = want if bias is None else k6.ln_matmul_reference(x, gamma, beta, w)
        allowed += MAX_BF16_STEPS * (bf16_step(pre) + bf16_step(want))
        del pre
    else:
        allowed += 2.0**-23 * want.abs() + 1e-30
    del xn, wabs
    out = gate(name, got, want, allowed, dtype)
    del allowed
    out["form"] = form
    line = (f"{name} {str(dtype).split('.')[-1]} [{form}"
            f"{', bit-equal twice' if same_bits else ''}]: max_abs_err {out['max_abs_err']:.3e} "
            f"err/allowed {out['bound_share']:.3f}{plan_note}")
    if timed:
        elem = x.element_size()
        out["ms"] = median_ms(lambda: k6.ln_matmul(x, gamma, beta, w, bias=bias))
        out["device_ms"] = device_ms([lambda: k6.ln_matmul(x, gamma, beta, w, bias=bias)] * 20)
        out["plain_ms"] = median_ms(
            lambda: k6.ln_matmul_reference(x, gamma, beta, w, bias), runs=10)
        g16, b16 = gamma.to(dtype), beta.to(dtype)
        out["ln_then_matmul_ms"] = median_ms(
            lambda: F.layer_norm(x, (k,), g16, b16, 1e-6) @ w)
        out["library_ms"] = None  # no one PyTorch call computes LayerNorm -> matmul
        out["bound_ms"], out["bound_by"] = bound_ms(
            2.0 * m * k * n + 8.0 * m * k,
            elem * (m * k + k * n + m * n + (n if with_bias else 0)) + 8 * k, dtype)
        line += (f" kernel {out['ms']:.4f} ms (back to back {out['device_ms']:.4f}) "
                 f"plain {out['plain_ms']:.3f} ms "
                 f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}) [context: "
                 f"F.layer_norm then x@W {out['ln_then_matmul_ms']:.4f} ms]")
    print(line, flush=True)
    return out


def k7_times(k7, x) -> dict:
    """K7's times at one input, and ``torch.var_mean``'s timed the same ways:
    ``ms``, the device time per call of back-to-back launches over copies of
    x that together exceed the 50 MB L2 (at least 128 MB, so each launch
    streams its input from HBM; the figure held against the bound);
    ``warm_ms``, back to back on x alone (an input that fits the L2 stays
    there, as the tower's LayerNorm input just written by the residual add
    partly does); ``median_ms``, the median of single launches from an idle
    card (the wrapper's host time included)."""
    import torch

    copies = [x] + [x.clone() for _ in range(-(-128 * 2**20 // (x.numel() * x.element_size())) - 1)]
    reps = max(1, 48 // len(copies))

    def var_mean(t):
        return torch.var_mean(t, dim=-1, keepdim=True, correction=0)

    out = {
        "ms": device_ms([lambda c=c: k7.ln_stats(c, 1e-6) for c in copies] * reps),
        "warm_ms": device_ms([lambda: k7.ln_stats(x, 1e-6)] * 48),
        "median_ms": median_ms(lambda: k7.ln_stats(x, 1e-6)),
        "library_ms": device_ms([lambda c=c: var_mean(c) for c in copies] * reps),
        "library_warm_ms": device_ms([lambda: var_mean(x)] * 48),
        "library_median_ms": median_ms(lambda: var_mean(x)),
        "copies": len(copies),
    }
    del copies
    return out


def ln_stats_case(k7, gen, name, shape, dtype, timed=False, offset=0, same_bits=False):
    """K7 against its plain version (tolerance: ``K7_RTOL``). ``offset``: x
    starts that many elements past an allocation; ``same_bits``: a second
    call must give the same bits. ``timed``: its times (``k7_times``), the
    plain version's median and the bound."""
    import torch

    numel = math.prod(shape)
    buf = torch.empty((numel + offset,), device="cuda", dtype=dtype)
    x = buf[offset:].view(shape)
    x.copy_(torch.randn(shape, generator=gen, device="cuda") * 1.3 + 0.2)
    mean, rstd = k7.ln_stats(x, 1e-6)
    if same_bits:  # no atomics, no order set by scheduling
        again = k7.ln_stats(x, 1e-6)
        check(torch.equal(mean, again[0]) and torch.equal(rstd, again[1]),
              f"{name}: two calls differ")
    want_m, want_r = k7.ln_stats_reference(x, 1e-6)
    torch.cuda.synchronize()
    rms = x.float().pow(2).mean(-1, keepdim=True).sqrt()
    out_m = gate(name + " mean", mean, want_m, K7_RTOL * rms + 1e-30, torch.float32)
    out_r = gate(name + " rstd", rstd, want_r, K7_RTOL * want_r, torch.float32)
    out = {"max_abs_err": max(out_m["max_abs_err"], out_r["max_abs_err"]),
           "mean_max_abs_err": out_m["max_abs_err"], "rstd_max_abs_err": out_r["max_abs_err"]}
    line = (f"{name}{' [bit-equal twice]' if same_bits else ''}: mean max_abs_err "
            f"{out_m['max_abs_err']:.3e} rstd max_abs_err {out_r['max_abs_err']:.3e}")
    if timed:
        b, l, d = shape
        out.update(k7_times(k7, x))
        out["plain_ms"] = median_ms(lambda: k7.ln_stats_reference(x, 1e-6))
        out["bound_ms"], out["bound_by"] = bound_ms(
            3.0 * b * l * d, x.element_size() * b * l * d + 8 * b * l, torch.float32)
        line += (f" | back to back over {out['copies']} copies (> L2) {out['ms']:.4f} ms, "
                 f"warm {out['warm_ms']:.4f}, single-launch median {out['median_ms']:.4f}; "
                 f"torch.var_mean {out['library_ms']:.4f} / {out['library_warm_ms']:.4f} / "
                 f"{out['library_median_ms']:.4f}; plain {out['plain_ms']:.4f} ms; bound "
                 f"{out['bound_ms']:.4f} ms ({out['bound_by']}), "
                 f"{100 * out['bound_ms'] / out['ms']:.0f}% of it")
    print(line, flush=True)
    return out


def register_usage(info) -> list:
    """(kernel, registers, spill note, spills) of every kernel of one library
    (``info``: its ``BuildInfo``): from ``ptxas``'s report where this process
    built the library, else from ``cuobjdump -res-usage`` of the library
    itself (a spill there shows as a stack frame or local memory); fails
    when neither is there."""
    import re
    import shutil

    out = []
    for block in info.log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        note = (f"spill stores/loads {spill.group(1)}/{spill.group(2)} bytes (ptxas)" if spill
                else "spills not reported")
        out.append((_short(block.split("'", 1)[0]), regs.group(1) if regs else "?", note,
                    spill is None or spill.groups() != ("0", "0")))
    if info.log:
        return out
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.access(tool, os.X_OK), f"{info.path.name}: no ptxas report and no cuobjdump")
    proc = subprocess.run([tool, "-res-usage", str(info.path)], capture_output=True, text=True)
    check(proc.returncode == 0, f"cuobjdump -res-usage {info.path.name}: {proc.returncode}")
    for name, regs, stack, local in re.findall(
            r"Function ([^\s:]+):\s+REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", proc.stdout):
        out.append((_short(name), regs, f"stack frame {stack}, local {local} bytes (cuobjdump)",
                    (stack, local) != ("0", "0")))
    check(bool(out), f"cuobjdump -res-usage {info.path.name}: no kernel read")
    return out


def k7_checks(k7) -> dict:
    """K7 at the three path shapes (timed, each equal bit for bit twice),
    ragged shapes, and the edges of ``K7_EDGES`` in bf16 and f32 (each twice);
    each kernel's registers and spills (none allowed)."""
    import torch

    for name, regs, note, spills in register_usage(k7.build_info()):
        print(f"  {name}: {regs} registers, {note}")
        check(not spills, f"{name}: {note}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    res = {}
    for name, (shape, dtype) in K7_SHAPES.items():
        res[name] = ln_stats_case(k7, gen, name, shape, getattr(torch, dtype), timed=True,
                                  same_bits=True)
        torch.cuda.empty_cache()
    for shape in ((1, 8, 40), (2, 16, 1000), (3, 24, 12), (1, 8, 4)):
        for dtype in (torch.bfloat16, torch.float32):
            ln_stats_case(k7, gen, f"ragged {shape} {str(dtype).split('.')[-1]}", shape, dtype)
    for shape, offset, what in K7_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            ln_stats_case(k7, gen, f"edge {shape} {str(dtype).split('.')[-1]}"
                                   f"{f' x +{offset} elements' if offset else ''}: {what}",
                          shape, dtype, offset=offset, same_bits=True)
    return res


def k5_checks(k5) -> dict:
    """K5 at the kernel-route page's four shapes (timed), one f32 shape, and
    edge shapes that reach every form ``_plan`` chooses, bf16 and f32: H
    and W off the tile, H = W = 1, a cluster of 3 (Cout 100), two groups of
    clusters (Cout 440 > 8·48), channel chunks (C 192), polyphase tiles (d
    24), the ``cp.async`` path (C 20, and an x 2 bytes off alignment); the
    per-page sums over the 12 launches, held to F.conv2d + F.silu's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    res = {}
    for name, ((n, c, h, w, d), _) in K5_SHAPES.items():
        res[name] = conv_case(k5, gen, name, n, c, h, w, d, bf16,
                              strided=name.endswith("d=2"), timed=True)
    res["f32"] = conv_case(k5, gen, "f32 (4,48,64,64) d=2", 4, 48, 64, 64, 2, f32, timed=True)
    for n, c, h, w, d, cout, misaligned in K5_EDGES:
        for dtype in (bf16, f32):
            conv_case(k5, gen, f"edge ({n},{c},{h},{w}) d={d} cout={cout}"
                               f"{' base+2B' if misaligned else ''}", n, c, h, w, d, dtype,
                      cout=cout, strided=c == 48, misaligned=misaligned)
    per_page = sum(res[s]["ms"] * cnt for s, (_, cnt) in K5_SHAPES.items())
    bound = sum(res[s]["bound_ms"] * cnt for s, (_, cnt) in K5_SHAPES.items())
    lib = sum(res[s]["library_ms"] * cnt for s, (_, cnt) in K5_SHAPES.items())
    print(f"K5 per page (12 launches) from these medians: {per_page:.3f} ms "
          f"(bound {bound:.3f} ms, F.conv2d+F.silu {lib:.3f} ms)")
    check(per_page <= lib, f"K5 per page {per_page:.3f} ms > F.conv2d+F.silu {lib:.3f} ms")
    for name, r in res.items():  # each page shape: at most the library (C 48), 1.25x (C 96)
        limit = K5_LIBRARY_FACTOR.get(K5_SHAPES.get(name, ((0, 0),))[0][1])
        if limit:
            check(r["ms"] <= limit * r["library_ms"],
                  f"K5 {name}: {r['ms']:.4f} ms > {limit} x F.conv2d+F.silu {r['library_ms']:.4f}")
    return res


def k5_s2_checks(k5) -> dict:
    """K5's stride-2 form at the detector's positions (timed), ragged edges,
    one f32 shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    res = {}
    for name, (n, c, h, w, cout) in K5_S2_SHAPES.items():
        res[name] = conv_case(k5, gen, f"s2 {name}", n, c, h, w, 1, bf16, cout=cout,
                              timed=True, stride=2)
        torch.cuda.empty_cache()
    res["f32"] = conv_case(k5, gen, "s2 f32 (4,48,64,64)->96", 4, 48, 64, 64, 1, f32,
                           cout=96, timed=True, stride=2)
    for n, c, h, w, cout in ((2, 8, 2, 2, 16), (2, 20, 14, 18, 40), (3, 48, 10, 6, 56),
                             (1, 3, 6, 4, 48)):
        for dtype in (bf16, f32):
            conv_case(k5, gen, f"s2 ragged ({n},{c},{h},{w})->{cout}", n, c, h, w, 1, dtype,
                      cout=cout, strided=c == 48, stride=2)
    return res


def k6_checks(k6) -> dict:
    """K6 at the three path shapes (timed, each on the wgmma form and equal
    bit for bit twice), one f32 shape, ragged shapes in bf16 and f32, the
    wgmma form's edges (and shapes the rule sends to the mma.sync form),
    each case's form held to the launcher's, each wgmma plan printed; from
    the build, registers and spills (none in the wgmma form) and the
    ``HGMMA`` (> 0) and ``I2F``/``I2FP`` (0) counts."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    for k in (768, 1280, 3000):
        consts = k6.wgmma_constants(k)
        print(f"K6 wgmma form at K = {k}: tile {consts[0]}x{consts[1]}, chunk {consts[2]} "
              f"columns, {consts[3]} stages, {consts[4]} B shared, {consts[5]} threads; "
              f"{k6.wgmma_resident()} resident CTAs")
        check(consts[:5] == (k6._WG_TILE_M, k6._WG_TILE_N, k6._WG_CHUNK, k6.wgmma_stages(k),
                             k6.wgmma_smem(k, k6.wgmma_stages(k))),
              f"the plan's constants differ from the kernel's {consts}")
    res = {}
    for name, (m, k, n, with_bias) in K6_SHAPES.items():
        res[name] = ln_matmul_case(k6, gen, name, m, k, n, with_bias, bf16, timed=True,
                                   same_bits=True)
        check(res[name]["form"] == "wgmma", f"{name}: took the {res[name]['form']} form")
        torch.cuda.empty_cache()
    res["f32"] = ln_matmul_case(k6, gen, "f32 (1024,768)x(768,512) +bias", 1024, 768,
                                512, True, f32, timed=True)
    for m, k, n in ((37, 200, 136), (1, 8, 16), (130, 128, 200), (300, 1000, 1030)):
        for dtype in (bf16, f32):
            ln_matmul_case(k6, gen, f"ragged ({m},{k})x({k},{n})", m, k, n, m % 2 == 1, dtype)
    for m, k, n, with_bias, offset, what in K6_WGMMA_EDGES:
        out = ln_matmul_case(k6, gen, f"wgmma edge ({m},{k})x({k},{n}) x +{offset} B: {what}",
                             m, k, n, with_bias, bf16, offset=offset)
        want = "mma_sync" if "mma.sync" in what else "wgmma"
        check(out["form"] == want, f"K6 edge {what}: took the {out['form']} form")
        if "more than CTAs" in what:
            plan = k6.ln_mm_wgmma_plan(m, k, n, k6.wgmma_resident())
            check(plan.units > plan.grid and any(
                plan.share(j)[0] % plan.nt for j in range(plan.grid)),
                f"K6 edge {what}: no run starts mid row block")
    kernel_sass("K6", k6.build_info(), wgmma="ln_mm_wgmma")
    return res


def route_kernel_checks(k1, k5, k6, k7) -> dict:
    """K5, K6, K7 and K1-BLHD against their plain versions."""
    import torch
    import torch.nn.functional as F

    phase("4a. K5, K6, K7 and K1-BLHD against their plain versions (kernel-route shapes)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    res = {"k5": k5_checks(k5), "k6": k6_checks(k6), "k7": k7_checks(k7)}

    # K1 over (B, L, H, D) head slices of the fused (B·L, 3·H·D) qkv product
    def blhd_views(b, l, h, d, dtype):
        slab = torch.randn((b * l, 3 * h * d), generator=gen, device="cuda").to(dtype)
        return tuple(slab[:, i * h * d : (i + 1) * h * d].view(b, l, h, d) for i in range(3))

    q, k, v = blhd_views(48, 784, 12, 64, bf16)
    res["blhd"] = compare_attention(
        "blhd (48,784,12,64) strided qkv bf16",
        lambda: k1.encoder_attention_blhd(q, k, v),
        lambda: k1.encoder_attention_blhd_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2)),
        bf16, attention_bound(48, 12, 784, 784, 64, 64, bf16),
        weighted=abs_v(k1.encoder_attention_blhd_reference, q, k, v),
    )
    q, k, v = blhd_views(8, 784, 12, 64, f32)
    res["blhd_f32"] = compare_attention(
        "blhd (8,784,12,64) strided qkv f32",
        lambda: k1.encoder_attention_blhd(q, k, v),
        lambda: k1.encoder_attention_blhd_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2)),
        f32, attention_bound(8, 12, 784, 784, 64, 64, f32),
    )
    for dtype in (bf16, f32):
        edge_gate("blhd edge shapes (L = 1, 8, 17, 130; strided; scale 0.3)", [
            (lambda t=qkv: k1.encoder_attention_blhd(*t, sm_scale=0.3),
             lambda t=qkv: k1.encoder_attention_blhd_reference(*t, 0.3),
             abs_v(k1.encoder_attention_blhd_reference, *qkv, 0.3))
            for l in (1, 8, 17, 130) for qkv in [blhd_views(2, l, 3, 40, dtype)]])
    return res


def cosines(a, b):
    import torch

    return torch.nn.functional.cosine_similarity(
        a.float().reshape(a.shape[0], -1), b.float().reshape(b.shape[0], -1), dim=-1)


def kernel_route_page(counters, default_detector, default_embedder) -> dict:
    """The ViT page with every opt-in kernel route on, at full width; held
    against phase 4's default route on the same weights and page."""
    import torch

    from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
    from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.vision_encoder import (
        DualEncoderConfig,
        VisionConfig,
    )
    from multimodal_embeddings_tpu_torch.ops.image import extract_views_matmul
    from multimodal_embeddings_tpu_torch.pipeline.fused import (
        build_split_page_fn,
        view_slice_bounds_for_page,
    )

    phase("4b. the ViT page on the kernel routes (K5, K6, K7, K1-BLHD)")
    t0 = time.perf_counter()
    det_config = DetectorConfig(image_size=1024, variant="m", pallas_convs=96,
                                pallas_mode="stage")
    detector = LayoutDetector(det_config, dtype=torch.bfloat16, device="cuda", seed=0)
    model_config = DualEncoderConfig(
        vision=VisionConfig(448, 16, 768, 12, 12, fuse_ln=True), embed_dim=768)
    embedder = MultimodalEmbedder(EmbedderConfig(family="siglip", dtype="bfloat16"),
                                  model_config=model_config, device="cuda", seed=0)
    fn = build_split_page_fn(detector, embedder, PAGE_HW, num_regions=NUM_REGIONS,
                             embed_chunk=NUM_REGIONS)
    pages = make_pages(1 + TIMED_PAGES)
    torch.cuda.synchronize()
    print(f"set-up (random init, upload): {time.perf_counter() - t0:.1f} s; "
          f"{det_config} VisionConfig.fuse_ln=True {ROUTE_SWITCHES}")
    layers = model_config.vision.layers
    per_page = {
        "conv3x3_nchw": len(detector.model.kernel_bias_names()), "ln_matmul": 2 * layers,
        "encoder_attention_blhd": layers, "ln_stats": 1, "encoder_attention_blf_packed": 1,
    }
    check(per_page["conv3x3_nchw"] == 12, f"K5 convs {per_page['conv3x3_nchw']} != 12")
    with switches(ROUTE_SWITCHES):
        t0 = time.perf_counter()
        fn(pages[0])
        torch.cuda.synchronize()
        print(f"warm-up page: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        torch.cuda.reset_peak_memory_stats()
        zero(counters)
        page_ms, results = [], []
        for page in pages[1:]:
            t0 = time.perf_counter()
            res = fn(page)
            torch.cuda.synchronize()
            page_ms.append((time.perf_counter() - t0) * 1e3)
            results.append(res)
        launches = counts(counters)
        peak = torch.cuda.max_memory_allocated()
        want = only(counters, {name: cnt * TIMED_PAGES for name, cnt in per_page.items()})
        check(launches == want, f"launches {launches} != {want}")
        for res in results:
            check_page(res, 768)
        print(f"ms/page {statistics.mean(page_ms):.1f} (pages: "
              + ", ".join(f"{t:.1f}" for t in page_ms) + ")")
        print(f"launches over {TIMED_PAGES} pages: " + ", ".join(
            f"{k} {v}" for k, v in launches.items() if v))
        print(f"peak device memory: {peak / 2**30:.2f} GiB")
        det_ms, emb_ms = [], []
        for page in pages[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *_, crops = fn.detect(page)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            embs = fn.embed(crops)
            torch.cuda.synchronize()
            det_ms.append((t1 - t0) * 1e3)
            emb_ms.append((time.perf_counter() - t1) * 1e3)
        print(f"detect+crop {statistics.mean(det_ms):.1f} ms/page, "
              f"embed {statistics.mean(emb_ms):.1f} ms/page")
        profile_run("kernel-route page", lambda: fn(pages[-1]))

        # the same weights and page on phase 4's default route
        with torch.inference_mode():
            bounds = view_slice_bounds_for_page(PAGE_HW[1], PAGE_HW[0],
                                                det_config.grid_configs,
                                                det_config.overlap_percentage)
            views = extract_views_matmul(pages[-1].to(torch.bfloat16), bounds, 1024,
                                         dtype=torch.bfloat16) / 255.0
            got_maps = detector.model(views)
            with switches({k: "0" for k in ROUTE_SWITCHES}):
                want_maps = default_detector.model(views)
                want_embs = default_embedder.encode_image(crops)
        level_cos = []
        for (greg, gcls), (wreg, wcls) in zip(got_maps, want_maps):
            c = torch.cat([cosines(greg, wreg), cosines(gcls, wcls)])
            level_cos.append(c.min().item())
        emb_cos = cosines(embs, want_embs)
        print(f"kernel route vs default route, same weights and page: head maps cosine "
              f"(min over the 30 views, per level) {[round(c, 6) for c in level_cos]}; "
              f"embeddings of the same 48 crops min {emb_cos.min().item():.6f}")
        check(min(level_cos) >= COSINE_MIN, f"head map cosine {level_cos} < {COSINE_MIN}")
        check(bool((emb_cos >= COSINE_MIN).all()), f"embedding cosine {emb_cos.min()}")

        cpu = MultimodalEmbedder(EmbedderConfig(family="siglip", dtype="float32"),
                                 model_config=model_config, device="cpu", seed=0)
        ref = cpu.encode_image(crops[:2].float().cpu())
        cos = cosines(embs[:2].cpu(), ref)
        print(f"fused ViT: card (bf16, kernels) vs CPU (f32, plain): "
              f"{[round(c, 6) for c in cos.tolist()]}")
        check(bool((cos >= COSINE_MIN).all()), f"cosine {cos.tolist()} < {COSINE_MIN}")
    return launches


def mme5_tower(counters, embedder, crops) -> dict:
    """Phase 8's mmE5-11B vision tower, its weights reused, with
    ``fuse_ln="mlp"`` and the LayerNorm statistics on K7, over one chunk."""
    import torch

    from multimodal_embeddings_tpu_torch.models.mllama_processor import IMAGE_MEAN, IMAGE_STD
    from multimodal_embeddings_tpu_torch.models.mme5 import MllamaVisionEncoder

    phase('8a. mmE5-11B vision tower with fuse_ln="mlp" and MMTPU_LN_STATS=1 (one chunk)')
    config = embedder.model_config
    default = embedder.model.vision_model
    cfg = dataclasses.replace(config.vision, fuse_ln="mlp")
    with torch.device("meta"):
        tower = MllamaVisionEncoder(cfg, config.text.hidden, embedder.dtype)
    tower.load_state_dict(default.state_dict(), assign=True)  # the same tensors
    tower.eval()
    mean = torch.tensor(IMAGE_MEAN, device="cuda", dtype=crops.dtype)
    std = torch.tensor(IMAGE_STD, device="cuda", dtype=crops.dtype)
    chunk = ((crops[:MME5_CHUNK] - mean) / std)[:, None]
    ids = torch.ones(MME5_CHUNK, dtype=torch.long, device="cuda")
    runs = 3
    with switches({"MMTPU_LN_STATS": "1"}), torch.inference_mode():
        tower(chunk, ids)
        torch.cuda.synchronize()
        zero(counters)
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            got, _ = tower(chunk, ids)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = counts(counters)
    with torch.inference_mode():
        default(chunk, ids)
        torch.cuda.synchronize()
        base = []
        for _ in range(runs):
            t0 = time.perf_counter()
            want, _ = default(chunk, ids)
            torch.cuda.synchronize()
            base.append((time.perf_counter() - t0) * 1e3)
    v = cfg
    per_chunk = {"ln_matmul": v.layers, "ln_stats": v.layers + 1 + 2 * v.global_layers,
                 "encoder_attention": v.layers + v.global_layers}
    want_launches = only(counters, {k: c * runs for k, c in per_chunk.items()})
    check(launches == want_launches, f"launches {launches} != {want_launches}")
    check(bool(torch.isfinite(got).all()), "non-finite tower output")
    cos = cosines(got, want)
    print(f"ms per chunk of {MME5_CHUNK}: kernel routes {statistics.median(times):.1f} "
          f"(runs: " + ", ".join(f"{t:.1f}" for t in times) + f"), default route "
          f"{statistics.median(base):.1f}")
    print(f"launches per chunk: " + ", ".join(
        f"{k} {c // runs}" for k, c in launches.items() if c))
    print(f"tower output vs the default route, same chunk: cosine per crop min "
          f"{cos.min().item():.6f}")
    check(bool((cos >= COSINE_MIN).all()), f"tower cosine {cos.tolist()} < {COSINE_MIN}")
    return {k: c // runs for k, c in launches.items()}


# --- the last ports: K1's BHLD form, K4 v2, K5's stride-2 form, K8 ----------

# (B, L, H, D) and valid keys of the attention candidates
# (scripts/attn_candidates_bench.py): the ViT-B page tower, an mmE5-2B vision
# chunk and a 4-tile mmE5-11B chunk
K4_V2_SHAPES = {
    "vit (48,784,12,64)": ((48, 784, 12, 64), None),
    "mme5-2B (8,1608,16,80) valid 1601": ((8, 1608, 16, 80), 1601),
    "mme5-11B 4-tile (2,6432,16,80) valid 6404": ((2, 6432, 16, 80), 6404),
}
K4_V2_HEADLINE = "mme5-11B 4-tile (2,6432,16,80) valid 6404"
# (N, C, H, W, Cout) of the detector's stride-2 3x3 positions at variant m
# over 30 views of 1024 px: the stem, and the first two downsamples
K5_S2_SHAPES = {
    "stem (30,3,1024,1024)->48": (30, 3, 1024, 1024, 48),
    "down (30,48,512,512)->96": (30, 48, 512, 512, 96),
    "down (30,96,256,256)->192": (30, 96, 256, 256, 192),
}
K5_S2_HEADLINE = "down (30,48,512,512)->96"
# the weights K8 would quantize: the mmE5-11B text stack's gate/up, the
# Qwen2.5-VL-32B decoder's gate, and a rank-3 kernel collapsed to 2-D
K8_SHAPES = {
    "mme5-11B gate/up (4096,14336) f32": ((4096, 14336), "float32"),
    "qwen-32B gate (5120,27648) bf16": ((5120, 27648), "bfloat16"),
    "rank 3 (4096,32,128) contract (0,) f32": ((4096, 32, 128), "float32"),
}
K8_HEADLINE = "qwen-32B gate (5120,27648) bf16"
# the mean of q·scale − w against scale/√(12·n), the size of the mean of n
# rounding errors spread evenly over one level: stochastic rounding keeps
# it within a few of that, round-to-floor would put it near √(3n)
K8_MEAN_RATIO_MAX = 10.0


def sr_case(k2, name, shape, dtype, seed) -> dict:
    """K8 through its entry point (the seeded draw) against its plain
    version on the same draw: EXACTLY equal int8 values."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(100 + seed)
    w = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dtype)
    rows = shape[0]
    cols = w.numel() // rows
    qt = k2.stochastic_round_quantize(w, (0,), seed=seed)
    w2 = w.reshape(rows, cols)  # the contracted axis leads: the collapse is a view
    scale_row = k2.compute_scale(w, (0,)).reshape(1, cols)
    u = k2.sr_uniform((rows, cols), seed, "cuda")
    want = k2.sr_quantize_reference(w2, scale_row, u).reshape(shape)
    torch.cuda.synchronize()
    check(qt.q.dtype == torch.int8 and qt.q.shape == w.shape, f"{name}: {qt.q.dtype} {qt.q.shape}")
    mismatched = int((qt.q != want).sum())
    max_err = int((qt.q.int() - want.int()).abs().max())
    check(mismatched == 0, f"{name}: {mismatched} int8 values differ from the plain version")
    mean_err = (qt.q.double() * qt.scale.double() - w.double()).mean().item()
    spread = qt.scale.double().mean().item() / math.sqrt(12 * w.numel())
    check(abs(mean_err) <= K8_MEAN_RATIO_MAX * spread,
          f"{name}: mean of q·scale − w {mean_err:.3e} > {K8_MEAN_RATIO_MAX}× {spread:.3e}")
    out = {"max_abs_err": max_err, "mismatched": mismatched, "mean_err": mean_err,
           "mean_err_scale": spread}
    out["ms"] = median_ms(lambda: k2._sr_quantize_2d(w2, scale_row, u))
    out["plain_ms"] = median_ms(lambda: k2.sr_quantize_reference(w2, scale_row, u))
    out["rand_ms"] = median_ms(lambda: k2.sr_uniform((rows, cols), seed, "cuda"))
    out["entry_ms"] = median_ms(lambda: k2.stochastic_round_quantize(w, (0,), seed=seed),
                                runs=10)
    out["library_ms"] = None  # no one PyTorch call rounds stochastically
    n = w.numel()
    out["bound_ms"], out["bound_by"] = bound_ms(
        3.0 * n, n * (w.element_size() + 4 + 1) + 4 * cols, torch.float32)
    print(f"{name}: int8 values differing from the plain version {mismatched}; mean of "
          f"q·scale − w {mean_err:.3e} (scale/√(12n) {spread:.3e}); kernel {out['ms']:.4f} ms "
          f"plain {out['plain_ms']:.4f} ms bound {out['bound_ms']:.4f} ms ({out['bound_by']}) "
          f"[context: torch.rand draw {out['rand_ms']:.4f} ms; the whole entry point "
          f"(scale, draw, kernel) {out['entry_ms']:.4f} ms]", flush=True)
    return out


def last_port_checks(k1, k2, k4, k5) -> dict:
    """K1's BHLD form, K4 v2, K5's stride-2 form and K8 against their plain
    versions."""
    import torch
    import torch.nn.functional as F

    phase("3a. K1-BHLD, K4 v2, K5 stride 2 and K8 against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    res = {}

    # K1 in BHLD form on (B, H, L, D) permuted views of (B, L, H·D)
    # projections, as the proj-BHLD route hands them
    def bhld_views(b, h, l, d, dtype):
        return torch.randn((b, l, h * d), generator=gen, device=dev).to(dtype).view(
            b, l, h, d).permute(0, 2, 1, 3)

    for key, (b, h, l, d, dv), dtype in (("vit", (48, 12, 784, 64, 64), bf16),
                                         ("vit_f32", (8, 12, 784, 64, 64), f32),
                                         ("psa", (30, 4, 1024, 64, 128), bf16)):
        q, k, v = bhld_views(b, h, l, d, dtype), bhld_views(b, h, l, d, dtype), \
            bhld_views(b, h, l, dv, dtype)
        res["bhld_" + key] = compare_attention(
            f"bhld ({b},{h},{l},{d}|{dv}) views {str(dtype).split('.')[-1]}",
            lambda: k1.encoder_attention(q, k, v, bhld_inputs=True),
            lambda: k1.encoder_attention_reference(q, k, v, bhld_inputs=True),
            lambda: F.scaled_dot_product_attention(q, k, v),
            dtype, attention_bound(b, h, l, l, d, dv, dtype),
            weighted=abs_v(k1.encoder_attention_reference, q, k, v, bhld_inputs=True))
    for dtype in (bf16, f32):
        edge_gate("bhld edges (L = 1, 17, 130; valid_len 1, L-1, L; views; Dv != D)", [
            (lambda t=qkv, n=n: k1.encoder_attention(*t, valid_len=n, bhld_inputs=True),
             lambda t=qkv, n=n: k1.encoder_attention_reference(*t, n, bhld_inputs=True),
             abs_v(k1.encoder_attention_reference, *qkv, n, bhld_inputs=True))
            for l in (1, 17, 130) for n in sorted({1, max(1, l - 1), l})
            for qkv in [(bhld_views(2, 3, l, 40, dtype), bhld_views(2, 3, l, 40, dtype),
                         bhld_views(2, 3, l, 56, dtype))]])

    # K4 on its K/V-resident schedule, K4 v1 and SDPA beside it
    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    res["v2"] = {}
    for name, ((b, l, h, d), valid) in K4_V2_SHAPES.items():
        lengths = None if valid is None else torch.full((b,), valid, dtype=torch.int32,
                                                        device=dev)
        res["v2"][name] = flash_compare(k4, f"v2 {name} bf16", randn(b, l, h, d),
                                        randn(b, l, h, d), randn(b, l, h, d), lengths, False,
                                        timed=True, v2=True)
    b, l, h, kvh, dk, dv = QWEN_TEXT_ATTN
    res["v2"]["causal"] = flash_compare(
        k4, f"v2 text causal ({b},{l},{h}/{kvh},{dk}) bf16", randn(b, l, h, dk),
        randn(b, l, kvh, dk), randn(b, l, kvh, dv), None, True, timed=True, v2=True)
    res["v2"]["f32"] = flash_compare(
        k4, "v2 f32 (2,1608,16,80) valid 1601", randn(2, 1608, 16, 80, dtype=f32),
        randn(2, 1608, 16, 80, dtype=f32), randn(2, 1608, 16, 80, dtype=f32),
        torch.full((2,), 1601, dtype=torch.int32, device=dev), False, timed=True, v2=True)
    for l in (1, 127, 129):
        for causal in (False, True):
            for dtype in (bf16, f32):
                lens = sorted({1, max(1, l - 1)})
                lengths = torch.tensor([lens[i % len(lens)] for i in range(2)],
                                       dtype=torch.int32, device=dev)
                flash_compare(
                    k4, f"v2 edge L={l} causal={causal} lengths={lengths.tolist()} Dk=40 "
                        f"Dv=56 4/2 heads {str(dtype).split('.')[-1]}",
                    randn(2, l, 4, 40, dtype=dtype), randn(2, l, 2, 40, dtype=dtype),
                    randn(2, l, 2, 56, dtype=dtype), lengths, causal, timed=False, v2=True)

    # K5's stride-2 form at the detector's positions, ragged edges, one f32
    res["s2"] = k5_s2_checks(k5)

    # K8 on the card's draws
    res["k8"] = {}
    for i, (name, (shape, dtype)) in enumerate(K8_SHAPES.items()):
        res["k8"][name] = sr_case(k2, name, shape, getattr(torch, dtype), seed=i)
        torch.cuda.empty_cache()
    return res


def bhld_route_page(counters, detector, embedder, crops, embs) -> dict:
    """The ViT page on the proj-BHLD route with phase 4's weights and pages;
    its embeddings of phase 4's last 48 crops held against phase 4's."""
    import torch

    from multimodal_embeddings_tpu_torch.pipeline.fused import build_split_page_fn

    phase("4c. the ViT page on the proj-BHLD route (MMTPU_ENC_ATTN_BLF=0)")
    fn = build_split_page_fn(detector, embedder, PAGE_HW, num_regions=NUM_REGIONS,
                             embed_chunk=NUM_REGIONS)
    pages = make_pages(1 + TIMED_PAGES)
    layers = embedder.model_config.vision.layers
    with switches({"MMTPU_ENC_ATTN_BLF": "0"}):
        t0 = time.perf_counter()
        fn(pages[0])
        torch.cuda.synchronize()
        print(f"warm-up page: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        zero(counters)
        page_ms, results = [], []
        for page in pages[1:]:
            t0 = time.perf_counter()
            res = fn(page)
            torch.cuda.synchronize()
            page_ms.append((time.perf_counter() - t0) * 1e3)
            results.append(res)
        launches = counts(counters)
        want = only(counters, {"encoder_attention (bhld)": layers * TIMED_PAGES,
                               "encoder_attention_blf_packed": TIMED_PAGES})
        check(launches == want, f"launches {launches} != {want}")
        for res in results:
            check_page(res, 768)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn.embed(crops)
        torch.cuda.synchronize()
        embed_ms = (time.perf_counter() - t0) * 1e3
    print(f"ms/page {statistics.mean(page_ms):.1f} (pages: "
          + ", ".join(f"{t:.1f}" for t in page_ms) + f"); embed of 48 crops {embed_ms:.1f} ms")
    print(f"launches over {TIMED_PAGES} pages: " + ", ".join(
        f"{k} {v}" for k, v in launches.items() if v))
    cos = cosines(got, embs)
    print(f"proj-BHLD route vs phase 4's BLF route, the same 48 crops: embedding cosine min "
          f"{cos.min().item():.6f}")
    check(bool((cos >= COSINE_MIN).all()), f"embedding cosine {cos.min().item()} < {COSINE_MIN}")
    return launches


# phase 16: the serving CLI at full width on its defaults. 4 synthetic pages
# at 2200x1700 fall in the (2400, 1800) bucket and one at 1500x1150 in (1600,
# 1200); a corrupt .png beside them must be skipped
SERVE_PAGES = ((2200, 1700),) * 4 + ((1500, 1150),)
SERVE_MME5_PAGES = 2
SERVE_STORE_ROWS = 100_000
SERVE_QUERIES, SERVE_K = 64, 10
SERVE_TIE = 1e-5  # similarities this close may rank either way
# the native HNSW build is single-threaded on the host and grows about as
# the square of the rows (2,000 rows: 2.6-4.8 s on an H100 machine's host):
# 4,000 rows of the store, cut from 10,000 to keep the phase near 90 s
SERVE_HNSW_ROWS = 4_000


class _IngestLog:
    """Collects the serving CLI's "ingested N pages in S s" records."""

    def __init__(self):
        import logging

        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = self.records.append
        logging.getLogger("mmtpu.cli.serve").addHandler(self.handler)

    def ingest_seconds(self) -> float:
        rec = [r for r in self.records if r.msg.startswith("ingested")][-1]
        return float(rec.args[1])

    def close(self) -> None:
        import logging

        logging.getLogger("mmtpu.cli.serve").removeHandler(self.handler)


def serve_args(folder: str, db: str, *extra) -> list:
    return ["--input_folder", folder, "--db_path", db, *extra]


def serve_launches(vit_layers: int, n_pages: int) -> dict:
    """Per siglip page: K1 packed once (the PSA over 30 views), K1 BLF once
    per ViT layer for the 48 crops and once per layer for the whole-page
    embedding."""
    return {"encoder_attention_blf_packed": n_pages,
            "encoder_attention_blf": 2 * vit_layers * n_pages}


def serving_cli(counters) -> dict:
    """Phase 16; returns the launches of the pipelined siglip run and of the
    mme5 run."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from multimodal_embeddings_tpu_torch.cli import serve
    from multimodal_embeddings_tpu_torch.ops.image import letterbox_views_matmul
    from multimodal_embeddings_tpu_torch.pipeline.fused import view_slice_bounds_for_page
    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page
    from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db, masked_topk
    from multimodal_embeddings_tpu_torch.utils.native import cosine_topk_native

    phase("16. the serving CLI at full width (cli.serve: siglip, letterbox, the store)")
    out = {}
    log = _IngestLog()
    with tempfile.TemporaryDirectory() as tmp:
        folder, warm = os.path.join(tmp, "pages"), os.path.join(tmp, "warm")
        os.makedirs(folder)
        os.makedirs(warm)
        t0 = time.perf_counter()
        pages = []
        for i, (h, w) in enumerate(SERVE_PAGES):
            path = os.path.join(folder, f"page_{i}.png")
            Image.fromarray(make_page(h, w, seed=20 + i)).save(path)
            pages.append(path)
        corrupt = os.path.join(folder, "page_corrupt.png")
        with open(corrupt, "wb") as f:
            f.write(b"not a png")
        for path in (pages[0], pages[-1]):  # one page of each bucket
            shutil.copy(path, warm)
        buckets = sorted({serve.bucket_for(h, w, serve.DEFAULT_BUCKETS) for h, w in SERVE_PAGES})
        print(f"pages: {len(pages)} + 1 corrupt, buckets {buckets}; "
              f"written in {time.perf_counter() - t0:.1f} s")
        check(buckets == [(1600, 1200), (2400, 1800)], f"buckets {buckets}")

        # warm-up: the same CLI on one page of each bucket, into its own store
        serve.main(serve_args(warm, os.path.join(tmp, "db_warm")))
        torch.cuda.synchronize()

        # 1. pipelined, through the user's entry point
        torch.cuda.reset_peak_memory_stats()
        zero(counters)
        t0 = time.perf_counter()
        check(serve.main(serve_args(folder, os.path.join(tmp, "db_a"))) == 0, "serve exit code")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(counters)
        peak = torch.cuda.max_memory_allocated()
        pipelined_s = log.ingest_seconds()
        errors = [r for r in log.records if r.levelname == "ERROR"]
        check(len(errors) == 1 and corrupt in errors[0].getMessage(),
              f"the corrupt page logged once: {[r.getMessage() for r in errors]}")
        vit_layers = 12
        want = only(counters, serve_launches(vit_layers, len(pages)))
        check(launches == want, f"launches {launches} != {want}")
        out["pipelined"] = launches
        print(f"pipelined: {len(pages)} pages ingested in {pipelined_s:.3f} s "
              f"({1e3 * pipelined_s / len(pages):.1f} ms/page, {len(pages) / pipelined_s:.3f} "
              f"pages/s; main() {wall:.1f} s with the models' set-up); peak device memory "
              f"{peak / 2**30:.2f} GiB")
        print("launches per page: " + ", ".join(
            f"{k} {c // len(pages)}" for k, c in launches.items() if c))

        # 2. sequential (--no_prefetch), through the server main() builds
        args = serve.build_parser().parse_args(
            serve_args(folder, os.path.join(tmp, "db_b"), "--no_prefetch"))
        server = serve.FusedServer(args)
        zero(counters)
        check(server.run_once() == len(pages) + 1, "sequential run attempted every page")
        torch.cuda.synchronize()
        check(counts(counters) == want, f"sequential launches {counts(counters)} != {want}")
        sequential_s = log.ingest_seconds()
        print(f"sequential: {len(pages)} pages ingested in {sequential_s:.3f} s "
              f"({1e3 * sequential_s / len(pages):.1f} ms/page, "
              f"{len(pages) / sequential_s:.3f} pages/s)")
        for path in pages:
            check(server.progress.is_completed(path), f"{path} not marked done")
        check(not server.progress.is_completed(corrupt), "the corrupt page marked done")
        check(server.run_once() == 1, "a second run attempts only the corrupt page")
        profiled = serve.FusedServer(serve.build_parser().parse_args(
            serve_args(folder, os.path.join(tmp, "db_c"))))
        profile_run(f"the pipelined ingest of {len(pages)} pages (run_once)", profiled.run_once)
        del profiled

        # the two stores: the same ids, embeddings equal bit for bit
        _, pipelined_store = initialize_db(os.path.join(tmp, "db_a"), device="cuda")
        a = pipelined_store.get(include=("embeddings", "metadatas"))
        b = server.collection.get(include=("embeddings", "metadatas"))
        check(sorted(a["ids"]) == sorted(b["ids"]), "pipelined and sequential ids differ")
        ea, eb = dict(zip(a["ids"], a["embeddings"])), dict(zip(b["ids"], b["embeddings"]))
        check(all(ea[i] == eb[i] for i in ea), "pipelined and sequential embeddings differ")
        n_regions = sum(i.startswith("region_") for i in a["ids"])
        vecs = np.asarray(a["embeddings"])
        check(bool(np.isfinite(vecs).all()), "non-finite stored embeddings")
        check(bool((np.abs(np.linalg.norm(vecs, axis=1) - 1) < 1e-3).all()), "stored norms")
        print(f"stores equal bit for bit: {len(a['ids'])} ids ({n_regions} regions, "
              f"{len(a['ids']) - n_regions} pages)")

        # the served page's halves, timed apart, and a profile of one page
        fn = server._fn_for_bucket((2400, 1800))
        padded = torch.from_numpy(server._prepare(pages[1])[0]).to("cuda")
        det_ms, emb_ms, page_embed_ms = [], [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *_, crops = fn.detect(padded)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn.embed(crops)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            server.embedder.get_image_embeddings([pages[1]], batch_size=1)
            t3 = time.perf_counter()
            det_ms.append((t1 - t0) * 1e3)
            emb_ms.append((t2 - t1) * 1e3)
            page_embed_ms.append((t3 - t2) * 1e3)
        print(f"served (2400, 1800) page: detect+crop {statistics.mean(det_ms):.1f} ms, "
              f"embed 48 crops {statistics.mean(emb_ms):.1f} ms, whole-page embedding "
              f"(host API, decode included) {statistics.mean(page_embed_ms):.1f} ms")
        profile_run("one served page (process_page)", lambda: server.process_page(pages[2]))

        # 3. letterboxed views: the card's bf16 program against the CPU's f32
        cfg = server.detector.config
        bounds = view_slice_bounds_for_page(1800, 2400, cfg.grid_configs,
                                            cfg.overlap_percentage)
        with torch.inference_mode():
            card = letterbox_views_matmul(padded.to(torch.bfloat16), bounds,
                                          cfg.image_size)[0].to(torch.bfloat16)
        cpu = letterbox_views_matmul(padded.cpu().float(), bounds, cfg.image_size)[0]
        err = float((card.float().cpu() - cpu).abs().max())
        print(f"letterboxed views ({len(bounds)} views at {cfg.image_size}): card bf16 vs "
              f"CPU f32 max |diff| {err:.3f} (gate: one uint8 step)")
        check(err <= 1.0, f"letterboxed views differ by {err}")

        # 4. the store at 100,000 rows of 768 f32 on the card
        coll = server.collection
        n0 = coll.count()
        rng = np.random.default_rng(16)
        extra = rng.standard_normal((SERVE_STORE_ROWS - n0, 768)).astype(np.float32)
        extra /= np.linalg.norm(extra, axis=1, keepdims=True)
        t0 = time.perf_counter()
        coll.upsert(ids=[f"synthetic_{i}" for i in range(len(extra))], embeddings=extra,
                    metadatas=[{"is_region": True, "synthetic": True}] * len(extra))
        upsert_s = time.perf_counter() - t0
        queries = rng.standard_normal((SERVE_QUERIES, 768)).astype(np.float32)
        coll.query(queries[:1], n_results=SERVE_K)  # places the corpus on the card
        corpus = coll._device_embeddings()
        torch.cuda.synchronize()
        check(corpus.is_cuda and tuple(corpus.shape) == (SERVE_STORE_ROWS, 768),
              f"corpus {tuple(corpus.shape)} on {corpus.device}")
        q_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = coll.query(queries, n_results=SERVE_K)
            q_times.append((time.perf_counter() - t0) * 1e3)
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        qd = torch.from_numpy(qn).cuda()
        mask = torch.ones(SERVE_STORE_ROWS, dtype=torch.bool, device="cuda")
        topk_ms = median_ms(lambda: masked_topk(corpus, qd, mask, SERVE_K), runs=10)
        ids = coll.get(include=())["ids"]
        position = {i: n for n, i in enumerate(ids)}
        host = corpus.cpu().numpy()
        exact = host.astype(np.float64) @ qn.astype(np.float64).T  # (N, Q)
        near, t0 = 0, time.perf_counter()
        for qi in range(SERVE_QUERIES):
            nat, _ = cosine_topk_native(host, qn[qi], SERVE_K)
            got = np.asarray([position[i] for i in res["ids"][qi]])
            for g, w in zip(got, nat):
                if g != w:
                    near += 1
                    check(abs(exact[g, qi] - exact[w, qi]) <= SERVE_TIE,
                          f"query {qi}: row {g} for {w}, similarities "
                          f"{exact[g, qi]} vs {exact[w, qi]}")
        native_s = time.perf_counter() - t0
        print(f"store: {SERVE_STORE_ROWS} rows x 768 f32 on the card "
              f"({SERVE_STORE_ROWS * 768 * 4 / 1e9:.3f} GB; upsert of {len(extra)} rows "
              f"{upsert_s:.1f} s); {SERVE_QUERIES} queries at k={SERVE_K}: "
              f"{statistics.median(q_times):.1f} ms per query batch (host clock, query()), "
              f"masked_topk {topk_ms:.3f} ms (CUDA events); ids equal to the native host "
              f"ranking ({native_s:.1f} s) but at {near} near-ties within {SERVE_TIE}")

        # the HNSW collection over the store's first rows
        _, hnsw = initialize_db(os.path.join(tmp, "db_hnsw"), index="hnsw", device="cuda")
        rows = host[:SERVE_HNSW_ROWS]
        t0 = time.perf_counter()
        hnsw.upsert(ids=ids[:SERVE_HNSW_ROWS], embeddings=rows)
        build_s = time.perf_counter() - t0
        approx = hnsw.query(queries, n_results=SERVE_K)["ids"]
        hits = 0
        for qi in range(SERVE_QUERIES):
            nat, _ = cosine_topk_native(rows, qn[qi], SERVE_K)
            hits += len({ids[j] for j in nat} & set(approx[qi]))
        recall = hits / (SERVE_QUERIES * SERVE_K)
        print(f"hnsw over the first {SERVE_HNSW_ROWS} rows (M=32, ef 200): build "
              f"{build_s:.1f} s, recall@{SERVE_K} {recall:.4f} against exact")
        check(recall >= 0.5, f"hnsw recall@{SERVE_K} {recall}")
        del server, coll, corpus, pipelined_store
        gc_cuda()

        # 5. mmE5 int8-mixed on two pages
        mfolder = os.path.join(tmp, "mme5_pages")
        os.makedirs(mfolder)
        for path in pages[:SERVE_MME5_PAGES]:
            shutil.copy(path, mfolder)
        margs = serve.build_parser().parse_args(serve_args(
            mfolder, os.path.join(tmp, "db_m"), "--embedder_family", "mme5", "--quantize"))
        t0 = time.perf_counter()
        mserver = serve.FusedServer(margs)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        chunk = mserver._embed_chunk()
        zero(counters)
        check(mserver.run_once() == SERVE_MME5_PAGES, "mme5 run attempted both pages")
        torch.cuda.synchronize()
        mme5_s = log.ingest_seconds()
        mlaunches = counts(counters)
        config = mserver.embedder.model_config
        chunks = NUM_REGIONS // chunk
        per_page = mme5_launches(config, chunks, chunks)
        page_embed = mme5_launches(config, 0, 1, prefix=False)
        del page_embed["encoder_attention_blf_packed"]
        for k, c in page_embed.items():
            per_page[k] = per_page.get(k, 0) + c
        mwant = only(counters, {k: c * SERVE_MME5_PAGES for k, c in per_page.items()})
        check(mlaunches == mwant, f"mme5 launches {mlaunches} != {mwant}")
        out["mme5"] = mlaunches
        m = mserver.collection.get(include=("embeddings",))
        mvecs = np.asarray(m["embeddings"])
        check(sum(not i.startswith("region_") for i in m["ids"]) == SERVE_MME5_PAGES,
              "mme5 page embeddings")
        check(bool(np.isfinite(mvecs).all()), "non-finite mme5 embeddings")
        check(bool((np.abs(np.linalg.norm(mvecs, axis=1) - 1) < 1e-3).all()), "mme5 norms")
        print(f"mme5 int8-mixed: set-up {setup_s:.1f} s, embed chunk {chunk}; "
              f"{SERVE_MME5_PAGES} pages in {mme5_s:.3f} s "
              f"({1e3 * mme5_s / SERVE_MME5_PAGES:.1f} ms/page); {len(m['ids'])} ids; "
              "launches per page: " + ", ".join(
                  f"{k} {c // SERVE_MME5_PAGES}" for k, c in mlaunches.items() if c))
        del mserver
        gc_cuda()
    log.close()
    return out


class _LogRecords:
    """Collects the records of the ``mmtpu`` loggers while it is open."""

    def __init__(self):
        import logging

        self.records = []
        self.handler = logging.Handler()
        self.handler.emit = self.records.append
        logging.getLogger("mmtpu").addHandler(self.handler)

    def __enter__(self) -> "_LogRecords":
        return self

    def __exit__(self, *exc) -> None:
        import logging

        logging.getLogger("mmtpu").removeHandler(self.handler)

    def stage_seconds(self) -> dict:
        """Wall seconds of each stage the runner ran: from its "running"
        record to the next one (the last to the timing summary)."""
        marks = [(r.args[0], r.created) for r in self.records
                 if r.name == "mmtpu.runner" and r.msg == "stage %s: running"]
        end = [r.created for r in self.records if r.name == "mmtpu.profiling"][-1]
        return {name: (marks[i + 1][1] if i + 1 < len(marks) else end) - t
                for i, (name, t) in enumerate(marks)}

    def pipeline_results(self) -> dict:
        # logging keeps a lone dict argument as the record's args
        return [r.args for r in self.records if r.name == "mmtpu.cli.pipeline"][-1]


def _file_digests(root: str) -> dict:
    import hashlib

    out = {}
    for folder in STAGE_FOLDERS:
        for dirpath, _, files in os.walk(os.path.join(root, folder)):
            for name in files:
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def fit_head(detector, image, view_boxes=STAGE_VIEW_BOXES) -> dict:
    """The class head's output convs ``{level: (weight, bias)}`` that
    ``view_boxes`` asks for, fitted on ``image``'s views (see
    ``STAGE_VIEW_BOXES``): each level's weight rows lose their component along the mean
    of the conv's input over the views, so that the logits vary about 0 and
    bf16 resolves them, then each class's row and bias take the affine map.
    Leaves ``detector`` with the fitted head."""
    import math

    import torch

    from multimodal_embeddings_tpu_torch.config import ID_TO_NAMES
    from multimodal_embeddings_tpu_torch.ops.image import letterbox_views_matmul

    head = detector.model.head
    convs = [getattr(head, f"cls{i}_out") for i in range(head.levels)]
    _, bounds, _ = detector._views_layout(*image.shape[:2])
    means = {}

    def logits():
        with torch.inference_mode():
            page = torch.from_numpy(image.copy()).to(detector.device).float()
            views, _ = letterbox_views_matmul(page, bounds, detector.config.image_size)
            maps = detector.model((views / 255.0).to(detector.dtype))
            return torch.cat([cls.flatten(1, 2) for _, cls in maps], 1).float()

    hooks = [conv.register_forward_hook(
        lambda m, args, out, i=i: means.__setitem__(i, args[0].float().mean((0, 2, 3))))
        for i, conv in enumerate(convs)]
    logits()
    for hook in hooks:
        hook.remove()
    with torch.no_grad():
        for i, conv in enumerate(convs):
            w, m = conv.weight.float()[:, :, 0, 0], means[i]
            w = w - torch.outer(w @ m, m) / (m @ m)
            conv.weight.copy_(w[:, :, None, None])
            conv.bias.zero_()
    z = logits()
    low = math.log(detector.config.conf_threshold / (1 - detector.config.conf_threshold))
    high = math.log(STAGE_BEST_SCORE / (1 - STAGE_BEST_SCORE))
    with torch.no_grad():
        for c in range(z.shape[-1]):
            k = view_boxes.get(ID_TO_NAMES[c], 0) * len(bounds)
            if k:
                best = z[..., c].flatten().topk(k).values
                spread = (best[0] - best[-1]).item()
                check(spread > 0, f"class {c}: its {k} best logits tie")
                a, b = (high - low) / spread, low - (high - low) / spread * best[-1].item()
            else:
                a, b = 0.0, 2 * low  # no anchor reaches the threshold
            for conv in convs:
                conv.weight[c] *= a
                conv.bias[c] = b
    return {i: (conv.weight.detach().clone(), conv.bias.detach().clone())
            for i, conv in enumerate(convs)}


def apply_head(detector, fit: dict) -> None:
    """Gives ``detector`` the class head ``fit_head`` fitted."""
    import torch

    with torch.no_grad():
        for i, (weight, bias) in fit.items():
            conv = getattr(detector.model.head, f"cls{i}_out")
            conv.weight.copy_(weight)
            conv.bias.copy_(bias)


def stage_chain(counters) -> dict:
    """Phase 17; returns the launches of the chain's run over the four
    pages."""
    import collections
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from multimodal_embeddings_tpu_torch.cli import pipeline as cli_pipeline
    from multimodal_embeddings_tpu_torch.config import DetectorConfig
    from multimodal_embeddings_tpu_torch.io.images import (
        load_image_bgr,
        load_image_rgb,
        save_image_bgr,
    )
    from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
    from multimodal_embeddings_tpu_torch.ops.image import rotate_bound
    from multimodal_embeddings_tpu_torch.ops.skew import detect_skew
    from multimodal_embeddings_tpu_torch.pipeline import detect as stage1
    from multimodal_embeddings_tpu_torch.pipeline.runner import (
        PipelineRunner,
        numbered_pipeline_stages,
    )

    phase("17. the numbered chain (run.sh stages 0-5) through cli.pipeline on the card")
    n = len(STAGE_ANGLES)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        src = os.path.join(run_dir, "pages")
        os.makedirs(src)
        t0 = time.perf_counter()
        paths = []
        for i, angle in enumerate(STAGE_ANGLES):
            path = os.path.join(src, f"page_{i}.png")
            Image.fromarray(synthetic_page(40 + i, angle)).save(path)
            paths.append(path)
        print(f"pages: {n} at {PAGE_HW}, rotated by {STAGE_ANGLES}; written in "
              f"{time.perf_counter() - t0:.1f} s")

        # the estimator: two card runs EQUAL, EQUAL to the CPU's f32 run, each
        # within STAGE_ANGLE_TOL of -angle
        rgbs = [load_image_rgb(p) for p in paths]
        card_a = [detect_skew(rgb, device="cuda") for rgb in rgbs]
        card_b = [detect_skew(rgb, device="cuda") for rgb in rgbs]
        t0 = time.perf_counter()
        cpu = [detect_skew(rgb, device="cpu") for rgb in rgbs]
        cpu_s = time.perf_counter() - t0
        print(f"skew estimates (card): {card_a}; second card run {card_b}; CPU f32 {cpu} "
              f"({1e3 * cpu_s / n:.0f} ms/page on the host)")
        check(card_a == card_b, f"two card runs differ: {card_a} vs {card_b}")
        check(card_a == cpu, f"card {card_a} vs CPU {cpu}")
        for angle, est in zip(STAGE_ANGLES, card_a):
            if angle:
                check(est is not None and abs(est + angle) <= STAGE_ANGLE_TOL,
                      f"page rotated by {angle}: estimate {est}")
            else:
                check(est is None or abs(est) <= STAGE_ANGLE_TOL, f"clean page: {est}")

        # warm-up: a detector of the chain's config (kept for the splits)
        # runs one page's views, so the chain's first forward finds the
        # card's libraries loaded
        t0 = time.perf_counter()
        detector = LayoutDetector(DetectorConfig())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        fit = fit_head(detector, rgbs[0])
        detector.detect_page_multigrid(paths[0], image=rgbs[0])

        # the chain through the user's entry point; stage 1 builds its own
        # detector, whose build is timed apart
        builds = []

        class TimedDetector(LayoutDetector):
            def __init__(self, *args, **kwargs):
                t0 = time.perf_counter()
                super().__init__(*args, **kwargs)
                apply_head(self, fit)
                torch.cuda.synchronize()
                builds.append(time.perf_counter() - t0)

        os.chdir(run_dir)
        torch.cuda.reset_peak_memory_stats()
        zero(counters)
        t0 = time.perf_counter()
        with _LogRecords() as log, _swap(stage1, "LayoutDetector", TimedDetector):
            check(cli_pipeline.main(["pages", "--device", "cuda"]) == 0, "chain exit code")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(counters)
        peak = torch.cuda.max_memory_allocated()
        want = only(counters, {"encoder_attention_blf_packed": n})
        check(launches == want, f"launches {launches} != {want}")
        results = log.pipeline_results()
        check(set(results.values()) == {"ran"} and len(results) == 6, f"first run {results}")
        seconds = log.stage_seconds()
        check(len(builds) == 1, f"stage 1 built {len(builds)} detectors")
        print(f"chain: {n} pages in {wall:.2f} s through cli.pipeline.main; peak device "
              f"memory {peak / 2**30:.2f} GiB; stage 1's detector build {builds[0]:.2f} s "
              f"(the warm-up's {build_s:.2f} s)")
        print("ms per page by stage: " + ", ".join(
            f"{name} {1e3 * sec / n:.1f}" for name, sec in seconds.items())
            + f"; stage 1 without its detector build "
              f"{1e3 * (seconds['detect'] - builds[0]) / n:.1f} "
              f"({n / (seconds['detect'] - builds[0]):.3f} pages/s, prefetch)")
        print("launches per page: " + ", ".join(
            f"{k} {c // n}" for k, c in launches.items() if c))

        # stage 0's outputs: rotated pages within one uint8 step of the CPU's
        # rotation by the same angle; the clean page copied byte for byte
        for path, angle, est in zip(paths, STAGE_ANGLES, card_a):
            out = os.path.join("0_oriented_images", os.path.basename(path))
            if est is None or abs(est) < 0.5:
                check(open(out, "rb").read() == open(path, "rb").read(), f"{out} not copied")
                continue
            got = np.asarray(Image.open(out).convert("RGB"))[:, :, ::-1].astype(np.int16)
            bgr = load_image_bgr(path)
            ref = np.clip(rotate_bound(torch.from_numpy(bgr), est).numpy(), 0, 255)
            diff = int(np.abs(got - ref.astype(np.uint8).astype(np.int16)).max())
            print(f"{os.path.basename(path)} (rotated by {angle}): corrected by {est}, "
                  f"{got.shape[1]}x{got.shape[0]}, card vs CPU rotation max |diff| {diff}")
            check(diff <= 1, f"{out}: card rotation differs from the CPU's by {diff}")

        # the stage-1 tree (pipeline/detect.py::write_page_artifacts)
        grids = DetectorConfig().grid_configs
        for path in paths:
            base = os.path.splitext(os.path.basename(path))[0]
            check(os.path.isfile(f"1_doclayout_parsed/json/{base}.json"), f"{base}.json")
            for rows, cols in grids:
                g = f"1_doclayout_parsed/grid_{rows}x{cols}"
                info = json.load(open(f"1_doclayout_parsed/json/{base}_grid_{rows}x{cols}.json"))
                check(list(info) == ["original_image_path", "grid_config", "cells"]
                      and len(info["cells"]) == rows * cols, f"{base} grid {rows}x{cols}")
                for sub, ext in (("images", ".png"), ("json", ".json")):
                    cells = [f for f in os.listdir(f"{g}/{sub}") if f.startswith(base + "_row")]
                    check(len(cells) == rows * cols and all(f.endswith(ext) for f in cells),
                          f"{g}/{sub}: {len(cells)} cells of {base}")
                for sub in ("visualizations", "visualizations_original_coords"):
                    check(os.path.isdir(f"{g}/{sub}"), f"{g}/{sub}")
        n_cells = sum(r * c for r, c in grids)
        view_boxes = [len(json.load(open(f"1_doclayout_parsed/json/page_{i}.json"))["boxes"])
                      for i in range(n)]
        classes = collections.Counter(
            name for f in sorted(os.listdir("3_combined_bboxes/json"))
            for name in json.load(open(f"3_combined_bboxes/json/{f}"))["class_names"])
        medians = [json.load(open(f"4_medians_extracted/json/page_{i}_combined_median_width"
                                  ".json"))["median_width"] for i in range(n)]
        columns = [len(json.load(open(f"5_column_detection/json/{f}"))["column_centers"])
                   for f in sorted(os.listdir("5_column_detection/json"))]
        print(f"stage-1 tree: {n} pages x (1 + {n_cells} cells), grids {grids}; full-page "
              f"boxes {view_boxes}; {sum(classes.values())} combined boxes by class "
              f"{dict(classes)}; median widths {medians}; column centres per column file "
              f"{columns}")
        check(classes["plain_text"] > 0, "no plain_text box")
        check(all(m > 0 for m in medians), f"median widths {medians}")
        check(sum(columns) > 0, f"column files {columns}")

        # a cached rerun skips all six stages and changes no byte
        before = _file_digests(".")
        with _LogRecords() as log:
            check(cli_pipeline.main(["pages", "--device", "cuda"]) == 0, "cached rerun")
        results = log.pipeline_results()
        check(set(results.values()) == {"skipped"} and len(results) == 6, f"rerun {results}")
        check(_file_digests(".") == before, "the cached rerun changed files")
        # a forced rerun of stages 2-5 writes the same JSON
        stages = numbered_pipeline_stages("pages", device="cuda")[2:]
        check(set(PipelineRunner().run(stages, force=True).values()) == {"ran"}, "forced rerun")
        after = _file_digests(".")
        json_before = {k: v for k, v in before.items()
                       if k.endswith(".json") and not k.startswith(STAGE_FOLDERS[:2])}
        check(len(json_before) > 4 * n and all(after[k] == v for k, v in json_before.items()),
              "forced rerun of stages 2-5 changed the JSON")
        print(f"cached rerun: all six stages skipped, {len(before)} files unchanged; forced "
              f"stages 2-5: {len(json_before)} JSON files byte-identical")

        # stage 0 split, on the same pages
        split = {"decode": [], "estimate": [], "rotate": [], "encode": []}
        for path, est in zip(paths, card_a):
            t0 = time.perf_counter()
            bgr = load_image_bgr(path)
            t1 = time.perf_counter()
            detect_skew(bgr[:, :, ::-1], device="cuda")
            t2 = time.perf_counter()
            with torch.inference_mode():
                rot = rotate_bound(torch.from_numpy(bgr).cuda(), est or 0.0).cpu().numpy()
            rot = np.clip(rot, 0, 255).astype(np.uint8)
            t3 = time.perf_counter()
            save_image_bgr(os.path.join(tmp, "split0", os.path.basename(path)), rot)
            t4 = time.perf_counter()
            for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                split[key].append(1e3 * dt)
        print("stage 0 per page (host clock): " + ", ".join(
            f"{k} {statistics.mean(v):.1f} ms" for k, v in split.items()))

        # stage 1 sequential (prefetch=False) over the first
        # STAGE_PROFILED_PAGES oriented pages, its forward and its writer
        # timed inside the run, under the profiler
        split = {"detect": [], "write": []}
        seq_in, m = os.path.join(tmp, "s1_seq_in"), STAGE_PROFILED_PAGES
        os.makedirs(seq_in)
        for name in sorted(f for f in os.listdir("0_oriented_images") if f.endswith(".png"))[:m]:
            shutil.copy(os.path.join("0_oriented_images", name), seq_in)

        def timed(key, fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                split[key].append(1e3 * (time.perf_counter() - t0))
                return out
            return call

        detector.detect_page_multigrid = timed("detect", detector.detect_page_multigrid)
        seq = {}

        def sequential():
            t0 = time.perf_counter()
            seq["stats"] = stage1.run_detect_stage(
                seq_in, os.path.join(tmp, "s1_seq"), detector=detector, prefetch=False)
            seq["s"] = time.perf_counter() - t0

        with _swap(stage1, "write_page_artifacts",
                   timed("write", stage1.write_page_artifacts)):
            profile_run(f"stage 1 over {m} pages (run_detect_stage, prefetch=False)",
                        sequential)
        stats = seq["stats"]
        check(stats.processed == m and stats.errors == 0, f"stage 1 {stats}")
        other = 1e3 * seq["s"] / m - statistics.mean(split["detect"]) - statistics.mean(
            split["write"])
        print(f"stage 1 sequential (profiled): {m / seq['s']:.3f} pages/s; per page (host "
              f"clock) detect {statistics.mean(split['detect']):.1f} ms, write "
              f"{statistics.mean(split['write']):.1f} ms, decode and the rest {other:.1f} ms")
        del detector
        os.chdir(cwd)
    gc_cuda()
    return launches


def synthetic_page(seed: int, angle: float):
    """A 2200×1700 synthetic text page, rotated by ``angle`` degrees (0:
    clean) and cut back to the page's size around its centre."""
    import numpy as np
    import torch

    from multimodal_embeddings_tpu_torch.ops.image import rotate_bound
    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    page = make_page(*PAGE_HW, seed=seed)
    if angle:
        rot = rotate_bound(torch.from_numpy(page), angle).numpy()
        top = (rot.shape[0] - PAGE_HW[0]) // 2
        left = (rot.shape[1] - PAGE_HW[1]) // 2
        rot = rot[top : top + PAGE_HW[0], left : left + PAGE_HW[1]]
        page = np.clip(rot, 0, 255).astype(np.uint8)
    return page


def snapped(pages):
    """``pages`` with each embedding value rounded to a multiple of 2^-11:
    every product and partial sum of a similarity (|value| < 4) is then
    exact in f32 whatever the order, so the card and the CPU see the same
    similarities and the same ties. Unsnapped, a near tie at the k-th place
    may fall either way between two summation orders, which moves a pair's
    sum by a whole product of areas."""
    import numpy as np

    from multimodal_embeddings_tpu_torch.analysis.clustering import PageRegions

    return [PageRegions(p.name, (np.round(p.embeddings * 2048.0) / 2048.0).astype(np.float32),
                        p.areas) for p in pages]


def near_merges(linkage) -> int:
    """Merges whose distance lies within ``WORKFLOW_SIM_TOL`` of another's."""
    import numpy as np

    d = np.sort(linkage[:, 2])
    return int(np.sum(np.diff(d) <= WORKFLOW_SIM_TOL))


def trace_busy(path: str) -> tuple:
    """Device busy ms (kernel events summed) and the number of kernel events
    in a Chrome trace that ``torch.profiler`` wrote (``utils/trace_analysis.py``)."""
    from multimodal_embeddings_tpu_torch.utils import trace_analysis

    stats = trace_analysis.aggregate_kernels(path)
    return sum(s.total_us for s in stats) / 1e3, sum(s.count for s in stats)


def workflow_run(counters) -> dict:
    """Phase 18; returns the launches of the workflow's run over the six
    pages."""
    import collections
    import tempfile

    import torch
    from PIL import Image

    from multimodal_embeddings_tpu_torch.analysis import clustering
    from multimodal_embeddings_tpu_torch.analysis import cross_compare as cross_mod
    from multimodal_embeddings_tpu_torch.analysis import demo_queries as demo_mod
    from multimodal_embeddings_tpu_torch.analysis import region_compare as region_mod
    from multimodal_embeddings_tpu_torch.analysis.reports import _have
    from multimodal_embeddings_tpu_torch.cli import workflow
    from multimodal_embeddings_tpu_torch.config import DetectorConfig
    from multimodal_embeddings_tpu_torch.io.images import cv2_module, load_image_rgb
    from multimodal_embeddings_tpu_torch.models import detector as detector_mod
    from multimodal_embeddings_tpu_torch.models import embedder as embedder_mod
    from multimodal_embeddings_tpu_torch.store import embedding_store
    from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db
    from multimodal_embeddings_tpu_torch.utils import profiling

    phase("18. the integrated workflow through cli.workflow on the card (orient, detect, "
          "embed, cluster, cross/region compare, demo)")
    n = len(WORKFLOW_PAGES)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        src, warm = os.path.join(tmp, "pages"), os.path.join(tmp, "warm_pages")
        os.makedirs(src)
        os.makedirs(warm)
        t0 = time.perf_counter()
        paths = []
        for i, (publication, angle) in enumerate(WORKFLOW_PAGES):
            paths.append(os.path.join(src, f"{publication}_{i}.png"))
            Image.fromarray(synthetic_page(50 + i, angle)).save(paths[-1])
        Image.open(paths[0]).save(os.path.join(warm, "warm_0.png"))
        print(f"pages: {n} at {PAGE_HW}, {[p for p, _ in WORKFLOW_PAGES]}, rotated by "
              f"{[a for _, a in WORKFLOW_PAGES]}; written in {time.perf_counter() - t0:.1f} s")

        # the class head, fitted once on page 0's one view (detect_regions
        # runs the whole page alone), then given to every detector the CLI
        # builds
        fit_detector = detector_mod.LayoutDetector(DetectorConfig(grid_configs=()))
        fit = fit_head(fit_detector, load_image_rgb(paths[0]), WORKFLOW_VIEW_BOXES)
        del fit_detector
        embeds, timers, seconds = [], [], collections.Counter()

        def timed(key, fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                seconds[key] += time.perf_counter() - t0
                return out
            return call

        class FittedDetector(detector_mod.LayoutDetector):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                apply_head(self, fit)

            def detect_batch(self, images):  # ends in the outputs' download
                return timed("detect_batch", super().detect_batch)(images)

        class CountedEmbedder(embedder_mod.MultimodalEmbedder):
            def _embed_batch(self, batch):
                embeds.append(len(batch))
                return super()._embed_batch(batch)

            def get_image_embeddings(self, *args, **kwargs):
                return timed("get_image_embeddings", super().get_image_embeddings)(
                    *args, **kwargs)

        class KeptTimer(profiling.StageTimer):
            def __init__(self):
                super().__init__()
                timers.append(self)

        trace_dir = os.path.join(tmp, "trace")
        demo = ["--demo_image", paths[0]]
        reports = ["--run_cross_compare", "--run_region_compare", "--run_demo"]
        with contextlib.ExitStack() as stack:
            for module, name, value in (
                (detector_mod, "LayoutDetector", FittedDetector),
                (embedder_mod, "MultimodalEmbedder", CountedEmbedder),
                (profiling, "StageTimer", KeptTimer),
                (cross_mod, "create_cross_comparison",
                 timed("cross_compare", cross_mod.create_cross_comparison)),
                (region_mod, "create_region_cross_comparison",
                 timed("region_compare", region_mod.create_region_cross_comparison)),
                (demo_mod, "run_demo_queries", timed("demo", demo_mod.run_demo_queries)),
                (detector_mod, "_letterbox_host",
                 timed("letterbox_host", detector_mod._letterbox_host)),
                (embedding_store.Collection, "upsert",
                 timed("upsert", embedding_store.Collection.upsert)),
            ):
                stack.enter_context(_swap(module, name, value))

            # warm-up: the whole workflow over one page in its own directory
            os.makedirs(os.path.join(tmp, "warm_run"))
            os.chdir(os.path.join(tmp, "warm_run"))
            t0 = time.perf_counter()
            check(workflow.main(["--input_folder", warm, *reports, *demo, "--device", "cuda"])
                  == 0, "warm-up exit code")
            torch.cuda.synchronize()
            print(f"warm-up: 1 page in {time.perf_counter() - t0:.2f} s")

            os.makedirs(os.path.join(tmp, "run"))
            os.chdir(os.path.join(tmp, "run"))
            embeds.clear()
            seconds.clear()
            gc_cuda()
            torch.cuda.reset_peak_memory_stats()
            zero(counters)
            t0 = time.perf_counter()
            check(workflow.main(["--input_folder", src, *reports, *demo, "--device", "cuda",
                                 "--trace_dir", trace_dir]) == 0, "workflow exit code")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts(counters)
            peak = torch.cuda.max_memory_allocated()
            vit_calls = len(embeds)
            want = only(counters, {"encoder_attention_blf_packed": n,
                                   "encoder_attention_blf": WORKFLOW_VIT_LAYERS * vit_calls})
            check(launches == want, f"launches {launches} != {want}")
            timer = timers[-1]
            print(f"workflow: {n} pages in {wall:.2f} s through cli.workflow.main (traced); "
                  f"peak device memory {peak / 2**30:.2f} GiB; {vit_calls} ViT calls "
                  f"({sum(embeds)} images: {embeds})")
            print("ms per page by stage: " + ", ".join(
                f"{name} {1e3 * timer.totals[name] / n:.1f}" for name in timer._order))
            print("seconds over the run (host clock): " + ", ".join(
                f"{k} {v:.2f}" for k, v in seconds.items()))
            print("launches: " + ", ".join(f"{k} {c}" for k, c in launches.items() if c))
            for key in ("cross_compare", "region_compare", "demo"):
                check(key in seconds, f"{key} did not run")
            check(timer._order == ["orient", "detect", "embed_pages", "embed_regions",
                                   "cluster"], f"stages {timer._order}")

            # the store: every page, each with regions
            _, collection = initialize_db("db", device="cuda")
            got = collection.get(include=("metadatas",))
            names = [os.path.basename(p) for p in paths]
            check(sorted(i for i in got["ids"] if not i.startswith("region_")) == sorted(names),
                  f"page rows {got['ids'][:10]}")
            regions = collections.Counter(
                m["parent_image_name"] for m in got["metadatas"] if m["is_region"])
            types = collections.Counter(m["region_type"] for m in got["metadatas"]
                                        if m["is_region"])
            print(f"store: {collection.count()} rows; regions per page "
                  f"{[regions[name] for name in names]}; by type {dict(types)}")
            check(all(regions[name] >= 1 for name in names), f"regions per page {regions}")
            rows = collection.count()

            # the similarity pass on the card against the CPU's f32 one, on the
            # store's PageRegions (snapped, see ``snapped``), and the clusters
            pages = clustering.group_regions_by_page(collection)
            check([p.name for p in pages] == sorted(names), "pages with regions")
            raw = {dev: clustering.compute_similarity_matrix(pages, device=dev)
                   for dev in ("cuda", "cpu")}
            exact = {dev: clustering.compute_similarity_matrix(snapped(pages), device=dev)
                     for dev in ("cuda", "cpu")}
            card = exact["cuda"]
            err = float(abs(card - exact["cpu"]).max())
            check(err <= WORKFLOW_SIM_TOL, f"card vs CPU similarity max |diff| {err}")
            check((card == card.T).all() and (card.diagonal() == 1.0).all(),
                  "the card's similarity matrix: not symmetric with a unit diagonal")
            labels = {dev: clustering.cluster_pages(exact[dev], [p.name for p in pages])
                      for dev in ("cuda", "cpu")}
            near = near_merges(labels["cpu"].linkage)
            same = bool((labels["cuda"].labels == labels["cpu"].labels).all())
            check(same or near > 0, f"labels {labels['cuda'].labels} vs {labels['cpu'].labels}")
            print(f"similarity ({len(pages)} pages, card vs CPU f32): snapped max |diff| "
                  f"{err:.2e}, unsnapped {float(abs(raw['cuda'] - raw['cpu']).max()):.2e}; "
                  f"labels equal {same} ({labels['cpu'].n_clusters} clusters, silhouette "
                  f"{labels['cpu'].silhouette:.4f}; {near} merges within {WORKFLOW_SIM_TOL})")

            # the output tree
            report = os.path.join("output", "weighted_clustering")
            for name in ("clustering_results.json", "similarity_matrix.npy",
                         "clustering_report.html"):
                check(os.path.isfile(os.path.join(report, name)), f"{report}/{name}")
            plots = {"similarity_heatmap.png": _have("matplotlib"),
                     "dendrogram.png": _have("matplotlib", "scipy"),
                     "similarity_network.png": _have("matplotlib", "networkx")}
            for name, expected in plots.items():
                check(os.path.isfile(os.path.join(report, name)) == expected,
                      f"{report}/{name}: libraries installed {expected}")
            result = json.load(open(os.path.join(report, "clustering_results.json")))
            check(result["names"] == sorted(names), f"clustered {result['names']}")
            check(os.path.isfile("cross_compare/index.html"), "cross_compare/index.html")
            for name in names:
                page = f"cross_compare/{os.path.splitext(name)[0]}_comparison.html"
                check(os.path.isfile(page), page)
            check(os.path.isfile("region_compare/index.html"), "region_compare/index.html")
            region_pages = len([f for f in os.listdir("region_compare") if f.endswith(".html")])
            drawn = {folder: len(os.listdir(folder)) if os.path.isdir(folder) else 0
                     for folder in ("output/region_visualizations", "region_compare/comparisons")}
            has_cv2 = cv2_module() is not None
            # composites only for regions with a match over the threshold
            check((drawn["output/region_visualizations"] == n) == has_cv2
                  and (has_cv2 or not drawn["region_compare/comparisons"]),
                  f"cv2 installed {has_cv2}, drawings {drawn}")
            results = open("testout/query_results.txt").read().splitlines()
            sections = [line for line in results if line.startswith("===")]
            check(sections == list(WORKFLOW_QUERY_SECTIONS), f"demo sections {sections}")
            traces = os.listdir(trace_dir)
            check(len(traces) == 1 and traces[0].endswith(".json"), f"trace files {traces}")
            busy, kernels = trace_busy(os.path.join(trace_dir, traces[0]))
            print(f"outputs: clustering {result['labels']}; plots "
                  f"{[k for k, v in plots.items() if v] or 'none (no matplotlib)'}; cv2 "
                  f"{has_cv2}: {drawn}; "
                  f"{len(names)} cross-compare pages; {region_pages - 1} region-compare "
                  f"pages; demo sections {len(sections)}; trace {traces[0]} "
                  f"({os.path.getsize(os.path.join(trace_dir, traces[0])) / 2**20:.1f} MiB, "
                  f"{kernels} kernels, device busy {busy:.1f} ms of {1e3 * wall:.1f} ms wall, "
                  f"idle {100 * (1 - busy / (1e3 * wall)):.1f}%)")

            # where region-compare's time goes on the host: the same call on
            # the same store into another folder, under cProfile
            import cProfile
            import pstats

            prof = cProfile.Profile()
            prof.enable()
            region_mod.create_region_cross_comparison(
                collection, output_folder=os.path.join(tmp, "region_again"),
                similarity_threshold=0.1)
            prof.disable()
            stats = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
            print(f"region-compare host profile ({pstats.Stats(prof).total_tt:.2f} s), "
                  "own s: " + "; ".join(
                      f"{fn[2]} ({os.path.basename(fn[0])}:{fn[1]}) {st[2]:.2f} x{st[1]}"
                      for fn, st in stats[:8]))

            # a second run detects and embeds nothing, and adds no row
            zero(counters)
            embeds.clear()
            check(workflow.main(["--input_folder", src, "--device", "cuda"]) == 0, "rerun")
            torch.cuda.synchronize()
            again = counts(counters)
            _, collection = initialize_db("db", device="cuda")
            check(again == only(counters, {}) and not embeds, f"rerun launched {again}")
            check(collection.count() == rows, f"rerun: {collection.count()} rows, not {rows}")
            print(f"second run: no kernel launched, no image embedded, {rows} rows kept")
        os.chdir(cwd)
    gc_cuda()
    archive_similarity()
    return launches


def archive_similarity() -> None:
    """The clustering pass at archive scale: ``ARCHIVE_PAGES`` pages of
    ``ARCHIVE_REGIONS`` unit regions. Each region has 64 nonzero values of
    ±1/8 (16 of them its topic's, the rest its own), so every similarity is
    a multiple of 1/64, exact in any summation order: ties at the k-th place
    are common and must fall as on the CPU."""
    import numpy as np
    import torch

    from multimodal_embeddings_tpu_torch.analysis import clustering

    n, r, d, q, k = ARCHIVE_PAGES, ARCHIVE_REGIONS, ARCHIVE_DIM, ARCHIVE_QUERIES, ARCHIVE_K
    gen = torch.Generator(device="cuda").manual_seed(18)
    dims = torch.randperm(d, generator=gen, device="cuda")[: ARCHIVE_TOPICS * 16]
    topic_dims = dims.view(ARCHIVE_TOPICS, 16)
    topic_signs = torch.randint(0, 2, (ARCHIVE_TOPICS, 16), generator=gen, device="cuda") * 2 - 1
    topic = torch.arange(n, device="cuda") % ARCHIVE_TOPICS
    keys = torch.rand(n, r, d, generator=gen, device="cuda")
    keys.scatter_(-1, topic_dims[topic][:, None, :].expand(n, r, 16), -1.0)
    own = keys.topk(48, dim=-1).indices  # 48 dims outside the topic's
    signs = torch.randint(0, 2, (n, r, 48), generator=gen, device="cuda") * 2 - 1
    emb = torch.zeros(n, r, d, device="cuda")
    emb.scatter_(-1, own, signs / 8.0)
    emb.scatter_(-1, topic_dims[topic][:, None, :].expand(n, r, 16),
                 (topic_signs[topic][:, None, :] / 8.0).expand(n, r, 16))
    areas = torch.rand(n, r, generator=gen, device="cuda") * 0.05 + 0.001
    del keys
    emb_np, areas_np = emb.cpu().numpy(), areas.cpu().numpy()
    del emb, areas
    check(np.allclose(np.linalg.norm(emb_np, axis=-1), 1.0), "archive regions not unit")
    pages = [clustering.PageRegions(f"page_{i:04d}.png", e, a)
             for i, (e, a) in enumerate(zip(emb_np, areas_np))]

    arrays = [torch.from_numpy(x).cuda() for x in clustering._pad_pages(pages, q)]
    with torch.inference_mode():
        sums = clustering.pair_scores(*arrays, k, 0.1, True)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sums = clustering.pair_scores(*arrays, k, 0.1, True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() - base
    chunk = max(1, clustering._CHUNK_ELEMENTS // (n * q * r))
    t0 = time.perf_counter()
    sim = clustering.compute_similarity_matrix(pages, query_limit=q, top_k=k, device="cuda")
    whole_s = time.perf_counter() - t0
    check(np.isfinite(sim).all() and np.array_equal(sim, sim.T)
          and np.all(np.diag(sim) == 1.0), "archive similarity matrix")

    # the first pages' block against the CPU's f32 run on those pages
    m = ARCHIVE_CHECKED
    cpu_arrays = [torch.from_numpy(x) for x in clustering._pad_pages(pages[:m], q)]
    cpu = clustering.pair_scores(*cpu_arrays, k, 0.1, True).numpy()
    block = sums[:m, :m].cpu().numpy()
    err = float(np.abs(block - cpu).max() / np.abs(cpu).max())
    check(err <= WORKFLOW_SIM_TOL, f"archive: first {m} pages vs CPU, {err} of the largest sum")
    accepted = float(np.count_nonzero(cpu)) / cpu.size

    flops = 2.0 * n * n * q * r * d
    nbytes = 4.0 * (n * q * d + n * r * d + n * q + n * r) + n * r + 4.0 * n * n
    bound, by = bound_ms(flops, nbytes, torch.float32)
    ms = statistics.median(times)
    print(f"archive similarity pass: {n} pages x {r} regions x {d}, Q={q}, k={k}, "
          f"{(n + chunk - 1) // chunk} query chunks of {chunk} pages: device {ms:.2f} ms "
          f"(median of 5: {', '.join(f'{t:.2f}' for t in times)}), bound {bound:.2f} ms "
          f"({by}: {flops:.3g} f32 operations at {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s), "
          f"{100 * bound / ms:.1f}% of it; peak {peak / 2**30:.2f} GiB above the inputs; "
          f"compute_similarity_matrix whole (host clock, upload and host tail) "
          f"{whole_s:.2f} s; first {m} pages vs CPU f32 {err:.2e} of the largest sum "
          f"({100 * accepted:.1f}% of pairs nonzero)")


# phase 19: the activation dumps' tolerance, card bf16 against the CPU's f32
# dump of the same weights (compare_traces' rule |a - b| <= atol + rtol *
# max(|a|, |b|) on the five moments and the 8 head values of each layer).
# One bf16 rounding moves a value by up to 2^-9 of itself, and each layer
# rounds its inputs and outputs again: the gate allows 5e-2 (about 25 such
# steps) over an atol of 1e-3, which compare_traces' default atol of 1e-4
# would leave to single head values of ~1e-3. The atol is absolute: the
# random detector's head (std ~1e-7..1e-5) passes it whatever it holds, so
# those layers are read through the boxes of 19d. Each run prints the rtol
# its worst layer needs.
PARITY_RTOL, PARITY_ATOL = 5e-2, 1e-3
# the mmE5 text stack's hidden states reach |x| ~ 400 on seeded weights
# (std ~424), where one bf16 step is 2, and its down projections sum 14,336
# products of bf16 inputs: its layers take an atol of 8 such steps, 4% of
# the std (H100 readings: a head value of the reduced model's cross-layer
# down projection -55.75 on the card against -64.70 on the CPU in f32,
# everything else within 4); a wrong weight or layout moves values by a
# good part of the std. The tower (|x| ~ 0.01-1) and the pooled output
# keep PARITY_ATOL.
PARITY_TEXT_ATOL = 16.0
PARITY_PAGES = 2  # phase 19d: pages through detect_regions, one view each
PARITY_CROPS = 8  # phase 19d: crops in each store
IOU_MIN = 0.99  # BASELINE.json's matched-box IoU target
# phase 19c: our module -> its ultralytics index (the inverse of
# models/hf_port.py::_YOLO_INDEX_TO_MODULE), and the sequential positions
# of the CIB block and of the head's class branch
_ULTRALYTICS_INDEX = {
    "backbone/stem": 0, "backbone/down2": 1, "backbone/c2f_2": 2, "backbone/down3": 3,
    "backbone/c2f_3": 4, "backbone/down4": 5, "backbone/c2f_4": 6, "backbone/down5": 7,
    "backbone/c2fcib_5": 8, "backbone/sppf": 9, "backbone/psa": 10, "neck/td_c2f_4": 13,
    "neck/td_c2f_3": 16, "neck/bu_down_3": 17, "neck/bu_c2fcib_4": 19, "neck/bu_down_4": 20,
    "neck/bu_c2fcib_5": 22,
}
_CIB_SEQ = {"dw1": 0, "pw1": 1, "dw2": 2, "pw2": 3, "dw3": 4}
_HEAD_CLS_SEQ = {"dw1": (0, 0), "pw1": (0, 1), "dw2": (1, 0), "pw2": (1, 1)}


def _ultralytics_leaf(collection: str, leaf: str) -> str:
    if collection == "params":
        return {"conv/kernel": "conv.weight", "bn/scale": "bn.weight", "bn/bias": "bn.bias",
                "kernel": "weight", "bias": "bias"}[leaf]
    return {"bn/mean": "bn.running_mean", "bn/var": "bn.running_var"}[leaf]


def ultralytics_key(flat_key: str) -> str:
    """Our flat JAX key -> the ultralytics key that ``doclayout_key_map``
    maps onto it."""
    import re

    collection, rest = flat_key.split("/", 1)
    parts = rest.split("/")
    if parts[0] == "head":
        branch, level, sub = re.match(r"(reg|cls)(\d)_(.+)", parts[1]).groups()
        leaf = _ultralytics_leaf(collection, "/".join(parts[2:]))
        cv = "one2one_cv2" if branch == "reg" else "one2one_cv3"
        if sub == "out":
            return f"model.23.{cv}.{level}.2.{leaf}"
        if branch == "reg":
            return f"model.23.{cv}.{level}.{int(sub[-1]) - 1}.{leaf}"
        outer, inner = _HEAD_CLS_SEQ[sub]
        return f"model.23.{cv}.{level}.{outer}.{inner}.{leaf}"
    idx = _ULTRALYTICS_INDEX["/".join(parts[:2])]
    tail = parts[2:]
    if tail[0] in ("conv", "bn"):
        return f"model.{idx}.{_ultralytics_leaf(collection, '/'.join(tail))}"
    if tail[0] in ("cv1", "cv2", "ffn1", "ffn2"):
        mod = {"ffn1": "ffn.0", "ffn2": "ffn.1"}.get(tail[0], tail[0])
        return f"model.{idx}.{mod}.{_ultralytics_leaf(collection, '/'.join(tail[1:]))}"
    if tail[0] == "attn":
        return f"model.{idx}.attn.{tail[1]}.{_ultralytics_leaf(collection, '/'.join(tail[2:]))}"
    inner = int(tail[0][1:])  # m<i>: a C2f / G2L_CRM / C2fCIB inner block
    if tail[1] == "gate":
        return f"model.{idx}.m.{inner}.gate.{_ultralytics_leaf(collection, tail[2])}"
    sub = f"cv1.{_CIB_SEQ[tail[1]]}" if tail[1] in _CIB_SEQ else tail[1]
    return f"model.{idx}.m.{inner}.{sub}.{_ultralytics_leaf(collection, '/'.join(tail[2:]))}"


def ultralytics_state(module) -> dict:
    """``module``'s parameters as an ultralytics DocLayout-YOLO state dict:
    OIHW convs, each folded conv with an unfolded identity BatchNorm
    (``export_jax_params``), plus the bookkeeping entries the map skips."""
    import numpy as np
    import torch

    from multimodal_embeddings_tpu_torch.models.hf_port import doclayout_key_map
    from multimodal_embeddings_tpu_torch.models.weights import export_jax_params

    state = {}
    for key, arr in export_jax_params(module).items():
        tkey = ultralytics_key(key)
        check(doclayout_key_map(tkey) == key, f"{tkey} does not map back onto {key}")
        arr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr
        state[tkey] = torch.from_numpy(np.ascontiguousarray(arr))
        if tkey.endswith("bn.running_var"):
            state[tkey[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def worst_layer(ref: dict, cand: dict, atol: float) -> tuple:
    """The least rtol at which every statistic of a layer passes at
    ``atol`` (``max(0, |a - b| - atol) / max(|a|, |b|)``), the largest over
    the layers both dumps hold, and where: (rtol, layer, statistic, a, b)."""
    worst = (0.0, None, None, None, None)
    for name, r in ref["layers"].items():
        c = cand["layers"].get(name)
        if c is None:
            continue
        pairs = [(f, r[f], c[f]) for f in ("mean", "std", "min", "max", "absmean")]
        pairs += [(f"head[{i}]", a, b) for i, (a, b) in enumerate(zip(r["head"], c["head"]))]
        for field, a, b in pairs:
            need = max(0.0, abs(a - b) - atol) / max(abs(a), abs(b), 1e-30)
            if worst[1] is None or need > worst[0]:
                worst = (need, name, field, a, b)
    return worst


def worst_text(ref: dict, cand: dict, atol: float) -> str:
    need, layer, field, a, b = worst_layer(ref, cand, atol)
    std = ref["layers"][layer]["std"] if layer else 0.0
    return (f"worst layer {layer} (needs rtol {need:.4g}: {field} {a:.6g} against {b:.6g}, "
            f"the layer's std {std:.4g})")


def finite_trace(trace: dict) -> bool:
    return all(math.isfinite(v) for rec in [*trace["layers"].values(), trace["output"]]
               for v in (rec["mean"], rec["std"], rec["min"], rec["max"], rec["absmean"],
                         *rec["head"]))


def traced_and_plain(counters, trace_fn, module, plain_fn) -> tuple:
    """``trace_fn()`` with the counters zeroed (its output captured by a
    hook on ``module``, the root, which the trace leaves out), then
    ``plain_fn()`` with them zeroed again: (trace, traced output, launches
    traced, plain output, launches plain)."""
    import torch

    captured = []
    hook = module.register_forward_hook(lambda m, args, out: captured.append(out))
    zero(counters)
    trace = trace_fn()
    torch.cuda.synchronize()
    traced = counts(counters)
    hook.remove()
    zero(counters)
    with torch.inference_mode():
        plain = plain_fn()
    torch.cuda.synchronize()
    return trace, captured[0], traced, plain, counts(counters)


def parity_phase(counters) -> dict:
    """Phase 19; returns the launches of each of its runs on the card."""
    import gc
    import re
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from multimodal_embeddings_tpu_torch.analysis import activations as acts
    from multimodal_embeddings_tpu_torch.analysis.parity import compare_detection_dirs
    from multimodal_embeddings_tpu_torch.cli import parity as parity_cli
    from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
    from multimodal_embeddings_tpu_torch.io.json_io import save_json
    from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.hf_port import doclayout_key_map
    from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig
    from multimodal_embeddings_tpu_torch.models.weights import (
        export_jax_params,
        load_torch_state_dict,
        save_checkpoint_safetensors,
    )
    from multimodal_embeddings_tpu_torch.pipeline.fused import build_split_page_fn
    from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db
    from multimodal_embeddings_tpu_torch.utils import profiling
    from multimodal_embeddings_tpu_torch.utils import trace_analysis

    phase("19. checkpoint and parity tooling: activation dumps, a published-layout "
          "checkpoint, the parity measures, the trace parser")
    start = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- a. the detector's dump at full width, card and CPU ----------------
        t0 = time.perf_counter()
        dump = ["acts-dump", "--family", "detector", "--variant", "m", "--imgsz", "1024"]
        card_json, cpu_json = os.path.join(tmp, "det_card.json"), os.path.join(tmp, "det_cpu.json")
        zero(counters)
        check(parity_cli.main([*dump, "--out", card_json, "--device", "cuda"]) == 0,
              "acts-dump on the card")
        torch.cuda.synchronize()
        launches["parity_detector_dump"] = counts(counters)
        want = only(counters, {"encoder_attention_blf_packed": 1})
        check(launches["parity_detector_dump"] == want,
              f"detector dump launches {launches['parity_detector_dump']} != {want}")
        check(parity_cli.main([*dump, "--out", cpu_json, "--device", "cpu"]) == 0,
              "acts-dump on the CPU")
        card, cpu = acts.load_trace(card_json), acts.load_trace(cpu_json)
        print(f"a. detector dumps (DocLayout-YOLOv10-m GL-CRM, 1024 px): {len(card['layers'])} "
              f"layers, output {card['output']['shape']}, card and CPU in "
              f"{time.perf_counter() - t0:.1f} s")
        detector = make_detector()  # the CLI's weights: seed 0
        probe = torch.from_numpy(acts.detector_probe(1024)).to("cuda")
        trace, traced_out, traced, plain_out, plain = traced_and_plain(
            counters, lambda: acts.detector_trace(detector), detector.model,
            lambda: detector.model(probe))
        check(trace == card, "the in-process trace differs from the CLI's dump")
        check(all(torch.equal(a, b) for a, b in zip(acts._leaves(traced_out),
                                                    acts._leaves(plain_out))),
              "the traced forward's output is not the plain forward's, bit for bit")
        check(acts.device_tensor_stats(acts._leaves(plain_out)[0]) == card["output"],
              "the dump's output record is not the plain forward's")
        check(traced == plain == want, f"launches traced {traced}, plain {plain}, want {want}")
        rc = parity_cli.main(["acts-compare", cpu_json, card_json, "--rtol", str(PARITY_RTOL),
                              "--atol", str(PARITY_ATOL)])
        print(f"   traced output EQUAL to the plain forward's; K1 packed 1 launch traced and "
              f"plain; card bf16 vs CPU f32 at rtol {PARITY_RTOL} / atol {PARITY_ATOL}: "
              f"exit {rc}; {worst_text(cpu, card, PARITY_ATOL)}")
        check(rc == 0, "detector: card against CPU diverges")

        # -- c. a published-layout checkpoint on the card ----------------------
        t0 = time.perf_counter()
        page = make_pages(1)[0].cpu().numpy()
        want_det = detector.detect_batch([page])[0]
        pt = os.path.join(tmp, "docstructbench_layout.pt")
        torch.save(ultralytics_state(detector.model), pt)
        fresh = LayoutDetector(DetectorConfig(image_size=1024, variant="m"),
                               dtype=torch.bfloat16, device="cuda", seed=1)
        load_torch_state_dict(pt, fresh.model, doclayout_key_map)
        st = os.path.join(tmp, "detector.safetensors")
        save_checkpoint_safetensors(detector.model, st)
        from_st = LayoutDetector(DetectorConfig(image_size=1024, variant="m", weights_path=st),
                                 dtype=torch.bfloat16, device="cuda")
        for label, other in (("ultralytics state dict", fresh), (".safetensors", from_st)):
            got = other.detect_batch([page])[0]
            check(all(np.array_equal(g, w) for g, w in zip(got, want_det)),
                  f"{label}: detections differ from the source model's")
        print(f"c. {len(torch.load(pt, weights_only=True))} ultralytics tensors through "
              f"doclayout_key_map, and the .safetensors checkpoint: {len(want_det[1])} "
              f"detections on a 2200x1700 page EQUAL to the source model's "
              f"({time.perf_counter() - t0:.1f} s)")
        del fresh, from_st
        gc_cuda()

        # -- d. boxes and embeddings, card against CPU ------------------------
        t0 = time.perf_counter()
        paths = []
        for i in range(PARITY_PAGES):
            paths.append(os.path.join(tmp, f"parity_{i}.png"))
            Image.fromarray(synthetic_page(60 + i, 0.0)).save(paths[-1])
        one_view = DetectorConfig(grid_configs=())
        card_det = LayoutDetector(one_view, dtype=torch.bfloat16, device="cuda")
        fit = fit_head(card_det, np.asarray(Image.open(paths[0]).convert("RGB")),
                       WORKFLOW_VIEW_BOXES)
        cpu_det = LayoutDetector(one_view, dtype=torch.float32, device="cpu")
        apply_head(cpu_det, fit)
        dirs = {"card": os.path.join(tmp, "boxes_card"), "cpu": os.path.join(tmp, "boxes_cpu")}
        regions = {}
        for label, det in (("card", card_det), ("cpu", cpu_det)):
            os.makedirs(dirs[label])
            for path in paths:
                regions[label, path] = det.detect_regions(path)
                name = os.path.basename(path).replace(".png", ".json")
                save_json(regions[label, path], os.path.join(dirs[label], name))
        report = os.path.join(tmp, "boxes.json")
        check(parity_cli.main(["boxes", dirs["cpu"], dirs["card"], "--out", report]) == 0,
              "parity boxes")
        boxes = compare_detection_dirs(dirs["cpu"], dirs["card"])
        check(json.load(open(report))["mean_matched_iou"] == boxes["mean_matched_iou"],
              "the CLI's report")
        print(f"d. boxes, card bf16 vs CPU f32 over {PARITY_PAGES} pages (one view, fitted "
              f"head): {boxes['total_reference_boxes']} CPU boxes, "
              f"{boxes['total_candidate_boxes']} card boxes, precision "
              f"{boxes['precision']:.6f}, recall {boxes['recall']:.6f}, mean matched IoU "
              f"{boxes['mean_matched_iou']:.6f}")
        check(boxes["total_matched"] > 0 and boxes["mean_matched_iou"] >= IOU_MIN,
              f"mean matched IoU {boxes['mean_matched_iou']} < {IOU_MIN}")
        del cpu_det
        image = np.asarray(Image.open(paths[0]).convert("RGB"))
        crops = [image[int(b[1]) : int(b[3]) + 1, int(b[0]) : int(b[2]) + 1]
                 for b in regions["card", paths[0]]["boxes"][:PARITY_CROPS]]
        check(len(crops) == PARITY_CROPS, f"{len(crops)} crops")
        vit = {}
        for label, device, dtype in (("card", "cuda", "bfloat16"), ("cpu", "cpu", "float32")):
            vit[label] = MultimodalEmbedder(EmbedderConfig(family="siglip", dtype=dtype),
                                            device=device, seed=0)
            _, collection = initialize_db(os.path.join(tmp, f"db_{label}"), device=device)
            embs = vit[label].get_image_embeddings(crops)
            collection.upsert(ids=[f"crop{i}" for i in range(len(crops))], embeddings=embs)
        report = os.path.join(tmp, "embeddings.json")
        check(parity_cli.main(["embeddings", os.path.join(tmp, "db_cpu"),
                               os.path.join(tmp, "db_card"), "--out", report,
                               "--device", "cuda"]) == 0,
              "parity embeddings")
        emb = json.load(open(report))
        print(f"   embeddings, card bf16 vs CPU f32 stores of {PARITY_CROPS} crops (ViT-B/16 "
              f"at 448): count {emb['count']}, mean cosine {emb['mean_cosine']:.6f}, min "
              f"{emb['min_cosine']:.6f} ({time.perf_counter() - t0:.1f} s)")
        check(emb["count"] == PARITY_CROPS and emb["min_cosine"] >= COSINE_MIN,
              f"embeddings: {emb}")
        del card_det

        # -- e. the trace parser over one ViT page ----------------------------
        fn = build_split_page_fn(detector, vit["card"], PAGE_HW, num_regions=NUM_REGIONS,
                                 embed_chunk=NUM_REGIONS)
        pages = make_pages(2)
        fn(pages[0])
        torch.cuda.synchronize()
        zero(counters)
        with profiling.trace(os.path.join(tmp, "trace")) as t:
            fn(pages[1])
            torch.cuda.synchronize()
        launches["trace_vit_page"] = counts(counters)
        want = only(counters, {"encoder_attention_blf": 12, "encoder_attention_blf_packed": 1})
        check(launches["trace_vit_page"] == want,
              f"traced ViT page launches {launches['trace_vit_page']} != {want}")
        stats = trace_analysis.aggregate_kernels(t.path)
        with open(t.path) as f:
            kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        total = sum(e.get("dur", 0) for e in kernels)
        by_cat = trace_analysis.category_summary(stats)
        k1 = sum(s.count for s in stats if s.category == "K1 enc_attn")
        print(f"e. the trace of one ViT page ({len(kernels)} kernel events, {total / 1e3:.3f} ms):")
        trace_analysis.print_report(t.path, top=6)
        check(abs(sum(by_cat.values()) - total) <= 1e-3 * total,
              f"category sums {sum(by_cat.values())} vs kernel total {total}")
        check(k1 == 13, f"K1 row: {k1} launches, not 12 + 1")
        del fn, vit, detector
        gc_cuda()

        # -- b. the mmE5-11B dump at full width, and card against CPU ---------
        t0 = time.perf_counter()
        engine = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="bfloat16"),
                                    model_config=MllamaConfig.mme5_11b(), device="cuda")
        built = time.perf_counter() - t0
        args = [torch.from_numpy(a).to("cuda") for a in acts.mme5_probe(
            engine.model_config.vision.image_size, engine.text_len,
            engine.model_config.text.vocab_size)]
        args[0], args[3] = args[0].long(), args[3].long()
        trace, traced_out, traced, plain_out, plain = traced_and_plain(
            counters, lambda: acts.mme5_trace(engine), engine.model,
            lambda: engine.model(*args))
        launches["parity_mme5_11b_dump"] = traced
        acts.save_trace(trace, os.path.join(tmp, "mme5_11b_card.json"))
        check(torch.equal(traced_out, plain_out), "mmE5 traced output differs from plain")
        # the probe carries a tile mask, so the tower attends on its masked
        # plain path, as JAX's does (phase 8c): no K1 here
        check(traced == plain, f"mmE5 launches traced {traced} vs plain {plain}")
        check(finite_trace(trace), "mmE5: a non-finite statistic")
        tiny_json = os.path.join(tmp, "mme5_tiny.json")
        check(parity_cli.main(["acts-dump", "--family", "mme5", "--size", "tiny", "--out",
                               tiny_json, "--device", "cpu"]) == 0, "tiny mmE5 dump")

        def general(names):
            return {re.sub(r"\d+", "N", n) for n in names}

        tiny = acts.load_trace(tiny_json)
        check(general(trace["layers"]) == general(tiny["layers"]),
              f"layer names: {sorted(general(trace['layers']) ^ general(tiny['layers']))}")
        print(f"b. mmE5-11B bf16 dump at full width: built in {built:.1f} s, "
              f"{len(trace['layers'])} layers, all finite, names those of the tiny config's "
              f"with indices generalised; output EQUAL to the engine's forward; launches "
              f"traced = plain = {only_nonzero(traced)}")
        del engine, traced_out, plain_out
        gc_cuda()
        # the weights drawn from a seed on the card (an H100 machine's CPU
        # took ~25 s to draw them), then loaded into the CPU's f32 engine and
        # the card's
        reduced = reduced_mme5(MllamaConfig.mme5_11b_int8_mixed())
        flat = export_jax_params(MultimodalEmbedder(
            EmbedderConfig(family="mme5", dtype="float32", quantize="int8-mixed"),
            model_config=reduced, device="cuda", seed=0).model)
        gc_cuda()
        cpu_engine = MultimodalEmbedder(
            EmbedderConfig(family="mme5", dtype="float32", quantize="int8-mixed"),
            model_config=reduced, device="cpu", params=flat)
        card_engine = MultimodalEmbedder(
            EmbedderConfig(family="mme5", dtype="bfloat16", quantize="int8-mixed"),
            model_config=reduced, device="cuda", params=flat)
        del flat
        trace, traced_out, traced, plain_out, plain = traced_and_plain(
            counters, lambda: acts.mme5_trace(card_engine), card_engine.model,
            lambda: card_engine.model(*args))
        launches["parity_mme5_reduced_dump"] = traced
        check(torch.equal(traced_out, plain_out), "reduced mmE5 traced output differs")
        check(traced == plain and traced["int8_matmul"] > 0,
              f"reduced mmE5 launches traced {traced} vs plain {plain}")
        cpu_trace = acts.mme5_trace(cpu_engine)
        print(f"   11B widths at reduced depth, int8-mixed, card bf16 vs CPU f32; launches "
              f"traced = plain = {only_nonzero(traced)}:")
        for stack, atol in (("vision_model", PARITY_ATOL), ("text_model", PARITY_TEXT_ATOL)):
            part = [{"layers": {k: v for k, v in t["layers"].items() if k.startswith(stack)},
                     "output": t["output"] if stack == "vision_model" else None}
                    for t in (cpu_trace, trace)]
            report = acts.compare_traces(*part, rtol=PARITY_RTOL, atol=atol)
            print(f"   {stack}{' and the output' if stack == 'vision_model' else ''}: "
                  f"{report['layers_ok']}/{report['layers_compared']} layers ok at rtol "
                  f"{PARITY_RTOL} / atol {atol}, first divergent {report['first_divergent']}; "
                  f"{worst_text(*part, atol)}")
            for r in report["results"]:
                if not r["ok"]:
                    print(f"     {r['layer']}: {r['bad_fields']} head ok {r['head_ok']}; "
                          f"{worst_text(*({'layers': {r['layer']: t['layers'][r['layer']]}} for t in part), atol)}")
            check(report["ok"] and report.get("output_ok", True),
                  f"mmE5 {stack}: card against CPU diverges")
        print(f"   ({time.perf_counter() - t0:.1f} s for b)")
        del cpu_engine, card_engine
        gc_cuda()
    print(f"phase 19: {time.perf_counter() - start:.1f} s")
    return launches


def only_nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


@contextlib.contextmanager
def _swap(module, name: str, value):
    """``module.name`` is ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    yield
    setattr(module, name, old)


# phase 20: K1's gradient. f32: the kernel route's dQ/dK/dV against autograd
# of the plain version on the card, within TRAIN_F32_GRAD_RTOL of the
# tensor's largest |g| (the same f32 function summed in other orders; CPU
# reading at (2, 784, 768) 5e-7). bf16: both routes against the f32
# gradient of the plain version on the same bf16 inputs, the kernel route's
# largest and mean error within TRAIN_BF16_GRAD_FACTOR times the plain bf16
# autograd's (which rounds e and its gradient to bf16; the kernel route
# rounds only the output; CPU readings 2.5-3.0e-3 of the largest |g| for the
# backward's route, 3.1-3.4e-3 for plain autograd)
TRAIN_F32_GRAD_RTOL = 1e-5
TRAIN_BF16_GRAD_FACTOR = 2.0
# phase 20: the trainer at DualEncoderConfig.base(): a global batch of 32
# seeded pairs, and the card's step-1 gradient against the CPU's at the
# base widths and TRAIN_CPU_*_LAYERS' depth (f32, TF32 off; both plain-code
# sums in other orders): each leaf within TRAIN_CARD_CPU_RTOL of the leaf's
# largest |g|
TRAIN_BATCH = 32
TRAIN_STEPS = 5
TRAIN_CARD_CPU_RTOL = 1e-3
# phase 20b's card-against-CPU gradient: the base widths at this depth
TRAIN_CPU_VISION_LAYERS, TRAIN_CPU_TEXT_LAYERS = 2, 1
# phase 20: pp_greedy_generate at the 32B int4 widths, the decoder cut to 4
# of 64 layers (the vision tower built, unused by a text prompt), 2 rows of a
# 2048-token text prompt (the causal prefill at L >= 2048 takes K4), 8 new
# tokens
PP_LAYERS = 4
PP_PROMPT = 2048
PP_NEW = 8


def k1_gradient_checks(k1) -> dict:
    """Phase 20a: K1's two wrapped forms with their gradient at ViT-B
    (32, 784, 768), H = 12, in f32 and bf16, against autograd of the plain
    version on the card; forward, backward, plain and SDPA times."""
    import torch
    import torch.nn.functional as F

    phase("20a. K1's gradient (KernelAttention) at ViT-B (32, 784, 768) H=12, "
          "both wrapped forms")
    b, l, heads, d = TRAIN_BATCH, 784, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(20)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(b, l, heads * d, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        for form in ("blf", "bhld"):
            def route(q, k, v, form=form):
                if form == "blf":
                    return k1.encoder_attention_blf(q, k, v, heads)
                views = (t.view(b, l, heads, d).permute(0, 2, 1, 3) for t in (q, k, v))
                return k1.encoder_attention(*views, bhld_inputs=True).permute(0, 2, 1, 3) \
                    .reshape(b, l, heads * d)

            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = route(*leaves)
            check(out.grad_fn is not None, f"K1 {form}: the kernel's output has no grad_fn")
            got = torch.autograd.grad(out, leaves, do, retain_graph=True)
            plain_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            plain_out = k1.encoder_attention_blf_reference(*plain_leaves, heads)
            want = torch.autograd.grad(plain_out, plain_leaves, do, retain_graph=True)
            name = f"{form} {str(dtype).split('.')[-1]}"
            res = {}
            if dtype == torch.float32:
                worst = max(((g - w).abs().max() / w.abs().max()).item()
                            for g, w in zip(got, want))
                check(worst <= TRAIN_F32_GRAD_RTOL,
                      f"K1 gradient {name}: {worst:.3g} of the largest |g| > "
                      f"{TRAIN_F32_GRAD_RTOL}")
                res["max_rel_err"] = worst
                note = f"max |dX - plain| / max |plain| {worst:.3g} (gate {TRAIN_F32_GRAD_RTOL})"
            else:
                f32_leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
                truth = torch.autograd.grad(
                    k1.encoder_attention_blf_reference(*f32_leaves, heads), f32_leaves,
                    do.float())
                del f32_leaves
                ratios = []
                for g, w, t in zip(got, want, truth):
                    scale = t.abs().max()
                    e_got = ((g.float() - t).abs().max() / scale).item()
                    e_plain = ((w.float() - t).abs().max() / scale).item()
                    m_got = ((g.float() - t).abs().mean() / t.abs().mean()).item()
                    m_plain = ((w.float() - t).abs().mean() / t.abs().mean()).item()
                    ratios.append((e_got, e_plain, m_got, m_plain))
                    check(e_got <= TRAIN_BF16_GRAD_FACTOR * e_plain
                          and m_got <= TRAIN_BF16_GRAD_FACTOR * m_plain,
                          f"K1 gradient {name}: max {e_got:.3g} / mean {m_got:.3g} from the f32 "
                          f"gradient, plain bf16 autograd {e_plain:.3g} / {m_plain:.3g}")
                res["max_rel_err"] = max(r[0] for r in ratios)
                res["plain_bf16_max_rel_err"] = max(r[1] for r in ratios)
                note = ("from the f32 gradient, max/mean per dQ,dK,dV: " + "; ".join(
                    f"{a:.3g}/{c:.3g} (plain bf16 {p:.3g}/{m:.3g})" for a, p, c, m in ratios))
                del truth
            with torch.no_grad():
                fwd = median_ms(lambda: route(q, k, v))
            bwd = median_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
            plain = median_ms(lambda: torch.autograd.grad(
                k1.encoder_attention_blf_reference(*plain_leaves, heads), plain_leaves, do))
            sdpa_leaves = [t.view(b, l, heads, d).transpose(1, 2).contiguous().requires_grad_()
                           for t in (q, k, v)]
            sdpa_do = do.view(b, l, heads, d).transpose(1, 2)
            sdpa = median_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*sdpa_leaves), sdpa_leaves, sdpa_do))
            res.update(forward_ms=fwd, backward_ms=bwd, plain_fwd_bwd_ms=plain,
                       sdpa_fwd_bwd_ms_context=sdpa)
            print(f"K1 {name}: {note}; forward {fwd:.3f} ms, backward {bwd:.3f} ms, plain "
                  f"fwd+bwd {plain:.3f} ms, SDPA fwd+bwd {sdpa:.3f} ms (context)")
            results[name] = res
            del leaves, plain_leaves, out, plain_out, got, want, sdpa_leaves
            gc_cuda()
    return results


def guarded_wrappers_raise(k1, k2, k3, k4, k5, k6, k7, counters) -> None:
    """Phase 20a: every kernel wrapper without a backward, called on the card
    with an input that requires a gradient in grad mode, raises naming itself
    and launches nothing."""
    import torch

    bf16 = dict(device="cuda", dtype=torch.bfloat16)

    def g(*shape, **kw):
        return torch.randn(*shape, **(kw or bf16)).requires_grad_()

    qkv4 = [g(1, 64, 2, 32) for _ in range(3)]
    cl = dict(memory_format=torch.channels_last)
    calls = {
        "encoder_attention_blf_packed": lambda: k1.encoder_attention_blf_packed(
            g(1, 64, 2 * 48), 2, 16, 16),
        "encoder_attention": lambda: k1.encoder_attention(*qkv4, valid_len=60),
        "encoder_attention (bhld)": lambda: k1.encoder_attention(
            *(t.transpose(1, 2) for t in qkv4), valid_len=60, bhld_inputs=True),
        "encoder_attention_blhd": lambda: k1.encoder_attention_blhd(*qkv4),
        "int8_matmul": lambda: k2.int8_matmul(
            g(8, 64), torch.ones(64, 32, device="cuda", dtype=torch.int8),
            torch.ones(32, device="cuda")),
        "stochastic_round_quantize": lambda: k2._sr_quantize_2d(
            g(16, 32, device="cuda", dtype=torch.float32), torch.ones(1, 32, device="cuda"),
            torch.rand(16, 32, device="cuda")),
        "int4_matmul": lambda: k3.int4_matmul(
            g(8, 128), torch.zeros(64, 32, device="cuda", dtype=torch.uint8),
            torch.ones(1, 32, device="cuda")),
        "flash_attention": lambda: k4.flash_attention(*(g(1, 128, 2, 64) for _ in range(3))),
        "flash_attention_v2": lambda: k4.flash_attention_v2(
            *(g(1, 128, 2, 64) for _ in range(3))),
        "conv3x3_nchw": lambda: k5.conv3x3_nchw(
            torch.randn(1, 16, 8, 8, **bf16).to(**cl).requires_grad_(), g(32, 16, 3, 3)),
        "conv3x3_s2_nchw": lambda: k5.conv3x3_s2_nchw(
            torch.randn(1, 16, 8, 8, **bf16).to(**cl).requires_grad_(), g(32, 16, 3, 3)),
        "ln_matmul": lambda: k6.ln_matmul(g(16, 64), torch.ones(64, device="cuda"),
                                          torch.zeros(64, device="cuda"), g(64, 32)),
        "ln_stats": lambda: k7.ln_stats(g(1, 8, 64)),
    }
    zero(counters)
    for name, call in calls.items():
        wrapper = name.split(" ")[0]
        raised = None
        try:
            call()
        except RuntimeError as err:
            raised = str(err)
        check(raised is not None and raised.startswith(wrapper)
              and "no backward" in raised, f"{name} under grad: {raised!r}")
    check(counts(counters) == only(counters, {}), f"launches {counts(counters)}")
    print(f"the {len(calls)} wrappers without a backward each raised under grad, naming "
          "itself, and launched nothing")


def trainer_phase(counters) -> dict:
    """Phase 20b: ``ContrastiveTrainer`` at ``DualEncoderConfig.base()`` on
    the card, f32 (TF32 off), a global batch of 32 seeded pairs, mesh (1, 1)
    over a one-rank NCCL group."""
    import tempfile

    import numpy as np
    import torch

    from multimodal_embeddings_tpu_torch.config import MeshConfig
    from multimodal_embeddings_tpu_torch.core.mesh import ProcessGroup, make_mesh
    from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
    from multimodal_embeddings_tpu_torch.models.vision_encoder import DualEncoderConfig
    from multimodal_embeddings_tpu_torch.training.contrastive import (
        ContrastiveTrainer,
        TrainerConfig,
    )

    phase("20b. ContrastiveTrainer at DualEncoderConfig.base() (ViT-B/16 at 448, text 6x512), "
          f"f32, global batch {TRAIN_BATCH}, mesh (1, 1) on a one-rank NCCL group")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    config = DualEncoderConfig.base()
    tconfig = TrainerConfig(warmup_steps=1, total_steps=100)
    rng = np.random.default_rng(20)
    size = config.vision.image_size
    images = rng.uniform(0, 1, (TRAIN_BATCH, size, size, 3)).astype(np.float32)
    ids, mask = ByteTokenizer().encode_batch(
        [f"page {i}: region text of the archive" * (1 + i % 3) for i in range(TRAIN_BATCH)],
        config.text.max_len)
    batch = (images, ids, mask)
    t0 = time.perf_counter()
    cpu = ContrastiveTrainer(config, tconfig, seed=0, device="cpu")
    params = cpu.jax_params()  # the same weights on the card, through the bridge
    print(f"{cpu.num_params():,} parameters in {len(params)} leaves; CPU init "
          f"{time.perf_counter() - t0:.1f} s")
    del cpu
    # the card against the CPU at reduced depth: the CPU's f32 step of the
    # whole model took 78-98 s on an H100 machine's CPU
    shallow = dataclasses.replace(
        config, vision=dataclasses.replace(config.vision, layers=TRAIN_CPU_VISION_LAYERS),
        text=dataclasses.replace(config.text, layers=TRAIN_CPU_TEXT_LAYERS))
    cpu = ContrastiveTrainer(shallow, tconfig, seed=0, device="cpu")
    out = {}
    # deterministic kernels (the embedding's and the patch conv's gradients
    # accumulate by atomics otherwise), so that two trainers compare bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    with tempfile.TemporaryDirectory() as tmp, \
            ProcessGroup(0, 1, "cuda", store_path=os.path.join(tmp, "store")):
        mesh = make_mesh(MeshConfig(shape=(1, 1)))
        trainer = ContrastiveTrainer(config, tconfig, mesh=mesh, device="cuda", params=params)
        zero(counters)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, grads = trainer.value_and_grad(*batch)
        first_s = time.perf_counter() - t0
        launches = counts(counters)
        want = only(counters, {"encoder_attention_blf": config.vision.layers})
        check(launches == want, f"trainer step launches {launches} != {want}")
        bad = [k for k, g in grads.items() if not np.isfinite(g).all() or not np.abs(g).max() > 0]
        check(not bad, f"{len(bad)} gradient leaves zero or not finite, e.g. {bad[:5]}")
        print(f"step-1 gradient: loss {metrics['loss']:.6f}, all {len(grads)} leaves finite "
              f"and non-zero (q/k/v of all 12 ViT blocks included), K1 BLF "
              f"{launches['encoder_attention_blf']} launches, no other kernel "
              f"({first_s:.1f} s, the first step)")
        plain = ContrastiveTrainer(config, tconfig, mesh=None, device="cuda", params=params)
        p_metrics, p_grads = plain.value_and_grad(*batch)
        check(p_metrics == metrics and all(np.array_equal(p_grads[k], g)
                                           for k, g in grads.items()),
              "mesh (1, 1) and mesh=None differ")
        print("mesh (1, 1) against mesh=None: metrics and every gradient leaf EQUAL")
        del plain, p_grads
        gc_cuda()
        card = ContrastiveTrainer(shallow, tconfig, mesh=mesh, device="cuda",
                                  params=cpu.jax_params())
        s_metrics, s_grads = card.value_and_grad(*batch)
        del card
        t0 = time.perf_counter()
        c_metrics, c_grads = cpu.value_and_grad(*batch)
        cpu_s = time.perf_counter() - t0
        worst, worst_key = 0.0, None
        for key, ref in c_grads.items():
            err = float(np.abs(s_grads[key] - ref).max() / np.abs(ref).max())
            if err > worst:
                worst, worst_key = err, key
        check(worst <= TRAIN_CARD_CPU_RTOL,
              f"card vs CPU gradient: {worst_key} {worst:.3g} of its largest |g|")
        print(f"card vs CPU at {TRAIN_CPU_VISION_LAYERS} ViT and {TRAIN_CPU_TEXT_LAYERS} text "
              f"layers, all {len(c_grads)} leaves (plain attention, f32, {cpu_s:.1f} s on the "
              f"CPU): loss {s_metrics['loss']:.7f} / {c_metrics['loss']:.7f}; worst leaf "
              f"{worst_key} at {worst:.3g} of its largest |g| (gate {TRAIN_CARD_CPU_RTOL})")
        del cpu, c_grads, s_grads
        losses, step_ms = [], []
        zero(counters)
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_step(*batch)["loss"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = counts(counters)
        want = only(counters, {"encoder_attention_blf": config.vision.layers * TRAIN_STEPS})
        check(launches == want, f"{TRAIN_STEPS} steps' launches {launches} != {want}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"the loss did not fall on a repeated batch: {losses}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{TRAIN_STEPS} steps on one batch: losses {', '.join(f'{x:.6f}' for x in losses)} "
              f"(update 0 has learning rate 0); step ms {', '.join(f'{x:.1f}' for x in step_ms)}"
              f" (median {statistics.median(step_ms):.1f}); peak {peak:.2f} GiB; K1 BLF "
              f"{launches['encoder_attention_blf']} launches ({config.vision.layers} a step)")
        out = {"launches": counts(counters), "losses": losses, "step_ms": step_ms,
               "peak_gib": peak, "card_cpu_rel_err": worst}
        del trainer
    torch.use_deterministic_algorithms(False)
    gc_cuda()
    return out


def pp_phase(counters) -> dict:
    """Phase 20c: ``pp_greedy_generate(n_stages=1)`` on the card at the
    Qwen2.5-VL-32B int4 widths, the decoder cut to PP_LAYERS layers, a
    PP_PROMPT-token text prompt, PP_NEW new tokens: tokens EQUAL to
    ``greedy_generate`` on the same model, K3 and K4 launches exact."""
    import numpy as np
    import torch

    from multimodal_embeddings_tpu_torch.models.qwen_pp import pp_greedy_generate
    from multimodal_embeddings_tpu_torch.models.qwen_vl import QwenVLConfig, greedy_generate
    from multimodal_embeddings_tpu_torch.models.weights import build_qwen
    from multimodal_embeddings_tpu_torch.parallel.pipeline import make_pp_mesh

    phase(f"20c. pp_greedy_generate(n_stages=1) at the Qwen2.5-VL-32B int4 widths, "
          f"{PP_LAYERS} of 64 decoder layers, 2 rows of a {PP_PROMPT}-token prompt, {PP_NEW} new tokens")
    full = QwenVLConfig.qwen25_vl_32b_int4()
    config = dataclasses.replace(full, text=dataclasses.replace(full.text, layers=PP_LAYERS))
    model = build_qwen(config, torch.bfloat16, "cuda", seed=0)
    # the seeded 1-D leaves (0.02) make the model emit one token over and
    # over (PR 23's first call); norm scales 1 and biases 0, as phase 12b
    # sets them, give tokens that vary
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0 if name.endswith("scale") else 0.0)
    prompt = np.random.default_rng(21).integers(6, 4096, (2, PP_PROMPT))
    want = greedy_generate(model, prompt, max_new_tokens=PP_NEW)
    torch.cuda.synchronize()
    zero(counters)
    t0 = time.perf_counter()
    got = pp_greedy_generate(config, model, prompt, mesh=make_pp_mesh(1), n_stages=1,
                             max_new_tokens=PP_NEW)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(counters)
    per_pass = 7 * PP_LAYERS + 1
    expect = only(counters, {"int4_matmul": per_pass * (1 + PP_NEW),
                             "flash_attention": PP_LAYERS})
    check(launches == expect, f"pp launches {launches} != {expect}")
    check(np.array_equal(got, want), f"pp tokens {got} != greedy {want}")
    check(len(np.unique(got)) > 2, f"the tokens hardly vary: {got}")
    print(f"tokens EQUAL to greedy_generate: {got.tolist()}; K3 {launches['int4_matmul']} "
          f"({per_pass} per pass x {1 + PP_NEW} passes), K4 {launches['flash_attention']} "
          f"(the prefill's causal attention at L = {PP_PROMPT}); {seconds:.2f} s")
    del model
    gc_cuda()
    return launches


def train_phase(k1, k2, k3, k4, k5, k6, k7, counters, smi: str) -> dict:
    """Phase 20: K1's gradient, the guard, the trainer at full width, PP
    generation; returns its numbers and launches. ``smi``: the card's name
    and power limit, printed beside the phase's numbers."""
    start = time.perf_counter()
    grads = k1_gradient_checks(k1)
    guarded_wrappers_raise(k1, k2, k3, k4, k5, k6, k7, counters)
    trainer = trainer_phase(counters)
    pp = pp_phase(counters)
    print(f"phase 20: {time.perf_counter() - start:.1f} s; every number of it on {smi}")
    return {"k1_grad": grads, "trainer": trainer, "pp": pp}


SCALEOUT_PAGES = 4  # phase 21a: the fused batch's pages
SCALEOUT_MME5_PAGES = 2  # phase 21b: the split batch's pages
SCALEOUT_PARSE_PAGES = 2  # phase 21c: the parse meshes' pages


BATCH_MATCH_MIN = 0.75  # phase 21: least share of a page's boxes matched at IoU >= IOU_MIN


def batch_parity(label, batch, singles, timing) -> dict:
    """Each page of a batch result against its page function's result. The
    detector's cuDNN convs take other algorithms at 120 views than at 30
    (bf16; K1 is EQUAL across batch sizes), so near-tied boxes may swap:
    boxes are matched one to one within a class at IoU ≥ IOU_MIN
    (``match_boxes``), their embeddings' cosine must be ≥ COSINE_MIN, and at
    least BATCH_MATCH_MIN of each page's boxes must match; SERVE_PARITY.json's
    precision, recall and mean matched IoU at its floor of 0.5 are printed
    beside."""
    import numpy as np

    from multimodal_embeddings_tpu_torch.analysis.parity import match_boxes
    from multimodal_embeddings_tpu_torch.ops.iou import iou_matrix_np

    worst_share, worst_cos, rows = 1.0, 1.0, []
    for b, single in enumerate(singles):
        ref = {k: getattr(single, k).float().cpu().numpy() for k in single._fields}
        got = {k: getattr(batch, k)[b].float().cpu().numpy() for k in batch._fields}
        rv, gv = ref["valid"] > 0, got["valid"] > 0
        rb, gb = ref["boxes"][rv].astype(np.float64), got["boxes"][gv].astype(np.float64)
        rc, gc = ref["classes"][rv], got["classes"][gv]
        loose = match_boxes(rb, gb, 0.5, rc, gc)
        tight = match_boxes(rb, gb, IOU_MIN, rc, gc)
        iou = np.where(rc[:, None] == gc[None], iou_matrix_np(rb, gb), 0.0)
        re, ge = ref["embeddings"][rv], got["embeddings"][gv]
        cos = [float(re[i] @ ge[j] / np.linalg.norm(re[i]) / np.linalg.norm(ge[j]))
               for i, j in zip(*np.nonzero(iou >= IOU_MIN))]
        share = min(tight.precision, tight.recall)
        check(len(cos) == tight.n_matched, f"{label} page {b}: ambiguous matches at {IOU_MIN}")
        worst_share = min(worst_share, share)
        worst_cos = min([worst_cos, *cos])
        rows.append(f"page {b}: {tight.n_reference} / {tight.n_candidate} boxes; at IoU >= "
                    f"{IOU_MIN}: {tight.n_matched} matched (precision {tight.precision:.4f}, "
                    f"recall {tight.recall:.4f}), min cosine "
                    f"{min(cos) if cos else float('nan'):.6f}; at 0.5: precision "
                    f"{loose.precision:.4f}, recall {loose.recall:.4f}, mean matched IoU "
                    f"{loose.mean_matched_iou:.6f}")
    print(f"{label}, batched vs its page function per page:\n  " + "\n  ".join(rows))
    print(f"{label}: {timing}")
    check(worst_share >= BATCH_MATCH_MIN,
          f"{label}: {worst_share} of a page's boxes matched at {IOU_MIN} < {BATCH_MATCH_MIN}")
    check(worst_cos >= COSINE_MIN, f"{label}: embedding cosine {worst_cos} < {COSINE_MIN}")
    return {"matched_share": worst_share, "min_cosine": worst_cos}


def batch_invariance(detector, pages) -> None:
    """Why a batched page is not bit-equal to its page alone: the first
    detector module to finish whose output for page 0's 30 views differs
    inside the batch of all pages' views (forward hooks, compared on the
    fly), and K1's two page forms on a page's rows alone and inside the
    batch (EQUAL)."""
    import torch

    from multimodal_embeddings_tpu_torch.kernels import encoder_attention as k1
    from multimodal_embeddings_tpu_torch.ops.image import letterbox_views_matmul
    from multimodal_embeddings_tpu_torch.pipeline.fused import view_slice_bounds_for_page

    cfg = detector.config
    bounds = view_slice_bounds_for_page(PAGE_HW[1], PAGE_HW[0], cfg.grid_configs,
                                        cfg.overlap_percentage)
    views = [letterbox_views_matmul(p.to(torch.bfloat16), bounds, cfg.image_size)[0]
             .to(torch.bfloat16) / 255.0 for p in pages]
    n = views[0].shape[0]
    ref, diffs, order = {}, {}, []

    def tensors(o):
        return [o] if isinstance(o, torch.Tensor) else [t for x in o for t in tensors(x)] \
            if isinstance(o, (tuple, list)) else []

    def keep(name):
        def hook(m, a, o):
            ref[name] = [t.clone() for t in tensors(o)]
            order.append(name)  # the order the modules finish in
        return hook

    def compare(name):
        def hook(m, a, o):
            d = [float((x.float() - y[:n].float()).abs().max())
                 for x, y in zip(ref.get(name, []), tensors(o))]
            diffs[name] = max(d) if d else 0.0
        return hook

    mods = [(name, m) for name, m in detector.model.named_modules() if name]
    with torch.inference_mode():
        for hook, x in ((keep, views[0]), (compare, torch.cat(views))):
            handles = [m.register_forward_hook(hook(name)) for name, m in mods]
            detector.model(x)
            for h in handles:
                h.remove()
    first = next((name for name in order if diffs.get(name, 0.0) > 0), None)
    kinds = dict(mods)
    gen = torch.Generator(device="cuda").manual_seed(21)
    qkv = torch.randn(len(pages) * n, 1024, 4 * 144, device="cuda", generator=gen).bfloat16()
    packed_equal = torch.equal(k1.encoder_attention_blf_packed(qkv[:n].contiguous(), 4, 36, 72),
                               k1.encoder_attention_blf_packed(qkv, 4, 36, 72)[:n])
    x = torch.randn(len(pages) * NUM_REGIONS, 784, 3 * 768, device="cuda",
                    generator=gen).bfloat16()
    q, k, v = x[..., :768], x[..., 768:1536], x[..., 1536:]
    r = NUM_REGIONS
    blf_equal = torch.equal(k1.encoder_attention_blf(q[:r], k[:r], v[:r], 12),
                            k1.encoder_attention_blf(q, k, v, 12)[:r])
    print(f"page 0's {n} views alone against inside the batch of {len(pages) * n}: "
          f"{sum(d > 0 for d in diffs.values())} of {len(diffs)} detector modules differ, the "
          f"first {first} ({type(kinds[first]).__name__ if first else '-'}, max |diff| "
          f"{diffs.get(first, 0.0):.3g}); K1 packed on ({n}, 1024, 576) alone vs inside "
          f"({len(pages) * n}, ...) EQUAL: {packed_equal}; K1 BLF on ({r}, 784, 768) alone vs "
          f"inside ({len(pages) * r}, ...) EQUAL: {blf_equal}")
    check(packed_equal and blf_equal, "K1 differs inside a larger batch")


def timed_ms(fn, *args) -> tuple:
    """(result, ms) of one call, host clock ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def scaleout_phase(counters, smi: str) -> dict:
    """Phase 21: the batch page functions, the sharded store query, the
    sharded embedder and the parse meshes on the card (the mesh paths on a
    one-rank NCCL world), and the CLIs' refusal of a second card; returns
    the launches of each path."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from multimodal_embeddings_tpu_torch.analysis.doc_parser import DocumentParser
    from multimodal_embeddings_tpu_torch.cli import parse as parse_cli
    from multimodal_embeddings_tpu_torch.cli import serve as serve_cli
    from multimodal_embeddings_tpu_torch.config import EmbedderConfig, MeshConfig
    from multimodal_embeddings_tpu_torch.core.mesh import ProcessGroup, make_mesh
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig
    from multimodal_embeddings_tpu_torch.models.qwen_vl import QwenVLConfig
    from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
    from multimodal_embeddings_tpu_torch.models.vision_encoder import DualEncoderConfig
    from multimodal_embeddings_tpu_torch.models.weights import build_qwen
    from multimodal_embeddings_tpu_torch.parallel.pipeline import make_pp_mesh
    from multimodal_embeddings_tpu_torch.pipeline.fused import (
        build_fused_batch_fn,
        build_fused_page_fn,
        build_split_batch_fn,
        build_split_page_fn,
    )
    from multimodal_embeddings_tpu_torch.store.embedding_store import Collection, masked_topk

    start = time.perf_counter()
    out, launches = {}, {}

    # -- a. the fused batch: the headline ViT page, 4 pages ------------------
    phase(f"21a. build_fused_batch_fn(mesh=None) at the headline config (v10-m, 30 views "
          f"letterboxed, ViT-B/16 DualEncoderConfig.base(), {NUM_REGIONS} regions) on "
          f"{SCALEOUT_PAGES} pages of {PAGE_HW[0]}x{PAGE_HW[1]}")
    t0 = time.perf_counter()
    detector = make_detector()
    pages_np = [synthetic_page(70 + i, 0.0) for i in range(SCALEOUT_PAGES)]
    fit_head(detector, pages_np[0])  # scores spread (STAGE_VIEW_BOXES), not one tie
    vit = MultimodalEmbedder(EmbedderConfig(family="siglip", dtype="bfloat16"),
                             model_config=DualEncoderConfig.base(), device="cuda", seed=0)
    batch_np = np.stack(pages_np)
    pages = torch.from_numpy(batch_np).cuda()
    fused = build_fused_batch_fn(detector, vit, PAGE_HW, NUM_REGIONS, letterbox=True)
    single = build_fused_page_fn(detector, vit, PAGE_HW, NUM_REGIONS, letterbox=True)
    fused(pages)  # warm-up
    single(pages[0])
    print(f"set-up and warm-up {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    got, batch_ms = timed_ms(fused, pages)
    launches["serve_fused_batch_4_pages"] = counts(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    layers = vit.model_config.vision.layers
    want = only(counters, {"encoder_attention_blf_packed": 1, "encoder_attention_blf": layers})
    check(launches["serve_fused_batch_4_pages"] == want,
          f"fused batch launches {launches['serve_fused_batch_4_pages']} != {want}")
    print(f"launches: K1 packed 1 (one detector call over {SCALEOUT_PAGES}x30 views), K1 BLF "
          f"{layers} (one ViT call over {SCALEOUT_PAGES}x{NUM_REGIONS} crops, 1 a layer)")
    zero(counters)
    singles, single_ms = [], []
    for page in pages:
        res, ms = timed_ms(single, page)
        singles.append(res)
        single_ms.append(ms)
    want = only(counters, {"encoder_attention_blf_packed": SCALEOUT_PAGES,
                           "encoder_attention_blf": layers * SCALEOUT_PAGES})
    check(counts(counters) == want, f"single-page launches {counts(counters)} != {want}")
    for b in range(SCALEOUT_PAGES):
        check_page(type(singles[b])(*(x[b] for x in got)), 768)
    out["fused"] = batch_parity(
        "21a fused batch", got, singles,
        f"{batch_ms / SCALEOUT_PAGES:.1f} ms per page batched ({batch_ms:.1f} ms for "
        f"{SCALEOUT_PAGES}), {statistics.mean(single_ms):.1f} ms per page single (pages: "
        + ", ".join(f"{x:.1f}" for x in single_ms) + f"); peak {peak:.2f} GiB batched; {smi}")
    out["fused"].update(batch_ms_per_page=batch_ms / SCALEOUT_PAGES,
                        single_ms_per_page=statistics.mean(single_ms), peak_gib=peak)
    batch_invariance(detector, pages)

    # -- b. the split batch: mmE5-11B widths, int8-mixed, reduced depth ------
    config = reduced_mme5(MllamaConfig.mme5_11b_int8_mixed())
    phase(f"21b. build_split_batch_fn(mesh=None) at the mmE5-11B widths, int8-mixed, "
          f"{config.vision.layers}+{config.vision.global_layers} tower and "
          f"{config.text.layers} text layers, chunks of {MME5_CHUNK}, on {SCALEOUT_MME5_PAGES} "
          "pages")
    t0 = time.perf_counter()
    mme5 = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="bfloat16",
                                             quantize=config.quantize),
                              model_config=config, device="cuda", seed=0)
    split = build_split_batch_fn(detector, mme5, PAGE_HW, NUM_REGIONS, MME5_CHUNK,
                                 letterbox=True)
    split_single = build_split_page_fn(detector, mme5, PAGE_HW, NUM_REGIONS, MME5_CHUNK,
                                       letterbox=True)
    mme5_pages = pages[:SCALEOUT_MME5_PAGES]
    split(mme5_pages)
    split_single(mme5_pages[0])
    print(f"set-up and warm-up {time.perf_counter() - t0:.1f} s")
    zero(counters)
    got2, batch2_ms = timed_ms(split, mme5_pages)
    launches["serve_split_batch_mme5_2_pages"] = counts(counters)
    chunks = NUM_REGIONS // MME5_CHUNK
    per_call = mme5_launches(config, chunks, chunks)
    check(launches["serve_split_batch_mme5_2_pages"] == only(counters, per_call),
          f"split batch launches {launches['serve_split_batch_mme5_2_pages']} != {per_call}")
    print(f"launches: {per_call} — per batch call, as per page: K1 packed 1, K1 prefix "
          f"({config.vision.layers}+{config.vision.global_layers}) x {chunks} chunk calls of "
          f"{SCALEOUT_MME5_PAGES}x{MME5_CHUNK} crops, K2 7 x {config.text.layers} x {chunks}")
    zero(counters)
    singles2, single2_ms = [], []
    for page in mme5_pages:
        res, ms = timed_ms(split_single, page)
        singles2.append(res)
        single2_ms.append(ms)
    want = only(counters, {k: v * SCALEOUT_MME5_PAGES for k, v in per_call.items()})
    check(counts(counters) == want, f"split single launches {counts(counters)} != {want}")
    out["split"] = batch_parity(
        "21b split batch (mmE5)", got2, singles2,
        f"{batch2_ms / SCALEOUT_MME5_PAGES:.1f} ms per page batched, "
        f"{statistics.mean(single2_ms):.1f} ms per page single; {smi}")

    # -- c. the mesh paths on a world of one ----------------------------------
    phase("21c. mesh (1, 1) on a one-rank NCCL world: both batch functions, "
          "Collection.set_mesh, MultimodalEmbedder(mesh=), DocumentParser(dp_mesh=, pp_mesh=)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            ProcessGroup(0, 1, "cuda", store_path=os.path.join(tmp, "store")):
        mesh = make_mesh(MeshConfig(shape=(1, 1)))
        for label, fn, ref, inputs in (
                ("fused", build_fused_batch_fn(detector, vit, PAGE_HW, NUM_REGIONS, mesh=mesh,
                                               letterbox=True), got, batch_np),
                ("split", build_split_batch_fn(detector, mme5, PAGE_HW, NUM_REGIONS,
                                               MME5_CHUNK, letterbox=True, mesh=mesh), got2,
                 batch_np[:SCALEOUT_MME5_PAGES])):
            res = fn(inputs)
            check(all(torch.equal(a, b) for a, b in zip(res, ref)),
                  f"{label} batch on mesh (1, 1) != mesh=None")
        print("both batch functions on mesh (1, 1): every field EQUAL to mesh=None")
        del vit
        gc_cuda()

        rng = np.random.default_rng(21)
        rows = rng.standard_normal((SERVE_STORE_ROWS, 768)).astype(np.float32)
        rows[SERVE_STORE_ROWS - 7] = rows[11]  # a planted tie: row 11 must come first
        queries = rng.standard_normal((SERVE_QUERIES, 768)).astype(np.float32)
        queries[0] = rows[11]
        col = Collection(tmp, "scaleout", device="cuda")
        col.upsert(ids=[f"r{i}" for i in range(SERVE_STORE_ROWS)], embeddings=rows,
                   metadatas=[{}] * SERVE_STORE_ROWS)
        unit = torch.from_numpy(rows / np.linalg.norm(rows, axis=1, keepdims=True)).cuda()
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        ws, wi = masked_topk(unit, torch.from_numpy(qn).cuda(),
                             torch.ones(SERVE_STORE_ROWS, dtype=torch.bool, device="cuda"),
                             SERVE_K)
        col.set_mesh(mesh)
        res = col.query(queries, n_results=SERVE_K)
        check(res["ids"] == [[f"r{j}" for j in row] for row in wi.cpu().tolist()],
              "sharded store ids != masked_topk")
        check(res["distances"] == (1.0 - ws.cpu().numpy()).tolist(),
              "sharded store distances != masked_topk")
        check(res["ids"][0][:2] == ["r11", f"r{SERVE_STORE_ROWS - 7}"],
              f"the planted tie: {res['ids'][0][:2]}")
        print(f"Collection.set_mesh at {SERVE_STORE_ROWS} x 768, {SERVE_QUERIES} queries, "
              f"k = {SERVE_K}: ids and distances EQUAL to the unsharded masked_topk; the "
              "planted tie in row order")
        del col, unit

        ref_config = reduced_mme5(MllamaConfig.mme5_11b())
        *_, crops = split_single.detect(mme5_pages[0])
        crops = normalised(crops[:MME5_CHUNK])
        images = [pages_np[0][200:760, 300:860], pages_np[1][900:1460, 100:660]]
        embs = {}
        for label, m in (("mesh", mesh), ("plain", None)):
            emb = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="bfloat16"),
                                     model_config=ref_config, device="cuda", seed=0, mesh=m)
            zero(counters)
            tiles = emb.encode_image(crops)
            if label == "mesh":
                launches["mesh1_embedder_tp"] = counts(counters)
            embs[label] = (tiles, emb.get_image_embeddings(images, batch_size=2))
            del emb
            gc_cuda()
        n_tower = ref_config.vision.layers + ref_config.vision.global_layers
        want = only(counters, {"encoder_attention": n_tower})
        check(launches["mesh1_embedder_tp"] == want,
              f"mesh embedder launches {launches['mesh1_embedder_tp']} != {want}")
        check(torch.equal(embs["mesh"][0], embs["plain"][0])
              and embs["mesh"][1] == embs["plain"][1], "mme5 bf16 on mesh (1, 1) != mesh=None")
        print(f"MultimodalEmbedder(mesh=(1, 1)) mme5 bf16 at the 11B widths, "
              f"{ref_config.vision.layers}+{ref_config.vision.global_layers} tower and "
              f"{ref_config.text.layers} text layers: {MME5_CHUNK} single-tile crops (K1 prefix "
              f"{n_tower}, one a tower layer) and the host API on 2 images EQUAL to mesh=None")
        del mme5, split, split_single, detector
        gc_cuda()

        full = QwenVLConfig.qwen25_vl_32b_int4()
        qconfig = dataclasses.replace(full, text=dataclasses.replace(full.text,
                                                                       layers=PP_LAYERS))
        model = build_qwen(qconfig, torch.bfloat16, "cuda", seed=0)
        with torch.no_grad():  # varying tokens, as in phases 12b and 20c
            for name, p in model.named_parameters():
                if p.dim() == 1:
                    p.fill_(1.0 if name.endswith("scale") else 0.0)
        paths = []
        for i in range(SCALEOUT_PARSE_PAGES):
            paths.append(os.path.join(tmp, f"parse{i}.png"))
            Image.fromarray(pages_np[i]).save(paths[-1])
        kw = dict(dynamic_resolution=True, max_pixels=QWEN_MAX_PIXELS, device="cuda")

        def recording(parser):
            """``parser`` with the token rows it decodes kept in ``parser.rows``."""
            parser.rows, decode = [], parser.decode_tokens
            parser.decode_tokens = lambda row: (parser.rows.append(np.array(row)), decode(row))[1]
            return parser

        # the DP parse runs parse_batch's one generate call over the pages; the
        # PP ring runs one a page (JAX's rule), so it is held to the
        # single-device parse of each page
        base = recording(DocumentParser(model, ByteTokenizer(), **kw))
        plain = base.parse_batch(paths, PP_NEW)
        per_page = recording(DocumentParser(model, ByteTokenizer(), **kw))
        plain_pages = [per_page.parse(p, PP_NEW) for p in paths]
        per_pass = 7 * PP_LAYERS + 1
        blocks = len(qconfig.vision.fullatt_block_indexes)
        for label, parser, want, ref, ref_rows in (
                ("mesh1_parse_dp", DocumentParser(model, ByteTokenizer(), dp_mesh=mesh, **kw),
                 {"int4_matmul": per_pass * (1 + PP_NEW), "flash_attention": blocks},
                 plain, base.rows),
                ("mesh1_parse_pp", DocumentParser(model, ByteTokenizer(), pp_mesh=make_pp_mesh(1),
                                                  pp_stages=1, **kw),
                 {"int4_matmul": per_pass * (1 + PP_NEW) * SCALEOUT_PARSE_PAGES,
                  "flash_attention": blocks * SCALEOUT_PARSE_PAGES},
                 plain_pages, per_page.rows)):
            recording(parser)
            zero(counters)
            res, ms = timed_ms(parser.parse_batch, paths, PP_NEW)
            launches[label] = counts(counters)
            check(launches[label] == only(counters, want),
                  f"{label} launches {launches[label]} != {want}")
            check(res == ref and all(np.array_equal(a, b) for a, b in zip(parser.rows, ref_rows)),
                  f"{label}: {parser.rows} != {ref_rows}")
            print(f"{label}: {SCALEOUT_PARSE_PAGES} pages' tokens and outputs EQUAL to the "
                  f"single-device {'parse_batch' if label.endswith('dp') else 'parse a page'}; "
                  f"{ms:.1f} ms; K3 {launches[label]['int4_matmul']}, K4 "
                  f"{launches[label]['flash_attention']}")
        same = [int(np.argmax(np.asarray(a) != np.asarray(b))) if not np.array_equal(a, b)
                else len(a) for a, b in zip(base.rows, per_page.rows)]
        print(f"parse_batch (one call, B = {SCALEOUT_PARSE_PAGES}) against parse a page (B = 1): "
              f"the first {same} tokens of each page agree (bf16 on the card; EQUAL in f32 on "
              "the CPU, tests/test_torch_doc_parser.py)")
        from multimodal_embeddings_tpu_torch.kernels.quantization_int4 import int4_matmul

        gen = torch.Generator(device="cuda").manual_seed(21)
        x = torch.randn(2, 5120, device="cuda", generator=gen).bfloat16()
        packed = torch.randint(0, 256, (2560, 5120), device="cuda", generator=gen,
                               dtype=torch.uint8)
        scale = torch.rand(40, 5120, device="cuda", generator=gen) * 0.02
        print(f"K3's decode form at (M, 5120) x (5120, 5120): row 0 at M = 1 EQUAL to row 0 at "
              f"M = 2: {torch.equal(int4_matmul(x[:1], packed, scale), int4_matmul(x, packed, scale)[:1])}")
        check(all(len(np.unique(r)) > 2 for r in base.rows),
              f"the tokens hardly vary: {base.rows}")
        print(f"tokens: {[r.tolist() for r in base.rows]}")
        print(f"the 32B int4 widths, {PP_LAYERS} of 64 decoder layers, {PP_NEW} new tokens, pages "
              f"at {plain[0][2]}x{plain[0][1]}: K3 = (7 x {PP_LAYERS} + 1) x (1 + {PP_NEW}) a "
              f"generate call (dp: one call for both pages; pp: one a page), K4 = {blocks} "
              "full-attention vision blocks a vision call")
        del model
        gc_cuda()
    print(f"21c: {time.perf_counter() - t0:.1f} s")

    # -- d. the CLIs refuse a second card -------------------------------------
    phase("21d. cli.serve / cli.parse --data_parallel 2 on one card")
    for name, main, argv, words in (
            ("serve", serve_cli.main, ["--device", "cuda"], "needs 2 devices; only 1 visible"),
            ("parse", parse_cli.main, ["--device", "cuda", "--size", "tiny"],
             "--data_parallel 2: only 1 devices visible")):
        try:
            main(argv + ["--data_parallel", "2"])
            check(False, f"cli.{name} --data_parallel 2 ran on one card")
        except SystemExit as exc:
            check(words in str(exc), f"cli.{name}: {exc}")
            print(f"cli.{name} --data_parallel 2: exits with {str(exc)!r}")
    seconds = time.perf_counter() - start
    print(f"phase 21: {seconds:.1f} s; every number of it on {smi}")
    out.update(launches=launches, seconds=seconds)
    return out


SERVE_PARITY_PAGES = 3  # phase 22: the JAX parity tools' default --pages


def _script(name: str):
    """``scripts/<name>.py`` of this checkout as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k1_scale_checks(k1) -> None:
    """Phase 22's K1 part: each wrapper once at a scale other than 1/√D
    against its plain version at that scale, bf16, K1's per-output and mean
    gates, at a shape of its page path (fewer batch rows);
    ``encoder_attention_padded``, which has no scale argument, at the
    Mllama prefix."""
    import torch

    phase("22a. K1's wrappers at a non-default sm_scale against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(22)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    def weighted(plain, q, k, v, *args, **kw):
        return plain(q.float(), k.float(), v.float().abs(), *args, **kw)

    blf = [randn(8, 784, 768) for _ in range(3)]
    packed = randn(4, 1024, 576)
    bhld = [randn(8, 784, 768).view(8, 784, 12, 64).permute(0, 2, 1, 3) for _ in range(3)]
    prefix = [randn(2, 1608, 16, 80) for _ in range(3)]
    cases = (
        ("encoder_attention_blf", 0.05, tuple(blf[0].shape),
         lambda s: k1.encoder_attention_blf(*blf, 12, sm_scale=s),
         lambda s: k1.encoder_attention_blf_reference(*blf, 12, sm_scale=s),
         lambda s: weighted(k1.encoder_attention_blf_reference, *blf, 12, sm_scale=s)),
        ("encoder_attention_blf_packed", 0.1, tuple(packed.shape),
         lambda s: k1.encoder_attention_blf_packed(packed, 4, 36, 72, sm_scale=s),
         lambda s: k1.encoder_attention_blf_packed_reference(packed, 4, 36, 72, sm_scale=s),
         lambda s: k1.encoder_attention_blf_packed_reference(
             packed_abs_v(packed, 4, 36), 4, 36, 72, sm_scale=s)),
        ("encoder_attention (bhld)", 0.05, tuple(bhld[0].shape),
         lambda s: k1.encoder_attention(*bhld, bhld_inputs=True, sm_scale=s),
         lambda s: k1.encoder_attention_reference(*bhld, bhld_inputs=True, sm_scale=s),
         lambda s: weighted(k1.encoder_attention_reference, *bhld, bhld_inputs=True,
                            sm_scale=s)),
        ("encoder_attention valid 1601", 0.07, tuple(prefix[0].shape),
         lambda s: k1.encoder_attention(*prefix, valid_len=1601, sm_scale=s),
         lambda s: k1.encoder_attention_reference(*prefix, 1601, sm_scale=s),
         lambda s: weighted(k1.encoder_attention_reference, *prefix, 1601, sm_scale=s)),
        ("encoder_attention_padded valid 1601", None, tuple(prefix[0].shape),
         lambda s: k1.encoder_attention_padded(*prefix, 1601),
         lambda s: k1.encoder_attention_reference(*prefix, 1601),
         lambda s: weighted(k1.encoder_attention_reference, *prefix, 1601)),
    )
    for name, scale, shape, kernel, plain, plain_abs in cases:
        got, want = kernel(scale), plain(scale)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        _, note = k1_bf16_gate(f"{name} sm_scale {scale}", got, want, plain_abs(scale))
        err = (got.float() - want.float()).abs()
        check(err.mean().item() <= ATOL_BF16_MEAN, f"{name}: mean err {err.mean().item()}")
        print(f"{name} {shape} bf16 at sm_scale {scale or '1/sqrt(D)'}: max_abs_err "
              f"{err.max().item():.3e} mean_abs_err {err.mean().item():.3e} ({note})")


def serve_parity_phase(k1, counters, smi: str) -> dict:
    """Phase 22: ``scripts/torch_serve_parity.py`` and
    ``scripts/torch_knife_edge_probe.py`` at ``--full`` on the card, the
    class head fitted as in phase 17; the candidate tap against the serving
    NMS; K1 at a non-default scale. Returns the twins' records and the
    launches of their run."""
    import numpy as np
    import torch

    from multimodal_embeddings_tpu_torch.models.yolo_decode import top_k
    from multimodal_embeddings_tpu_torch.ops.nms import nms_padded

    start = time.perf_counter()
    k1_scale_checks(k1)
    phase(f"22b. serve-vs-exact detection parity at --full (v10-m, 1024 px, grids 2x2/3x3/4x4, "
          f"{SERVE_PARITY_PAGES} pages of 2200x1700, 48 regions, bf16; the head fitted on "
          "page 0)")
    sp, ke = _script("torch_serve_parity"), _script("torch_knife_edge_probe")
    t0 = time.perf_counter()
    page_hw, num_regions, detector = sp.setup(True, "cuda")
    pages = sp.make_pages(page_hw, SERVE_PARITY_PAGES)
    fit_head(detector, pages[0])  # scores spread (STAGE_VIEW_BOXES), not one tie
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    calls = [0]
    hook = detector.model.register_forward_pre_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    t0 = time.perf_counter()
    exact = sp.exact_chain(detector, pages)
    serve = sp.run(detector, pages, page_hw, num_regions, full=True, exact=exact)
    knife = ke.run(detector, pages, page_hw, num_regions, full=True, exact=exact)
    torch.cuda.synchronize()
    twins_s = time.perf_counter() - t0
    launches = counts(counters)
    hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one detector call a page in the exact chain, each of the six variants,
    # the three eps runs and the candidate tap
    want_calls = (1 + len(sp.VARIANTS) + 4) * len(pages)
    check(calls[0] == want_calls, f"{calls[0]} detector calls, not {want_calls}")
    want = only(counters, {"encoder_attention_blf_packed": calls[0]})
    check(launches == want, f"launches {launches} != {want}: K1 packed once a detect call")
    print(f"both twins: {twins_s:.1f} s for {calls[0]} detector calls (the exact chain once, "
          f"shared); K1 packed {launches['encoder_attention_blf_packed']}, every other kernel "
          f"0; peak device memory {peak:.2f} GiB")
    print(f"exact chain (stages 1-3): {exact[1]:.2f} s for {len(pages)} pages; boxes per page "
          f"{[len(v[0]) for v in exact[0].values()]}")

    def unit(name, x):
        check(math.isfinite(x) and 0.0 <= x <= 1.0, f"{name} = {x}")

    print("variant: precision, recall_topk, mean matched IoU, seconds")
    for variant, *_ in sp.VARIANTS:
        r = serve[variant]
        for key in ("precision", "recall_topk", "mean_matched_iou"):
            unit(f"{variant} {key}", r[key])
            for row in r["pages"]:
                unit(f"{variant} {row['page']} {key}", row[key])
        print(f"  {variant}: {r['precision']} {r['recall_topk']} {r['mean_matched_iou']} "
              f"{r['seconds_incl_compile']} s; serve boxes "
              f"{[row['serve_boxes'] for row in r['pages']]}")
    for key in ("iou_048", "iou_050", "iou_052", "host_remerge"):
        for metric in ("precision", "recall_topk", "mean_matched_iou"):
            unit(f"{key} {metric}", knife[key][metric])
    unit("uncut_candidate_recall_topk", knife["host_remerge"]["uncut_candidate_recall_topk"])
    for x in knife["unmatched_best_iou_at_050"]:
        unit("unmatched best IoU", x)
    for key in ("recall_gap_at_050", "recall_gap_after_host_f64_remerge", "recall_moved_by_eps"):
        unit(key, knife["interpretation"][key])
    print("knife edge: recall_topk " + ", ".join(
        f"{k} {knife[k]['recall_topk']}" for k in ("iou_048", "iou_050", "iou_052",
                                                    "host_remerge"))
        + f"; uncut {knife['host_remerge']['uncut_candidate_recall_topk']}; flips "
          f"{knife['eps_flips']}; {len(knife['unmatched_best_iou_at_050'])} unmatched exact "
          f"top-K boxes, best IoUs {knife['unmatched_best_iou_at_050']}; "
          f"{knife['interpretation']}")
    print("serve parity record: " + json.dumps(serve))
    print("knife edge record: " + json.dumps({"knife_edge": knife}))

    # the tap holds what the serving NMS takes: the device NMS on it gives
    # the plain call's regions, bit for bit
    opts = dict(letterbox=True, edge_filter=True, candidate_cap=ke.CANDIDATE_CAP)
    tap = sp.detect_fn(detector, page_hw, num_regions, return_candidates=True, **opts)
    plain = sp.detect_fn(detector, page_hw, num_regions, **opts)
    for i, page in enumerate(pages):
        page = torch.from_numpy(page).cuda()
        cb, cs, cc = tap(page)
        keep, order = nms_padded(cb, cs, cc, cs > 0, iou_threshold=0.5, class_aware=True)
        top, sel = top_k(torch.where(keep, cs[order], -1.0), num_regions)
        boxes, scores, classes, valid, _ = plain(page)
        check(torch.equal(cb[order[sel]], boxes) and torch.equal(top, scores)
              and torch.equal(cc[order[sel]], classes),
              f"page {i}: nms_padded on the candidate tap differs from the plain call")
        print(f"page {i}: {int((cs > 0).sum())} live of {cs.numel()} candidates; nms_padded on "
              f"the tap EQUAL to the plain call's {int(valid.sum())} regions")
    del detector
    gc_cuda()
    seconds = time.perf_counter() - start
    print(f"phase 22: {seconds:.1f} s; every number of it on {smi}")
    return {"launches": {f"serve_parity_{len(pages)}_pages": launches}, "serve": serve,
            "knife_edge": knife, "seconds": seconds}


def gc_cuda() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from multimodal_embeddings_tpu_torch.kernels import conv as k5
    from multimodal_embeddings_tpu_torch.kernels import encoder_attention as k1
    from multimodal_embeddings_tpu_torch.kernels import flash_attention as k4
    from multimodal_embeddings_tpu_torch.kernels import ln_matmul as k6
    from multimodal_embeddings_tpu_torch.kernels import ln_stats as k7
    from multimodal_embeddings_tpu_torch.kernels import quantization as k2
    from multimodal_embeddings_tpu_torch.kernels import quantization_int4 as k3
    from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig

    start = time.perf_counter()
    smi = card()
    if sys.argv[1:] == ["--k5"]:
        build(("K5", k5))
        phase("4a/3a. K5 alone: both forms against their plain versions")
        k5_checks(k5)
        k5_s2_checks(k5)
        print(f"K5 alone: {time.perf_counter() - start:.1f} s")
        return 0
    if sys.argv[1:] == ["--k2"]:
        build(("K2", k2))
        int8_checks(k2)
        print(f"K2 alone: {time.perf_counter() - start:.1f} s")
        return 0
    if sys.argv[1:] == ["--k3"]:
        build(("K3", k3))
        int4_checks(k3)
        print(f"K3 alone: {time.perf_counter() - start:.1f} s")
        return 0
    if sys.argv[1:] == ["--qwen"]:
        build(("K3", k3), ("K4", k4))
        int4_checks(k3)
        counters = kernel_counters(k1, k2, k3, k4, k5, k6, k7)
        _, ids, pixels, config, model, parser = qwen_page(counters)
        qwen_continuous(counters, model, parser, ids, pixels, config)
        print(f"Qwen alone: {time.perf_counter() - start:.1f} s")
        return 0
    if sys.argv[1:] == ["--k6"]:
        build(("K6", k6))
        phase("4a. K6 alone: every form against its plain version")
        k6_checks(k6)
        print(f"K6 alone: {time.perf_counter() - start:.1f} s")
        return 0
    if sys.argv[1:] == ["--serve"]:
        build(("K1", k1), ("K2", k2))
        serving_cli(kernel_counters(k1, k2, k3, k4, k5, k6, k7))
        print(f"serving CLI alone: {time.perf_counter() - start:.1f} s")
        return 0
    if sys.argv[1:] == ["--stages"]:
        build(("K1", k1))
        stage_chain(kernel_counters(k1, k2, k3, k4, k5, k6, k7))
        print(f"stage chain alone: {time.perf_counter() - start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    if sys.argv[1:] == ["--workflow"]:
        build(("K1", k1))
        workflow_run(kernel_counters(k1, k2, k3, k4, k5, k6, k7))
        print(f"workflow alone: {time.perf_counter() - start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    if sys.argv[1:] == ["--parity"]:
        build(("K1", k1), ("K2", k2))
        parity_phase(kernel_counters(k1, k2, k3, k4, k5, k6, k7))
        print(f"parity tooling alone: {time.perf_counter() - start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    if sys.argv[1:] == ["--train"]:
        build(("K1", k1), ("K3", k3), ("K4", k4))
        train_phase(k1, k2, k3, k4, k5, k6, k7, kernel_counters(k1, k2, k3, k4, k5, k6, k7),
                    smi)
        print(f"phase 20 alone: {time.perf_counter() - start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    if sys.argv[1:] == ["--scaleout"]:
        build(("K1", k1), ("K2", k2), ("K3", k3), ("K4", k4))
        scaleout_phase(kernel_counters(k1, k2, k3, k4, k5, k6, k7), smi)
        print(f"phase 21 alone: {time.perf_counter() - start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    if sys.argv[1:] == ["--serve_parity"]:
        build(("K1", k1))
        serve_parity_phase(k1, kernel_counters(k1, k2, k3, k4, k5, k6, k7), smi)
        print(f"phase 22 alone: {time.perf_counter() - start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    if sys.argv[1:] == ["--k7"]:
        build(("K7", k7))
        phase("4a. K7 alone: against its plain version, its times and its edges")
        k7_checks(k7)
        print(f"K7 alone: {time.perf_counter() - start:.1f} s")
        return 0
    # K4 takes the longest nvcc by far: the phases that do not call it (4 to
    # 8d) run while it builds, and phases 3, 3a and 6 follow them
    k4_built = build(("K1", k1), ("K2", k2), ("K3", k3), ("K4", k4), ("K5", k5), ("K6", k6),
                     ("K7", k7), ("K8", SimpleNamespace(build_info=k2.sr_build_info)),
                     later=("K4",))
    counters = kernel_counters(k1, k2, k3, k4, k5, k6, k7)
    vit_launches, crops, embs, model_config, detector, vit_embedder = full_slice(counters)
    card_vs_cpu(crops, embs, model_config)
    route = route_kernel_checks(k1, k5, k6, k7)
    gc.collect()
    torch.cuda.empty_cache()
    route_launches = kernel_route_page(counters, detector, vit_embedder)
    bhld_launches = bhld_route_page(counters, detector, vit_embedder, crops, embs)
    del vit_embedder
    gc.collect()
    torch.cuda.empty_cache()
    int8 = int8_checks(k2)
    mme5_config = MllamaConfig.mme5_11b_int8_mixed()
    mme5_launches, mme5_crops, _, mme5_embedder, mme5_pages, mme5_ms = mme5_page(
        counters, detector, mme5_config, "8. full-width mmE5-11B int8-mixed page program")
    tower_launches = mme5_tower(counters, mme5_embedder, mme5_crops)
    text_chunk_launches = mme5_text_chunk_page(counters, detector, mme5_embedder, mme5_pages,
                                               mme5_ms)
    del mme5_pages
    tiles4_launches = mme5_tiles4_page(counters, detector, mme5_embedder)
    api_launches = mme5_engine_api(counters, mme5_embedder)
    del mme5_embedder
    gc.collect()
    torch.cuda.empty_cache()
    k4_built()
    checks = kernel_checks(k1, k4)
    last = last_port_checks(k1, k2, k4, k5)
    masked = masked_checks(k1, k4)
    gc.collect()
    torch.cuda.empty_cache()
    float_tree = mme5_card_vs_cpu(mme5_crops, mme5_config)
    gc.collect()
    storage_launches = mme5_storage_pages(counters, detector)
    mme5_float_checkpoint(mme5_crops, mme5_config, float_tree)
    del float_tree
    del detector, crops, embs, mme5_crops
    gc.collect()
    torch.cuda.empty_cache()
    flash = flash_checks(k4)
    int4 = int4_checks(k3)
    int4_mme5 = int4.pop("mme5")
    int4_m8 = int4.pop("decode_m8")
    gc.collect()
    torch.cuda.empty_cache()
    qwen_launches, ids, pixels, qwen_config, qwen_model, parser = qwen_page(counters)
    gc.collect()
    torch.cuda.empty_cache()
    cont_launches, _ = qwen_continuous(counters, qwen_model, parser, ids, pixels, qwen_config)
    del qwen_model, parser
    gc.collect()
    torch.cuda.empty_cache()
    qwen_card_vs_cpu(ids, pixels, qwen_config)
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches_by_run = serving_cli(counters)
    stage_launches = stage_chain(counters)
    workflow_launches = workflow_run(counters)
    gc_cuda()
    parity_launches = parity_phase(counters)
    gc_cuda()
    train = train_phase(k1, k2, k3, k4, k5, k6, k7, counters, smi)
    gc_cuda()
    scaleout = scaleout_phase(counters, smi)
    gc_cuda()
    serve_parity = serve_parity_phase(k1, counters, smi)
    print(f"all phases: {time.perf_counter() - start:.1f} s")

    src = "multimodal_embeddings_tpu_torch/csrc/encoder_attention.cu"
    ref = "multimodal_embeddings_tpu/kernels/encoder_attention.py"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches over each path's timed run: 3 ViT pages on each route, 2 Qwen
    # pages; per page of each mmE5 path (per chunk of the fuse_ln tower, per
    # host-API call of 3 images); phase 19: one traced forward of each dump,
    # one traced ViT page
    paths = {"vit_page": vit_launches, "vit_kernel_route_page": route_launches,
             "vit_bhld_route_page": bhld_launches, "mme5_page": mme5_launches,
             "mme5_tower_fuse_mlp": tower_launches,
             "mme5_text_chunk_page": text_chunk_launches, "mme5_tiles4_page": tiles4_launches,
             "mme5_engine_api": api_launches,
             **{f"mme5_{label}_page": v for label, v in storage_launches.items()},
             "qwen_page": qwen_launches,
             "qwen_continuous_early_exit": cont_launches["continuous, early-exit chunks"],
             "qwen_continuous_fixed": cont_launches["continuous, fixed chunks"],
             "qwen_waves_b8": cont_launches["waves"],
             "serve_siglip_5_pages": serve_launches_by_run["pipelined"],
             "serve_mme5_2_pages": serve_launches_by_run["mme5"],
             "stage_chain_4_pages": stage_launches,
             "workflow_6_pages": workflow_launches,
             **parity_launches,
             f"trainer_{TRAIN_STEPS}_steps": train["trainer"]["launches"],
             "pp_greedy_generate": train["pp"],
             **scaleout["launches"],
             **serve_parity["launches"]}

    def entry(name, source, replaces, home, shape, res, library=True):
        """``home``: the path whose launches the entry reports (None for a
        kernel on no path: the sum over all, 0)."""
        by_path = {path: launches[name] for path, launches in paths.items()}
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": by_path[home] if home else sum(by_path.values()),
               "launches_by_path": by_path, "shape": shape}
        out.update({k: res.get(k) if library or k != "library_ms" else None for k in keys})
        return out

    def headline(results, name):
        """The headline shape's numbers with the largest error over all."""
        head = dict(results[name])
        head["max_abs_err"] = max(r["max_abs_err"] for r in results.values())
        return head

    vit, psa = checks[("vit", torch.bfloat16)], checks["psa"]
    k2_head = headline({s: int8[s] for s in K2_SHAPES}, K2_HEADLINE)
    k3_head = headline({**int4, **{f"mmE5 {k}": v for k, v in int4_mme5.items()},
                        **{f"decode B={K3_DECODE_ROWS} {k}": v for k, v in int4_m8.items()}},
                       K3_HEADLINE)
    k4_head = headline(flash, "vision")
    k5_head = headline({s: route["k5"][s] for s in K5_SHAPES}, K5_HEADLINE)
    k6_head = headline({s: route["k6"][s] for s in K6_SHAPES}, K6_HEADLINE)
    k7_head = headline({s: route["k7"][s] for s in K7_SHAPES}, K7_HEADLINE)
    bhld_head = headline({k: v for k, v in last.items() if k.startswith("bhld_")}, "bhld_vit")
    v2_head = headline(last["v2"], K4_V2_HEADLINE)
    s2_head = headline(last["s2"], K5_S2_HEADLINE)
    k8_head = headline(last["k8"], K8_HEADLINE)
    kernels = [
        entry("encoder_attention_blf", src, f"{ref}:327", "vit_page",
              "(48,784,768) H=12 bf16", vit),
        entry("encoder_attention_blf_packed", src, f"{ref}:458", "vit_page",
              "(30,1024,576) 4x(36|36|72) bf16", psa),
        entry("encoder_attention", src, f"{ref}:523 (and encoder_attention_padded :619)",
              "mme5_page", "(8,1608,16,80) valid 1601 bf16", masked[torch.bfloat16]),
        entry("int8_matmul", "multimodal_embeddings_tpu_torch/csrc/int8_matmul.cu",
              "multimodal_embeddings_tpu/kernels/quantization.py:219", "mme5_page",
              K2_HEADLINE + " bf16 (max_abs_err over the five text shapes)",
              k2_head, library=False),
        entry("int4_matmul", "multimodal_embeddings_tpu_torch/csrc/int4_matmul.cu",
              "multimodal_embeddings_tpu/kernels/quantization_int4.py:166", "qwen_page",
              K3_HEADLINE + " bf16 (max_abs_err over every checked shape)",
              k3_head, library=False),
        entry("flash_attention", "multimodal_embeddings_tpu_torch/csrc/flash_attention.cu",
              "multimodal_embeddings_tpu/kernels/flash_attention.py:112", "qwen_page",
              "(1,4960,16,80) bf16 non-causal (max_abs_err over it and the causal text "
              "shape)", k4_head),
        entry("encoder_attention_blhd", src,
              f"{ref}:157 (and the TPU probes blhd_static scripts/enc_attn_blhd_probe.py:93, "
              "blhd_grid :137)", "vit_kernel_route_page",
              "(48,784,12,64) strided qkv bf16", route["blhd"]),
        entry("conv3x3_nchw", "multimodal_embeddings_tpu_torch/csrc/conv3x3.cu",
              "multimodal_embeddings_tpu/kernels/conv.py:112", "vit_kernel_route_page",
              K5_HEADLINE + " bf16 (max_abs_err over the four page shapes)", k5_head),
        entry("ln_matmul", "multimodal_embeddings_tpu_torch/csrc/ln_matmul.cu",
              "multimodal_embeddings_tpu/kernels/ln_matmul.py:73", "vit_kernel_route_page",
              K6_HEADLINE + " bf16 (max_abs_err over the three path shapes)", k6_head),
        entry("ln_stats", "multimodal_embeddings_tpu_torch/csrc/ln_stats.cu",
              "multimodal_embeddings_tpu/kernels/ln_stats.py:96", "vit_kernel_route_page",
              K7_HEADLINE + " (max_abs_err over the three path shapes)", k7_head),
        entry("encoder_attention (bhld)", src,
              f"{ref}:523 (bhld_inputs=True; and the probe's inline call "
              "scripts/enc_attn_blhd_probe.py:308)", "vit_bhld_route_page",
              "(48,12,784,64) views of (48,784,768) projections bf16 (max_abs_err over it, "
              "the f32 and the PSA-probe shapes)", bhld_head),
        entry("flash_attention_v2", "multimodal_embeddings_tpu_torch/csrc/flash_attention.cu",
              "multimodal_embeddings_tpu/kernels/flash_attention.py:259", None,
              K4_V2_HEADLINE + " bf16 (max_abs_err over every timed case)", v2_head),
        entry("conv3x3_s2_nchw", "multimodal_embeddings_tpu_torch/csrc/conv3x3.cu",
              "multimodal_embeddings_tpu/kernels/conv.py:239", None,
              K5_S2_HEADLINE + " bf16 (max_abs_err over the three detector positions "
              "and f32)", s2_head),
        entry("stochastic_round_quantize", "multimodal_embeddings_tpu_torch/csrc/sr_quantize.cu",
              "multimodal_embeddings_tpu/kernels/quantization.py:85 (_sr_quantize_2d :117)",
              None, K8_HEADLINE + " (max_abs_err in int8 levels over the three weights)",
              k8_head, library=False),
    ]
    by_name = {k["name"]: k for k in kernels}
    by_name["ln_matmul"]["layer_norm_then_matmul_ms_context"] = k6_head["ln_then_matmul_ms"]
    by_name["int8_matmul"]["cublas_bf16_ms_context"] = k2_head["cublas_ms"]
    by_name["int8_matmul"]["weight_int8pack_mm_ms_context"] = k2_head["library_ms"]
    by_name["int8_matmul"]["shapes"] = {
        s: {key: int8[s][key] for key in ("form", "tile_m", "ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by", "cublas_ms", "library_ms")}
        for s in (*K2_SHAPES, *K2_MME5_SHAPES)}
    by_name["int4_matmul"]["cublas_bf16_ms_context"] = k3_head["cublas_ms"]
    # the M > 4 (wgmma) form at the headline prefill shape, beside the decode headline
    pre = int4[f"prefill gate,up ({K3_PREFILL_M},5120)x(5120,27648)"]
    by_name["int4_matmul"]["prefill_gate_up"] = {
        key: pre[key] for key in ("form", "ms", "plain_ms", "bound_ms", "bound_by", "cublas_ms")}
    by_name["int4_matmul"][f"decode_b{K3_DECODE_ROWS}_shapes"] = {
        s: {key: r[key] for key in ("form", "ms", "plain_ms", "bound_ms", "bound_by", "cublas_ms")}
        for s, r in int4_m8.items()}
    by_name["int4_matmul"]["mme5_shapes"] = {
        s: {key: r[key] for key in ("form", "ms", "plain_ms", "bound_ms", "bound_by", "cublas_ms")}
        for s, r in int4_mme5.items()}
    by_name["flash_attention_v2"]["flash_attention_v1_ms_context"] = v2_head["v1_ms"]
    for name, res in (("encoder_attention_blf", vit), ("encoder_attention", masked[torch.bfloat16])):
        by_name[name]["flash_attention_v1_ms_context"] = res["flash_attention_v1_ms_context"]
    # phase 20: the gradient of K1's two wrapped forms at ViT-B (32,784,768),
    # its backward plain tensor code; the trainer's launches per step
    by_name["encoder_attention_blf"]["gradient"] = {
        k: v for k, v in train["k1_grad"].items() if k.startswith("blf")}
    by_name["encoder_attention (bhld)"]["gradient"] = {
        k: v for k, v in train["k1_grad"].items() if k.startswith("bhld")}
    by_name["encoder_attention_blf"]["trainer_launches_per_step"] = (
        train["trainer"]["launches"]["encoder_attention_blf"] // TRAIN_STEPS)
    by_name["ln_stats"]["shapes"] = {
        s: {key: route["k7"][s][key] for key in (
            "ms", "warm_ms", "median_ms", "library_ms", "library_warm_ms",
            "library_median_ms", "plain_ms", "bound_ms", "bound_by")}
        for s in K7_SHAPES}
    by_name["stochastic_round_quantize"]["torch_rand_ms_context"] = k8_head["rand_ms"]
    by_name["stochastic_round_quantize"]["mismatched_int8"] = sum(
        r["mismatched"] for r in last["k8"].values())
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
