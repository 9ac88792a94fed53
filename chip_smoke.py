"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``var_tpu_torch/ops/cuda/csrc``, holds
each against its plain PyTorch version at the d16 main-path shapes (rows
1-7 of the kernel table in PERF.md; row 5 also at the 1024px eval shape,
an unmasked Lq != Lk shape and a ragged L), then drives the port's nine
paths, each run with the launch counters set to 0 just before it and read
just after:

* sampling: a greedy fp32 decode through the kernels against the reference
  fixture ``tests/fixtures/var_prod.npz`` (the modules loaded by name, then
  built again by ``models.from_pretrained_dict`` from a hub config and a
  bundled state dict), eagerly and through a replay of ``make_sampler``'s
  CUDA graph, then 256px class-conditional CFG
  sampling at d16 (depth 16, C = 1024, V = 4096, the 10-scale pyramid, the
  ch160 VQVAE decoder) with seeded random weights, bf16, cfg 1.5, top_k 900,
  top_p 0.96, 8 requests, through ``make_sampler`` (the first call warms up
  and captures the decode into one CUDA graph, the timed calls replay it);
  then ``graph_main_path``: from the same generator state a replay must
  give an eager ``decode_cfg``'s tokens bit for bit, one decode's launches
  must agree as the capture recorded them, as the wrappers count a replay
  and as ``torch.profiler`` counts one, and eager and replay batches are
  timed in turns (img/s, host ms a batch, capture s, graph pool GB, idle
  share);
* training: one fp32 step at the var_prod.npz geometry whose tokens must
  equal ``tests/fixtures/vae_prod.npz`` and whose loss and gradients must
  equal the same step on the CPU, then d16 teacher-forced training (batch
  32, bf16 compute with fp32 parameters, remat 2, tclip 2, seeded random
  images and labels), one warm-up step and ten timed steps;
* the ImageNet training CLI's loop (``apps/train.py``): the tokenizer from
  a seeded ch160 ``.pth`` named by ``VAR_TPU_VAE_CKPT``, the d16 VAR, the
  CLI's sampler and prefetching loader over 96 train and 32 val synthetic
  256px images (numpy, from the loader's per-sample streams), 2 epochs of 3
  steps at the same settings with eval every epoch and a checkpoint every 2
  steps, exact launch counts; then, at depth 2 and the d16 width under
  deterministic algorithms, a run stopped after its first mid-epoch
  checkpoint and resumed through ``auto_resume`` must end with the
  uninterrupted run's parameters and AdamW state, bit for bit;
* zero-shot sampling: at the var_prod.npz geometry in fp32, the
  ``cache_impl="prealloc"`` greedy decode through ``flash_decode_paired``
  must reproduce ``dec_tokens``, and greedy inpainting, box editing,
  ``kv_window=2``, both smooth-sampling modes and the bayesian classifier
  must give on the card the tokens (and, within rtol 1e-4, the
  log-likelihoods and scores) of the same calls on the CPU; then each mode
  at d16, bf16, with seeded random weights and images tokenised on the card,
  8 requests (the classifier: one image over 10 classes), each through its
  compiled program (``engine/compiled.py``: the inpainting, box-editing,
  ``kv_window=2`` and prealloc samplers, the smooth sampler, the
  classifier's tokenizer and scores): the first call captures, replays
  from the same generator states equal the eager function's outputs bit
  for bit, five replays and five eager runs in turns with their launch
  counts, img/s, capture s and graph pool GB; smooth and the classifier
  also profiled. Then ``zeroshot_cli``: rows 1-3 against their plain
  versions at the batch-1 decode shapes, and each zero-shot CLI's ``main``
  (inpaint keep-through, target layer and box, smooth, classify bayesian
  and gen) at d16, batch 1, over a folder of seeded PNGs (read with
  Pillow, as the CLIs read them): s and launches an image of the CLI (its
  first image captures, the rest replay) beside the eager functions it
  compiles, whose outputs must equal the CLI's;
* the long presets and the ``--attn`` impls: fp32 training steps at the
  512px patch numbers through ``pallas`` and ``hybrid`` on the card must
  equal the same steps on the CPU; then d16 512px training (L 2240, batch
  8, bf16, remat 2) for ``auto`` (row 6), ``pallas`` (row 5) and ``hybrid``
  (row 5's forward, the dense backward), one warm-up and five timed steps
  each, and one 512px (batch 8) and one 1024px (L 9451, batch 2) eval batch
  through ``pick_eval_attn`` (row 5's forward), with exact launch counts;
* tokenizer training: one fp32 step of the ch160 VQVAE with the
  ``vae_prod.npz`` weights and images and ``gn_impl="pallas"`` (row 7 in
  every GroupNorm) must give the fixture's tokens and the CPU's loss and
  gradients, and the ``"dot"`` step the same loss; then the published
  tokenizer (ch 160, ch_mult (1, 1, 2, 2, 4), V 4096, Cvae 32, the 256px
  pyramid; seeded random weights and images, fp32, batch 8, lr 3e-4, tclip
  2) trains one counted warm-up step and five timed steps for ``"dot"`` and
  for ``"pallas"``, and renders one bf16 batch of 8 through the decoder
  with each;
* the compiled training, eval and FID programs (``engine/compiled.py``
  with ``train=True``; every earlier training, eval and scoring phase runs
  through them too): the d16 training step at 256px batch 32 (``auto``,
  row 6) and at 512px batch 8 (``auto``; ``pallas``, row 5), the ch160
  tokenizer step (``gn_impl`` dot and pallas, row 7) from record_hit 98
  across the EMA decay switch at 100, and the eval step at 256px batch 32,
  512px batch 8 and 1024px batch 2 (row 5): replays against the eager
  body from the same state and generator state, bit for bit (parameters,
  moments, count, metrics, EMA hits, eval sums) under deterministic
  algorithms; then peak reserved GB of an eager step beside the compiled
  first call and what its pool holds, a fresh capture and replays beside
  eager steps in turns, with launches a run, capture s, pool GB and the
  idle share of a profiled replay. The ImageNet resume must capture anew
  after its checkpoint load and still end bit-equal, and the CLI's peak
  reserved GB is printed beside the same run with its steps eager;
* multi-GPU (``parallel/``), on the one card: two ranks joined by gloo
  over CUDA tensors (NCCL refuses two ranks on one device) through
  ``apps/dryrun_multigpu.py``, the d16 width (C 1024, 16 heads, V 4096) at
  depth 4, 256px, fp32 with TF32 off: one training step at (dp, mp) =
  (2, 1) and (1, 2), row 6 at 8 heads under mp 2, and greedy CFG decodes
  (chunked and prealloc, rows 1-4 at 8 heads) at both, each against the
  same call in one process on the card at the JAX dry run's tolerances,
  with each rank's launch counts. Gloo through host memory is no
  throughput figure, so none is printed;
* FID (``metrics/fid.py``, ``apps/fid_sample.py``): the vae extractor (the
  ch160 tokenizer, seeded weights) and the pixel extractor on two sets of 8
  seeded 256px images on the card against the CPU (features and the
  Fréchet distance), then ``fid_sample``'s decode loop at d16, bf16, the
  FID recipe, 8 classes x 4, batch 8, ``--rounds 2`` (``make_scan_sampler``:
  both rounds of a chunk replays of one captured decode), packed into an
  ``arr_0`` npz and scored against itself (~0) and a second seed's set
  (> 0) with both extractors, with the sampling img/s beside main_path's
  and the scorer's ms an image; each compiled extractor against its eager
  body, bit for bit, on two full batches and a ragged one, and ms an image
  both ways;
* the quality loop (``apps/quality_loop.py``) at the JAX script's default
  scale over in-memory gratings: the tokenizer's recon must fall below
  0.8x its first value and the held-out val loss must fall; the FID proxy
  is printed beside JAX's recorded CPU run;
* the analysis apps (``apps/analysis.py``): fp32 per-scale scores on the
  card against the CPU at the var_prod.npz geometry, without and with the
  CFG ramp and ``l2_dist`` (rtol 1e-4, predictions equal), then d16 and d20
  (``--depths 16,20``) in fp32 over 8 images x 10 classes: images/s per
  model of ``make_score_fn``'s replays beside its eager body, the same
  scores bit for bit.
  These last phases need neither Pillow nor matplotlib.

Rows 1 and 3 (modulated LayerNorm, top-k/top-p bound) are held against
their plain versions and timed at every stage shape of the d16 CFG decode
(``stage_ms``; ``per_batch_ms`` sums the launches a sampling batch makes:
2 x depth per stage for row 1, one for row 3), row 3 at k 1, 900 and V on
rows with real ties, two launches bit-identical; beside each, the nearest
single library call (not the same function): ``F.layer_norm`` without
affine, ``torch.topk``.

Rows 2 and 4 (decode attention) are held at every stage shape of the
chunked, prealloc and ``kv_window=2`` decodes over cache buffers whose rows
from the cache length on are NaN, row 4 also on the raw fused qkv with its
q norm in the launch, and timed at each stage (``stage_ms``, and
``ms_per_batch`` = depth 16 x their sum).

Row 7 (GroupNorm channel statistics) is also held against its plain
version at every GroupNorm input shape of that tokenizer at batch 8 and at
ragged shapes, in fp32 and bf16, with its VJP. No path before tokenizer
training launches it.

Each phase prints one JSON line; the last line is ``{"ok": true, "device":
{...}}``. Any failure raises and exits non-zero. Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PATCH_NUMS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
DEMO_CLASSES = [980, 980, 437, 437, 22, 22, 562, 562]  # demo_sample.py:64
BATCH = len(DEMO_CLASSES)
C, HEADS, V, DEPTH = 1024, 16, 4096, 16
TOP_K, TOP_P, CFG = 900, 0.96, 1.5
TOL = {  # kernel vs plain, |got - want| <= atol + rtol * |want|
    ("modulated_layernorm", torch.float32): (1e-4, 1e-4),
    ("modulated_layernorm", torch.bfloat16): (3e-2, 2e-2),  # one bf16 ulp of rounding order
    ("flash_decode", torch.float32): (1e-4, 1e-4),
    ("flash_decode_paired", torch.float32): (1e-4, 1e-4),
}
# bf16 flash_decode and flash_decode_paired are held against the plain version
# in fp32 on the same bf16 inputs: |got - want| <= this many bf16 ulps of
# max|want|, stage by stage (the kernel rounds q, the softmax weights and the
# output to bf16: about half an ulp)
FLASH_BF16_ULPS = 3
# paired-train attention (row 6), held against autograd through the
# plain block-causal attention: fp32 within atol + rtol |want|; bf16 against
# the plain version in fp32 on the same bf16 inputs, within this many bf16
# ulps of each tensor's max|want| (out rounds once; the gradients also round
# p and ds to bf16 before their products, as the TPU kernels do)
PTRAIN_F32_TOL = (1e-4, 1e-4)
PTRAIN_BF16_ULPS = {"out": 3, "dq": 4, "dk": 4, "dv": 4}
TRAIN_BATCH = 32
# streaming flash attention (row 5) against its plain version on the same
# inputs: fp32 within atol + rtol |want| (lse too, in both dtypes); bf16
# within this many bf16 ulps of each tensor's max|want|, the plain version
# run in bf16 (it rounds p and ds to bf16 where the kernel does)
FLASH_F32_TOL = (1e-4, 1e-4)
FLASH_TRAIN_BF16_ULPS = 3
LONG_BATCH, EVAL_1024_BATCH = 8, 2
# select: top-k bounds must be equal; with top-p a bound may differ only where
# the fp32 mass sums (taken in another order) straddle p * M, i.e. where the
# float64 mass above the disputed threshold is within this share of M of p * M
SELECT_MASS_TOL = 1e-5
# GroupNorm statistics (row 7) against the plain version on the same inputs:
# |got - want| <= atol + rtol * sum|x| for the sums and atol + rtol * sum x^2
# for the sums of squares (both fp32; sums of signed values can cancel, so
# the scale is the sum of magnitudes, not the sum); the VJP within
# atol + rtol |want|, rtol one bf16 ulp for bf16
GN_TOL = (1e-5, 1e-5)
GN_VJP_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}
VAE_BATCH = 8
# (C, H = W) of every GroupNorm input of the ch160 tokenizer at 256px: 25,
# 11, 9, 9, 9 and one each of the last four of its 67 layers
GN_SHAPES = ((640, 16), (160, 256), (160, 128), (320, 64), (320, 32), (160, 64), (320, 16),
             (640, 32), (320, 128))
GN_RAGGED = ((3, 7, 15, 15), (2, 5, 7, 5), (2, 3, 1, 1))  # odd C, H * W no multiple of 16 bytes


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms_by_name(fn, iters: int, warmup: int = 2) -> dict:
    """Device time per call of ``fn`` by device event name (kernels,
    copies): their self time from ``torch.profiler``, so the host time spent
    issuing back-to-back calls is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a session may come back without device events (it happened on row 3's
    # 2 us launches at k 1): take up to three before giving up
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {ev.key: ev.self_device_time_total / 1e3 / iters for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}
        if by:
            return by
    raise RuntimeError("torch.profiler recorded no device time in three sessions")


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of ``fn``: the summed self time of every device
    event it launches."""
    return sum(device_ms_by_name(fn, iters, warmup).values())


def call_ms(fn, iters: int) -> float:
    """Wall time per call of back-to-back calls between CUDA events: the
    larger of device time and host issue time."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_violation(got, want, atol, rtol):
    """(max |got - want|, whether every element is within atol + rtol|want|)."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return float(diff.max()), ok


def tolerances(name: str) -> dict:
    """{dtype: [atol, rtol]} of one kernel, as printed beside its errors."""
    return {str(dt).replace("torch.", ""): list(TOL[(n, dt)]) for n, dt in TOL if n == name}


def bound(bytes_moved: float, ops: float, op_rate: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / op_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "capability": torch.cuda.get_device_capability(0), "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    print(smi, flush=True)
    return smi


def phase_build():
    from var_tpu_torch.ops.cuda import build

    stale = build.library_path()
    if stale.exists():  # every run builds from the checkout's sources
        stale.unlink()
    path, log, seconds = build.build()
    build.lib()
    ptxas = [ln.strip() for ln in log.splitlines()  # registers, spills, wgmma notes
             if any(w in ln for w in ("registers", "Compiling", "spill", "C75"))]
    emit({"phase": "build", "seconds": round(seconds, 3), "sources": list(build.SOURCES),
          "flags": " ".join(build.NVCC_FLAGS), "ptxas": ptxas})


def _stage_lens(patch_nums=PATCH_NUMS):
    lens = [pn * pn for pn in patch_nums]
    return lens, [sum(lens[:i]) for i in range(len(lens))]


def check_ln(dev, b2: int, lens, c: int, dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """Row 1 against its plain version at (b2, l, c) for each l of ``lens``,
    with strided modulation rows as on the main path (slices of a (b2, 6, c)
    table), within TOL; raises on any violation. Returns {dtype: worst
    error}."""
    from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm, modulated_layernorm_plain

    g = torch.Generator(device=dev).manual_seed(1)
    p6 = torch.randn(b2, 6, c, generator=g, device=dev) * 0.3
    scale, shift = p6[:, 2], p6[:, 4]
    errs = {}
    for dtype in dtypes:
        atol, rtol = TOL[("modulated_layernorm", dtype)]
        worst = 0.0
        for l in lens:
            x = (torch.randn(b2, l, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
            err, ok = max_violation(modulated_layernorm(x, scale, shift),
                                    modulated_layernorm_plain(x, scale, shift), atol, rtol)
            if not ok:
                raise AssertionError(f"modulated_layernorm {dtype} ({b2}, {l}, {c}): "
                                     f"max err {err}")
            worst = max(worst, err)
        errs[str(dtype)] = worst
    return errs


def phase_kernel_ln(dev):
    """Row 1 at every stage shape of the d16 CFG decode, (2B, pn^2, C) with
    strided modulation rows as on the main path: held against the plain
    version in fp32 and bf16, timed in bf16 at each stage; ``per_batch_ms``
    sums 2 x depth launches per stage; ``ms`` is the last stage's."""
    import torch.nn.functional as F

    from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm, modulated_layernorm_plain

    b2 = 2 * BATCH
    lens, _ = _stage_lens()
    errs = check_ln(dev, b2, lens, C)
    g = torch.Generator(device=dev).manual_seed(11)
    p6 = torch.randn(b2, 6, C, generator=g, device=dev) * 0.3
    scale, shift = p6[:, 2], p6[:, 4]  # strided rows, as on the main path
    stage_ms, stage_bound_ms = [], []
    for l in lens:
        x = (torch.randn(b2, l, C, generator=g, device=dev) * 2 + 0.5).bfloat16()
        stage_ms.append(device_ms(lambda: modulated_layernorm(x, scale, shift), 50))
        nbytes = 2 * x.numel() * x.element_size() + 2 * b2 * C * 4
        stage_bound_ms.append(bound(nbytes, 8.0 * x.numel(), FP32_FLOPS)[0])
    wall = call_ms(lambda: modulated_layernorm(x, scale, shift), 50)
    plain_ms = device_ms(lambda: modulated_layernorm_plain(x, scale, shift), 20)
    # the library yardstick (never used by the port): the nearest single call
    library_ms = device_ms(lambda: F.layer_norm(x, (C,), eps=1e-6), 50)
    nbytes = 2 * x.numel() * x.element_size() + 2 * b2 * C * 4
    bound_ms, bound_by = bound(nbytes, 8.0 * x.numel(), FP32_FLOPS)
    per_stage = 2 * DEPTH
    return {"name": "modulated_layernorm", "max_abs_err": errs[str(torch.bfloat16)],
            "max_abs_err_fp32": errs[str(torch.float32)],
            "tol": tolerances("modulated_layernorm"), "ms": stage_ms[-1], "call_ms": wall,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "F.layer_norm(x, (C,)) without affine: the nearest single call, "
                       "not the same function",
            "stage_rows": [b2 * l for l in lens], "stage_ms": stage_ms,
            "stage_bound_ms": stage_bound_ms, "launches_per_stage": per_stage,
            "per_batch_ms": per_stage * sum(stage_ms),
            "per_batch_bound_ms": per_stage * sum(stage_bound_ms),
            "shape": [b2, lens[-1], C], "dtype": "bfloat16"}


def select_logits(g, rows: int, dev, v: int = V) -> torch.Tensor:
    """(rows, v) fp32 logits: by row, in turn, N(0, 9) in fp32, the same
    rounded to bf16 (a bf16 head's output: real ties) and a coarse grid
    (N(0, 4) rounded to halves, through fp16: about 13 distinct values, so
    the k-th value and the top-p threshold fall inside tie groups)."""
    logits = torch.randn(rows, v, generator=g, device=dev) * 3
    logits[1::3] = logits[1::3].bfloat16().float()
    grid = torch.round(torch.randn(rows, v, generator=g, device=dev) * 2) / 2
    logits[2::3] = grid[2::3].half().float()
    return logits


def check_select(dev, stage_rows, v: int, ks, top_p: float) -> dict:
    """Row 3 against its plain version on (rows, v) logits with real ties
    (select_logits) for each of ``stage_rows``: top-k bounds equal at each k
    of ``ks`` (0: k = v); top-p bounds at ``top_p`` within the mass-gap
    rule; two launches on the same logits bit-identical. Raises on any
    violation; returns the worst mass gap, the rows that differ, the rows
    and the checks."""
    from var_tpu_torch.ops.cuda.select import (bound_mass_gap, topk_topp_bound,
                                               topk_topp_bound_plain)

    g = torch.Generator(device=dev).manual_seed(2)
    worst, disputed, rows_total, checks = 0.0, 0, 0, 0
    for rows in stage_rows:
        logits = select_logits(g, rows, dev, v)
        for k in ks:
            tk = topk_topp_bound(logits, k, 0.0)
            if not torch.equal(tk, topk_topp_bound_plain(logits, k, 0.0)):
                raise AssertionError(f"topk_topp_bound top-k only, k={k} ({rows}, {v}): "
                                     "bounds differ")
            got = topk_topp_bound(logits, k, top_p)
            again = topk_topp_bound(logits, k, top_p)
            if not (torch.equal(got, again) and torch.equal(tk, topk_topp_bound(logits, k, 0.0))):
                raise AssertionError(f"topk_topp_bound k={k} ({rows}, {v}): two launches differ")
            want = topk_topp_bound_plain(logits, k, top_p)
            err, n = bound_mass_gap(logits, tk, got, want, top_p)
            if err > SELECT_MASS_TOL:
                raise AssertionError(f"topk_topp_bound k={k} p={top_p} ({rows}, {v}): {n} rows "
                                     f"differ, mass gap {err}")
            worst, disputed = max(worst, err), disputed + n
            rows_total, checks = rows_total + got.numel(), checks + 1
    return {"max_mass_gap": worst, "rows_differ": disputed, "rows": rows_total,
            "checks": checks}


def phase_kernel_select(dev):
    """Row 3 at every stage shape of the d16 CFG decode, (B pn^2, V) rows
    with real ties: top-k bounds equal to the plain version's at k 1, 900
    and V; top-p bounds at p 0.96 within the mass-gap rule; two launches on
    the same logits bit-identical. Timed at each stage at the main path's
    (k 900, p 0.96) and at inpainting's k 1; ``per_batch_ms`` sums one
    launch per stage; ``ms`` is the last stage's."""
    from var_tpu_torch.ops.cuda.select import topk_topp_bound, topk_topp_bound_plain

    lens, _ = _stage_lens()
    checked = check_select(dev, [BATCH * l for l in lens], V, (1, TOP_K, 0), TOP_P)
    g = torch.Generator(device=dev).manual_seed(12)
    stage_ms, stage_bound_ms, stage_k1_ms = [], [], []
    for l in lens:
        # timed on N(0, 9) logits (ties only by chance), as the kernel table has been
        logits = torch.randn(BATCH * l, V, generator=g, device=dev) * 3
        stage_ms.append(device_ms(lambda: topk_topp_bound(logits, TOP_K, TOP_P), 20))
        stage_k1_ms.append(device_ms(lambda: topk_topp_bound(logits, 1, TOP_P), 20))
        # the function reads each logit once and writes one int32 per row; a
        # minimal selection does per logit a key, an exp, a mass add and one
        # histogram count in each of 2 x 4 radix-256 passes
        stage_bound_ms.append(bound(logits.numel() * 4 + logits.shape[0] * 4,
                                    logits.numel() * (3 + 2 * 4), FP32_FLOPS)[0])
    wall = call_ms(lambda: topk_topp_bound(logits, TOP_K, TOP_P), 20)
    plain_ms = device_ms(lambda: topk_topp_bound_plain(logits, TOP_K, TOP_P), 3, warmup=1)
    # the library yardstick (never used by the port): the nearest single call
    library_ms = device_ms(lambda: torch.topk(logits, TOP_K), 20)
    bound_ms, bound_by = bound(logits.numel() * 4 + logits.shape[0] * 4,
                               logits.numel() * (3 + 2 * 4), FP32_FLOPS)
    return {"name": "topk_topp_bound", "max_abs_err": checked["max_mass_gap"],
            "rows_differ": checked["rows_differ"], "rows": checked["rows"],
            "checks": checked["checks"],
            "tol": f"top-k bounds equal; top-p mass gap <= {SELECT_MASS_TOL}; "
                   "two launches equal",
            "ms": stage_ms[-1], "call_ms": wall, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library": f"torch.topk(logits, {TOP_K}): the nearest single call, not the same "
                       "function",
            "stage_rows": [BATCH * l for l in lens], "stage_ms": stage_ms,
            "stage_bound_ms": stage_bound_ms, "stage_k1_ms": stage_k1_ms,
            "launches_per_stage": 1, "per_batch_ms": sum(stage_ms),
            "per_batch_bound_ms": sum(stage_bound_ms), "shape": [BATCH * lens[-1], V],
            "dtype": "float32"}


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return float(torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(abs(x))))


def l2_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """Per-head L2 norm in fp32, cast back: the K cache as attn_apply writes it."""
    b, l, c = t.shape
    tf = t.float().reshape(b, l, heads, c // heads)
    return (tf * torch.rsqrt((tf * tf).sum(-1, keepdim=True) + 1e-24)).reshape(b, l, c).to(t.dtype)


# the decode checks read rows [0, lk) of buffers POISON_ROWS rows longer than
# the longest cache, with every row from lk on set to NaN: a kernel that lets
# one row past lk reach its P V product (0 * NaN) fails
POISON_ROWS = 64


def _poisoned(t: torch.Tensor, lk: int) -> torch.Tensor:
    out = t.clone()
    out[:, lk:] = float("nan")
    return out


def _check_errs(name, dtype, got, want, errs, failures, what):
    """Hold one output of decode kernel ``name`` against its plain version:
    fp32 within TOL, bf16 within FLASH_BF16_ULPS bf16 ulps of max|want|; NaN
    fails too."""
    err = float((got - want).abs().max())
    if dtype == torch.float32:
        atol, rtol = TOL[(name, dtype)]
        ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        tol = f"{atol} + {rtol} |want|"
    else:
        ulp = bf16_ulp(float(want.abs().max()))
        ok, tol = err <= FLASH_BF16_ULPS * ulp, FLASH_BF16_ULPS * ulp
        errs["bfloat16_ulps"] = max(errs.get("bfloat16_ulps", 0.0), err / ulp)
    if not ok:
        failures.append(f"{dtype} {what}: err {err} tol {tol}")
    key = str(dtype).replace("torch.", "")
    errs[key] = max(errs.get(key, 0.0), err)


def chunked_shapes(patch_nums=PATCH_NUMS):
    """(Lq, Lk) of every stage of the chunked decode: Lk = every stage so far."""
    lens, cums = _stage_lens(patch_nums)
    return [(l, c + l) for l, c in zip(lens, cums)]


def check_decode(dev, dtypes=(torch.float32, torch.bfloat16), b2: int = 2 * BATCH, c: int = C,
                 heads: int = HEADS, shapes=None) -> dict:
    """flash_decode (row 2) against its plain version at every (Lq, Lk) of
    ``shapes`` (default: every stage of the d16 chunked decode), b2 rows
    (default 2B = 16), width c (1024), ``heads`` heads (16), q in the fused
    (b2, Lq, 3c) qkv, over rows [0, Lk) of a longer NaN-poisoned buffer: as
    the model feeds it (the q norm with scale_mul 4 in the kernel,
    L2-normalised K, scale 1) and with raw K and the post-dot scale
    0.25 / sqrt(d). fp32 within TOL; bf16 against the plain version in fp32
    on the same bf16 inputs, within FLASH_BF16_ULPS bf16 ulps of max|want|.
    Raises on any violation; returns {dtype: worst error}."""
    from var_tpu_torch.ops.cuda.flash_attention import flash_decode, flash_decode_plain

    shapes = shapes or chunked_shapes()
    g = torch.Generator(device=dev).manual_seed(3)
    d = c // heads
    lmax = max(lk for _, lk in shapes) + POISON_ROWS
    sm = torch.full((heads,), 4.0, device=dev)  # exp(log 4), the init scale_mul
    errs, failures = {}, []
    for dtype in dtypes:
        k_raw = torch.randn(b2, lmax, c, generator=g, device=dev).to(dtype)
        v = torch.randn(b2, lmax, c, generator=g, device=dev).to(dtype)
        cases = (("scale_mul", l2_heads(k_raw, heads), 1.0, sm),
                 ("scale", k_raw, 0.25 / d ** 0.5, None))
        for l, lk in shapes:
            qkv = torch.randn(b2, l, 3 * c, generator=g, device=dev).to(dtype)
            vp = _poisoned(v, lk)
            for case, k, scale, smul in cases:
                got = flash_decode(qkv, _poisoned(k, lk), vp, lk, heads, scale, smul).float()
                want = flash_decode_plain(qkv.float(), k.float(), v.float(), lk, heads, scale,
                                          smul)
                _check_errs("flash_decode", dtype, got, want, errs, failures,
                            f"{case} b2={b2} c={c} h={heads} l={l} lk={lk}")
    if failures:
        raise AssertionError("flash_decode differs from its plain version: " + "; ".join(failures))
    return errs


def _sdpa_decode_ms(qn, k, v):
    """SDPA's device ms on the normalised q and the cache rows, as (B, H, L,
    d) views: the library yardstick, never used by the port."""
    import torch.nn.functional as F

    b2, d = qn.shape[0], C // HEADS
    qh, kh, vh = (t.reshape(b2, t.shape[1], HEADS, d).transpose(1, 2) for t in (qn, k, v))
    return device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0), 20)


def _decode_timings(run, shapes, dev, seed):
    """Device ms of ``run(qkv, k, v, lk)`` at each (Lq, Lk) of ``shapes``, on
    seeded bf16 inputs as the model feeds them (raw fused qkv, L2-normalised
    K); the call ms of back-to-back calls at the first (smallest) shape,
    where the host's issue time exceeds the device's; the inputs of the
    last shape."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b2, lmax = 2 * BATCH, max(lk for _, lk in shapes)
    k = l2_heads(torch.randn(b2, lmax, C, generator=g, device=dev), HEADS).to(torch.bfloat16)
    v = torch.randn(b2, lmax, C, generator=g, device=dev).to(torch.bfloat16)
    stage_ms, first_call_ms = [], None
    for lq, lk in shapes:
        qkv = torch.randn(b2, lq, 3 * C, generator=g, device=dev).to(torch.bfloat16)
        stage_ms.append(device_ms(lambda: run(qkv, k, v, lk), 10))
        if first_call_ms is None:  # host-bound: the host cost of one launch
            first_call_ms = call_ms(lambda: run(qkv, k, v, lk), 50)
    return stage_ms, first_call_ms, (qkv, k, v, lk)


def _decode_row(name, errs, run, plain, shapes, dev, seed) -> dict:
    """A decode kernel's row: its errors, stage ms and ms per batch (depth
    16 x the stage sum), and at the last stage its device and call ms, the
    plain version's, SDPA's and the bound."""
    stage_ms, first_call_ms, (qkv, k, v, lk) = _decode_timings(run, shapes, dev, seed)
    b2, l, d = qkv.shape[0], qkv.shape[1], C // HEADS
    ms = device_ms(lambda: run(qkv, k, v, lk), 20)
    wall = call_ms(lambda: run(qkv, k, v, lk), 20)
    plain_ms = device_ms(lambda: plain(qkv, k, v, lk), 5)
    qf = qkv[..., :C].float().reshape(b2, l, HEADS, d)
    qn = (qf * torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-24) * 4.0).to(torch.bfloat16)
    library_ms = _sdpa_decode_ms(qn.reshape(b2, l, C), k[:, :lk], v[:, :lk])
    nbytes = 2 * (2 * b2 * l * C + 2 * b2 * lk * C)  # q, out, K, V in bf16
    bound_ms, bound_by = bound(nbytes, 4.0 * b2 * HEADS * l * lk * d, BF16_TENSOR_FLOPS)
    return {"name": name, "max_abs_err": errs["bfloat16"],
            "max_err_bf16_ulps": errs["bfloat16_ulps"], "max_abs_err_fp32": errs["float32"],
            "tol": {**tolerances(name),
                    "bfloat16": f"{FLASH_BF16_ULPS} bf16 ulps of max|want| per stage, "
                                "want in fp32 from the same bf16 inputs"},
            "ms": ms, "call_ms": wall, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "sdpa_factor": ms / library_ms,
            "stage_shapes": shapes, "stage_ms": stage_ms, "first_stage_call_ms": first_call_ms,
            "ms_per_batch": DEPTH * sum(stage_ms),
            "shape": [b2, l, lk, HEADS, d], "dtype": "bfloat16"}


def phase_kernel_attention(dev):
    """Row 2 at the chunked stage shapes; timed at each stage, and in full at
    the last (Lq 256, Lk 680), bf16, q norm in the kernel."""
    from var_tpu_torch.ops.cuda.flash_attention import flash_decode, flash_decode_plain

    sm = torch.full((HEADS,), 4.0, device=dev)
    return _decode_row(
        "flash_decode", check_decode(dev),
        lambda qkv, k, v, lk: flash_decode(qkv, k, v, lk, HEADS, 1.0, sm),
        lambda qkv, k, v, lk: flash_decode_plain(qkv, k, v, lk, HEADS, 1.0, sm),
        chunked_shapes(), dev, 4)


def kv_window2_shapes():
    """(Lq, Lk) of every stage of the kv_window=2 decode: Lk = stage 0 and
    the last two stages."""
    lens = _stage_lens()[0]
    return [(l, lens[0] + sum(lens[max(1, t - 1):t + 1])) for t, l in enumerate(lens)]


def decode_paired_shapes():
    """(Lq, Lk) of every stage of the prealloc decode (the chunked shapes)
    and of the kv_window=2 decode."""
    return sorted(set(chunked_shapes() + kv_window2_shapes()))


def check_decode_paired(dev, dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """flash_decode_paired against its plain version at every (Lq, Lk) of
    decode_paired_shapes, 2B = 16, C 1024, 16 heads, over rows [0, Lk) of a
    longer NaN-poisoned buffer: as an l2 model feeds it (the raw fused
    (2B, Lq, 3C) qkv with q_l2_scale_mul 4, the norm in the launch,
    L2-normalised K, scale 1), as a model without the norm feeds it (the
    fused qkv, raw K, the scale 0.125 folded into q), with q normalised
    beforehand and with a (2B, Lq, C) q, raw K and the scale 0.125. fp32
    within TOL; bf16 against the
    plain version in fp32 on the same bf16 inputs, within FLASH_BF16_ULPS
    bf16 ulps of max|want|. Raises on any violation; returns {dtype: worst
    error}."""
    from var_tpu_torch.ops.cuda.flash_attention import (flash_decode_paired,
                                                        flash_decode_paired_plain)

    g = torch.Generator(device=dev).manual_seed(6)
    b2, lmax = 2 * BATCH, sum(_stage_lens()[0]) + POISON_ROWS
    sm = torch.full((HEADS,), 4.0, device=dev)
    errs, failures = {}, []
    for dtype in dtypes:
        k_raw = torch.randn(b2, lmax, C, generator=g, device=dev)
        v = torch.randn(b2, lmax, C, generator=g, device=dev).to(dtype)
        k_l2 = l2_heads(k_raw, HEADS).to(dtype)
        for lq, lk in decode_paired_shapes():
            qkv = torch.randn(b2, lq, 3 * C, generator=g, device=dev).to(dtype)
            q_raw = qkv[..., :C].float()
            cases = (("model", qkv, k_l2, 1.0, sm),
                     ("model_no_norm", qkv, k_raw.to(dtype), 0.125, None),
                     ("prenormed", (l2_heads(q_raw, HEADS) * 4.0).to(dtype), k_l2, 1.0, None),
                     ("scale", q_raw.to(dtype), k_raw.to(dtype), 0.125, None))
            vp = _poisoned(v, lk)
            for case, q, k, scale, smul in cases:
                got = flash_decode_paired(q, _poisoned(k, lk), vp, HEADS, scale, lk=lk,
                                          q_l2_scale_mul=smul).float()
                want = flash_decode_paired_plain(q.float(), k.float(), v.float(), HEADS, scale,
                                                 lk, smul)
                _check_errs("flash_decode_paired", dtype, got, want, errs, failures,
                            f"{case} lq={lq} lk={lk}")
    if failures:
        raise AssertionError("flash_decode_paired differs from its plain version: "
                             + "; ".join(failures))
    return errs


def phase_kernel_decode_paired(dev):
    """Row 4 at the stage shapes, the q norm in its launch, bf16: timed at
    each prealloc and each kv_window=2 stage, and in full at the last
    prealloc stage (Lq 256, Lk 680)."""
    from var_tpu_torch.ops.cuda.flash_attention import (flash_decode_paired,
                                                        flash_decode_paired_plain)

    sm = torch.full((HEADS,), 4.0, device=dev)
    run = lambda qkv, k, v, lk: flash_decode_paired(  # noqa: E731
        qkv, k, v, HEADS, 1.0, lk=lk, q_l2_scale_mul=sm)
    row = _decode_row(
        "flash_decode_paired", check_decode_paired(dev), run,
        lambda qkv, k, v, lk: flash_decode_paired_plain(qkv, k, v, HEADS, 1.0, lk, sm),
        chunked_shapes(), dev, 7)
    kvw_ms, _, _ = _decode_timings(run, kv_window2_shapes(), dev, 8)
    row.update(stage_shapes_kv_window2=kv_window2_shapes(), stage_ms_kv_window2=kvw_ms,
               ms_per_batch_kv_window2=DEPTH * sum(kvw_ms))
    return row


def _scale_ends(patch_nums=PATCH_NUMS):
    lens, cums = _stage_lens(patch_nums)
    return tuple(c + n for c, n in zip(cums, lens))


BWD_NOTE = ("ms is one backward call: the dQ kernel, which also computes delta = sum_d "
            "do * out, then the dK/dV kernel; no other launch")


def bwd_split(bwd, iters: int) -> dict:
    """Device ms of one backward call of rows 5 or 6 by kernel, by name
    from the profiler: the dQ kernel's (delta included) and the dK/dV
    kernel's."""
    by = device_ms_by_name(bwd, iters)
    return {"dq_ms": sum(ms for k, ms in by.items() if "ptrain_dq" in k),
            "dkv_ms": sum(ms for k, ms in by.items() if "ptrain_dkv" in k), "kernels": by}


def ptrain_inputs(dev, dtype, batch: int, seed: int, c: int = C, heads: int = HEADS,
                  patch_nums=PATCH_NUMS):
    """q, k, v, do at the training shapes (default d16's), as the model feeds
    them: per-head L2-normalised q times scale_mul 4 (exp(log 4), the init),
    L2-normalised k."""
    g = torch.Generator(device=dev).manual_seed(seed)
    l = sum(_stage_lens(patch_nums)[0])
    q, k, v, do = (torch.randn(batch, l, c, generator=g, device=dev) for _ in range(4))
    q = l2_heads(q, heads) * 4.0
    return tuple(t.to(dtype) for t in (q, l2_heads(k, heads), v, do))


def check_ptrain(dev, batch: int = TRAIN_BATCH, c: int = C, heads: int = HEADS,
                 patch_nums=PATCH_NUMS, dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """flash_attention_paired_train's forward and backward kernels against
    autograd through ops/attention.py::attention at (batch, L, c) with
    ``heads`` heads over the pyramid ``patch_nums`` (default d16's at
    TRAIN_BATCH), in each of ``dtypes``; raises on any violation. Returns
    {dtype: {tensor: error}} (bf16 errors also in ulps)."""
    from var_tpu_torch.ops.attention import attention
    from var_tpu_torch.ops.cuda.flash_attention import flash_attention_paired_train

    ends = _scale_ends(patch_nums)
    d = c // heads
    errs, failures = {}, []
    for dtype in dtypes:
        q, k, v, do = ptrain_inputs(dev, dtype, batch, 4, c, heads, patch_nums)
        got_in = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention_paired_train(*got_in, heads, 1.0, ends)
        out.backward(do)
        want_in = [t.float().requires_grad_() for t in (q, k, v)]
        b, l, _ = q.shape
        ref = attention(*(t.reshape(b, l, heads, d) for t in want_in), 1.0, ends).reshape(b, l, c)
        ref.backward(do.float())
        got = {"out": out.detach(), "dq": got_in[0].grad, "dk": got_in[1].grad,
               "dv": got_in[2].grad}
        want = {"out": ref.detach(), "dq": want_in[0].grad, "dk": want_in[1].grad,
                "dv": want_in[2].grad}
        row = {}
        for name in got:
            g_, w_ = got[name].float(), want[name]
            err = float((g_ - w_).abs().max())
            if dtype == torch.float32:
                atol, rtol = PTRAIN_F32_TOL
                ok = bool(((g_ - w_).abs() <= atol + rtol * w_.abs()).all())
                row[name] = err
            else:
                ulp = bf16_ulp(float(w_.abs().max()))
                ok = err <= PTRAIN_BF16_ULPS[name] * ulp
                row[name] = err
                row[name + "_ulps"] = err / ulp
            if not ok:  # NaN fails too
                failures.append(f"{dtype} {name}: err {err}")
        errs[str(dtype).replace("torch.", "")] = row
        del got_in, want_in, out, ref, got, want
    if failures:
        raise AssertionError("flash_attention_paired_train differs from its plain version at "
                             f"({batch}, L, {c}), {heads} heads: " + "; ".join(failures)
                             + f" (errors {errs})")
    return errs


def phase_kernel_ptrain(dev):
    """Rows for the forward and backward kernels at the d16 bs32 shapes."""
    import torch.nn.functional as F

    from var_tpu_torch.ops.attention import levels_mask
    from var_tpu_torch.ops.cuda.flash_attention import (paired_train_bwd, paired_train_bwd_plain,
                                                        paired_train_delta, paired_train_fwd,
                                                        paired_train_fwd_plain)

    errs = check_ptrain(dev)
    ends = _scale_ends()
    lens, _ = _stage_lens()
    useful = sum(n * e for n, e in zip(lens, ends))  # visible (query, key) pairs per head
    b, d = TRAIN_BATCH, C // HEADS
    q, k, v, do = ptrain_inputs(dev, torch.bfloat16, b, 5)
    l = q.shape[1]
    out, lse = paired_train_fwd(q, k, v, HEADS, ends)
    fwd = lambda: paired_train_fwd(q, k, v, HEADS, ends)  # noqa: E731
    bwd = lambda: paired_train_bwd(q, k, v, out, lse, do, HEADS, ends)  # noqa: E731
    bwd_plain = lambda: paired_train_bwd_plain(  # noqa: E731
        q, k, v, do, lse, paired_train_delta(out, do, HEADS), HEADS, ends)
    ms_f, ms_b = device_ms(fwd, 20), device_ms(bwd, 20)
    call_f, call_b = call_ms(fwd, 20), call_ms(bwd, 20)
    plain_f = device_ms(lambda: paired_train_fwd_plain(q, k, v, HEADS, ends), 3, warmup=1)
    plain_b = device_ms(bwd_plain, 3, warmup=1)
    # the library yardstick: SDPA with the boolean block-causal mask (never used by the port)
    mask = levels_mask(l, l, ends, dev)
    qh, kh, vh = (t.reshape(b, l, HEADS, d).transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    doh = do.reshape(b, l, HEADS, d).transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)  # noqa: E731
    lib_f = device_ms(sdpa, 20)
    lib_fb = device_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), 20)
    esize, rows = 2, b * l * C
    flops = b * HEADS * d * useful
    bound_f, by_f = bound(4 * rows * esize + b * HEADS * l * 4, 4.0 * flops, BF16_TENSOR_FLOPS)
    # backward: reads q, k, v, out, do and the lse, writes dq, dk, dv (delta
    # is computed inside the launch)
    bound_b, by_b = bound(8 * rows * esize + b * HEADS * l * 4, 10.0 * flops,
                          BF16_TENSOR_FLOPS)
    common = {"tol": {"float32": f"{PTRAIN_F32_TOL[0]} + {PTRAIN_F32_TOL[1]} |want|",
                      "bfloat16": f"bf16 ulps of max|want| {PTRAIN_BF16_ULPS}, want in fp32 "
                                  "from the same bf16 inputs"},
              "errors": errs, "shape": [b, l, C, HEADS], "dtype": "bfloat16",
              "useful_pairs_per_head": useful}
    fwd_row = {"name": "paired_train_fwd", "max_abs_err": errs["bfloat16"]["out"],
               "ms": ms_f, "call_ms": call_f, "plain_ms": plain_f, "bound_ms": bound_f,
               "bound_by": by_f, "library_ms": lib_f, **common}
    bwd_row = {"name": "paired_train_bwd",
               "max_abs_err": max(errs["bfloat16"][n] for n in ("dq", "dk", "dv")),
               "ms": ms_b, "call_ms": call_b, "plain_ms": plain_b, "bound_ms": bound_b,
               "bound_by": by_b, "library_ms": lib_fb - lib_f, "note": BWD_NOTE,
               "split": bwd_split(bwd, 20), **common}
    return [fwd_row, bwd_row]


def _preset_ends(preset: str):
    from var_tpu_torch.config import PATCH_NUM_PRESETS

    return tuple(np.cumsum([p * p for p in PATCH_NUM_PRESETS[preset]]).tolist())


def useful_pairs(lq: int, lk: int, ends) -> int:
    """(query, key) pairs per head the mask leaves visible: sum_s n_s e_s."""
    if ends is None:
        return lq * lk
    begins = (0,) + tuple(ends[:-1])
    return sum((min(e, lq) - b) * min(e, lk) for b, e in zip(begins, ends) if b < lq)


def flash_shapes():
    """(name, B, Lq, Lk, ends, with backward) of the row-5 checks: the d16
    512px training shape, the 1024px eval shape (forward only), an unmasked
    Lq != Lk shape and a ragged L (1015: no multiple of the 64- or 16-row
    tiles) with 14 scales."""
    return [("512px", LONG_BATCH, 2240, 2240, _preset_ends("512"), True),
            ("1024px", EVAL_1024_BATCH, 9451, 9451, _preset_ends("1024"), False),
            ("unmasked", 2 * BATCH, 256, 680, None, True),
            ("ragged", 2, 1015, 1015, tuple(np.cumsum([p * p for p in range(1, 15)]).tolist()),
             True)]


def flash_inputs(dev, dtype, b: int, lq: int, lk: int, masked: bool, seed: int):
    """Pre-scaled q, k, v, do as BLHD (B, L, 16, 64): masked, as the model
    feeds them (per-head L2-normalised q times scale_mul 4, L2-normalised
    k); unmasked, raw q and k with the scale 0.125 folded into q."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, lq, C, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(b, lk, C, generator=g, device=dev) for _ in range(2))
    if masked:
        q, k = l2_heads(q, HEADS) * 4.0, l2_heads(k, HEADS)
    else:
        q = q * 0.125
    return tuple(t.to(dtype).reshape(t.shape[0], t.shape[1], HEADS, C // HEADS)
                 for t in (q, k, v, do))


def _batch_chunks(fn, b: int, lq: int, lk: int, *tensors):
    """``fn`` over batch chunks whose (H, Lq, Lk) fp32 logits stay under
    4 GB (the plain version at 1024px would need ~40 GB at once),
    concatenated along the batch."""
    step = max(1, int(4e9 // (HEADS * lq * lk * 4)))
    parts = [fn(*(t[i:i + step] for t in tensors)) for i in range(0, b, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def check_flash(dev, dtypes=(torch.float32, torch.bfloat16), shapes=None) -> dict:
    """Row 5's forward (out and lse) and backward (dq, dk, dv) kernels
    against their plain versions on the same inputs at every shape of
    flash_shapes: fp32 within FLASH_F32_TOL; bf16 within
    FLASH_TRAIN_BF16_ULPS bf16 ulps of each tensor's max|want| (lse within
    FLASH_F32_TOL). The backward of both is fed the kernel's out and lse.
    Raises on any violation; returns {shape: {dtype: {tensor: error}}}."""
    from var_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd,
                                                        flash_attention_bwd_plain,
                                                        flash_attention_fwd,
                                                        flash_attention_fwd_plain,
                                                        paired_train_delta)

    errs, failures = {}, []
    for si, (name, b, lq, lk, ends, with_bwd) in enumerate(shapes or flash_shapes()):
        errs[name] = {}
        for dtype in dtypes:
            qs, k, v, do = flash_inputs(dev, dtype, b, lq, lk, ends is not None, 20 + si)
            out, lse = flash_attention_fwd(qs, k, v, ends)
            want_out, want_lse = _batch_chunks(
                lambda q_, k_, v_: flash_attention_fwd_plain(q_, k_, v_, ends), b, lq, lk,
                qs, k, v)
            pairs = {"out": (out, want_out), "lse": (lse, want_lse)}
            if with_bwd:
                delta = paired_train_delta(out.reshape(b, lq, C), do.reshape(b, lq, C), HEADS)
                got = flash_attention_bwd(qs, k, v, out, lse, do, ends)
                want = _batch_chunks(
                    lambda q_, k_, v_, do_, l_, d_: flash_attention_bwd_plain(
                        q_, k_, v_, do_, l_, d_, ends), b, lq, lk, qs, k, v, do, lse, delta)
                pairs.update(zip(("dq", "dk", "dv"), zip(got, want)))
            torch.cuda.synchronize()
            row = {}
            for t, (g_, w_) in pairs.items():
                g_, w_ = g_.float(), w_.float()
                err = float((g_ - w_).abs().max())
                if dtype == torch.float32 or t == "lse":
                    atol, rtol = FLASH_F32_TOL
                    ok = bool(((g_ - w_).abs() <= atol + rtol * w_.abs()).all())
                else:
                    ulp = bf16_ulp(float(w_.abs().max()))
                    ok = err <= FLASH_TRAIN_BF16_ULPS * ulp
                    row[t + "_ulps"] = err / ulp
                row[t] = err
                if not ok:  # NaN fails too
                    failures.append(f"{name} {dtype} {t}: err {err}")
            errs[name][str(dtype).replace("torch.", "")] = row
            del qs, k, v, do, out, lse, pairs
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("flash_attention differs from its plain version: "
                             + "; ".join(failures) + f" (errors {errs})")
    return errs


def _sdpa_ms(qs, k, v, do, ends):
    """The library yardstick (never used by the port): SDPA with the boolean
    block-causal mask on the same pre-scaled BLHD inputs, forward and, from
    forward plus backward, backward device ms."""
    import torch.nn.functional as F

    from var_tpu_torch.ops.attention import levels_mask

    mask = levels_mask(qs.shape[1], k.shape[1], ends, qs.device)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (qs, k, v))
    doh = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,  # noqa: E731
                                                  scale=1.0)
    lib_f = device_ms(sdpa, 10)
    lib_fb = device_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), 5)
    return lib_f, lib_fb - lib_f


def _flash_bounds(b: int, lq: int, lk: int, ends):
    """Row 5's bounds in ms: forward reads q, k, v and writes out and the
    lse; backward reads q, k, v, out, do and the lse and writes dq, dk, dv
    (delta is computed inside the launch); operations 4 B H D pairs forward,
    2.5 times that backward (five products of the pairs instead of two)."""
    flops = b * HEADS * (C // HEADS) * useful_pairs(lq, lk, ends)
    rows_q, rows_k, stats = b * lq * C * 2, b * lk * C * 2, b * HEADS * lq * 4
    fwd = bound(2 * rows_q + 2 * rows_k + stats, 4.0 * flops, BF16_TENSOR_FLOPS)
    bwd = bound(4 * rows_q + 4 * rows_k + stats, 10.0 * flops, BF16_TENSOR_FLOPS)
    return fwd, bwd


def phase_kernel_flash(dev):
    """Rows for row 5's forward and backward kernels at the d16 512px
    training shape (B 8, L 2240, bf16), with their times at the 1024px eval
    shape (B 2, L 9451) and row 6's at the 512px shape beside them."""
    from var_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd,
                                                        flash_attention_bwd_plain,
                                                        flash_attention_fwd,
                                                        flash_attention_fwd_plain,
                                                        paired_train_bwd, paired_train_delta,
                                                        paired_train_fwd)

    errs = check_flash(dev)
    times = {}
    for name, b, lq, lk, ends, _ in flash_shapes()[:2]:
        qs, k, v, do = flash_inputs(dev, torch.bfloat16, b, lq, lk, True, 30)
        out, lse = flash_attention_fwd(qs, k, v, ends)
        delta = paired_train_delta(out.reshape(b, lq, C), do.reshape(b, lq, C), HEADS)
        fwd = lambda: flash_attention_fwd(qs, k, v, ends)  # noqa: E731
        bwd = lambda: flash_attention_bwd(qs, k, v, out, lse, do, ends)  # noqa: E731
        plain_f = lambda: _batch_chunks(  # noqa: E731
            lambda q_, k_, v_: flash_attention_fwd_plain(q_, k_, v_, ends), b, lq, lk, qs, k, v)
        plain_b = lambda: _batch_chunks(  # noqa: E731
            lambda q_, k_, v_, do_, l_, d_: flash_attention_bwd_plain(q_, k_, v_, do_, l_, d_,
                                                                      ends),
            b, lq, lk, qs, k, v, do, lse, delta)
        (bf, by_f), (bb, by_b) = _flash_bounds(b, lq, lk, ends)
        lib_f, lib_b = _sdpa_ms(qs, k, v, do, ends)
        t = {"fwd_ms": device_ms(fwd, 10), "bwd_ms": device_ms(bwd, 5),
             "fwd_call_ms": call_ms(fwd, 10), "bwd_call_ms": call_ms(bwd, 5),
             "plain_fwd_ms": device_ms(plain_f, 2, warmup=1),
             "plain_bwd_ms": device_ms(plain_b, 2, warmup=1),
             "fwd_bound_ms": bf, "fwd_bound_by": by_f, "bwd_bound_ms": bb, "bwd_bound_by": by_b,
             "library_fwd_ms": lib_f, "library_bwd_ms": lib_b,
             "useful_pairs_per_head": useful_pairs(lq, lk, ends), "shape": [b, lq, HEADS, 64],
             "bwd_split": bwd_split(bwd, 5)}
        if name == "512px":  # row 6 over the same bytes as merged (B, L, C)
            m = [x.reshape(b, lq, C) for x in (qs, k, v, out, do)]
            o6, lse6 = paired_train_fwd(m[0], m[1], m[2], HEADS, ends)
            bwd6 = lambda: paired_train_bwd(m[0], m[1], m[2], o6, lse6, m[4], HEADS,  # noqa: E731
                                            ends)
            t["row6_fwd_ms"] = device_ms(lambda: paired_train_fwd(m[0], m[1], m[2], HEADS, ends),
                                         10)
            t["row6_bwd_ms"] = device_ms(bwd6, 5)
            t["row6_bwd_split"] = bwd_split(bwd6, 5)
        times[name] = t
        del qs, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    t5 = times["512px"]
    common = {"tol": {"float32": f"{FLASH_F32_TOL[0]} + {FLASH_F32_TOL[1]} |want| (lse too)",
                      "bfloat16": f"{FLASH_TRAIN_BF16_ULPS} bf16 ulps of max|want|, want from "
                                  "the plain version on the same bf16 inputs"},
              "errors": errs, "shape": t5["shape"], "dtype": "bfloat16",
              "useful_pairs_per_head": t5["useful_pairs_per_head"], "at_1024px": times["1024px"],
              "row6_at_512px": {"fwd_ms": t5["row6_fwd_ms"], "bwd_ms": t5["row6_bwd_ms"],
                                "bwd_split": t5["row6_bwd_split"]}}
    bf16 = errs["512px"]["bfloat16"]
    fwd_row = {"name": "flash_attention_fwd", "max_abs_err": bf16["out"], "ms": t5["fwd_ms"],
               "call_ms": t5["fwd_call_ms"], "plain_ms": t5["plain_fwd_ms"],
               "bound_ms": t5["fwd_bound_ms"], "bound_by": t5["fwd_bound_by"],
               "library_ms": t5["library_fwd_ms"], **common}
    bwd_row = {"name": "flash_attention_bwd",
               "max_abs_err": max(bf16[n] for n in ("dq", "dk", "dv")), "ms": t5["bwd_ms"],
               "call_ms": t5["bwd_call_ms"], "plain_ms": t5["plain_bwd_ms"],
               "bound_ms": t5["bwd_bound_ms"], "bound_by": t5["bwd_bound_by"],
               "library_ms": t5["library_bwd_ms"], "note": BWD_NOTE, "split": t5["bwd_split"],
               **common}
    return [fwd_row, bwd_row]


def gn_shapes():
    """(B, C, H, W) of row 7's checks: every GroupNorm input shape of the
    ch160 tokenizer at 256px batch 8, then the ragged shapes."""
    return [(VAE_BATCH, c, h, h) for c, h in GN_SHAPES] + list(GN_RAGGED)


def check_gn_stats(dev, dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """gn_channel_stats against its plain version at every shape of
    gn_shapes, and the VJP of its autograd Function against autograd
    through the plain version at the largest and the ragged shapes, in
    each dtype; tolerances GN_TOL and GN_VJP_TOL. Raises on any violation;
    returns {dtype: {"s", "ss", "dx": worst error}}."""
    from var_tpu_torch.ops.cuda.gn_stats import gn_channel_stats, gn_channel_stats_plain

    g = torch.Generator(device=dev).manual_seed(13)
    atol, rtol = GN_TOL
    shapes = gn_shapes()
    errs, failures = {}, []
    for dtype in dtypes:
        row = {"s": 0.0, "ss": 0.0, "dx": 0.0}
        for shape in shapes:
            x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
            with torch.no_grad():
                got = gn_channel_stats(x)
                want = gn_channel_stats_plain(x)
                xf = x.float()
                scales = (xf.abs().sum((2, 3)), (xf * xf).sum((2, 3)))
            for name, a_, w_, sc in zip(("s", "ss"), got, want, scales):
                diff = (a_ - w_).abs()
                if not bool((diff <= atol + rtol * sc).all()):  # NaN fails too
                    failures.append(f"{dtype} {shape} {name}: max err {float(diff.max())}")
                row[name] = max(row[name], float(diff.max()))
            if shape == shapes[1] or shape in GN_RAGGED:  # the VJP
                gs, gss = (torch.randn(shape[:2], generator=g, device=dev) for _ in range(2))
                xg = x.clone().requires_grad_()
                s_, ss_ = gn_channel_stats(xg)
                (dx,) = torch.autograd.grad((s_ * gs).sum() + (ss_ * gss).sum(), xg)
                xp = x.clone().requires_grad_()
                s_, ss_ = gn_channel_stats_plain(xp)
                (dx_want,) = torch.autograd.grad((s_ * gs).sum() + (ss_ * gss).sum(), xp)
                va, vr = GN_VJP_TOL[dtype]
                diff = (dx.float() - dx_want.float()).abs()
                if dx.dtype != dtype or not bool((diff <= va + vr * dx_want.float().abs()).all()):
                    failures.append(f"{dtype} {shape} dx: max err {float(diff.max())}")
                row["dx"] = max(row["dx"], float(diff.max()))
            del x
        errs[str(dtype).replace("torch.", "")] = row
    if failures:
        raise AssertionError("gn_channel_stats differs from its plain version: "
                             + "; ".join(failures) + f" (errors {errs})")
    return errs


def phase_kernel_gn_stats(dev):
    """Row 7 at every tokenizer shape and the ragged ones; timed at the
    largest, (8, 160, 256, 256) fp32 (11 of the 67 layers)."""
    from var_tpu_torch.ops.cuda.gn_stats import gn_channel_stats, gn_channel_stats_plain

    errs = check_gn_stats(dev)
    g = torch.Generator(device=dev).manual_seed(14)
    shape = gn_shapes()[1]
    x = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
    ms = device_ms(lambda: gn_channel_stats(x), 50)
    wall = call_ms(lambda: gn_channel_stats(x), 50)
    plain_ms = device_ms(lambda: gn_channel_stats_plain(x), 20)
    # the library yardstick (never used by the port): the nearest single call
    library_ms = device_ms(lambda: torch.var_mean(x.float(), dim=(2, 3), correction=0), 20)
    b, c = shape[:2]
    bound_ms, bound_by = bound(x.numel() * 4 + 8 * b * c, 3.0 * x.numel(), FP32_FLOPS)
    return {"name": "gn_channel_stats", "max_abs_err": errs["float32"]["s"],
            "errors": errs, "tol": {"stats": f"{GN_TOL[0]} + {GN_TOL[1]} sum|x| (sum x^2)",
                                    "vjp": {str(k).replace("torch.", ""): list(v)
                                            for k, v in GN_VJP_TOL.items()}},
            "shapes": gn_shapes(), "ms": ms, "call_ms": wall, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "library": "torch.var_mean(x, dim=(2, 3), correction=0)", "shape": list(shape),
            "dtype": "float32"}


def _prod_models(root):
    """fp32 VAR and full VQVAE at the var_prod.npz geometry (d16 width,
    depth 2, 16 heads, 1000 classes, the 256px pyramid) with the weights
    tests/synth_weights.py synthesizes, on the CPU, in eval mode."""
    sys.path.insert(0, root)
    from tests.synth_weights import synth_state_dict
    from var_tpu_torch.config import VAEConfig, VARConfig
    from var_tpu_torch.models import vae as vae_mod
    from var_tpu_torch.models import var as var_mod

    data = np.load(os.path.join(root, "tests", "fixtures", "var_prod.npz"))
    pns = tuple(data["patch_nums"].tolist())
    depth, width, heads, ncls = data["depth_width_heads_ncls"].tolist()
    manifest = lambda key: json.loads(bytes(data[key]).decode())  # noqa: E731
    var = var_mod.VAR(VARConfig(num_classes=ncls, depth=depth, embed_dim=width, num_heads=heads,
                                attn_l2_norm=True, cond_drop_rate=0.0, patch_nums=pns,
                                vocab_size=V, z_channels=32))
    var.load_state_dict({k[4:]: torch.from_numpy(a) for k, a in
                         synth_state_dict(manifest("var_keys_shapes_json")).items()})
    vae = vae_mod.VQVAE(VAEConfig(v_patch_nums=pns))
    vae.load_state_dict({k: torch.from_numpy(a) for k, a in synth_state_dict(
        manifest("vae_keys_shapes_json")).items() if "ema_vocab_hit" not in k})
    return data, var.eval().requires_grad_(False), vae.eval().requires_grad_(False)


def _parity_decode(var, vae, data, dev, captured: bool = False):
    """The greedy fp32 decode of var_prod.npz's labels, TF32 off, counted:
    (tokens equal, tokens, f_hat max abs err, launches). ``captured``: through
    ``make_sampler``'s graph, whose first call warms up and captures; the
    second call, a replay, is the one counted and compared."""
    from var_tpu_torch.device import fp32_exact
    from var_tpu_torch.engine.sampler import decode_tokens_cfg, make_sampler

    labels = torch.as_tensor(data["dec_label"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = _all_kernels()
    with torch.inference_mode(), fp32_exact():
        if captured:
            sampler = make_sampler(var.cfg, vae.cfg, cfg_scale=CFG, top_k=1, top_p=0.0,
                                   dtype=torch.float32, device=dev)
            sampler(var, vae, gen, labels)
            torch.cuda.synchronize()
            _zero_counts(kernels)
            res = sampler(var, vae, gen, labels)
            tokens, f_hat = res.tokens, res.f_hat
        else:
            _zero_counts(kernels)
            tokens, f_hat = decode_tokens_cfg(var, vae, labels, gen, cfg_scale=CFG, top_k=1,
                                              top_p=0.0, dtype=torch.float32)
    torch.cuda.synchronize()
    launches = _counts(kernels)
    got = tokens.cpu().numpy()
    fhat_err = float(np.abs(f_hat.cpu().numpy()
                            - np.transpose(data["dec_fhat"], (0, 2, 3, 1))).max())
    return int((got == data["dec_tokens"]).sum()), int(got.size), fhat_err, launches


def phase_parity(dev, root):
    """Greedy fp32 decode through the kernels at the var_prod.npz geometry
    (d16 width, depth 2, full pyramid, synthesized weights), TF32 off: once
    with the modules loaded by name, once built by ``from_pretrained_dict``
    from a hub config and a bundled state dict (the VQVAE under
    ``vae_local.``, derived buffers included, which it drops); each eagerly
    through ``decode_tokens_cfg`` and through a replay of ``make_sampler``'s
    captured decode."""
    from var_tpu_torch.models import from_pretrained_dict

    data, var, vae = _prod_models(root)
    depth, sn = var.cfg.depth, len(var.cfg.patch_nums)
    want = {**_decode_want(depth, sn), "flash_decode": depth * sn}
    pns = list(var.cfg.patch_nums)
    config = dict(depth=depth, embed_dim=var.cfg.embed_dim, num_heads=var.cfg.num_heads,
                  num_classes=var.cfg.num_classes, attn_l2_norm=True, patch_nums=pns,
                  vae_kwargs=dict(vocab_size=V, z_channels=32, ch=160, v_patch_nums=pns))
    # the same weights as one reference-named dict, with a derived buffer to drop
    bundled = {**var.state_dict(), **{"vae_local." + k: t for k, t in vae.state_dict().items()},
               "vae_local.quantize.ema_vocab_hit_SV": torch.zeros(len(pns), V)}
    var, vae = var.to(dev), vae.to(dev)
    for built in ("load_state_dict", "from_pretrained_dict"):
        if built == "from_pretrained_dict":
            del var, vae
            _, _, vae, var = from_pretrained_dict(config, bundled, device=dev)
        for captured in (False, True):
            equal, total, fhat_err, through = _parity_decode(var, vae, data, dev, captured)
            emit({"phase": "parity", "built_by": built, "captured": captured,
                  "tokens_equal": equal, "tokens": total, "fhat_max_abs_err": fhat_err,
                  "launches": through})
            if through != want:
                raise AssertionError(f"parity decode ({built}, captured {captured}) launches "
                                     f"{through}, want {want}")
            if equal != total or fhat_err > 1e-4:
                raise AssertionError(f"greedy fp32 decode ({built}, captured {captured}) "
                                     f"differs from dec_tokens: {equal}/{total} equal, f_hat "
                                     f"err {fhat_err}")


def phase_main_path(dev):
    """d16 sampling through ``make_sampler`` as a user calls it: the first
    call (counted: the eager warm-up, whose result it returns, then the
    capture) checked for shape and range, then 10 timed calls, each a
    replay of the captured decode (counted: 10 decodes' launches)."""
    from var_tpu_torch.engine.sampler import make_sampler
    from var_tpu_torch.models import build_vae_var

    t0 = time.perf_counter()
    vae_cfg, var_cfg, vae, var = build_vae_var(seed=0, depth=DEPTH, patch_nums=PATCH_NUMS)
    sampler = make_sampler(var_cfg, vae_cfg, cfg_scale=CFG, top_k=TOP_K, top_p=TOP_P,
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kernels = _all_kernels()
    _zero_counts(kernels)
    t0 = time.perf_counter()
    res = sampler(var, vae, torch.Generator(device=dev).manual_seed(0), DEMO_CLASSES)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _counts(kernels)
    sn = len(PATCH_NUMS)
    want = {**_decode_want(DEPTH, sn), "flash_decode": DEPTH * sn}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, want {want}")
    img, tokens = res.image, res.tokens
    reso = 16 * var_cfg.patch_nums[-1]
    if tuple(img.shape) != (BATCH, reso, reso, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad image {tuple(img.shape)}")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("image outside [0, 1]")
    if tuple(tokens.shape) != (BATCH, var_cfg.seq_len) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= V:
        raise AssertionError("tokens out of range")
    times = []
    _zero_counts(kernels)
    for i in range(10):  # the counted run above was the warm-up and the capture
        t0 = time.perf_counter()
        sampler(var, vae, torch.Generator(device=dev).manual_seed(1 + i), DEMO_CLASSES)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    replayed = _counts(kernels)
    if replayed != {k: 10 * v for k, v in want.items()}:
        raise AssertionError(f"main path's 10 replays launched {replayed}, want 10 x {want}")
    median_s = float(np.median(times))
    emit({"phase": "main_path", "depth": DEPTH, "batch": BATCH, "dtype": "bfloat16",
          "cfg": CFG, "top_k": TOP_K, "top_p": TOP_P, "launches": launches,
          "captured": sampler.graphs[(BATCH, False)].graph is not None,
          "image_shape": list(img.shape), "image_min": float(img.min()),
          "image_max": float(img.max()), "distinct_tokens": int(tokens.unique().numel()),
          "setup_s": setup_s, "first_decode_s": first_s, "decode_s": times,
          "decode_s_median": median_s, "img_per_s": BATCH / median_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, BATCH / median_s


def _kernel_of(event: str):
    """The wrapper whose kernel a device event of the profiler is, or None."""
    n = event.lower()
    if "decode_attention" in n:  # row 4 is the kPaired instantiation of row 2's kernels
        return "flash_decode_paired" if "<true" in n else "flash_decode"
    if "modulated_ln" in n:
        return "modulated_layernorm"
    if "topk_topp_bound" in n:
        return "topk_topp_bound"
    return None


def profiled_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``
    (``utils/profiling.py::device_events``): its wall ms (host clock,
    ending in a synchronise), device-busy ms (the device events' self
    time), idle share, device events, the decode kernels' launches by
    wrapper name, and device ms by kind (``apps/profile_train.py``'s
    grouping: convolutions, GEMMs, the attention rows, the rest)."""
    from var_tpu_torch.apps.profile_train import _kind
    from var_tpu_torch.utils.profiling import device_events

    wall_ms, rows = device_events(fn)
    busy_us, events, launches, by_kind = 0.0, 0, {}, {}
    for key, count, us in rows:
        busy_us += us
        events += count
        kind = _kind(key)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        name = _kernel_of(key)
        if name is not None:
            launches[name] = launches.get(name, 0) + count
    busy_ms = busy_us / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "device_events": events, "launches": launches, "busy_ms_by_kind": by_kind}


def phase_graph_main_path(dev):
    """The captured sampler (``make_sampler`` on CUDA: one graph of the
    whole decode and render) at d16, 256px, bf16, cfg 1.5, top_k 900, top_p
    0.96, batch 8. From the same generator state a replay must give an
    eager ``decode_cfg``'s tokens bit for bit and leave the generator where
    the eager decode leaves it; one decode's launches, recorded at the
    capture, counted by the wrappers over a replay and counted by
    ``torch.profiler`` in a replay, must be the decode's. Then eager and
    replay batches in turns, 10 each: img/s (median), host ms a batch (until
    the call returns), the capture's seconds, the graph pool's GB and the
    idle share of one profiled replay beside one eager decode's."""
    from var_tpu_torch.engine.sampler import decode_cfg, make_sampler
    from var_tpu_torch.models import build_vae_var

    kw = dict(cfg_scale=CFG, top_k=TOP_K, top_p=TOP_P, dtype=torch.bfloat16)
    vae_cfg, var_cfg, vae, var = build_vae_var(device=dev, seed=0, depth=DEPTH,
                                               patch_nums=PATCH_NUMS)
    sampler = make_sampler(var_cfg, vae_cfg, device=dev, **kw)
    labels = torch.as_tensor(DEMO_CLASSES, device=dev)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731

    def eager(g):
        with torch.inference_mode():
            return decode_cfg(var, vae, labels, g, **kw)

    eager(gen(0))  # cuBLAS and cuDNN plans of the eager path
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    g_first = gen(1)
    t0 = time.perf_counter()
    first = sampler(var, vae, g_first, DEMO_CLASSES)  # warm-up and capture
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    pool_gb = (torch.cuda.memory_reserved(dev) - reserved0) / 1e9
    entry = sampler.graphs[(BATCH, False)]
    sn = len(PATCH_NUMS)
    want = {**_decode_want(DEPTH, sn), "flash_decode": DEPTH * sn}
    decode_kernels = {k: v for k, v in want.items() if v}
    if entry.launches != want:
        raise AssertionError(f"captured decode launches {entry.launches}, want {want}")
    same = []
    for s in (1, 2, 3):  # seed 1: the first call, whose result is its warm-up's
        g_eager = gen(s)
        e = eager(g_eager)
        if s == 1:
            r, g_replay = first, g_first
        else:
            g_replay = gen(s)
            r = sampler(var, vae, g_replay, DEMO_CLASSES)
        torch.cuda.synchronize()
        same.append({"seed": s, "tokens_equal": bool(torch.equal(r.tokens, e.tokens)),
                     "generator_equal": bool(torch.equal(g_eager.get_state(),
                                                         g_replay.get_state())),
                     "fhat_max_abs_err": float((r.f_hat - e.f_hat).abs().max()),
                     "image_max_abs_err": float((r.image - e.image).abs().max())})
    kernels = _all_kernels()
    _zero_counts(kernels)
    sampler(var, vae, gen(4), DEMO_CLASSES)
    torch.cuda.synchronize()
    counted = _counts(kernels)
    prof_replay = profiled_call(lambda: sampler(var, vae, gen(5), DEMO_CLASSES))
    prof_eager = profiled_call(lambda: eager(gen(5)))
    _zero_counts(kernels)
    times = {"eager": [], "replay": []}
    host = {"eager": [], "replay": []}
    runs = {"eager": lambda g: eager(g),
            "replay": lambda g: sampler(var, vae, g, DEMO_CLASSES)}
    for i in range(10):  # in turns: eager, replay, replay, eager, ...
        for name in (("eager", "replay") if i % 2 == 0 else ("replay", "eager")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name](gen(10 + i))
            host[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    timed = _counts(kernels)
    med = {k: float(np.median(v)) for k, v in times.items()}
    out = {"phase": "graph_main_path", "depth": DEPTH, "batch": BATCH, "dtype": "bfloat16",
           "cfg": CFG, "top_k": TOP_K, "top_p": TOP_P, "same_state": same,
           "launches_captured": {k: entry.launches[k] for k in decode_kernels},
           "launches_replay_counted": {k: counted[k] for k in decode_kernels},
           "launches_replay_profiled": prof_replay["launches"],
           "launches_timed": {k: timed[k] for k in decode_kernels},
           "first_call_s": first_s, "capture_s": entry.capture_s, "graph_pool_gb": pool_gb,
           "eager_img_per_s": BATCH / med["eager"], "replay_img_per_s": BATCH / med["replay"],
           "eager_batch_s": times["eager"], "replay_batch_s": times["replay"],
           "eager_host_ms_median": float(np.median(host["eager"])),
           "replay_host_ms_median": float(np.median(host["replay"])),
           "profiled_replay": {k: v for k, v in prof_replay.items() if k != "launches"},
           "profiled_eager": {k: v for k, v in prof_eager.items() if k != "launches"},
           "eager_launches_profiled": prof_eager["launches"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    for row in same:
        if not (row["tokens_equal"] and row["generator_equal"]):
            raise AssertionError(f"replay differs from the eager decode: {row}")
    if counted != want:
        raise AssertionError(f"one replay counted {counted}, want {want}")
    if prof_replay["launches"] != decode_kernels or prof_eager["launches"] != decode_kernels:
        raise AssertionError(f"profiled launches: replay {prof_replay['launches']}, eager "
                             f"{prof_eager['launches']}, want {decode_kernels}")
    if timed != {k: 20 * v for k, v in want.items()}:
        raise AssertionError(f"timed runs launched {timed}, want 20 x {want}")
    return out


def _all_kernels():
    """Every kernel wrapper with a launch counter, in kernel-table order."""
    from var_tpu_torch.ops.cuda import counted_wrappers

    return counted_wrappers()


def _zero_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0


def _counts(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


def _decode_want(depth: int, sn: int) -> dict:
    """Launches of one CFG decode of ``sn`` scales over ``depth`` blocks with
    the attention kernels at 0: the caller sets the one its cache uses."""
    return {"modulated_layernorm": 2 * depth * sn, "flash_decode": 0, "topk_topp_bound": sn,
            "flash_decode_paired": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "paired_train_fwd": 0, "paired_train_bwd": 0, "gn_channel_stats": 0}


def _train_want(depth: int, impl: str = "paired") -> dict:
    """Launches of one remat-2 training step over ``depth`` blocks: the
    core runs once forward and once recomputed in backward; ``hybrid``
    takes the dense backward."""
    want = dict.fromkeys(_decode_want(depth, 0), 0)
    if impl == "paired":
        want.update(paired_train_fwd=2 * depth, paired_train_bwd=depth)
    elif impl == "pallas":
        want.update(flash_attention_fwd=2 * depth, flash_attention_bwd=depth)
    elif impl == "hybrid":
        want.update(flash_attention_fwd=depth)
    return want


TRAIN_GRAD_RTOL = 1e-4  # per parameter: max|card - cpu| <= this * max|cpu grad|
TRAIN_LOSS_RTOL = 1e-5


def phase_train_parity(dev, root):
    """One fp32 training step at the var_prod.npz geometry (d16 width, depth
    2, full pyramid, batch 2, synthesized weights, no cond-drop or
    drop-path, remat 2): the card's tokens of the vae_prod.npz images must
    equal its idx_*, and the loss and every parameter gradient must equal
    the same step on the CPU (the same module weights moved with .to, the
    card's tokens, the plain path). TF32 off around the tokenizer (in
    img_to_idxBl) and the fp32 head (fp32 matmuls)."""
    from var_tpu_torch.config import TrainArgs
    from var_tpu_torch.engine import trainer as tr

    data, var, vae = _prod_models(root)
    vdata = np.load(os.path.join(root, "tests", "fixtures", "vae_prod.npz"))
    pns, depth = var.cfg.patch_nums, var.cfg.depth
    var, vae = var.to(dev).train().requires_grad_(True), vae.to(dev)
    args = TrainArgs(remat=2)
    img = torch.from_numpy(np.transpose(vdata["img"], (0, 2, 3, 1))).to(dev)
    labels = torch.as_tensor(data["dec_label"], device=dev)
    kernels = _all_kernels()
    _zero_counts(kernels)
    idx_bl = tr.tokenize(vae, img, args)
    equal = sum(int((i.cpu().numpy() == vdata[f"idx_{si}"]).sum()) for si, i in enumerate(idx_bl))
    total = sum(int(vdata[f"idx_{si}"].size) for si in range(len(pns)))
    loss, _ = tr.teacher_loss(var, vae, args, idx_bl, labels, None, dtype=torch.float32)
    loss.backward()
    torch.cuda.synchronize()
    launches = _counts(kernels)
    want_launches = _train_want(depth)
    card = {n: p.grad.detach().cpu() for n, p in var.named_parameters()}
    var.zero_grad(set_to_none=True)
    var_cpu, vae_cpu = var.to("cpu"), vae.to("cpu")
    loss_cpu, _ = tr.teacher_loss(var_cpu, vae_cpu, args, [i.cpu() for i in idx_bl],
                                  labels.cpu(), None, dtype=torch.float32)
    loss_cpu.backward()
    worst, worst_name = 0.0, ""
    for n, p in var_cpu.named_parameters():
        rel = float((card[n] - p.grad).abs().max()) / max(float(p.grad.abs().max()), 1e-30)
        if not rel <= worst:  # NaN counts as worst
            worst, worst_name = rel, n
    loss_rel = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    emit({"phase": "train_parity", "tokens_equal": equal, "tokens": total,
          "loss_card": float(loss), "loss_cpu": float(loss_cpu), "loss_rel_err": loss_rel,
          "grad_rel_err_max": worst, "grad_rel_err_param": worst_name,
          "tol": {"loss_rel": TRAIN_LOSS_RTOL, "grad_rel_of_max": TRAIN_GRAD_RTOL},
          "params": len(card), "launches": launches})
    if equal != total:
        raise AssertionError(f"card tokens differ from vae_prod.npz: {equal}/{total} equal")
    if launches != want_launches:
        raise AssertionError(f"train parity launches {launches}, want {want_launches}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"fp32 step differs from the CPU: loss rel {loss_rel}, "
                             f"grad rel {worst} ({worst_name})")


def phase_train_main_path(dev):
    """d16 teacher-forced training, batch 32, bf16 compute, fp32 params and
    AdamW state, remat 2, tclip 2, fp16=1 skip guard; 1 warm-up step (the
    counted run) and 10 timed steps."""
    from var_tpu_torch.config import TrainArgs
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.models import build_vae_var_train

    t0 = time.perf_counter()
    args = TrainArgs(depth=DEPTH, bs=TRAIN_BATCH, ac=1, ep=200, fp16=1, tclip=2.0, remat=2,
                     seed=0).finalize(world_size=1)
    vae_cfg, var_cfg, vae, var = build_vae_var_train(device=dev, seed=0, depth=DEPTH,
                                                     patch_nums=PATCH_NUMS)
    init_state, step = tr.make_train_step(var_cfg, vae_cfg, args, iters_per_ep=1000,
                                          dtype=torch.bfloat16)
    state = init_state(var)
    g = torch.Generator(device=dev).manual_seed(1)
    reso = PATCH_NUMS[-1] * vae_cfg.downsample
    imgs = torch.rand(1, TRAIN_BATCH, reso, reso, 3, generator=g, device=dev) * 2 - 1
    labels = torch.randint(0, var_cfg.num_classes, (1, TRAIN_BATCH), generator=g, device=dev)
    step_gen = lambda i: torch.Generator(device=dev).manual_seed(i)  # noqa: E731
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels = _all_kernels()
    _zero_counts(kernels)
    t0 = time.perf_counter()
    state, m = step(state, vae, imgs, labels, step_gen(0), 0, 1.0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _counts(kernels)
    want = _train_want(DEPTH)
    if launches != want:
        raise AssertionError(f"training main path launches {launches}, want {want}")
    losses, gnorms, times = [float(m.loss)], [float(m.grad_norm)], []
    for i in range(10):
        t0 = time.perf_counter()
        state, m = step(state, vae, imgs, labels, step_gen(1 + i), 1 + i, 1.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m.loss))
        gnorms.append(float(m.grad_norm))
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"non-finite training step: loss {losses} grad norm {gnorms}")
    median_s = float(np.median(times))
    emit({"phase": "train_main_path", "depth": DEPTH, "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "remat": args.remat, "tclip": args.tclip, "fp16": args.fp16,
          "launches": launches, "steps_taken": state.step, "setup_s": setup_s,
          "first_step_s": first_s, "step_s": times, "step_s_median": median_s,
          "img_per_s": TRAIN_BATCH / median_s, "loss": losses, "grad_norm": gnorms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, median_s


IMAGENET_TRAIN, IMAGENET_VAL = 96, 32  # synthetic images: 3 steps an epoch, 1 eval batch
RESUME_DEPTH = 2  # run B's depth at the d16 width: a d16 checkpoint is ~3.7 GB


class _SynthImages:
    """A dataset for ``data.imagenet.DataLoader`` with no image files:
    ``samples[i]`` is (i, a seeded label), and :func:`_synth_image` makes the
    image from the loader's per-sample stream ``sample_rng(seed, epoch, i)``."""

    def __init__(self, n: int, seed: int):
        labels = np.random.default_rng([seed, n]).integers(0, 1000, n)
        self.samples = [(i, int(lbl)) for i, lbl in enumerate(labels)]

    def __len__(self):
        return len(self.samples)


def _synth_image(item, rng: np.random.Generator) -> np.ndarray:
    reso = 16 * PATCH_NUMS[-1]
    return rng.random((reso, reso, 3), dtype=np.float32) * 2 - 1


class _Killed(RuntimeError):
    pass


def _killed_after(batches, n: int):
    """``batches``' first ``n`` items, then it takes one more and raises: a
    run stopped in the data fetch of the step after its checkpoint."""
    for i, item in enumerate(batches):
        if i == n:
            raise _Killed(f"stopped after {n} batches")
        yield item


def _imagenet_args(out_dir: str, depth: int, val_freq_ep: int = 1):
    from var_tpu_torch.config import TrainArgs

    return TrainArgs(depth=depth, bs=TRAIN_BATCH, ac=1, ep=2, fp16=1, tclip=2.0, remat=2, seed=0,
                     val_freq_ep=val_freq_ep, ckpt_iters=2, attn="auto",
                     pn="_".join(map(str, PATCH_NUMS)),
                     local_out_dir_path=out_dir).finalize(world_size=1)


def _imagenet_run(train_app, args, dev, vae, var, kill_after=None):
    """One call of the CLI's loop on the synthetic datasets, resuming from
    the newest checkpoint in ``args.local_out_dir_path`` as ``main`` does."""
    from var_tpu_torch.config import resolve_attn

    resume_path, start_ep, start_it, best = train_app.resume_point(args)
    train_iter, iters, val_batches = train_app.make_loaders(
        args, _SynthImages(IMAGENET_TRAIN, 0), _SynthImages(IMAGENET_VAL, 1), start_ep,
        start_it, _synth_image, _synth_image)
    if kill_after is not None:
        train_iter = _killed_after(train_iter, kill_after)
    return train_app.train(args, dev, resolve_attn(args.attn, dev), vae, var, train_iter, iters,
                           val_batches, resume_path, start_ep, start_it, best)


def _resume_var(dev, args):
    """A seeded VAR of the d16 width (C 1024, 16 heads) at ``args.depth``."""
    from var_tpu_torch.config import VARConfig
    from var_tpu_torch.models import var as var_mod

    cfg = VARConfig(depth=args.depth, embed_dim=C, num_heads=HEADS, attn_l2_norm=args.anorm,
                    drop_path_rate=0.1 * args.depth / 24, patch_nums=PATCH_NUMS)
    var = var_mod.init_var_params(var_mod.VAR(cfg).to(dev), torch.Generator(dev).manual_seed(3),
                                  init_std=args.ini, init_head=args.hd, init_adaln=args.aln,
                                  init_adaln_gamma=args.alng)
    return var.train().requires_grad_(True)


def phase_imagenet_train_main_path(dev, train_main_step_s: float):
    """The ImageNet training CLI's path on the card (``apps/train.py``):
    the tokenizer from a ``.pth`` named by ``VAR_TPU_VAE_CKPT`` (the ch160
    VQVAE, seeded weights written here), the d16 VAR, the CLI's sampler and
    prefetching loader over 96 train and 32 val synthetic 256px images, and
    its epoch loop: bs 32, fp16=1, remat 2, tclip 2, ``--attn auto``, 2
    epochs of 3 steps, eval every epoch, a checkpoint every 2 steps (run A,
    counted). Then run A' (RESUME_DEPTH, uninterrupted) and run B (the same,
    stopped in the data fetch after its first mid-epoch checkpoint, then
    resumed by a fresh call through ``auto_resume``, whose compiled step
    captures anew after the load), both under ``_Reproducible``
    (deterministic algorithms, as before the steps were compiled): B's
    final parameters and AdamW state must equal A''s bit for bit; the free
    memory and pool of every capture in A' and B are printed. Memory: run
    A's peak reserved GB beside the same run with its steps called eagerly
    (``Compiled.eager``, the steps before they were compiled; no
    checkpoint writes). Everything is written to a temporary directory
    that is removed."""
    import shutil
    import tempfile

    from var_tpu_torch.apps import train as train_app
    from var_tpu_torch.config import VAEConfig, resolve_attn
    from var_tpu_torch.engine import checkpoint as ckpt
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.engine.compiled import Compiled, CompiledEntry
    from var_tpu_torch.models import vae as vae_mod

    tmp = tempfile.mkdtemp(prefix="var_imagenet_")
    env_before = {k: os.environ.get(k) for k in ("VAR_TPU_VAE_CKPT", "CUBLAS_WORKSPACE_CONFIG")}
    try:
        t0 = time.perf_counter()
        vae_path = os.path.join(tmp, "vae_ch160v4096z32.pth")
        vae_src = vae_mod.init_vae_params(vae_mod.VQVAE(VAEConfig(v_patch_nums=PATCH_NUMS)).to(dev),
                                          torch.Generator(dev).manual_seed(0))
        torch.save({k: v.cpu() for k, v in vae_src.state_dict().items()}, vae_path)
        del vae_src
        os.environ["VAR_TPU_VAE_CKPT"] = vae_path
        args = _imagenet_args(os.path.join(tmp, "runA"), DEPTH)
        vae, var = train_app.build_models(args, dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        _fresh_peak(dev)
        kernels = _all_kernels()
        _zero_counts(kernels)
        t0 = time.perf_counter()
        state, times = _imagenet_run(train_app, args, dev, vae, var)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _counts(kernels)
        n_steps = len(times["step_t"])
        n_eval = sum(nb for _, nb in times["eval_s"])
        eval_attn = tr.pick_eval_attn(resolve_attn(args.attn, dev), var.cfg.seq_len)
        want = {k: n_steps * v for k, v in _train_want(DEPTH).items()}
        if eval_attn == "pallas":  # the 256px eval keeps the dense path (L 680)
            want["flash_attention_fwd"] += DEPTH * n_eval
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        memory = {"peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9}
        finite = all(bool(torch.isfinite(p).all()) for p in state.var.parameters())
        with open(args.log_txt_path) as f:
            epoch_lines = f.read().splitlines()[1:]
        ckpt_gb = os.path.getsize(args.last_ckpt_path) / 1e9
        meta = ckpt.load_meta(args.last_ckpt_path)
        steady = times["step_t"][1:]  # the first step is the warm-up
        share = [d / s for d, s in zip(times["data_t"][1:], steady)]
        eval_ms = [1e3 * sec / nb for sec, nb in times["eval_s"]]
        del state, var

        # the same run with its steps called eagerly: its peak reserved GB
        args_e = _imagenet_args(os.path.join(tmp, "runE"), DEPTH)
        os.makedirs(args_e.local_out_dir_path)  # which the first checkpoint write makes
        var_e = _resume_var(dev, args_e)
        _fresh_peak(dev)
        save, static = ckpt.save_checkpoint, Compiled.static
        ckpt.save_checkpoint = lambda *a, **k: None
        Compiled.static = lambda program, *a, generator=None: program.eager(*a,
                                                                           generator=generator)
        try:
            _imagenet_run(train_app, args_e, dev, vae, var_e)
        finally:
            ckpt.save_checkpoint, Compiled.static = save, static
        torch.cuda.synchronize()
        memory["eager_steps_peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
        del var_e
        torch.cuda.empty_cache()

        # resume equality at RESUME_DEPTH, deterministic algorithms
        captures = {"A2": [], "B": [], "B_resumed": []}  # (free GB before, pool GB)

        def capture_logged(run):
            def cap(entry, *a):
                free = torch.cuda.mem_get_info(dev)[0] / 1e9
                capture(entry, *a)
                captures[run].append([free, entry.pool_bytes / 1e9])
            return cap

        capture = CompiledEntry.capture
        try:
            with _Reproducible():
                # eval at the last epoch only: fewer checkpoints to write
                args_a = _imagenet_args(os.path.join(tmp, "runA2"), RESUME_DEPTH, val_freq_ep=2)
                CompiledEntry.capture = capture_logged("A2")
                state_a, _ = _imagenet_run(train_app, args_a, dev, vae, _resume_var(dev, args_a))
                args_b = _imagenet_args(os.path.join(tmp, "runB"), RESUME_DEPTH, val_freq_ep=2)
                CompiledEntry.capture = capture_logged("B")
                try:
                    _imagenet_run(train_app, args_b, dev, vae, _resume_var(dev, args_b),
                                  kill_after=args_b.ckpt_iters * args_b.ac)
                    raise AssertionError("run B was not stopped")
                except _Killed:
                    pass
                stopped_at = ckpt.load_meta(args_b.last_ckpt_path)
                CompiledEntry.capture = capture_logged("B_resumed")
                state_b, times_b = _imagenet_run(train_app, args_b, dev, vae,
                                                 _resume_var(dev, args_b))
                torch.cuda.synchronize()
        finally:
            CompiledEntry.capture = capture
        resumed_captures = len(captures["B_resumed"])
        sa, sb = state_a.var.state_dict(), state_b.var.state_dict()
        diverged = [k for k in sa if not torch.equal(sa[k], sb[k])]
        oa, ob = state_a.opt.opt.state_dict()["state"], state_b.opt.opt.state_dict()["state"]
        diverged += [f"opt.{i}.{k}" for i in oa for k in oa[i]
                     if not torch.equal(oa[i][k], ob[i][k])]
        resume = {"depth": RESUME_DEPTH, "deterministic": True,
                  "stopped_at": [stopped_at.get("epoch"), stopped_at.get("iter")],
                  "resumed_steps": len(times_b["step_t"]), "resumed_captures": resumed_captures,
                  "captures_free_gb_pool_gb": captures, "steps_a": state_a.step,
                  "steps_b": state_b.step, "tensors": len(sa) + sum(len(v) for v in oa.values()),
                  "diverged": diverged[:8]}
        del state_a, state_b
        torch.cuda.empty_cache()
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)

    median_s = float(np.median(steady))
    emit({"phase": "imagenet_train_main_path", "depth": DEPTH, "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "remat": args.remat, "tclip": args.tclip, "fp16": args.fp16,
          "attn": "auto", "eval_attn": eval_attn, "train_images": IMAGENET_TRAIN,
          "val_images": IMAGENET_VAL, "steps": n_steps, "eval_batches": n_eval,
          "launches": launches, "want": want, "setup_s": setup_s, "run_s": run_s,
          "run_s_eager_steps": EAGER_IMAGENET_RUN_S,
          "step_s": times["step_t"], "step_s_median": median_s,
          "img_per_s": TRAIN_BATCH / median_s,
          "train_main_path_step_s_median": train_main_step_s,
          "train_main_path_img_per_s": TRAIN_BATCH / train_main_step_s,
          "data_t_s": times["data_t"], "data_share_median": float(np.median(share)),
          "eval_ms_per_batch": eval_ms, "ckpt_save_s": times["save_s"],
          "ckpt_gb": ckpt_gb, "ckpt_saves": len(times["save_s"]), "peak_mem_gb": peak_gb,
          "memory": memory,
          "epoch_lines": epoch_lines, "final_meta": [meta["epoch"], meta["iter"]],
          "resume": resume})
    if launches != want:
        raise AssertionError(f"imagenet main path launches {launches}, want {want}")
    if not finite or len(epoch_lines) != 2 or meta["epoch"] != 2 or n_steps != 6:
        raise AssertionError(f"imagenet run incomplete: finite {finite}, log.txt "
                             f"{epoch_lines}, meta {meta}, steps {n_steps}")
    if resume["stopped_at"] != [0, 2] or resume["resumed_steps"] != 4 or diverged \
            or resume["resumed_captures"] != 2 \
            or not resume["steps_a"] == resume["steps_b"] == 6:
        raise AssertionError(f"resumed run differs from the uninterrupted one: {resume}")
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        raise AssertionError("the one-process CLI run created a process group")
    return launches


MULTIGPU_DEPTH, MULTIGPU_BATCH = 4, 4  # the d16 width; 2 rows a data rank at dp 2
MULTIGPU_TIMEOUT = 300


def _multigpu_spec() -> dict:
    """``apps/dryrun_multigpu.py``'s spec of the phase: the d16 width at
    MULTIGPU_DEPTH with the ch160 tokenizer, fp32, ``--attn paired``."""
    import dataclasses

    from var_tpu_torch.config import VAEConfig

    vae = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(VAEConfig(v_patch_nums=PATCH_NUMS)).items()}
    return {
        "device": "cuda", "backend": "gloo", "seed": 0, "batch": MULTIGPU_BATCH,
        "attn": "paired", "dtype": "float32", "threads": 4, "vae": vae,
        "var": dict(num_classes=1000, depth=MULTIGPU_DEPTH, embed_dim=C, num_heads=HEADS,
                    patch_nums=list(PATCH_NUMS), vocab_size=V, z_channels=32,
                    attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0),
        "args": dict(depth=MULTIGPU_DEPTH, ep=2, pn="_".join(map(str, PATCH_NUMS))),
        "meshes": [[2, 1], [1, 2]],
        "train": [{"name": "drop", "cond_drop_rate": 0.1, "drop_path_rate": 0.1, "ac": 1}],
        "decode": {"cache_impls": ["chunked", "prealloc"], "cfg_scale": CFG, "top_k": 1},
        "plant": False, "cli": False, "save": False,
    }


def _multigpu_want(case: str) -> dict:
    """Launches of one case on one rank: a remat-0 step runs row 6 once
    forward and once backward a block; a decode of the ten scales runs row
    1 twice a block a scale, its attention row once, row 3 once a scale."""
    want = dict.fromkeys(_decode_want(MULTIGPU_DEPTH, 0), 0)
    want.pop("gn_channel_stats")
    sn = len(PATCH_NUMS)
    if case.startswith("train"):
        want.update(paired_train_fwd=MULTIGPU_DEPTH, paired_train_bwd=MULTIGPU_DEPTH)
    else:
        row = "flash_decode" if case == "decode_chunked" else "flash_decode_paired"
        want.update({"modulated_layernorm": 2 * MULTIGPU_DEPTH * sn, row: MULTIGPU_DEPTH * sn,
                     "topk_topp_bound": sn})
    return want


def phase_multigpu_parity(dev):
    """Two ranks on the one card (``LOCAL_RANK`` 0 both), gloo over CUDA
    tensors: the all-reduce, all-gather and broadcast of ``parallel/`` (no
    reduce-scatter), each rank holding its (2, 1) and (1, 2) steps and
    decodes against the same calls in one process, which it runs first on
    the card (``apps/dryrun_multigpu.py``; this process only launches the
    ranks and reads their reports). Fails on any case off its tolerance,
    any launch count off, or a head count other than 8 under mp 2."""
    import shutil
    import tempfile

    from var_tpu_torch.apps import dryrun_multigpu as dry

    del dev  # the ranks pick the card themselves
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="var_multigpu_")
    try:
        reports, _ = dry.launch(_multigpu_spec(), 2, tmp, timeout=MULTIGPU_TIMEOUT,
                                local_ranks=[0, 0]).wait()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    bad = dry.failures(reports)
    summary = {}
    for rep in sorted(reports, key=lambda r: r["rank"]):
        emit({"phase": "multigpu_launches", "rank": rep["rank"],
              "launches": {f"{m}/{c}": v["launches"] for m, cases in rep["meshes"].items()
                           for c, v in cases.items()}})
        for mesh, cases in rep["meshes"].items():
            for case, v in cases.items():
                if v["launches"] != _multigpu_want(case):
                    bad.append(f"rank {rep['rank']} {mesh} {case}: launches {v['launches']}, "
                               f"want {_multigpu_want(case)}")
                if case.startswith("train") and v["heads_local"] != HEADS // int(mesh[-1]):
                    bad.append(f"rank {rep['rank']} {mesh}: {v['heads_local']} heads a rank")
                summary[f"rank{rep['rank']}/{mesh}/{case}"] = {
                    k: v[k] for k in ("loss_rel_err", "grad_norm_rel_err", "param_max_abs_err",
                                      "grad_rel_err_max", "grad_rel_err_param", "heads_local",
                                      "tokens_differ", "tokens", "f_hat_max_abs_err", "ok")
                    if k in v}
    emit({"phase": "multigpu_parity", "ranks": len(reports), "backend": "gloo",
          "collectives": reports[0]["collectives"],
          "depth": MULTIGPU_DEPTH, "width": C, "heads": HEADS, "vocab": V,
          "batch": MULTIGPU_BATCH, "dtype": "float32", "tf32": False,
          "tol": {"loss_rel": dry.LOSS_RTOL, "param_abs": dry.PARAM_ATOL,
                  "grad_rel_of_max": dry.GRAD_RTOL, "tokens": "equal"},
          "cases": summary, "seconds": seconds})
    if bad:
        raise AssertionError("multigpu parity failed:\n" + "\n".join(bad))


ZEROSHOT_RTOL = 1e-4  # card vs CPU log-likelihoods and classifier scores
KEEP_THROUGH = 6  # the inpaint app's default recipe
EDIT_BOX = (0.25, 0.25, 0.75, 0.75)
SMOOTH_N = 4096
SMOOTH_THRESHOLD = 1.5  # L2, the threshold mode's parity case
CLF_CLASSES = 10


def _zeroshot_runs(var, vae, img, gt, labels):
    """The zero-shot modes of the parity phase, greedy, fp32, on the modules'
    device: {mode: (tokens, [log-likelihoods or scores])}."""
    from var_tpu_torch.apps.classify import VARClassifier
    from var_tpu_torch.apps.masks import get_edit_mask, keep_scales_mask
    from var_tpu_torch.device import fp32_exact
    from var_tpu_torch.engine.sampler import decode_tokens_cfg, smooth_sampling

    dev, pns = gt.device, var.cfg.patch_nums
    b = labels.shape[0]
    keep = torch.from_numpy(keep_scales_mask(pns, KEEP_THROUGH))[None].expand(b, -1).to(dev)
    edit = torch.from_numpy(get_edit_mask(pns, *EDIT_BOX)).to(dev)
    common = dict(top_k=1, top_p=0.0, dtype=torch.float32)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    out = {}
    with torch.inference_mode(), fp32_exact():
        out["inpaint"] = (decode_tokens_cfg(var, vae, labels, gen(), cfg_scale=4.0, gt_tokens=gt,
                                            keep_mask=keep, **common)[0], [])
        out["edit"] = (decode_tokens_cfg(var, vae, labels, gen(), cfg_scale=4.0, gt_tokens=gt,
                                         edit_mask=edit, **common)[0], [])
        out["kv_window"] = (decode_tokens_cfg(var, vae, labels, gen(), cfg_scale=CFG,
                                              kv_window=2, **common)[0], [])
        for name, thr in (("smooth_count", None), ("smooth_threshold", SMOOTH_THRESHOLD)):
            r = smooth_sampling(var, vae, gt[:1], SMOOTH_N, labels[:1], cfg_scale=CFG,
                                neighbor_threshold=thr, dtype=torch.float32)
            out[name] = (r.tokens, [float(r.log_likelihood), float(r.distance_log_likelihood)])
    scores = VARClassifier(var, vae, mode="bayesian").class_likelihoods(
        img[:1], list(range(CLF_CLASSES)), batch_size=CLF_CLASSES)
    out["classify_bayesian"] = (torch.as_tensor(int(np.argmax(scores))), list(map(float, scores)))
    return {k: (t.cpu(), v) for k, (t, v) in out.items()}


def phase_zeroshot_parity(dev, root):
    """fp32, TF32 off, at the var_prod.npz geometry: the prealloc greedy
    decode through flash_decode_paired must reproduce dec_tokens; then every
    zero-shot mode on the card must give the CPU's tokens (the same module
    weights, the card's ground-truth tokens of the vae_prod.npz images)
    and, within ZEROSHOT_RTOL, its log-likelihoods and classifier scores,
    with the same argmax."""
    import copy

    from var_tpu_torch.device import fp32_exact
    from var_tpu_torch.engine.sampler import decode_tokens_cfg
    from var_tpu_torch.models.vae import img_to_idxBl

    data, var, vae = _prod_models(root)
    var_c, vae_c = copy.deepcopy(var).to(dev), copy.deepcopy(vae).to(dev)
    depth, sn = var.cfg.depth, len(var.cfg.patch_nums)
    kernels = _all_kernels()
    _zero_counts(kernels)
    with torch.inference_mode(), fp32_exact():
        tokens, _ = decode_tokens_cfg(
            var_c, vae_c, torch.as_tensor(data["dec_label"], device=dev),
            torch.Generator(device=dev).manual_seed(0), cfg_scale=CFG, top_k=1, top_p=0.0,
            dtype=torch.float32, cache_impl="prealloc")
    torch.cuda.synchronize()
    launches = _counts(kernels)
    want = {**_decode_want(depth, sn), "flash_decode_paired": depth * sn}
    equal = int((tokens.cpu().numpy() == data["dec_tokens"]).sum())
    if launches != want:
        raise AssertionError(f"prealloc parity launches {launches}, want {want}")
    if equal != tokens.numel():
        raise AssertionError(f"prealloc greedy decode differs from dec_tokens: "
                             f"{equal}/{tokens.numel()} equal")

    vdata = np.load(os.path.join(root, "tests", "fixtures", "vae_prod.npz"))
    img = torch.from_numpy(np.transpose(vdata["img"], (0, 2, 3, 1))).contiguous()
    labels = torch.as_tensor(data["dec_label"])
    with torch.inference_mode():
        gt = torch.cat(img_to_idxBl(vae_c, img.to(dev)), dim=1)
    _zero_counts(kernels)
    t0 = time.perf_counter()
    card = _zeroshot_runs(var_c, vae_c, img.to(dev), gt, labels.to(dev))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    mode_launches = _counts(kernels)
    t0 = time.perf_counter()
    cpu = _zeroshot_runs(var, vae, img, gt.cpu(), labels)
    cpu_s = time.perf_counter() - t0
    rows, failures = {}, []
    for mode, (tok, vals) in card.items():
        tok_cpu, vals_cpu = cpu[mode]
        eq = int((tok == tok_cpu).sum())
        rel = max([abs(a - b) / max(abs(b), 1e-30) for a, b in zip(vals, vals_cpu)], default=0.0)
        rows[mode] = {"tokens_equal": eq, "tokens": int(tok.numel()), "values_card": vals,
                      "values_cpu": vals_cpu, "max_rel_err": rel}
        if eq != tok.numel() or not rel <= ZEROSHOT_RTOL:  # NaN fails too
            failures.append(f"{mode}: {eq}/{tok.numel()} tokens equal, rel err {rel}")
    emit({"phase": "zeroshot_parity", "prealloc_tokens_equal": equal,
          "prealloc_tokens": int(tokens.numel()), "prealloc_launches": launches,
          "modes": rows, "modes_launches": mode_launches, "card_s": card_s, "cpu_s": cpu_s,
          "tol": {"tokens": "equal", "log_likelihoods_and_scores_rel": ZEROSHOT_RTOL}})
    if failures:
        raise AssertionError("zero-shot modes differ between the card and the CPU: "
                             + "; ".join(failures))
    if mode_launches["flash_decode_paired"] == 0 or mode_launches["paired_train_fwd"] == 0:
        raise AssertionError(f"zero-shot parity did not run on the kernels: {mode_launches}")


def _same(a, b) -> bool:
    """Bit-equal outputs: tensors, named tuples of tensors, numpy arrays."""
    if isinstance(a, np.ndarray):
        return bool(np.array_equal(a, b))
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return all(_same(x, y) for x, y in zip(a, b))


def _delta(kernels, before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts(kernels).items()}


def _entries(*programs) -> list:
    """The entries of compiled programs (``Compiled`` or a ``make_sampler``
    sampler)."""
    return [e for p in programs for e in p.graphs.values()]


def _capture_row(entries) -> dict:
    launches: dict = {}
    for e in entries:
        for k, v in e.launches.items():
            if v:
                launches[k] = launches.get(k, 0) + v
    return {"captured": bool(entries) and all(e.graph is not None for e in entries),
            "entries": len(entries), "capture_s": sum(e.capture_s for e in entries),
            "pool_gb": sum(e.pool_bytes for e in entries) / 1e9,
            "launches_captured": launches}


def _eager_vs_replay(kernels, replay, eager, n: int, seed: int) -> dict:
    """n replays and n eager runs in turns (eager first on even turns),
    each synchronised: their seconds and launches."""
    times = {"replay": [], "eager": []}
    launches = {k: dict.fromkeys(_counts(kernels), 0) for k in times}
    runs = {"replay": replay, "eager": eager}
    for i in range(n):
        for name in (("eager", "replay") if i % 2 == 0 else ("replay", "eager")):
            torch.cuda.synchronize()
            before = _counts(kernels)
            t0 = time.perf_counter()
            runs[name](seed + i)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            for k, v in _delta(kernels, before).items():
                launches[name][k] += v
    return {"times": times, "launches": launches}


def phase_zeroshot_main_path(dev):
    """Each zero-shot mode at d16, 256px, bf16, seeded random weights and
    images tokenised on the card, 8 requests (the classifier: one image
    over 10 classes in one batch), each through its compiled program (the
    inpainting, box-editing, ``kv_window=2`` and prealloc samplers, the
    smooth sampler, the classifier's tokenizer and scores): counters set to
    0 just before the mode's first call (its eager warm-up and capture) and
    read just after it; then from the same generator states (seeds 1-3) a
    replay must give the eager function's outputs bit for bit (tokens,
    f_hat and image; log-likelihood sums; scores); then 5 eager runs and 5
    replays in turns, each counted (5 x the first call's launches each):
    img/s of both, capture s and graph pool GB; smooth and the classifier
    also under ``torch.profiler``, one replay and one eager run."""
    from var_tpu_torch.apps.classify import VARClassifier
    from var_tpu_torch.apps.masks import get_edit_mask, keep_scales_mask
    from var_tpu_torch.engine.sampler import (decode_cfg, make_sampler, make_smooth_sampler,
                                              smooth_sampling)
    from var_tpu_torch.models import build_vae_var
    from var_tpu_torch.models.quantizer import idxBl_to_var_input
    from var_tpu_torch.models.vae import img_to_idxBl

    t0 = time.perf_counter()
    dtype = torch.bfloat16
    vae_cfg, var_cfg, vae, var = build_vae_var(device=dev, seed=0, depth=DEPTH,
                                               patch_nums=PATCH_NUMS, dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(8)
    reso = PATCH_NUMS[-1] * vae_cfg.downsample
    img = torch.rand(BATCH, reso, reso, 3, generator=g, device=dev) * 2 - 1
    labels = torch.as_tensor(DEMO_CLASSES, device=dev)
    with torch.inference_mode():
        gt = torch.cat(img_to_idxBl(vae, img), dim=1)
    keep = torch.from_numpy(keep_scales_mask(PATCH_NUMS, KEEP_THROUGH))[None].expand(BATCH, -1)
    keep = keep.to(dev)
    edit = torch.from_numpy(get_edit_mask(PATCH_NUMS, *EDIT_BOX)).to(dev)
    sample_kw = dict(cfg_scale=CFG, top_k=TOP_K, top_p=TOP_P, dtype=dtype)
    greedy_kw = dict(cfg_scale=4.0, top_k=1, dtype=dtype)
    inpaint = make_sampler(var_cfg, vae_cfg, device=dev, inpainting=True, **greedy_kw)
    editor = make_sampler(var_cfg, vae_cfg, device=dev, editing=True, **greedy_kw)
    kv_window = make_sampler(var_cfg, vae_cfg, kv_window=2, device=dev, **sample_kw)
    prealloc = make_sampler(var_cfg, vae_cfg, cache_impl="prealloc", device=dev, **sample_kw)
    smoother = make_smooth_sampler(SMOOTH_N, cfg_scale=CFG, dtype=dtype, device=dev)
    clf = VARClassifier(var, vae, mode="bayesian", dtype=dtype)
    classes = list(range(CLF_CLASSES))
    gen = lambda i: torch.Generator(device=dev).manual_seed(i)  # noqa: E731

    def eager_decode(i, **kw):
        with torch.inference_mode():
            return decode_cfg(var, vae, labels, gen(i), **kw)

    def eager_smooth(i):
        with torch.inference_mode():
            return smooth_sampling(var, vae, gt, SMOOTH_N, labels, cfg_scale=CFG, dtype=dtype)

    def eager_classify(i):
        with torch.inference_mode():
            idx = img_to_idxBl(vae, img[:1])
            x_in = idxBl_to_var_input(vae.quantize, vae_cfg, idx)
            ll, _ = clf._score_fn(var, torch.tensor(classes, device=dev),
                                  x_in.expand(CLF_CLASSES, -1, -1),
                                  torch.cat(idx, dim=1).expand(CLF_CLASSES, -1))
            return ll.float().cpu().numpy()

    modes = {  # name: (replay(i), eager(i), images per run, its programs)
        "inpaint": (lambda i: inpaint(var, vae, gen(i), labels, gt, keep),
                    lambda i: eager_decode(i, gt_tokens=gt, keep_mask=keep, **greedy_kw),
                    BATCH, (inpaint,)),
        "edit": (lambda i: editor(var, vae, gen(i), labels, gt, edit),
                 lambda i: eager_decode(i, gt_tokens=gt, edit_mask=edit, **greedy_kw),
                 BATCH, (editor,)),
        "kv_window": (lambda i: kv_window(var, vae, gen(i), labels),
                      lambda i: eager_decode(i, kv_window=2, **sample_kw), BATCH, (kv_window,)),
        "prealloc": (lambda i: prealloc(var, vae, gen(i), labels),
                     lambda i: eager_decode(i, cache_impl="prealloc", **sample_kw), BATCH,
                     (prealloc,)),
        "smooth": (lambda i: smoother(var, vae, gt, labels), eager_smooth, BATCH, (smoother,)),
        "classify": (lambda i: clf.class_likelihoods(img[:1], classes, batch_size=CLF_CLASSES),
                     eager_classify, 1, (clf._tokenize, clf._score)),
    }
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kernels = _all_kernels()
    sn = len(PATCH_NUMS)
    chunked = {**_decode_want(DEPTH, sn), "flash_decode": DEPTH * sn}
    paired = {**_decode_want(DEPTH, sn), "flash_decode_paired": DEPTH * sn}
    wants = {"inpaint": chunked, "edit": chunked, "kv_window": paired, "prealloc": paired,
             "smooth": {**chunked, "topk_topp_bound": 0},  # no top-k/top-p filter
             "classify": {**_train_want(DEPTH), "paired_train_fwd": DEPTH,
                          "paired_train_bwd": 0}}
    total = dict.fromkeys(_counts(kernels), 0)
    failures = []
    for name, (replay, eager, n_img, programs) in modes.items():
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        t0 = time.perf_counter()
        res = replay(0)  # the first call: eager warm-up, then the capture
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = _counts(kernels)
        want = wants[name]
        if launches != want:
            failures.append(f"{name}: first call launched {launches}, want {want}")
        total = {k: total[k] + launches[k] for k in total}
        check = _check_zeroshot_output(name, res, gt, keep, var_cfg)
        cap = _capture_row(_entries(*programs))
        if not cap["captured"] or cap["launches_captured"] != {k: v for k, v in want.items()
                                                              if v}:
            failures.append(f"{name}: capture {cap}")
        same = []
        for s in (1, 2, 3):
            r, e = replay(s), eager(s)
            torch.cuda.synchronize()
            same.append(_same(r, e))
        if not all(same):
            failures.append(f"{name}: a replay differs from the eager run: {same}")
        timed = _eager_vs_replay(kernels, replay, eager, 5, 10)
        for kind, got in timed["launches"].items():
            if got != {k: 5 * v for k, v in want.items()}:
                failures.append(f"{name}: 5 {kind} runs launched {got}, want 5 x {want}")
        med = {k: float(np.median(v)) for k, v in timed["times"].items()}
        row = {"phase": "zeroshot_main_path", "mode": name, "depth": DEPTH, "batch": n_img,
               "dtype": "bfloat16", "launches": launches, **cap, **check,
               "replay_equals_eager": same, "setup_s": setup_s, "first_s": first_s,
               "replay_batch_s": timed["times"]["replay"],
               "eager_batch_s": timed["times"]["eager"],
               "replay_img_per_s": n_img / med["replay"], "eager_img_per_s": n_img / med["eager"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name in ("smooth", "classify"):
            for kind, fn in (("replay", replay), ("eager", eager)):
                prof = profiled_call(lambda: fn(20))
                row[f"profiled_{kind}"] = {k: v for k, v in prof.items() if k != "launches"}
        emit(row)
    if failures:
        raise AssertionError("zero-shot main path: " + "; ".join(failures))
    return total


def _check_zeroshot_output(name, res, gt, keep, var_cfg) -> dict:
    """Finite outputs of the expected shapes; kept positions hold the
    ground truth; token ids in range."""
    if name == "classify":
        scores = np.asarray(res)
        if scores.shape != (CLF_CLASSES,) or not np.isfinite(scores).all():
            raise AssertionError(f"classify: bad scores {scores}")
        return {"scores": scores.tolist(), "pred": int(np.argmax(scores))}
    img, tokens = res.image, res.tokens
    reso = 16 * var_cfg.patch_nums[-1]
    if tuple(img.shape) != (BATCH, reso, reso, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{name}: bad image {tuple(img.shape)}")
    if tuple(tokens.shape) != (BATCH, var_cfg.seq_len) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= V:
        raise AssertionError(f"{name}: tokens out of range")
    if name == "inpaint" and not bool((tokens[keep] == gt[keep]).all()):
        raise AssertionError("inpaint: kept positions do not hold the ground truth")
    out = {"image_min": float(img.min()), "image_max": float(img.max()),
           "distinct_tokens": int(tokens.unique().numel()),
           "tokens_equal_gt": float((tokens == gt).float().mean())}
    if name == "smooth":
        out["log_likelihood"] = float(res.log_likelihood)
    return out



CLI_IMAGES = 4  # the synthetic folder: 2 classes x 2 PNGs of 256 x 256
CLI_MODES = {  # name: (app, its arguments, --limit)
    "inpaint_keep": ("inpaint", [], CLI_IMAGES),
    "inpaint_target": ("inpaint", ["--target_layer", "5", "--patches", "2,3;1,1"], CLI_IMAGES),
    "inpaint_box": ("inpaint", ["--box", ",".join(map(str, EDIT_BOX))], CLI_IMAGES),
    "smooth": ("smooth", [], CLI_IMAGES),
    "classify_bayesian": ("classify", ["--mode", "bayesian"], CLI_IMAGES),
    "classify_gen": ("classify", ["--mode", "gen"], 2),
}


class _LineClock:
    """A stdout that timestamps each line holding an image's report."""

    def __init__(self, out):
        self.out, self.stamps = out, []

    def write(self, text):
        if "] label=" in text:
            self.stamps.append(time.perf_counter())
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _check_batch1_kernels(dev) -> dict:
    """Rows 1, 2 and 3 against their plain versions at the shapes of the
    CLIs' batch-1 decodes: row 1 at (2, pn^2, C) per stage, row 2 at every
    chunked stage over 2 rows, row 3 at (pn^2, V) at k 1 (the CLIs'
    greedy decodes), TOP_K and V."""
    lens, _ = _stage_lens()
    return {"modulated_layernorm": check_ln(dev, 2, lens, C),
            "flash_decode": check_decode(dev, b2=2),
            "topk_topp_bound": check_select(dev, lens, V, (1, TOP_K, 0), TOP_P)}


def phase_zeroshot_cli(dev):
    """Each zero-shot CLI's ``main(argv)`` at d16 (seeded random weights, no
    checkpoints), batch 1, over a synthetic folder of seeded 256px PNGs in
    a temporary directory: inpaint (keep-through, target layer, box),
    smooth (n 4096) and classify (bayesian over 10 classes, gen over 10
    classes; fp32, as its CLI builds the models). First rows 1-3 against
    their plain versions at the batch-1 shapes. Counters are set to 0 just
    before each ``main`` and read just after it: launches an image must be
    one image's (the first image warms up and captures, the others
    replay). s an image is the median gap between successive images'
    reports (replays; the first image's is ``first_image_s``). Beside it,
    the eager functions the CLI compiles, on the same models and images at
    batch 1: s and launches an image, and their outputs (the PNGs, the
    predictions) equal to the CLI's. Pillow reads the PNGs, as in the
    CLIs."""
    import contextlib
    import importlib
    import shutil
    import tempfile

    from var_tpu_torch.apps.classify import VARClassifier
    from var_tpu_torch.apps.masks import generate_inpainting_mask, get_edit_mask, keep_scales_mask
    from var_tpu_torch.apps.sample import save_grid
    from var_tpu_torch.data import imagenet
    from var_tpu_torch.engine.sampler import decode_cfg, smooth_sampling
    from var_tpu_torch.models import build_vae_var
    from var_tpu_torch.models.quantizer import idxBl_to_var_input
    from var_tpu_torch.models.vae import img_to_fhat, img_to_idxBl

    t_phase = time.perf_counter()
    checks = _check_batch1_kernels(dev)
    root = tempfile.mkdtemp(prefix="var_cli_")
    kernels = _all_kernels()
    sn = len(PATCH_NUMS)
    decode = {**_decode_want(DEPTH, sn), "flash_decode": DEPTH * sn}
    wants = {"inpaint": decode, "smooth": {**decode, "topk_topp_bound": 0},
             "classify_bayesian": {**dict.fromkeys(decode, 0), "paired_train_fwd": DEPTH},
             "classify_gen": {k: CLF_CLASSES * v for k, v in decode.items()}}
    rows, failures = {}, []
    try:
        data = os.path.join(root, "data")
        rng = np.random.default_rng(14)
        reso = 16 * PATCH_NUMS[-1]
        for i in range(CLI_IMAGES):
            os.makedirs(os.path.join(data, f"n0{i // 2}"), exist_ok=True)
            save_grid(rng.random((1, reso, reso, 3)), os.path.join(data, f"n0{i // 2}",
                                                                    f"{i}.png"), per_row=1)
        common = ["--device", dev.type, "--depth", str(DEPTH), "--pn",
                  "_".join(map(str, PATCH_NUMS)), "--data_path", data,
                  "--vae_ckpt", os.path.join(root, "none.pth")]
        tf = imagenet.make_transform(reso, train=False)
        samples = imagenet.FolderDataset(data).samples
        models = {}
        for name, (app, extra, limit) in CLI_MODES.items():
            out_dir = os.path.join(root, name)
            argv = common + ["--out_dir", out_dir, "--limit", str(limit)] + extra
            if app == "classify":
                argv += ["--num_classes", str(CLF_CLASSES), "--batch_size", str(CLF_CLASSES)]
            if app == "smooth":
                argv += ["--n", str(SMOOTH_N)]
            mod = importlib.import_module(f"var_tpu_torch.apps.{app}")
            torch.cuda.synchronize()
            _zero_counts(kernels)
            clock = _LineClock(sys.stdout)
            t_main = time.perf_counter()
            if app == "classify":  # it reports once a run: time each image's classify call
                real = VARClassifier.classify

                def timed(self, *a, **k):
                    r = real(self, *a, **k)
                    clock.stamps.append(time.perf_counter())
                    return r

                VARClassifier.classify = timed
            try:
                with contextlib.redirect_stdout(clock):
                    mod.main(argv)
            finally:
                if app == "classify":
                    VARClassifier.classify = real
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t_main
            launches = _counts(kernels)
            want = wants.get(name, wants.get(app))
            if launches != {k: limit * v for k, v in want.items()}:
                failures.append(f"{name}: {limit} images launched {launches}, want {limit} x "
                                f"{want}")
            gaps = np.diff(clock.stamps)
            # the eager functions the CLI compiles, on its models and images
            # the CLIs' dtypes: fp32 for the classifier and on the CPU, else bf16
            dtype = torch.float32 if app == "classify" or dev.type == "cpu" else torch.bfloat16
            key = (app == "classify", dtype)
            if key not in models:
                models.clear()
                torch.cuda.empty_cache()
                models[key] = build_vae_var(
                    device=dev, depth=DEPTH, patch_nums=PATCH_NUMS, dtype=dtype,
                    num_classes=CLF_CLASSES if app == "classify" else 1000)[2:]
            vae, var = models[key]
            clf = VARClassifier(var, vae, mode="bayesian") if app == "classify" else None
            img_rng = np.random.default_rng(0)
            times, same = [], []
            _zero_counts(kernels)
            for idx, (path, label) in enumerate(samples[:limit]):
                x = torch.from_numpy(tf(path, img_rng))[None].to(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.inference_mode():
                    idx_bl = img_to_idxBl(vae, x)
                    gt = torch.cat(idx_bl, dim=1)
                    g = torch.Generator(device=dev).manual_seed(idx)
                    lab = torch.tensor([label], device=dev)
                    if app == "inpaint":
                        if "--box" in extra:
                            masks = {"edit_mask": torch.from_numpy(
                                get_edit_mask(PATCH_NUMS, *EDIT_BOX)).to(dev)}
                        elif "--target_layer" in extra:
                            masks = {"keep_mask": torch.from_numpy(generate_inpainting_mask(
                                PATCH_NUMS, 5, [(2, 3), (1, 1)]))[None].to(dev)}
                        else:
                            masks = {"keep_mask": torch.from_numpy(
                                keep_scales_mask(PATCH_NUMS, KEEP_THROUGH))[None].to(dev)}
                        res = decode_cfg(var, vae, lab, g, cfg_scale=4.0, top_k=1, dtype=dtype,
                                         gt_tokens=gt, **masks)
                        out = res.image.cpu().numpy()
                    elif app == "smooth":
                        res = smooth_sampling(var, vae, gt, SMOOTH_N, lab, cfg_scale=CFG,
                                              dtype=dtype)
                        out = (res.image.cpu().numpy(), float(res.log_likelihood),
                               float(res.distance_log_likelihood))
                    elif "bayesian" in name:
                        x_in = idxBl_to_var_input(vae.quantize, vae.cfg, idx_bl)
                        ll, _ = clf._score_fn(var, torch.arange(CLF_CLASSES, device=dev),
                                              x_in.expand(CLF_CLASSES, -1, -1),
                                              gt.expand(CLF_CLASSES, -1))
                        out = int(ll.argmax())
                    else:
                        keep = torch.ones_like(gt, dtype=torch.bool)
                        feat_in = img_to_fhat(vae, x)[-1].reshape(-1)
                        scores = []
                        for c in range(CLF_CLASSES):
                            res = decode_cfg(var, vae, torch.tensor([c], device=dev),
                                             torch.Generator(device=dev).manual_seed(0),
                                             cfg_scale=CFG, top_k=1, dtype=dtype, gt_tokens=gt,
                                             keep_mask=keep)
                            feat = img_to_fhat(vae, res.image * 2.0 - 1.0)[-1].reshape(-1)
                            scores.append(-float((feat_in - feat).abs().mean()))
                        out = int(np.argmax(scores))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if app in ("inpaint", "smooth"):  # both write PNGs with save_grid
                    want_png = os.path.join(root, f"{name}_{idx}.png")
                    save_grid(out if app == "inpaint" else out[0], want_png, per_row=1)
                    got_png = os.path.join(out_dir, f"{idx}_inpainted_{label}.png" if app ==
                                           "inpaint" else f"{idx}_smoothed_{label}.png")
                    with open(got_png, "rb") as a, open(want_png, "rb") as b:
                        same.append(a.read() == b.read())
                else:
                    with open(os.path.join(out_dir, f"{idx}.json")) as f:
                        same.append(json.load(f)["pred"] == out)
            eager_launches = _counts(kernels)
            if not all(same):
                failures.append(f"{name}: the CLI's outputs differ from the eager run's: {same}")
            if eager_launches != {k: limit * v for k, v in want.items()}:
                failures.append(f"{name}: eager launched {eager_launches}, want {limit} x {want}")
            rows[name] = {
                "images": limit, "main_s": main_s,
                "first_image_s": clock.stamps[0] - t_main,
                "replay_s_per_image": float(np.median(gaps)) if len(gaps) else None,
                "replay_gaps_s": gaps.tolist(),
                "eager_s_per_image": float(np.median(times[1:])), "eager_s": times,
                "launches_per_image": {k: v // limit for k, v in launches.items() if v},
                "eager_launches_per_image": {k: v // limit for k, v in eager_launches.items()
                                             if v},
                "outputs_equal_eager": same}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "zeroshot_cli", "depth": DEPTH, "batch": 1,
          "kernel_checks_batch1": checks, "modes": rows,
          "seconds": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError("zero-shot CLIs: " + "; ".join(failures))


def phase_long_parity(dev):
    """One fp32 training step (remat 2) at the 512px patch numbers (L 2240)
    with ``pallas`` and with ``hybrid`` on the card against the same step on
    the CPU: depth 2, C 128, 2 heads of 64 (so the kernels run), V 64, a
    tiny VQVAE, batch 2, seeded weights and images, the CPU's tokens on both
    sides. Loss within TRAIN_LOSS_RTOL relative, every parameter gradient
    within TRAIN_GRAD_RTOL of its max|cpu grad|; launches exact."""
    import copy

    from var_tpu_torch.config import PATCH_NUM_PRESETS, TrainArgs, VAEConfig, VARConfig
    from var_tpu_torch.device import fp32_exact
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.models import vae as vae_mod
    from var_tpu_torch.models import var as var_mod

    pns = PATCH_NUM_PRESETS["512"]
    gen = torch.Generator().manual_seed(11)
    vae = vae_mod.init_vae_params(vae_mod.VQVAE(VAEConfig(
        vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1), v_patch_nums=pns)), gen)
    vae = vae.eval().requires_grad_(False)
    var = var_mod.init_var_params(var_mod.VAR(VARConfig(
        num_classes=10, depth=2, embed_dim=128, num_heads=2, patch_nums=pns, vocab_size=64,
        z_channels=8, attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0)), gen).train()
    img = torch.rand(2, 2 * pns[-1], 2 * pns[-1], 3, generator=gen) * 2 - 1
    labels = torch.tensor([1, 7])
    args = TrainArgs(remat=2)
    idx_bl = tr.tokenize(vae, img, args)
    kernels = _all_kernels()
    rows, failures = {}, []
    for impl in ("pallas", "hybrid"):
        grads, losses = {}, {}
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            v_, q_ = copy.deepcopy(var).to(where), copy.deepcopy(vae).to(where)
            _zero_counts(kernels)
            with fp32_exact():
                loss, _ = tr.teacher_loss(v_, q_, args, [i.to(where) for i in idx_bl],
                                          labels.to(where), None, dtype=torch.float32,
                                          attn_impl=impl)
                loss.backward()
            if side == "card":
                torch.cuda.synchronize()
                launches = _counts(kernels)
            losses[side] = float(loss)
            grads[side] = {n: p.grad.detach().cpu() for n, p in v_.named_parameters()}
        worst, worst_name = 0.0, ""
        for n, g in grads["cpu"].items():
            rel = float((grads["card"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            if not rel <= worst:  # NaN counts as worst
                worst, worst_name = rel, n
        loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        want = _train_want(2, impl)
        rows[impl] = {"loss_card": losses["card"], "loss_cpu": losses["cpu"],
                      "loss_rel_err": loss_rel, "grad_rel_err_max": worst,
                      "grad_rel_err_param": worst_name, "launches": launches}
        if launches != want:
            failures.append(f"{impl}: launches {launches}, want {want}")
        if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL):
            failures.append(f"{impl}: loss rel {loss_rel}, grad rel {worst} ({worst_name})")
    emit({"phase": "long_parity", "patch_nums": list(pns), "seq_len": var.cfg.seq_len,
          "impls": rows, "tol": {"loss_rel": TRAIN_LOSS_RTOL, "grad_rel_of_max": TRAIN_GRAD_RTOL}})
    if failures:
        raise AssertionError("512px fp32 steps differ between the card and the CPU: "
                             + "; ".join(failures))


def _timed(run, n: int):
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_long_main_path(dev):
    """d16 teacher-forced training at the 512px preset (L 2240), batch 8,
    bf16 compute with fp32 parameters and AdamW state, remat 2, tclip 2,
    fp16=1 skip guard, seeded random weights and images, once per ``--attn``
    choice (``auto``, resolved to paired on the card; ``pallas``; ``hybrid``):
    counters set to 0 before a warm-up step and read after it, then 5 timed
    steps. Then one 512px eval batch of 8 and one 1024px eval batch of 2
    (L 9451) through ``pick_eval_attn`` of the auto choice, each counted on
    its first batch and timed over 3 more. Returns {run: launches}."""
    from var_tpu_torch.config import PATCH_NUM_PRESETS, TrainArgs, resolve_attn
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.models import build_vae_var_train

    kernels = _all_kernels()
    out = {}
    auto = resolve_attn("auto", dev)
    args = TrainArgs(depth=DEPTH, bs=LONG_BATCH, ac=1, ep=200, fp16=1, tclip=2.0, remat=2,
                     seed=0, pn="512").finalize(world_size=1)
    t0 = time.perf_counter()
    vae_cfg, var_cfg, vae, var = build_vae_var_train(device=dev, seed=0, depth=DEPTH,
                                                     patch_nums=PATCH_NUM_PRESETS["512"])
    g = torch.Generator(device=dev).manual_seed(12)
    reso = var_cfg.patch_nums[-1] * vae_cfg.downsample
    imgs = torch.rand(1, LONG_BATCH, reso, reso, 3, generator=g, device=dev) * 2 - 1
    labels = torch.randint(0, var_cfg.num_classes, (1, LONG_BATCH), generator=g, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for choice in ("auto", "pallas", "hybrid"):
        impl = resolve_attn(choice, dev)
        init_state, step = tr.make_train_step(var_cfg, vae_cfg, args, iters_per_ep=1000,
                                              dtype=torch.bfloat16, attn_impl=impl)
        state = init_state(var)
        gen = lambda i: torch.Generator(device=dev).manual_seed(i)  # noqa: E731
        metrics = []

        def run(i):
            metrics.append(step(state, vae, imgs, labels, gen(i), i, 1.0)[1])

        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        first_s = _timed(run, 1)[0]
        launches = _counts(kernels)
        want = _train_want(DEPTH, impl)
        if launches != want:
            raise AssertionError(f"512px {choice} training launches {launches}, want {want}")
        times = _timed(lambda i: run(1 + i), 5)
        losses = [float(m.loss) for m in metrics]
        gnorms = [float(m.grad_norm) for m in metrics]
        if not all(np.isfinite(losses + gnorms)):
            raise AssertionError(f"non-finite 512px {choice} step: loss {losses} gnorm {gnorms}")
        median_s = float(np.median(times))
        emit({"phase": "long_main_path", "run": f"train_{choice}", "attn": impl,
              "depth": DEPTH, "batch": LONG_BATCH, "seq_len": var_cfg.seq_len,
              "dtype": "bfloat16", "remat": args.remat, "launches": launches,
              "setup_s": setup_s, "first_step_s": first_s, "step_s": times,
              "step_s_median": median_s, "img_per_s": LONG_BATCH / median_s, "loss": losses,
              "grad_norm": gnorms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        out[f"train_{choice}"] = launches
        del state, step, init_state, metrics
        torch.cuda.empty_cache()
    for preset, batch in (("512", LONG_BATCH), ("1024", EVAL_1024_BATCH)):
        if preset == "1024":
            del vae, var
            torch.cuda.empty_cache()
            vae_cfg, var_cfg, vae, var = build_vae_var_train(
                device=dev, seed=0, depth=DEPTH, patch_nums=PATCH_NUM_PRESETS["1024"])
        var.eval()
        eval_attn = tr.pick_eval_attn(auto, var_cfg.seq_len)
        eval_step = tr.make_eval_step(var_cfg, vae_cfg, dtype=torch.bfloat16,
                                      attn_impl=eval_attn)
        reso = var_cfg.patch_nums[-1] * vae_cfg.downsample
        img = torch.rand(batch, reso, reso, 3, generator=g, device=dev) * 2 - 1
        label = torch.randint(0, var_cfg.num_classes, (batch,), generator=g, device=dev)
        valid = torch.ones(batch, device=dev)
        sums = []
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        first_s = _timed(lambda i: sums.append(eval_step(var, vae, img, label, valid)), 1)[0]
        launches = _counts(kernels)
        want = {**_train_want(DEPTH, "xla"), "flash_attention_fwd": DEPTH}
        if launches != want:
            raise AssertionError(f"{preset}px eval launches {launches}, want {want}")
        s = sums[0].cpu()
        if not bool(torch.isfinite(s).all()) or float(s[4]) != batch:
            raise AssertionError(f"{preset}px eval sums {s.tolist()}")
        times = _timed(lambda i: eval_step(var, vae, img, label, valid), 3)
        median_s = float(np.median(times))
        emit({"phase": "long_main_path", "run": f"eval_{preset}px", "attn": eval_attn,
              "depth": DEPTH, "batch": batch, "seq_len": var_cfg.seq_len, "dtype": "bfloat16",
              "launches": launches, "L_mean": float(s[0] / s[4]), "acc_mean": float(s[2] / s[4]),
              "first_s": first_s, "batch_s": times, "batch_s_median": median_s,
              "img_per_s": batch / median_s,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        out[f"eval_{preset}px"] = launches
    return out


# ---------------------------------------------------------------------------
# the compiled training, eval and FID programs (engine/compiled.py, train=True)

# the same runs with eager training, eval and FID steps (H100 80GB HBM3, 700.00 W)
EAGER_SCRIPT_S, EAGER_IMAGENET_RUN_S, EAGER_QLOOP_WALL_S = 303.2, 28.113, 25.924
HOLD_STEPS = 4  # steps held bit for bit: the capture's eager run, then 3 replays
COMPILED_TRAIN_CELLS = (("256", TRAIN_BATCH, "auto", 10), ("512", LONG_BATCH, "auto", 5),
                        ("512", LONG_BATCH, "pallas", 5))  # (preset, batch, --attn, timed n)
COMPILED_EVAL_CELLS = (("256", TRAIN_BATCH, 5), ("512", LONG_BATCH, 5),
                       ("1024", EVAL_1024_BATCH, 3))


def _tensor_fields(metrics) -> list:
    """The tensors of a step's metrics (StepMetrics or the tokenizer's dict)."""
    vals = metrics.values() if isinstance(metrics, dict) else metrics
    return [v for v in vals if isinstance(v, torch.Tensor)]


def _bits_equal(a, b) -> bool:
    """Two lists of tensors equal bit for bit (NaN where NaN)."""
    def eq(x, y):
        if x.is_floating_point():
            return torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(),
                                                                     y.nan_to_num())
        return torch.equal(x, y)
    return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))


class _Reproducible:
    """Inside the block: deterministic algorithms and cuBLAS's fixed
    workspace, the settings under which the training CLI's runs repeat bit
    for bit. cuDNN keeps its default plan choice (no benchmark mode)."""

    def __enter__(self):
        self.env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        if self.env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self.env


def _hold_steps(dev, step, sa, sb, args_of, n: int):
    """n steps of state ``sa`` through the compiled ``step`` (the first
    captures, the rest replay) beside ``sb`` through ``step.eager``, each
    pair from the same generator state: rows of bit-equality (metrics,
    every state tensor, the generator afterwards). ``args_of(i, g)``: step
    i's arguments after the state."""
    rows = []
    for i in range(n):
        ga, gb = (torch.Generator(device=dev).manual_seed(500 + i) for _ in range(2))
        sa, ma = step(sa, *args_of(i, ga))
        sb, mb = step.eager(sb, *args_of(i, gb))
        torch.cuda.synchronize()
        rows.append({"step": i, "replay": i > 0,
                     "metrics_equal": _bits_equal(_tensor_fields(ma), _tensor_fields(mb)),
                     "state_equal": _bits_equal(sa.tensors(), sb.tensors()),
                     "generator_equal": bool(torch.equal(ga.get_state(), gb.get_state()))})
    return sa, sb, rows


def _held(rows) -> bool:
    return all(r["metrics_equal"] and r["state_equal"] and r["generator_equal"] for r in rows)


def _step_turns(dev, kernels, step, sa, sb, args_of, n: int, seed: int) -> dict:
    """n replays of ``step`` on ``sa`` and n eager steps on ``sb`` in turns
    (``_eager_vs_replay``), then one profiled replay and one profiled eager
    step: ms a step both ways, launches, wall / busy ms and idle share."""
    st = {"replay": sa, "eager": sb}

    def run(name):
        fn = step if name == "replay" else step.eager

        def go(s):
            st[name] = fn(st[name], *args_of(s, torch.Generator(device=dev).manual_seed(s)))[0]
        return go

    turns = _eager_vs_replay(kernels, run("replay"), run("eager"), n, seed)
    prof = {k: profiled_call(lambda: run(k)(seed + 2 * n)) for k in ("replay", "eager")}
    return {"ms": {k: 1e3 * float(np.median(v)) for k, v in turns["times"].items()},
            "step_s": turns["times"], "launches": turns["launches"],
            "profiled": {k: {f: v[f] for f in ("wall_ms", "busy_ms", "idle_share",
                                                "device_events", "busy_ms_by_kind")}
                         for k, v in prof.items()}}


def _per_run(launches: dict, n: int) -> dict:
    return {k: v // n for k, v in launches.items()} if all(v % n == 0 for v in
                                                           launches.values()) else launches


def _fresh_peak(dev) -> float:
    """Empty the allocator's cache and restart its peak: the GB reserved
    now, from which the next peak is read."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_reserved(dev) / 1e9


def _pool_held(entry) -> dict:
    """What a captured entry's memory pool holds: its segments, their GB,
    the GB live tensors take (static outputs, gradients; the rest is the
    capture's temporaries, activations and workspaces, which each replay
    reuses) and the largest segment's GB."""
    pool = tuple(entry.graph.pool())
    sizes = [(s["total_size"], s["allocated_size"]) for s in torch.cuda.memory_snapshot()
             if tuple(s.get("segment_pool_id", ())) == pool]
    return {"segments": len(sizes), "gb": sum(t for t, _ in sizes) / 1e9,
            "live_gb": sum(a for _, a in sizes) / 1e9,
            "largest_gb": max((t for t, _ in sizes), default=0) / 1e9}


def phase_compiled_train_main_path(dev):
    """``make_train_step``'s compiled step (``trainer.py:312``'s jit) at the
    published d16 (nothing cut), bf16 compute, fp32 state, remat 2, tclip
    2, fp16=1, seeded weights and images: 256px batch 32 through ``auto``
    (row 6), 512px batch 8 through ``auto`` and ``pallas`` (row 5). From one
    state and one generator state, HOLD_STEPS steps whose lr, wd and
    prog_wp differ (the first captures, the rest replay) must equal the
    eager step's bit for bit: parameters, Adam's moments and count, the
    metrics and the generator, under ``_Reproducible`` (the graph is then
    dropped). Then a fresh capture without them (its launches
    recorded as one step's) and replays beside eager steps in turns (n 10
    at 256px, 5 at 512px), each launching one step's kernels; one profiled
    replay and one profiled eager step; capture s and pool GB."""
    import copy

    from var_tpu_torch.config import PATCH_NUM_PRESETS, TrainArgs, resolve_attn
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.models import build_vae_var_train

    kernels = _all_kernels()
    out, built = {}, None
    for preset, batch, choice, n in COMPILED_TRAIN_CELLS:
        t_cell = time.perf_counter()
        if built is None or built[0] != preset:
            built = None
            torch.cuda.empty_cache()
            vae_cfg, var_cfg, vae, var0 = build_vae_var_train(
                device=dev, seed=0, depth=DEPTH, patch_nums=PATCH_NUM_PRESETS[preset])
            g = torch.Generator(device=dev).manual_seed(21)
            reso = var_cfg.patch_nums[-1] * vae_cfg.downsample
            imgs = torch.rand(1, batch, reso, reso, 3, generator=g, device=dev) * 2 - 1
            labels = torch.randint(0, var_cfg.num_classes, (1, batch), generator=g, device=dev)
            built = (preset, vae_cfg, var_cfg, vae, var0, imgs, labels)
        _, vae_cfg, var_cfg, vae, var0, imgs, labels = built
        impl = resolve_attn(choice, dev)
        args = TrainArgs(depth=DEPTH, bs=batch, ac=1, ep=200, fp16=1, tclip=2.0, remat=2,
                         seed=0, pn=preset).finalize(world_size=1)
        init_state, step = tr.make_train_step(var_cfg, vae_cfg, args, iters_per_ep=1000,
                                              dtype=torch.bfloat16, attn_impl=impl)
        want = _train_want(DEPTH, impl)

        def args_of(i, g):  # lr and wd move with g_it; prog_wp differs too
            return vae, imgs, labels, g, 10 * i, 0.25 + 0.25 * (i % 4)

        sa, sb = init_state(copy.deepcopy(var0)), init_state(copy.deepcopy(var0))
        with _Reproducible():
            sa, sb, held = _hold_steps(dev, step, sa, sb, args_of, HOLD_STEPS)
        held_launches = dict(next(iter(step.program.graphs.values())).launches)
        step.program.graphs.clear()  # that graph holds the deterministic kernels
        # peak reserved GB of one eager step, then of the compiled step's
        # first call (its eager run and its capture), each from an emptied cache
        reserved0 = _fresh_peak(dev)
        sb, _ = step.eager(sb, *args_of(HOLD_STEPS, torch.Generator(device=dev).manual_seed(7)))
        torch.cuda.synchronize()
        mem = {"resident_gb": reserved0,
               "eager_step_peak_gb": torch.cuda.max_memory_reserved(dev) / 1e9}
        _fresh_peak(dev)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        sa, _ = step(sa, *args_of(HOLD_STEPS, torch.Generator(device=dev).manual_seed(7)))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        mem["compiled_first_call_peak_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
        mem["compiled_held_gb"] = _fresh_peak(dev)  # the state and the graph's pool
        first = _counts(kernels)
        (entry,) = step.program.graphs.values()
        mem["pool"] = _pool_held(entry)
        turns = _step_turns(dev, kernels, step, sa, sb, args_of, n, 100)
        row = {"phase": "compiled_train_main_path", "run": f"{preset}px_{choice}", "attn": impl,
               "depth": DEPTH, "batch": batch, "seq_len": var_cfg.seq_len, "dtype": "bfloat16",
               "remat": 2, "fp16": 1, "held_steps": held, "held_reproducible": True,
               "launches_captured": {k: v for k, v in entry.launches.items() if v},
               "launches_first_call": {k: v for k, v in first.items() if v},
               "launches_replay": _per_run(turns["launches"]["replay"], n),
               "launches_eager": _per_run(turns["launches"]["eager"], n),
               "first_call_s": first_s, "capture_s": entry.capture_s,
               "pool_gb": entry.pool_bytes / 1e9, "memory": mem,
               "replay_ms": turns["ms"]["replay"], "eager_ms": turns["ms"]["eager"],
               "replay_img_per_s": 1e3 * batch / turns["ms"]["replay"],
               "eager_img_per_s": 1e3 * batch / turns["ms"]["eager"],
               "step_s": turns["step_s"], "profiled": turns["profiled"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "seconds": time.perf_counter() - t_cell}
        emit(row)
        out[row["run"]] = row
        failures = []
        if not _held(held):
            failures.append(f"replay differs from the eager step: {held}")
        if held_launches != want or entry.launches != want or first != want:
            failures.append(f"captured {held_launches} / {entry.launches}, first call {first}, "
                            f"want {want}")
        if turns["launches"]["replay"] != {k: n * v for k, v in want.items()} \
                or turns["launches"]["eager"] != {k: n * v for k, v in want.items()}:
            failures.append(f"timed launches {turns['launches']}, want {n} x {want}")
        if failures:
            raise AssertionError(f"compiled {preset}px {choice} step: " + "; ".join(failures))
        del sa, sb, step, init_state, entry
        torch.cuda.empty_cache()
    return out


def phase_compiled_vae_train_main_path(dev):
    """``make_vae_train_step``'s compiled step (``vae_trainer.py:53``'s
    jit): the published ch160 tokenizer, fp32, batch VAE_BATCH, lr 3e-4,
    tclip 2, seeded weights and images, for ``gn_impl`` dot and pallas
    (row 7). From record_hit 98, HOLD_STEPS steps (the capture's eager run
    at 98, replays at 99, 100 and 101: the EMA decay switches to 0.99
    inside the replays) must equal the eager step's bit for bit
    (parameters, moments, count, ema_hits, record_hit, metrics), under
    ``_Reproducible`` (the graph is then dropped); then a fresh capture,
    and replays and eager steps in turns, n 5, with row 7's launches."""
    import copy

    from var_tpu_torch.config import VAEConfig
    from var_tpu_torch.engine.vae_trainer import make_vae_train_step
    from var_tpu_torch.models import build_vae_train

    cfg = VAEConfig()
    g = torch.Generator(device=dev).manual_seed(16)
    reso = cfg.v_patch_nums[-1] * cfg.downsample
    img = torch.rand(VAE_BATCH, reso, reso, 3, generator=g, device=dev) * 2 - 1
    kernels = _all_kernels()
    zero = dict.fromkeys(_counts(kernels), 0)
    out = {}
    for impl in ("dot", "pallas"):
        t_cell = time.perf_counter()
        vae0 = build_vae_train(device=dev, seed=0, cfg=cfg)
        n_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in vae0.modules())
        want = {**zero, "gn_channel_stats": n_gn if impl == "pallas" else 0}
        init_state, step = make_vae_train_step(cfg, lr=3e-4, tclip=2.0, gn_impl=impl)
        sa, sb = init_state(copy.deepcopy(vae0)), init_state(copy.deepcopy(vae0))
        for s in (sa, sb):
            s.record_hit.fill_(98)
        _zero_counts(kernels)
        with _Reproducible():
            sa, sb, held = _hold_steps(dev, step, sa, sb, lambda i, g: (img,), HOLD_STEPS)
        held_counts = _counts(kernels)  # HOLD_STEPS compiled steps + as many eager ones
        held_launches = dict(next(iter(step.program.graphs.values())).launches)
        record_hit = int(sa.record_hit)
        step.program.graphs.clear()  # that graph holds the deterministic kernels
        # peak reserved GB of one eager step, then of a fresh capture without
        # them (the first call: its eager run and the capture)
        mem = {"resident_gb": _fresh_peak(dev)}
        sb, _ = step.eager(sb, img)
        torch.cuda.synchronize()
        mem["eager_step_peak_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
        _fresh_peak(dev)
        sa, _ = step(sa, img)
        torch.cuda.synchronize()
        mem["compiled_first_call_peak_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
        mem["compiled_held_gb"] = _fresh_peak(dev)  # the state and the graph's pool
        (entry,) = step.program.graphs.values()
        mem["pool"] = _pool_held(entry)
        turns = _step_turns(dev, kernels, step, sa, sb, lambda i, g: (img,), 5, 200)
        row = {"phase": "compiled_vae_train_main_path", "run": f"train_{impl}",
               "gn_impl": impl, "ch": cfg.ch, "batch": VAE_BATCH, "dtype": "float32",
               "held_steps": held, "record_hit_from_to": [98, record_hit],
               "held_reproducible": True, "group_norms": n_gn,
               "launches_captured": {k: v for k, v in entry.launches.items() if v},
               "launches_replay": _per_run(turns["launches"]["replay"], 5),
               "launches_eager": _per_run(turns["launches"]["eager"], 5),
               "capture_s": entry.capture_s, "pool_gb": entry.pool_bytes / 1e9, "memory": mem,
               "replay_ms": turns["ms"]["replay"], "eager_ms": turns["ms"]["eager"],
               "replay_img_per_s": 1e3 * VAE_BATCH / turns["ms"]["replay"],
               "eager_img_per_s": 1e3 * VAE_BATCH / turns["ms"]["eager"],
               "step_s": turns["step_s"], "profiled": turns["profiled"],
               "seconds": time.perf_counter() - t_cell}
        emit(row)
        out[row["run"]] = row
        failures = []
        if not _held(held) or record_hit != 98 + HOLD_STEPS:
            failures.append(f"replay differs from the eager step: {held}, record_hit {record_hit}")
        if entry.launches != want or held_launches != want \
                or held_counts != {k: 2 * HOLD_STEPS * v for k, v in want.items()}:
            failures.append(f"captured {held_launches} / {entry.launches}, held {held_counts}, "
                            f"want {want}")
        if turns["launches"]["replay"] != {k: 5 * v for k, v in want.items()} \
                or turns["launches"]["eager"] != {k: 5 * v for k, v in want.items()}:
            failures.append(f"timed launches {turns['launches']}, want 5 x {want}")
        if failures:
            raise AssertionError(f"compiled tokenizer step ({impl}): " + "; ".join(failures))
        del sa, sb, step, init_state, entry, vae0
        torch.cuda.empty_cache()
    return out


def phase_compiled_eval_main_path(dev):
    """``make_eval_step``'s compiled program (``trainer.py:342``'s jit) at
    d16, bf16, seeded weights: 256px batch 32 (dense, as ``pick_eval_attn``
    picks for ``auto``), 512px batch 8 and 1024px batch 2 (row 5's
    forward). Three batches (the last padded: valid 0 on its last row) on
    one entry must give the eager body's sums bit for bit under
    ``_Reproducible``; then a fresh capture, and replays and eager batches
    in turns (n 5, 5, 3) with their launches."""
    from var_tpu_torch.config import PATCH_NUM_PRESETS, resolve_attn
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.models import build_vae_var_train

    kernels = _all_kernels()
    out = {}
    for preset, batch, n in COMPILED_EVAL_CELLS:
        t_cell = time.perf_counter()
        vae_cfg, var_cfg, vae, var = build_vae_var_train(
            device=dev, seed=0, depth=DEPTH, patch_nums=PATCH_NUM_PRESETS[preset])
        var.eval()
        eval_attn = tr.pick_eval_attn(resolve_attn("auto", dev), var_cfg.seq_len)
        ev = tr.make_eval_step(var_cfg, vae_cfg, dtype=torch.bfloat16, attn_impl=eval_attn)
        want = {**_train_want(DEPTH, "xla"),
                "flash_attention_fwd": DEPTH if eval_attn == "pallas" else 0}
        g = torch.Generator(device=dev).manual_seed(22)
        reso = var_cfg.patch_nums[-1] * vae_cfg.downsample
        batches = []
        for i in range(3):
            valid = torch.ones(batch, device=dev)
            if i == 2:
                valid[-1] = 0.0
            batches.append((torch.rand(batch, reso, reso, 3, generator=g, device=dev) * 2 - 1,
                            torch.randint(0, var_cfg.num_classes, (batch,), generator=g,
                                          device=dev), valid))
        _zero_counts(kernels)
        held = []
        with _Reproducible():
            for b in batches:
                got, eager = ev(var, vae, *b), ev.eager(var, vae, *b)
                held.append(bool(torch.equal(got, eager)) and bool(torch.isfinite(got).all()))
        torch.cuda.synchronize()
        held_counts = _counts(kernels)
        ev.graphs.clear()  # that graph holds the deterministic kernels
        # peak reserved GB of an eager batch, then of a fresh capture without
        # them (the first call: its eager run and the capture)
        mem = {"resident_gb": _fresh_peak(dev)}
        ev.eager(var, vae, *batches[0])
        torch.cuda.synchronize()
        mem["eager_batch_peak_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
        _fresh_peak(dev)
        ev(var, vae, *batches[0])
        torch.cuda.synchronize()
        mem["compiled_first_call_peak_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
        mem["compiled_held_gb"] = _fresh_peak(dev)  # the model and the graph's pool
        (entry,) = ev.graphs.values()
        mem["pool"] = _pool_held(entry)
        turns = _eager_vs_replay(kernels, lambda s: ev(var, vae, *batches[s % 3]),
                                 lambda s: ev.eager(var, vae, *batches[s % 3]), n, 0)
        ms = {k: 1e3 * float(np.median(v)) for k, v in turns["times"].items()}
        row = {"phase": "compiled_eval_main_path", "run": f"eval_{preset}px", "attn": eval_attn,
               "depth": DEPTH, "batch": batch, "seq_len": var_cfg.seq_len, "dtype": "bfloat16",
               "held_batches": held, "launches_captured": {k: v for k, v in
                                                            entry.launches.items() if v},
               "launches_replay": _per_run(turns["launches"]["replay"], n),
               "launches_eager": _per_run(turns["launches"]["eager"], n),
               "capture_s": entry.capture_s, "pool_gb": entry.pool_bytes / 1e9, "memory": mem,
               "replay_ms": ms["replay"], "eager_ms": ms["eager"],
               "replay_img_per_s": 1e3 * batch / ms["replay"],
               "eager_img_per_s": 1e3 * batch / ms["eager"], "batch_s": turns["times"],
               "seconds": time.perf_counter() - t_cell}
        emit(row)
        out[row["run"]] = row
        if not all(held) or entry.launches != want \
                or held_counts != {k: 6 * v for k, v in want.items()} \
                or turns["launches"]["replay"] != {k: n * v for k, v in want.items()} \
                or turns["launches"]["eager"] != {k: n * v for k, v in want.items()}:
            raise AssertionError(f"compiled {preset}px eval: held {held}, captured "
                                 f"{entry.launches}, counted {held_counts}, timed "
                                 f"{turns['launches']}, want {want} a batch")
        del ev, entry, vae, var, batches
        torch.cuda.empty_cache()
    return out


VAE_PARITY_BATCH = 2


def phase_vae_train_parity(dev, root):
    """One fp32 tokenizer-training forward and backward of the ch160 VQVAE
    (vae_prod.npz's synthesized weights, its first VAE_PARITY_BATCH 256px
    images), TF32 off in the forward and the backward: with
    ``gn_impl="pallas"`` on the card the tokens must equal the fixture's
    idx_*, row 7 must launch once per GroupNorm (67) and nothing else, and
    the loss and every parameter gradient must equal the same step on the
    CPU (the plain path) within TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL of each
    tensor's max; the card's ``"dot"`` loss must equal its "pallas" loss
    within TRAIN_LOSS_RTOL."""
    import copy

    from tests.synth_weights import synth_state_dict
    from var_tpu_torch.config import VAEConfig
    from var_tpu_torch.device import fp32_exact
    from var_tpu_torch.models import build_vae_train
    from var_tpu_torch.models.vae import vae_train_forward

    vdata = np.load(os.path.join(root, "tests", "fixtures", "vae_prod.npz"))
    pns = tuple(vdata["patch_nums"].tolist())
    sd = {k: torch.from_numpy(a) for k, a in synth_state_dict(
        json.loads(bytes(vdata["keys_shapes_json"]).decode())).items()
        if "ema_vocab_hit" not in k}
    vae_cpu = build_vae_train(device="cpu", cfg=VAEConfig(v_patch_nums=pns), state_dict=sd)
    vae_card = copy.deepcopy(vae_cpu).to(dev)
    n_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in vae_cpu.modules())
    img = torch.from_numpy(np.ascontiguousarray(
        np.transpose(vdata["img"][:VAE_PARITY_BATCH], (0, 2, 3, 1))))
    kernels = _all_kernels()

    def step(vae, x, impl):
        vae.zero_grad(set_to_none=True)
        with fp32_exact():  # the backward too: it runs outside the forward's context
            out = vae_train_forward(vae, x, impl)
            loss = ((out.recon - x) ** 2).mean() + out.vq_loss  # make_vae_train_step's loss
            loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for n, p in vae.named_parameters()}
        return float(loss.detach()), out, grads

    _zero_counts(kernels)
    t0 = time.perf_counter()
    loss_card, out, grads_card = step(vae_card, img.to(dev), "pallas")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = _counts(kernels)
    idx = [i.cpu().numpy() for i in out.idx_bl]
    equal = sum(int((i == vdata[f"idx_{si}"][:VAE_PARITY_BATCH]).sum()) for si, i in enumerate(idx))
    total = sum(i.size for i in idx)
    loss_dot, _, _ = step(vae_card, img.to(dev), "dot")
    t0 = time.perf_counter()
    loss_cpu, _, grads_cpu = step(vae_cpu, img, "pallas")
    cpu_s = time.perf_counter() - t0
    worst, worst_name = 0.0, ""
    for n, g in grads_cpu.items():
        rel = float((grads_card[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        if not rel <= worst:  # NaN counts as worst
            worst, worst_name = rel, n
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    dot_rel = abs(loss_dot - loss_card) / abs(loss_card)
    want = {**dict.fromkeys(launches, 0), "gn_channel_stats": n_gn}
    emit({"phase": "vae_train_parity", "batch": VAE_PARITY_BATCH, "gn_impl": "pallas",
          "tokens_equal": equal, "tokens": total, "loss_card": loss_card, "loss_cpu": loss_cpu,
          "loss_rel_err": loss_rel, "loss_card_dot": loss_dot, "dot_vs_pallas_rel": dot_rel,
          "grad_rel_err_max": worst, "grad_rel_err_param": worst_name,
          "params": len(grads_cpu), "group_norms": n_gn, "launches": launches,
          "card_s": card_s, "cpu_s": cpu_s,
          "tol": {"loss_rel": TRAIN_LOSS_RTOL, "grad_rel_of_max": TRAIN_GRAD_RTOL}})
    if equal != total:
        raise AssertionError(f"card tokens differ from vae_prod.npz: {equal}/{total} equal")
    if launches != want:
        raise AssertionError(f"tokenizer parity launches {launches}, want {want}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL and dot_rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"fp32 tokenizer step differs: card vs CPU loss rel {loss_rel}, "
                             f"grad rel {worst} ({worst_name}); dot vs pallas loss rel {dot_rel}")


def phase_vae_train_main_path(dev):
    """The published tokenizer (VAEConfig(): ch 160, ch_mult (1, 1, 2, 2, 4),
    V 4096, Cvae 32, the 256px pyramid, nothing cut), fp32 parameters and
    compute under torch's default TF32 flags, batch VAE_BATCH of seeded
    random images, lr 3e-4, tclip 2, seeded random weights: for each
    gn_impl, counters set to 0 before one warm-up step and read after it
    (row 7 once per GroupNorm with "pallas", never with "dot", no other
    kernel), then 5 timed steps; then one bf16 decoder render of a batch
    through each impl (row 7 once per decoder GroupNorm with "pallas").
    Returns {run: launches}."""
    from var_tpu_torch.config import VAEConfig
    from var_tpu_torch.engine.vae_trainer import make_vae_train_step, vocab_usage_percent
    from var_tpu_torch.models import build_vae_train
    from var_tpu_torch.models.vae import fhat_to_img

    cfg = VAEConfig()
    g = torch.Generator(device=dev).manual_seed(15)
    reso = cfg.v_patch_nums[-1] * cfg.downsample
    img = torch.rand(VAE_BATCH, reso, reso, 3, generator=g, device=dev) * 2 - 1
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    kernels = _all_kernels()
    zero = dict.fromkeys(_counts(kernels), 0)
    out = {}
    for impl in ("dot", "pallas"):
        t0 = time.perf_counter()
        vae = build_vae_train(device=dev, seed=0, cfg=cfg)
        init_state, step = make_vae_train_step(cfg, lr=3e-4, tclip=2.0, gn_impl=impl)
        state = init_state(vae)
        n_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in vae.modules())
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        metrics = []

        def run(i):
            nonlocal state
            state, m = step(state, img)
            metrics.append(m)

        torch.cuda.reset_peak_memory_stats()
        _zero_counts(kernels)
        first_s = _timed(run, 1)[0]
        launches = _counts(kernels)
        want = {**zero, "gn_channel_stats": n_gn if impl == "pallas" else 0}
        if launches != want:
            raise AssertionError(f"tokenizer training {impl} launches {launches}, want {want}")
        times = _timed(run, 5)
        vals = {k: [float(m[k]) for m in metrics] for k in ("loss", "recon", "vq", "grad_norm")}
        if not all(np.isfinite(sum(vals.values(), []))):
            raise AssertionError(f"non-finite tokenizer step ({impl}): {vals}")
        median_s = float(np.median(times))
        emit({"phase": "vae_train_main_path", "run": f"train_{impl}", "gn_impl": impl,
              "ch": cfg.ch, "ch_mult": list(cfg.ch_mult), "vocab_size": cfg.vocab_size,
              "z_channels": cfg.z_channels, "batch": VAE_BATCH, "dtype": "float32", "tf32": tf32,
              "group_norms": n_gn, "launches": launches, "steps_taken": state.step,
              "setup_s": setup_s, "first_step_s": first_s, "step_s": times,
              "step_s_median": median_s, "img_per_s": VAE_BATCH / median_s, **vals,
              "vocab_usage_pct": vocab_usage_percent(state, cfg, 1, VAE_BATCH).tolist(),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        out[f"train_{impl}"] = launches
        del state, step, init_state, metrics
        torch.cuda.empty_cache()
    vae.eval()
    n_dec = sum(isinstance(m, torch.nn.GroupNorm) for m in vae.decoder.modules())
    f_hat = (torch.randn(VAE_BATCH, cfg.v_patch_nums[-1], cfg.v_patch_nums[-1], cfg.z_channels,
                         generator=g, device=dev) * 0.5).to(torch.bfloat16)
    renders = {}
    for impl in ("dot", "pallas"):
        with torch.inference_mode():
            _zero_counts(kernels)
            t0 = time.perf_counter()
            renders[impl] = fhat_to_img(vae, f_hat, impl)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = _counts(kernels)
            want = {**zero, "gn_channel_stats": n_dec if impl == "pallas" else 0}
            if launches != want:
                raise AssertionError(f"render {impl} launches {launches}, want {want}")
            times = _timed(lambda i: fhat_to_img(vae, f_hat, impl), 5)
        r = renders[impl]
        if tuple(r.shape) != (VAE_BATCH, reso, reso, 3) or not bool(torch.isfinite(r).all()):
            raise AssertionError(f"render {impl}: bad image {tuple(r.shape)}")
        median_s = float(np.median(times))
        emit({"phase": "vae_train_main_path", "run": f"render_{impl}", "gn_impl": impl,
              "batch": VAE_BATCH, "dtype": "bfloat16", "launches": launches,
              "first_s": first_s, "batch_s": times, "batch_s_median": median_s,
              "img_per_s": VAE_BATCH / median_s})
        out[f"render_{impl}"] = launches
    diff = float((renders["dot"].float() - renders["pallas"].float()).abs().max())
    emit({"phase": "vae_train_main_path", "run": "render_dot_vs_pallas", "max_abs_diff": diff,
          "bf16_ulp_at_1": bf16_ulp(1.0)})
    return out


FID_IMAGES = 8  # seeded 256px images a set in fid_parity
# card vs CPU, fp32 with TF32 off: vae features within this share of the
# set's max |feature| (the encoder's convolutions sum in another order on
# each device); pixel features within atol; the Fréchet distance between
# two sets within this relative tolerance
FID_FEAT_RTOL_OF_MAX = 1e-4
FID_PIXEL_ATOL = 1e-6
FID_RTOL = 1e-3
FID_SELF_ATOL = 1e-2  # a set against itself: 0 up to the eigensolver's noise (JAX's bound)
FID_CLASSES, FID_PER_CLASS, FID_BATCH, FID_ROUNDS = 8, 4, 8, 2  # 32 images, 2 chunks


def _fid_vae(seed: int):
    """The published ch160 tokenizer with seeded weights, on the CPU."""
    from var_tpu_torch.config import VAEConfig
    from var_tpu_torch.models import vae as vae_mod

    vae = vae_mod.VQVAE(VAEConfig(v_patch_nums=PATCH_NUMS))
    return vae_mod.init_vae_params(vae, torch.Generator().manual_seed(seed)).eval()


def phase_fid_parity(dev):
    """``metrics/fid.py``'s extractors on the card against the same calls on
    the CPU: two sets of FID_IMAGES seeded 256px uint8 images through the
    vae extractor (the ch160 tokenizer, seeded weights carried to the card),
    the randproj extractor built on the card from seed 0 (held against the
    CPU's vae features: ``_fid_vae(0)`` is the same seed-0 init, drawn on
    the CPU) and the pixel extractor; the features, and the Fréchet
    distance between the two sets, within the stated tolerances."""
    import copy

    from var_tpu_torch.metrics import fid as F

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    sets = [rng.integers(0, 256, (FID_IMAGES, 256, 256, 3), dtype=np.uint8) for _ in range(2)]
    vae = _fid_vae(0)
    cpu_vae = F.make_vae_extractor(vae=vae, device="cpu")
    extractors = {
        "vae": (F.make_vae_extractor(vae=copy.deepcopy(vae), device=dev), cpu_vae),
        "vae_randproj": (F.make_vae_extractor(seed=0, device=dev), cpu_vae),
        "pixel": (F.make_pixel_extractor(device=dev), F.make_pixel_extractor(device="cpu")),
    }
    if extractors["vae_randproj"][0].feature_space != "vae_randproj":
        raise AssertionError("the seeded extractor is not labelled vae_randproj")
    rows, failures, cpu_feats = {}, [], {}
    for name, (card_ex, cpu_ex) in extractors.items():
        card = [card_ex(s) for s in sets]
        if id(cpu_ex) not in cpu_feats:  # the CPU's vae features serve both vae rows
            cpu_feats[id(cpu_ex)] = [cpu_ex(s) for s in sets]
        cpu = cpu_feats[id(cpu_ex)]
        err = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
        scale = max(float(np.abs(b).max()) for b in cpu)
        fids = [F.frechet_distance(*F.feature_stats(f[0]), *F.feature_stats(f[1]))
                for f in (card, cpu)]
        fid_rel = abs(fids[0] - fids[1]) / abs(fids[1])
        bound = FID_PIXEL_ATOL if name == "pixel" else FID_FEAT_RTOL_OF_MAX * scale
        rows[name] = {"dims": int(card[0].shape[1]), "feat_max_abs_err": err,
                      "feat_max_abs": scale, "feat_bound": bound, "fid_card": fids[0],
                      "fid_cpu": fids[1], "fid_rel_err": fid_rel}
        if not (err <= bound and fid_rel <= FID_RTOL):  # NaN fails too
            failures.append(f"{name}: features {err} (bound {bound}), FID rel {fid_rel}")
    emit({"phase": "fid_parity", "images": 2 * FID_IMAGES, "reso": 256, "tf32": False,
          "extractors": rows, "tol": {"vae_feat_of_max": FID_FEAT_RTOL_OF_MAX,
                                      "pixel_feat_abs": FID_PIXEL_ATOL, "fid_rel": FID_RTOL},
          "seconds": time.perf_counter() - t0})
    if failures:
        raise AssertionError("fid parity failed: " + "; ".join(failures))


def phase_fid_main_path(dev, main_path_img_per_s: float):
    """``apps/fid_sample.py``'s decode loop at d16, bf16, the FID recipe
    (cfg 1.5, top_k 900, top_p 0.96): FID_CLASSES x FID_PER_CLASS images in
    batches of FID_BATCH, ``--rounds`` FID_ROUNDS (counted), packed into
    an ``arr_0`` npz with numpy; a second seed's set likewise (not
    counted; its time, and that of its chunks after the first, which
    replay without capturing, are the img/s printed beside main_path's). Each
    extractor scores the first set against itself (~0) and against the
    second (> 0)."""
    import shutil
    import tempfile

    from var_tpu_torch.apps.fid_sample import decode_chunks
    from var_tpu_torch.metrics import fid as F
    from var_tpu_torch.models import build_vae_var

    t_phase = time.perf_counter()
    dtype = torch.bfloat16
    _, var_cfg, vae, var = build_vae_var(device=dev, seed=0, depth=DEPTH, patch_nums=PATCH_NUMS,
                                         dtype=dtype)
    labels = np.repeat(np.arange(FID_CLASSES), FID_PER_CLASS)
    kw = dict(batch=FID_BATCH, rounds=FID_ROUNDS, cfg_scale=CFG, top_k=TOP_K, top_p=TOP_P,
              dtype=dtype, device=dev)
    torch.cuda.synchronize()
    kernels = _all_kernels()
    _zero_counts(kernels)
    t0 = time.perf_counter()
    chunks = list(decode_chunks(var, vae, labels, seed=0, **kw))
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = _counts(kernels)
    batches = len(labels) // FID_BATCH
    sn = len(PATCH_NUMS)
    want = {k: batches * v for k, v in {**_decode_want(DEPTH, sn),
                                        "flash_decode": DEPTH * sn}.items()}
    if launches != want:
        raise AssertionError(f"fid_sample launches {launches}, want {want}")
    reso = 16 * PATCH_NUMS[-1]
    first = np.concatenate([imgs for _, imgs in chunks])
    if [i for i, _ in chunks] != [0, FID_ROUNDS * FID_BATCH] \
            or first.shape != (len(labels), reso, reso, 3) or first.dtype != np.uint8:
        raise AssertionError(f"fid_sample chunks {[i for i, _ in chunks]}, images "
                             f"{first.shape} {first.dtype}")
    # the second seed's set: the same work, warm, not counted; a new
    # decode_chunks call makes a new sampler, whose first chunk captures
    # again, so its later chunks (replays only) are timed apart
    t0 = time.perf_counter()
    second, stamps = [], []
    for _, imgs in decode_chunks(var, vae, labels, seed=1, **kw):  # yields after a host copy
        second.append(imgs)
        stamps.append(time.perf_counter())
    second = np.concatenate(second)
    second_s = stamps[-1] - t0
    replay_img_per_s = (len(labels) - FID_ROUNDS * FID_BATCH) / (stamps[-1] - stamps[0])
    tmp = tempfile.mkdtemp(prefix="var_fid_")
    try:
        paths = []
        for name, arr in (("seed0", first), ("seed1", second)):
            paths.append(os.path.join(tmp, f"{name}.npz"))
            np.savez(paths[-1], arr_0=arr)
        scores, compiled = {}, {}
        for name, ex in (("vae", F.make_vae_extractor(vae=vae, device=dev)),
                         ("pixel", F.make_pixel_extractor(device=dev))):
            ex(first[:FID_BATCH])  # warm-up and capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = [F.path_stats(p, ex, batch=FID_BATCH) for p in paths]
            score_s = time.perf_counter() - t0
            scores[name] = {"fid_self": F.frechet_distance(*stats[0], *stats[0]),
                            "fid_other_seed": F.frechet_distance(*stats[0], *stats[1]),
                            "scorer_ms_per_image": 1e3 * score_s / (2 * len(labels))}
            compiled[name] = _extractor_replays(ex, first)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "fid_main_path", "depth": DEPTH, "dtype": "bfloat16", "cfg": CFG,
          "top_k": TOP_K, "top_p": TOP_P, "images": len(labels), "batch": FID_BATCH,
          "rounds": FID_ROUNDS, "chunks": len(chunks), "launches": launches,
          "first_sample_s": sample_s, "sample_s": second_s,
          "sample_img_per_s": len(labels) / second_s,
          "replayed_chunks_img_per_s": replay_img_per_s,
          "main_path_img_per_s": main_path_img_per_s,
          "distinct_pixels_first": int(np.unique(first.reshape(-1, 3), axis=0).shape[0]),
          "scores": scores, "fid_self_atol": FID_SELF_ATOL, "compiled_extractors": compiled,
          "seconds": time.perf_counter() - t_phase})
    for name, s in scores.items():
        if not (abs(s["fid_self"]) < FID_SELF_ATOL and s["fid_other_seed"] > 0):
            raise AssertionError(f"fid {name}: self {s['fid_self']}, other {s['fid_other_seed']}")
    for name, c in compiled.items():
        if not all(c["features_equal"]) or c["entries"] != 2:
            raise AssertionError(f"compiled {name} extractor differs from its eager body: {c}")


def _extractor_replays(ex, imgs: np.ndarray) -> dict:
    """A compiled FID extractor (``metrics/fid.py``, the JAX extractors'
    jit) against its eager body on two full batches of FID_BATCH and a
    ragged one of 3 (its own entry; its first call and a replay), features
    bit for bit under ``_Reproducible``; then, captured afresh, 5 replays
    and 5 eager batches in turns: ms an image both ways."""
    chunks = [imgs[:FID_BATCH], imgs[FID_BATCH:2 * FID_BATCH], imgs[:3]]
    ex.program.graphs.clear()
    with _Reproducible():
        equal = [bool(np.array_equal(ex(c), ex.eager(c))) for c in chunks]
        equal.append(bool(np.array_equal(ex(chunks[2]), ex.eager(chunks[2]))))  # a replay
    entries = len(ex.program.graphs)
    ex.program.graphs.clear()  # those graphs hold the deterministic kernels
    torch.cuda.empty_cache()
    ex(chunks[0])  # a fresh capture
    turns = _eager_vs_replay(_all_kernels(), lambda s: ex(chunks[s % 2]),
                             lambda s: ex.eager(chunks[s % 2]), 5, 0)
    captured = list(ex.program.graphs.values())
    return {"features_equal": equal, "entries": entries,
            "capture_s": sum(e.capture_s for e in captured),
            "pool_gb": sum(e.pool_bytes for e in captured) / 1e9,
            **{f"{k}_ms_per_image": 1e3 * float(np.median(v)) / FID_BATCH
               for k, v in turns["times"].items()}}


# JAX's recorded CPU run at the script's defaults (scripts/quality_loop.py:30-34)
QLOOP_JAX_CPU = {"vae_recon_first_last": [0.28375, 0.00647], "val_curve_first_last":
                 [4.8513, 4.7869], "fid_init": 0.015, "fid_trained": 0.013}


def _qloop_want(args) -> dict:
    """The quality loop's launches: row 6 forward and backward once a block a
    step (remat 0), none in eval (dense at L 130); rows 1-3 in the chunked
    decodes of the two sample sets."""
    from var_tpu_torch.config import parse_patch_nums

    sn = len(parse_patch_nums(args.pn))
    steps = args.epochs * max(1, args.classes * args.per_class // args.bs)
    decodes = 2 * -(-args.classes * args.sample_per_class // args.bs)
    want = dict.fromkeys(_decode_want(args.depth, 0), 0)
    want.update(modulated_layernorm=decodes * 2 * args.depth * sn,
                flash_decode=decodes * args.depth * sn, topk_topp_bound=decodes * sn,
                paired_train_fwd=steps * args.depth, paired_train_bwd=steps * args.depth)
    return want


class _Gratings:
    """An in-memory split of ``apps/quality_loop.py``'s gratings, for its
    ``run``: ``samples[i]`` is ((H, W, 3) uint8, label), without the JPEG
    round trip or the resize-and-crop of the folder route."""

    def __init__(self):
        self.samples = []

    def __len__(self):
        return len(self.samples)


def _u8_to_pm1(item: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return item.astype(np.float32) / 255.0 * 2.0 - 1.0


def _grating_splits(args, reso: int):
    """(train, val): ``grating_images``' stream, in ``gen_dataset``'s order."""
    from var_tpu_torch.apps.quality_loop import grating_images

    splits = {"train": _Gratings(), "val": _Gratings()}
    for split, c, _, arr in grating_images(args.classes, args.per_class, args.val_per_class,
                                           reso, args.seed):
        splits[split].samples.append((arr, c))
    return splits["train"], splits["val"]


def _check_qloop_kernels(dev, args) -> dict:
    """Each kernel of the quality loop against its plain version at the
    shapes and in the dtype (fp32) the loop gives it: row 1 at (2 bs, pn^2,
    width) per stage, row 2 at the loop's chunked stages over 2 bs rows and
    ``heads`` heads, row 3 at (bs pn^2, vocab) with the loop's top_k and
    top_p (and k 1 and k = vocab), row 6's forward and backward at (bs, L,
    width). Raises on any violation; returns the errors."""
    from var_tpu_torch.apps import quality_loop as ql
    from var_tpu_torch.config import parse_patch_nums

    pns = parse_patch_nums(args.pn)
    lens, _ = _stage_lens(pns)
    f32 = (torch.float32,)
    return {
        "modulated_layernorm": check_ln(dev, 2 * args.bs, lens, args.width, f32),
        "flash_decode": check_decode(dev, f32, 2 * args.bs, args.width, args.heads,
                                     chunked_shapes(pns)),
        "topk_topp_bound": check_select(dev, [args.bs * l for l in lens], args.vocab,
                                        (1, ql.TOP_K, 0), ql.TOP_P),
        "paired_train": check_ptrain(dev, args.bs, args.width, args.heads, pns, f32),
    }


def phase_quality_loop(dev):
    """``apps/quality_loop.py::run`` at the JAX script's defaults (8 classes,
    64 train and 16 val per class, pn 1_2_3_4_6_8, 300 tokenizer steps, 6
    epochs, bs 32, depth 4, width 256, 4 heads, vocab 128, cfg 2.0, seed
    0) on the card, over the gratings in memory, after each kernel of the
    loop is held against its plain version at the loop's shapes. Fails
    unless the tokenizer's recon falls below 0.8x its first value, the
    held-out val loss falls and every number is finite; fid_improved is
    reported."""
    from var_tpu_torch.apps import quality_loop as ql
    from var_tpu_torch.config import parse_patch_nums

    args = ql.build_parser().parse_args(["--device", dev.type])
    t0 = time.perf_counter()
    checks = _check_qloop_kernels(dev, args)
    checks_s = time.perf_counter() - t0
    reso = parse_patch_nums(args.pn)[-1] * ql.vae_config(args).downsample
    train, val = _grating_splits(args, reso)
    lines = []
    kernels = _all_kernels()
    torch.cuda.synchronize()
    _zero_counts(kernels)
    t0 = time.perf_counter()
    result, samples, _ = ql.run(args, train, val, _u8_to_pm1, _u8_to_pm1, log=lines.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts(kernels)
    want = _qloop_want(args)
    numbers = result["vae_recon_first_last"] + result["val_curve"] \
        + [result["fid_init"], result["fid_trained"]]
    emit({"phase": "quality_loop", **result, "jax_cpu_recorded": QLOOP_JAX_CPU,
          "launches": launches, "kernel_checks": checks, "kernel_checks_s": checks_s,
          "log": lines, "wall_s": seconds, "wall_s_eager_steps": EAGER_QLOOP_WALL_S})
    r0, r1 = result["vae_recon_first_last"]
    failures = []
    if launches != want:
        failures.append(f"launches {launches}, want {want}")
    if not all(np.isfinite(numbers)):
        failures.append(f"non-finite numbers {numbers}")
    if not r1 < 0.8 * r0:
        failures.append(f"tokenizer recon {r0} -> {r1}, not below 0.8x")
    if not result["val_curve"][-1] < result["val_curve"][0]:
        failures.append(f"val loss did not fall: {result['val_curve']}")
    if any(s.shape != (args.classes * args.sample_per_class, reso, reso, 3)
           for s in samples.values()):
        failures.append(f"sample shapes {[s.shape for s in samples.values()]}")
    if failures:
        raise AssertionError("quality loop failed: " + "; ".join(failures))


ANALYSIS_CLASSES, ANALYSIS_IMAGES = 10, 8
ANALYSIS_DEPTHS = (DEPTH, 20)  # --depths 16,20: d20 has 20 heads of 64
ANALYSIS_CASES = ((0.0, False), (CFG, True))  # (cfg_scale, l2_dist) of the parity phase


def _analysis_records(models, imgs, labels):
    from var_tpu_torch.apps.analysis import analyze_image

    return [analyze_image(models, img[None], int(lbl), list(range(ANALYSIS_CLASSES)),
                          batch_size=ANALYSIS_CLASSES) for img, lbl in zip(imgs, labels)]


def phase_analysis_parity(dev, root):
    """``apps/analysis.py`` at the var_prod.npz geometry (fp32, TF32 off):
    one seeded image over ANALYSIS_CLASSES classes, without and with the
    CFG ramp and ``l2_dist``: the card's per-scale scores within
    ZEROSHOT_RTOL of the CPU's, the predictions equal, row 6's forward
    launched once a block a forward and no backward."""
    import copy

    from var_tpu_torch.apps.analysis import make_score_fn

    t0 = time.perf_counter()
    _, var, vae = _prod_models(root)
    var_c, vae_c = copy.deepcopy(var).to(dev), copy.deepcopy(vae).to(dev)
    img = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(5)) * 2 - 1
    rows, failures = {}, []
    kernels = _all_kernels()
    for cfg_scale, l2 in ANALYSIS_CASES:
        name = f"cfg{cfg_scale:g}_l2{int(l2)}"
        _zero_counts(kernels)
        card = _analysis_records({"m": (var_c, vae_c, make_score_fn(var_c, vae_c, cfg_scale, l2))},
                                 img.to(dev), [3])[0]["m"]
        torch.cuda.synchronize()
        launches = _counts(kernels)
        cpu = _analysis_records({"m": (var, vae, make_score_fn(var, vae, cfg_scale, l2))}, img,
                                [3])[0]["m"]
        got, want = np.asarray(card["per_scale"]), np.asarray(cpu["per_scale"])
        rel = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())
        preds_equal = all(card[k] == cpu[k] for k in ("pred_per_scale", "pred_cumulative",
                                                       "pred"))
        fwd = var.cfg.depth * (2 if cfg_scale > 0 else 1)
        want_launches = {**dict.fromkeys(launches, 0), "paired_train_fwd": fwd}
        rows[name] = {"max_rel_err": rel, "preds_equal": preds_equal, "pred": card["pred"],
                      "launches": launches}
        if not (rel <= ZEROSHOT_RTOL and preds_equal) or launches != want_launches:
            failures.append(f"{name}: rel {rel}, preds equal {preds_equal}, launches "
                            f"{launches} (want {want_launches})")
    emit({"phase": "analysis_parity", "depth": var.cfg.depth, "width": var.cfg.embed_dim,
          "classes": ANALYSIS_CLASSES, "tf32": False, "cases": rows,
          "tol": {"per_scale_rel": ZEROSHOT_RTOL, "preds": "equal"},
          "seconds": time.perf_counter() - t0})
    if failures:
        raise AssertionError("analysis parity failed: " + "; ".join(failures))


def phase_analysis_main_path(dev):
    """``apps/analysis.py``'s scoring as its CLI runs it (fp32 models,
    ``make_score_fn``'s fp32 default, TF32 off) at d16, then d16 and d20
    side by side (``--depths 16,20``; d20: 20 heads of 64): first row 6 at
    each model's score-batch shape held against its plain version in fp32,
    then ANALYSIS_IMAGES seeded 256px images over ANALYSIS_CLASSES classes
    in one score batch each, one warm-up image (the capture) not timed,
    then replays of the compiled score and the eager body in turns, twice:
    images/s of both per model (the second of each), the same scores bit
    for bit, row 6's forward launched once a block a batch (twice with the
    CFG ramp, one image at d16) and no backward."""
    from var_tpu_torch.apps.analysis import aggregate, make_score_fn
    from var_tpu_torch.models import build_vae_var

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(9)
    reso = 16 * PATCH_NUMS[-1]
    imgs = torch.rand(ANALYSIS_IMAGES, reso, reso, 3, generator=g, device=dev) * 2 - 1
    labels = np.arange(ANALYSIS_IMAGES) % ANALYSIS_CLASSES
    kernels = _all_kernels()
    out, records = {}, [dict(label=int(lbl)) for lbl in labels]
    for depth in ANALYSIS_DEPTHS:
        _, _, vae, var = build_vae_var(device=dev, seed=0, depth=depth, patch_nums=PATCH_NUMS,
                                       dtype=torch.float32)
        name = f"d{depth}"
        # the score batch's attention: (classes, L, C), the model's heads, fp32
        checks = check_ptrain(dev, ANALYSIS_CLASSES, var.cfg.embed_dim, var.cfg.num_heads,
                              PATCH_NUMS, (torch.float32,))
        score_fn = make_score_fn(var, vae)
        models = {name: (var, vae, score_fn)}
        eager_models = {name: (var, vae, lambda *a: score_fn.program.eager(var, vae, *a))}
        _analysis_records(models, imgs[:1], labels[:1])  # warm-up and capture
        torch.cuda.synchronize()
        entry = next(iter(score_fn.program.graphs.values()))
        launches, seconds, recs = {}, {}, {}
        for kind in ("replay", "eager", "replay", "eager"):  # in turns, the last of each kept
            _zero_counts(kernels)
            t0 = time.perf_counter()
            recs[kind] = _analysis_records(models if kind == "replay" else eager_models, imgs,
                                           labels)
            torch.cuda.synchronize()
            seconds[kind] = time.perf_counter() - t0
            launches[kind] = _counts(kernels)
        same = [a[name] == b[name] for a, b in zip(recs["replay"], recs["eager"])]
        if not all(same):
            raise AssertionError(f"analysis {name}: replayed scores differ from eager: {same}")
        want = {**dict.fromkeys(launches["replay"], 0),
                "paired_train_fwd": depth * ANALYSIS_IMAGES}
        for kind in launches:
            if launches[kind] != want:
                raise AssertionError(f"analysis {name} {kind} launches {launches[kind]}, "
                                     f"want {want}")
        for rec, r in zip(records, recs["replay"]):
            rec[name] = r[name]
        if not np.isfinite([r[name]["per_scale"] for r in recs["replay"]]).all():
            raise AssertionError(f"analysis {name}: non-finite scores")
        row = {"launches": launches["replay"], "seconds": seconds["replay"],
               "img_per_s": ANALYSIS_IMAGES / seconds["replay"],
               "eager_seconds": seconds["eager"],
               "eager_img_per_s": ANALYSIS_IMAGES / seconds["eager"],
               "replay_equals_eager": all(same), "capture_s": entry.capture_s,
               "pool_gb": entry.pool_bytes / 1e9, "heads": var.cfg.num_heads,
               "kernel_check": checks}
        if depth == DEPTH:
            cfg_models = {name: (var, vae, make_score_fn(var, vae, cfg_scale=CFG))}
            _zero_counts(kernels)
            _analysis_records(cfg_models, imgs[:1], labels[:1])
            torch.cuda.synchronize()
            row["cfg_launches"] = _counts(kernels)
            del cfg_models
            if row["cfg_launches"] != {**want, "paired_train_fwd": 2 * depth}:
                raise AssertionError(f"analysis {name} with cfg launches {row['cfg_launches']}")
        out[name] = row
        del models, eager_models, score_fn, entry, var, vae
        torch.cuda.empty_cache()
    emit({"phase": "analysis_main_path", "dtype": "float32", "tf32": False,
          "images": ANALYSIS_IMAGES, "classes": ANALYSIS_CLASSES, "models": out,
          "aggregate": aggregate(records, list(out)), "seconds": time.perf_counter() - t_phase})


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import var_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    rows = [phase(dev) for phase in (phase_kernel_ln, phase_kernel_select,
                                     phase_kernel_attention, phase_kernel_decode_paired)]
    rows += phase_kernel_flash(dev)
    torch.cuda.empty_cache()
    rows += phase_kernel_ptrain(dev)
    rows.append(phase_kernel_gn_stats(dev))
    for row in rows:
        emit({"phase": "kernel", **row})
    phase_parity(dev, root)
    launches, main_path_img_per_s = phase_main_path(dev)
    phase_graph_main_path(dev)
    phase_train_parity(dev, root)
    _, train_step_s = phase_train_main_path(dev)
    torch.cuda.empty_cache()
    launches.update({k: v for k, v in phase_imagenet_train_main_path(dev, train_step_s).items()
                     if k.startswith("paired_train")})
    phase_zeroshot_parity(dev, root)
    zeroshot = phase_zeroshot_main_path(dev)
    launches["flash_decode_paired"] = zeroshot["flash_decode_paired"]
    torch.cuda.empty_cache()
    phase_zeroshot_cli(dev)
    torch.cuda.empty_cache()
    phase_long_parity(dev)
    long_runs = phase_long_main_path(dev)
    launches.update({k: v for k, v in long_runs["train_pallas"].items()
                     if k.startswith("flash_attention")})
    torch.cuda.empty_cache()
    phase_vae_train_parity(dev, root)
    launches["gn_channel_stats"] = phase_vae_train_main_path(dev)["train_pallas"][
        "gn_channel_stats"]
    torch.cuda.empty_cache()
    phase_compiled_train_main_path(dev)
    torch.cuda.empty_cache()
    phase_compiled_vae_train_main_path(dev)
    torch.cuda.empty_cache()
    phase_compiled_eval_main_path(dev)
    torch.cuda.empty_cache()
    phase_multigpu_parity(dev)
    torch.cuda.empty_cache()
    phase_fid_parity(dev)
    phase_fid_main_path(dev, main_path_img_per_s)
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    phase_quality_loop(dev)
    torch.cuda.empty_cache()
    phase_analysis_parity(dev, root)
    phase_analysis_main_path(dev)
    meta = {
        "modulated_layernorm": ("var_tpu_torch/ops/cuda/csrc/fused_ln.cu",
                                "var_tpu/ops/pallas/fused_ln.py:54"),
        "topk_topp_bound": ("var_tpu_torch/ops/cuda/csrc/select.cu",
                            "var_tpu/ops/pallas/select.py:86"),
        "flash_decode": ("var_tpu_torch/ops/cuda/csrc/flash_attention.cu",
                         "var_tpu/ops/pallas/flash_attention.py:556"),
        "flash_decode_paired": ("var_tpu_torch/ops/cuda/csrc/flash_attention.cu",
                                "var_tpu/ops/pallas/flash_attention.py:635"),
        "flash_attention_fwd": ("var_tpu_torch/ops/cuda/csrc/flash_attention_train.cu",
                                "var_tpu/ops/pallas/flash_attention.py:194"),
        "flash_attention_bwd": ("var_tpu_torch/ops/cuda/csrc/flash_attention_train.cu",
                                "var_tpu/ops/pallas/flash_attention.py:305"),
        "paired_train_fwd": ("var_tpu_torch/ops/cuda/csrc/flash_attention_train.cu",
                             "var_tpu/ops/pallas/flash_attention.py:912"),
        "paired_train_bwd": ("var_tpu_torch/ops/cuda/csrc/flash_attention_train.cu",
                             "var_tpu/ops/pallas/flash_attention.py:1071"),
        "gn_channel_stats": ("var_tpu_torch/ops/cuda/csrc/gn_stats.cu",
                             "var_tpu/ops/pallas/gn_stats.py:51"),
    }
    emit({"phase": "script", "seconds": time.perf_counter() - t_script,
          "seconds_eager_steps": EAGER_SCRIPT_S})
    emit({"kernels": [{"name": r["name"], "route": "cuda", "source": meta[r["name"]][0],
                       "replaces": meta[r["name"]][1], "launches": launches[r["name"]],
                       "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
                      for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
