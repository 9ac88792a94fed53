"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``var_tpu_torch/ops/cuda/csrc``, holds
each against its plain PyTorch version at the d16 main-path shapes, then
drives the port's two paths, each with the launch counters set to 0 just
before it and read just after:

* sampling: a greedy fp32 decode through the kernels against the reference
  fixture ``tests/fixtures/var_prod.npz``, then 256px class-conditional CFG
  sampling at d16 (depth 16, C = 1024, V = 4096, the 10-scale pyramid, the
  ch160 VQVAE decoder) with seeded random weights, bf16, cfg 1.5, top_k 900,
  top_p 0.96, 8 requests;
* training: one fp32 step at the var_prod.npz geometry whose tokens must
  equal ``tests/fixtures/vae_prod.npz`` and whose loss and gradients must
  equal the same step on the CPU, then d16 teacher-forced training (batch
  32, bf16 compute with fp32 parameters, remat 2, tclip 2, seeded random
  images and labels), one warm-up step and ten timed steps.

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
}
# bf16 flash_decode is held against the plain version in fp32 on the same bf16
# inputs: |got - want| <= this many bf16 ulps of max|want|, stage by stage (the
# kernel rounds q, the softmax weights and the output to bf16: about half an ulp)
FLASH_BF16_ULPS = 3
# paired-train attention (kernels 4-5), held against autograd through the
# plain block-causal attention: fp32 within atol + rtol |want|; bf16 against
# the plain version in fp32 on the same bf16 inputs, within this many bf16
# ulps of each tensor's max|want| (out rounds once; the gradients also round
# p and ds to bf16 before their products, as the TPU kernels do)
PTRAIN_F32_TOL = (1e-4, 1e-4)
PTRAIN_BF16_ULPS = {"out": 3, "dq": 4, "dk": 4, "dv": 4}
TRAIN_BATCH = 32
# select: top-k bounds must be equal; with top-p a bound may differ only where
# the fp32 mass sums (taken in another order) straddle p * M, i.e. where the
# float64 mass above the disputed threshold is within this share of M of p * M
SELECT_MASS_TOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of ``fn``: the summed self time of every device
    event it launches (kernels, copies), from ``torch.profiler``, so the host
    time spent issuing back-to-back calls is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / 1e3 / iters


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
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling" in ln]
    emit({"phase": "build", "seconds": round(seconds, 3), "sources": list(build.SOURCES),
          "flags": " ".join(build.NVCC_FLAGS), "ptxas": ptxas})


def _stage_lens():
    lens = [pn * pn for pn in PATCH_NUMS]
    return lens, [sum(lens[:i]) for i in range(len(lens))]


def phase_kernel_ln(dev):
    from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm, modulated_layernorm_plain

    g = torch.Generator(device=dev).manual_seed(1)
    b2 = 2 * BATCH
    p6 = torch.randn(b2, 6, C, generator=g, device=dev) * 0.3
    scale, shift = p6[:, 2], p6[:, 4]  # strided rows, as on the main path
    lens, _ = _stage_lens()
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[("modulated_layernorm", dtype)]
        worst = 0.0
        for l in lens:
            x = (torch.randn(b2, l, C, generator=g, device=dev) * 2 + 0.5).to(dtype)
            err, ok = max_violation(modulated_layernorm(x, scale, shift),
                                    modulated_layernorm_plain(x, scale, shift), atol, rtol)
            if not ok:
                raise AssertionError(f"modulated_layernorm {dtype} l={l}: max err {err}")
            worst = max(worst, err)
        errs[str(dtype)] = worst
    x = (torch.randn(b2, lens[-1], C, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
    ms = device_ms(lambda: modulated_layernorm(x, scale, shift), 50)
    wall = call_ms(lambda: modulated_layernorm(x, scale, shift), 50)
    plain_ms = device_ms(lambda: modulated_layernorm_plain(x, scale, shift), 20)
    nbytes = 2 * x.numel() * x.element_size() + 2 * b2 * C * 4
    bound_ms, bound_by = bound(nbytes, 8.0 * x.numel(), FP32_FLOPS)
    return {"name": "modulated_layernorm", "max_abs_err": errs[str(torch.bfloat16)],
            "max_abs_err_fp32": errs[str(torch.float32)],
            "tol": tolerances("modulated_layernorm"), "ms": ms, "call_ms": wall,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": [b2, lens[-1], C], "dtype": "bfloat16"}


def phase_kernel_select(dev):
    from var_tpu_torch.ops.cuda.select import (bound_mass_gap, topk_topp_bound,
                                               topk_topp_bound_plain)

    g = torch.Generator(device=dev).manual_seed(2)
    lens, _ = _stage_lens()
    worst, disputed, rows_total = 0.0, 0, 0
    for l in lens:
        logits = torch.randn(BATCH, l, V, generator=g, device=dev) * 3
        tk = topk_topp_bound(logits, TOP_K, 0.0)
        if not torch.equal(tk, topk_topp_bound_plain(logits, TOP_K, 0.0)):
            raise AssertionError(f"topk_topp_bound top-k only, l={l}: bounds differ")
        got = topk_topp_bound(logits, TOP_K, TOP_P)
        want = topk_topp_bound_plain(logits, TOP_K, TOP_P)
        err, n = bound_mass_gap(logits, tk, got, want, TOP_P)
        if err > SELECT_MASS_TOL:
            raise AssertionError(f"topk_topp_bound l={l}: {n} rows differ, mass gap {err}")
        worst, disputed, rows_total = max(worst, err), disputed + n, rows_total + got.numel()
    logits = torch.randn(BATCH, lens[-1], V, generator=g, device=dev) * 3
    ms = device_ms(lambda: topk_topp_bound(logits, TOP_K, TOP_P), 20)
    wall = call_ms(lambda: topk_topp_bound(logits, TOP_K, TOP_P), 20)
    plain_ms = device_ms(lambda: topk_topp_bound_plain(logits, TOP_K, TOP_P), 3, warmup=1)
    # the function reads each logit once and writes one int32 per row; a
    # minimal selection does per logit a key, an exp, a mass add and one
    # histogram count in each of 2 x 4 radix-256 passes (the kernel's 2 x 32
    # binary descent steps are its own choice, not the function's work)
    bound_ms, bound_by = bound(logits.numel() * 4 + logits.numel() // V * 4,
                               logits.numel() * (3 + 2 * 4), FP32_FLOPS)
    return {"name": "topk_topp_bound", "max_abs_err": worst, "rows_differ": disputed,
            "rows": rows_total,
            "tol": f"top-k bounds equal; top-p mass gap <= {SELECT_MASS_TOL}",
            "ms": ms, "call_ms": wall, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": [BATCH, lens[-1], V],
            "dtype": "float32"}


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return float(torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(abs(x))))


def l2_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """Per-head L2 norm in fp32, cast back: the K cache as attn_apply writes it."""
    b, l, c = t.shape
    tf = t.float().reshape(b, l, heads, c // heads)
    return (tf * torch.rsqrt((tf * tf).sum(-1, keepdim=True) + 1e-24)).reshape(b, l, c).to(t.dtype)


def phase_kernel_attention(dev):
    import torch.nn.functional as F

    from var_tpu_torch.ops.cuda.flash_attention import flash_decode, flash_decode_plain

    g = torch.Generator(device=dev).manual_seed(3)
    b2, d = 2 * BATCH, C // HEADS
    lens, cums = _stage_lens()
    lmax = sum(lens)
    sm = torch.full((HEADS,), 4.0, device=dev)  # exp(log 4), the init scale_mul
    errs, ulps, failures = {}, 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        k_raw = torch.randn(b2, lmax, C, generator=g, device=dev).to(dtype)
        v = torch.randn(b2, lmax, C, generator=g, device=dev).to(dtype)
        # as on the main path: the L2-normalised cache with scale_mul, the raw
        # cache with the post-dot scale 0.25 / sqrt(d)
        cases = (("scale_mul", l2_heads(k_raw, HEADS), 1.0, sm),
                 ("scale", k_raw, 0.25 / d ** 0.5, None))
        worst = 0.0
        for l, cum in zip(lens, cums):
            qkv = torch.randn(b2, l, 3 * C, generator=g, device=dev).to(dtype)
            for case, k, scale, smul in cases:
                got = flash_decode(qkv, k, v, cum + l, HEADS, scale, smul).float()
                want = flash_decode_plain(qkv.float(), k.float(), v.float(), cum + l, HEADS,
                                          scale, smul)
                err = float((got - want).abs().max())
                if dtype == torch.float32:
                    atol, rtol = TOL[("flash_decode", dtype)]
                    ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
                    tol = f"{atol} + {rtol} |want|"
                else:
                    ulp = bf16_ulp(float(want.abs().max()))
                    ok, tol = err <= FLASH_BF16_ULPS * ulp, FLASH_BF16_ULPS * ulp
                    ulps = max(ulps, err / ulp)
                if not ok:  # NaN fails too
                    failures.append(f"{dtype} {case} l={l} lk={cum + l}: err {err} tol {tol}")
                worst = max(worst, err)
        errs[str(dtype)] = worst
    if failures:
        raise AssertionError("flash_decode differs from its plain version: " + "; ".join(failures))
    l, lk = lens[-1], lmax
    qkv = torch.randn(b2, l, 3 * C, generator=g, device=dev).to(torch.bfloat16)
    k = l2_heads(torch.randn(b2, lmax, C, generator=g, device=dev), HEADS).to(torch.bfloat16)
    v = torch.randn(b2, lmax, C, generator=g, device=dev).to(torch.bfloat16)
    ms = device_ms(lambda: flash_decode(qkv, k, v, lk, HEADS, 1.0, sm), 20)
    wall = call_ms(lambda: flash_decode(qkv, k, v, lk, HEADS, 1.0, sm), 20)
    plain_ms = device_ms(lambda: flash_decode_plain(qkv, k, v, lk, HEADS, 1.0, sm), 5)
    # the library yardstick: SDPA on the already-normalised q (never used by the port)
    qf = qkv[..., :C].float().reshape(b2, l, HEADS, d)
    qn = (qf * torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-24) * 4.0).to(torch.bfloat16)
    qh, kh, vh = (t.transpose(1, 2) for t in (qn, k.reshape(b2, lk, HEADS, d),
                                               v.reshape(b2, lk, HEADS, d)))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0), 20)
    nbytes = 2 * (2 * b2 * l * C + 2 * b2 * lk * C)  # q, out, K, V in bf16
    bound_ms, bound_by = bound(nbytes, 4.0 * b2 * HEADS * l * lk * d, BF16_TENSOR_FLOPS)
    return {"name": "flash_decode", "max_abs_err": errs[str(torch.bfloat16)],
            "max_err_bf16_ulps": ulps, "max_abs_err_fp32": errs[str(torch.float32)],
            "tol": {**tolerances("flash_decode"),
                    "bfloat16": f"{FLASH_BF16_ULPS} bf16 ulps of max|want| per stage, "
                                "want in fp32 from the same bf16 inputs"},
            "ms": ms, "call_ms": wall, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": [b2, l, lk, HEADS, d], "dtype": "bfloat16"}


def _scale_ends():
    lens, cums = _stage_lens()
    return tuple(c + n for c, n in zip(cums, lens))


def ptrain_inputs(dev, dtype, batch: int, seed: int):
    """q, k, v, do at the d16 training shapes, as the model feeds them:
    per-head L2-normalised q times scale_mul 4 (exp(log 4), the init), L2-normalised k."""
    g = torch.Generator(device=dev).manual_seed(seed)
    l = sum(_stage_lens()[0])
    q, k, v, do = (torch.randn(batch, l, C, generator=g, device=dev) for _ in range(4))
    q = l2_heads(q, HEADS) * 4.0
    return tuple(t.to(dtype) for t in (q, l2_heads(k, HEADS), v, do))


def check_ptrain(dev, batch: int = TRAIN_BATCH) -> dict:
    """flash_attention_paired_train's forward and backward kernels against
    autograd through ops/attention.py::attention, in fp32 and bf16; raises
    on any violation. Returns {dtype: {tensor: error}} (bf16 errors also in ulps)."""
    from var_tpu_torch.ops.attention import attention
    from var_tpu_torch.ops.cuda.flash_attention import flash_attention_paired_train

    ends = _scale_ends()
    d = C // HEADS
    errs, failures = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = ptrain_inputs(dev, dtype, batch, 4)
        got_in = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention_paired_train(*got_in, HEADS, 1.0, ends)
        out.backward(do)
        want_in = [t.float().requires_grad_() for t in (q, k, v)]
        b, l, _ = q.shape
        ref = attention(*(t.reshape(b, l, HEADS, d) for t in want_in), 1.0, ends).reshape(b, l, C)
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
        raise AssertionError("flash_attention_paired_train differs from its plain version: "
                             + "; ".join(failures) + f" (errors {errs})")
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
    bound_b, by_b = bound(8 * rows * esize + 2 * b * HEADS * l * 4, 10.0 * flops,
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
               "bound_by": by_b, "library_ms": lib_fb - lib_f, **common}
    return [fwd_row, bwd_row]


def phase_parity(dev, root):
    """Greedy fp32 decode through the kernels at the var_prod.npz geometry
    (d16 width, depth 2, full pyramid, synthesized weights), TF32 off."""
    sys.path.insert(0, root)
    from tests.synth_weights import synth_state_dict
    from var_tpu_torch.config import VAEConfig, VARConfig
    from var_tpu_torch.device import fp32_exact
    from var_tpu_torch.engine.sampler import decode_tokens_cfg
    from var_tpu_torch.models import vae as vae_mod
    from var_tpu_torch.models import var as var_mod
    from var_tpu_torch.ops.cuda.flash_attention import flash_decode
    from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm
    from var_tpu_torch.ops.cuda.select import topk_topp_bound

    data = np.load(os.path.join(root, "tests", "fixtures", "var_prod.npz"))
    pns = tuple(data["patch_nums"].tolist())
    depth, width, heads, ncls = data["depth_width_heads_ncls"].tolist()
    var_cfg = VARConfig(num_classes=ncls, depth=depth, embed_dim=width, num_heads=heads,
                        attn_l2_norm=True, cond_drop_rate=0.0, patch_nums=pns,
                        vocab_size=V, z_channels=32)
    vae_cfg = VAEConfig(v_patch_nums=pns)
    manifest = lambda key: json.loads(bytes(data[key]).decode())  # noqa: E731
    var = var_mod.VAR(var_cfg)
    var.load_state_dict({k[4:]: torch.from_numpy(a) for k, a in
                         synth_state_dict(manifest("var_keys_shapes_json")).items()})
    vae = vae_mod.VQVAE(vae_cfg)
    quant = [ks for ks in manifest("vae_keys_shapes_json")
             if ks[0].startswith("quantize.") and "ema_vocab_hit" not in ks[0]]
    vae.quantize.load_state_dict({k[9:]: torch.from_numpy(a)
                                  for k, a in synth_state_dict(quant).items()})
    var, vae = var.to(dev).eval(), vae.to(dev).eval()
    counts = (modulated_layernorm.launches, flash_decode.launches, topk_topp_bound.launches)
    with torch.inference_mode(), fp32_exact():
        tokens, f_hat = decode_tokens_cfg(
            var, vae, torch.as_tensor(data["dec_label"], device=dev),
            torch.Generator(device=dev).manual_seed(0), cfg_scale=CFG, top_k=1, top_p=0.0,
            dtype=torch.float32)
    torch.cuda.synchronize()
    through = [c1 - c0 for c0, c1 in zip(counts, (modulated_layernorm.launches,
                                                  flash_decode.launches,
                                                  topk_topp_bound.launches))]
    if through != [2 * depth * len(pns), depth * len(pns), len(pns)]:
        raise AssertionError(f"parity decode did not run on the kernels: {through}")
    got = tokens.cpu().numpy()
    equal = int((got == data["dec_tokens"]).sum())
    fhat_err = float(np.abs(f_hat.cpu().numpy()
                            - np.transpose(data["dec_fhat"], (0, 2, 3, 1))).max())
    emit({"phase": "parity", "tokens_equal": equal, "tokens": int(got.size),
          "fhat_max_abs_err": fhat_err, "launches": through})
    if equal != got.size or fhat_err > 1e-4:
        raise AssertionError(f"greedy fp32 decode differs from dec_tokens: {equal}/{got.size} "
                             f"equal, f_hat err {fhat_err}")


def phase_main_path(dev):
    from var_tpu_torch.engine.sampler import make_sampler
    from var_tpu_torch.models import build_vae_var
    from var_tpu_torch.ops.cuda.flash_attention import flash_decode
    from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm
    from var_tpu_torch.ops.cuda.select import topk_topp_bound

    t0 = time.perf_counter()
    vae_cfg, var_cfg, vae, var = build_vae_var(seed=0, depth=DEPTH, patch_nums=PATCH_NUMS)
    sampler = make_sampler(var_cfg, vae_cfg, cfg_scale=CFG, top_k=TOP_K, top_p=TOP_P,
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kernels = (modulated_layernorm, flash_decode, topk_topp_bound)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    res = sampler(var, vae, torch.Generator(device=dev).manual_seed(0), DEMO_CLASSES)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    sn = len(PATCH_NUMS)
    want = {"modulated_layernorm": 2 * DEPTH * sn, "flash_decode": DEPTH * sn,
            "topk_topp_bound": sn}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, want {want}")
    img, tokens = res.image, res.tokens
    if tuple(img.shape) != (BATCH, 256, 256, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad image {tuple(img.shape)}")
    if float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("image outside [0, 1]")
    if tuple(tokens.shape) != (BATCH, var_cfg.seq_len) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= V:
        raise AssertionError("tokens out of range")
    times = []
    for i in range(10):  # the counted run above was the warm-up
        t0 = time.perf_counter()
        sampler(var, vae, torch.Generator(device=dev).manual_seed(1 + i), DEMO_CLASSES)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median_s = float(np.median(times))
    emit({"phase": "main_path", "depth": DEPTH, "batch": BATCH, "dtype": "bfloat16",
          "cfg": CFG, "top_k": TOP_K, "top_p": TOP_P, "launches": launches,
          "image_shape": list(img.shape), "image_min": float(img.min()),
          "image_max": float(img.max()), "distinct_tokens": int(tokens.unique().numel()),
          "setup_s": setup_s, "first_decode_s": first_s, "decode_s": times,
          "decode_s_median": median_s, "img_per_s": BATCH / median_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def _train_kernels():
    from var_tpu_torch.ops.cuda.flash_attention import (flash_decode, paired_train_bwd,
                                                        paired_train_fwd)
    from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm
    from var_tpu_torch.ops.cuda.select import topk_topp_bound

    return (paired_train_fwd, paired_train_bwd, modulated_layernorm, flash_decode,
            topk_topp_bound)


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
    sys.path.insert(0, root)
    from tests.synth_weights import synth_state_dict
    from var_tpu_torch.config import TrainArgs, VAEConfig, VARConfig
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.models import vae as vae_mod
    from var_tpu_torch.models import var as var_mod

    fx = os.path.join(root, "tests", "fixtures")
    vdata = np.load(os.path.join(fx, "vae_prod.npz"))
    data = np.load(os.path.join(fx, "var_prod.npz"))
    manifest = lambda d, key: json.loads(bytes(d[key]).decode())  # noqa: E731
    pns = tuple(vdata["patch_nums"].tolist())
    depth, width, heads, ncls = data["depth_width_heads_ncls"].tolist()
    var_cfg = VARConfig(num_classes=ncls, depth=depth, embed_dim=width, num_heads=heads,
                        attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0,
                        patch_nums=pns, vocab_size=V, z_channels=32)
    var = var_mod.VAR(var_cfg)
    var.load_state_dict({k[4:]: torch.from_numpy(a) for k, a in
                         synth_state_dict(manifest(data, "var_keys_shapes_json")).items()})
    vae = vae_mod.VQVAE(VAEConfig(v_patch_nums=pns))
    vae.load_state_dict({k: torch.from_numpy(a) for k, a in synth_state_dict(
        manifest(vdata, "keys_shapes_json")).items() if "ema_vocab_hit" not in k})
    var, vae = var.to(dev).train(), vae.to(dev).eval().requires_grad_(False)
    args = TrainArgs(remat=2)
    img = torch.from_numpy(np.transpose(vdata["img"], (0, 2, 3, 1))).to(dev)
    labels = torch.as_tensor(data["dec_label"], device=dev)
    kernels = _train_kernels()
    for fn in kernels:
        fn.launches = 0
    idx_bl = tr.tokenize(vae, img, args)
    equal = sum(int((i.cpu().numpy() == vdata[f"idx_{si}"]).sum()) for si, i in enumerate(idx_bl))
    total = sum(int(vdata[f"idx_{si}"].size) for si in range(len(pns)))
    loss, _ = tr.teacher_loss(var, vae, args, idx_bl, labels, None, dtype=torch.float32)
    loss.backward()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    want_launches = {"paired_train_fwd": 2 * depth, "paired_train_bwd": depth,
                     "modulated_layernorm": 0, "flash_decode": 0, "topk_topp_bound": 0}
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
    kernels = _train_kernels()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    state, m = step(state, vae, imgs, labels, step_gen(0), 0, 1.0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    want = {"paired_train_fwd": 2 * DEPTH, "paired_train_bwd": DEPTH,
            "modulated_layernorm": 0, "flash_decode": 0, "topk_topp_bound": 0}
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
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import var_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    rows = [phase(dev) for phase in (phase_kernel_ln, phase_kernel_select,
                                     phase_kernel_attention)]
    rows += phase_kernel_ptrain(dev)
    for row in rows:
        emit({"phase": "kernel", **row})
    phase_parity(dev, root)
    launches = phase_main_path(dev)
    phase_train_parity(dev, root)
    launches.update({k: v for k, v in phase_train_main_path(dev).items()
                     if k.startswith("paired_train")})
    meta = {
        "modulated_layernorm": ("var_tpu_torch/ops/cuda/csrc/fused_ln.cu",
                                "var_tpu/ops/pallas/fused_ln.py:54"),
        "topk_topp_bound": ("var_tpu_torch/ops/cuda/csrc/select.cu",
                            "var_tpu/ops/pallas/select.py:86"),
        "flash_decode": ("var_tpu_torch/ops/cuda/csrc/flash_attention.cu",
                         "var_tpu/ops/pallas/flash_attention.py:556"),
        "paired_train_fwd": ("var_tpu_torch/ops/cuda/csrc/flash_attention_train.cu",
                             "var_tpu/ops/pallas/flash_attention.py:912"),
        "paired_train_bwd": ("var_tpu_torch/ops/cuda/csrc/flash_attention_train.cu",
                             "var_tpu/ops/pallas/flash_attention.py:1071"),
    }
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
